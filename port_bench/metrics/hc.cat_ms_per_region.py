"""HaplotypeCallerCore's five read streams and the pairs' offset
arrays for the flat PairHMM call (span ``hc.cat``, inside
``hc.likelihoods``) per region."""

from port_bench import spans


def read(rec):
    return spans.ms_per_region(rec, spans.total_s(rec, "hc.cat"))
