"""PairHMMEngine's staging: the pinned host buffer and its fill from
the packed planes (span ``pairhmm.stage``) per call."""

from port_bench import spans


def read(rec):
    return spans.ms_per_call(rec, spans.total_s(rec, "pairhmm.stage"))
