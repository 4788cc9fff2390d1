"""PairHMMEngine's wait for the D2H copy of the results, which waits
for the card (span ``pairhmm.wait``) per call."""

from port_bench import spans


def read(rec):
    return spans.ms_per_call(rec, spans.total_s(rec, "pairhmm.wait"))
