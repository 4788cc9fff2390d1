"""PairHMMEngine's enqueue: the staging layout, the H2D copy, one
kernel launch a bucket and the D2H copy of the results (span
``pairhmm.launch``) per call."""

from port_bench import spans


def read(rec):
    return spans.ms_per_call(rec, spans.total_s(rec, "pairhmm.launch"))
