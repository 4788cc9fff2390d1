"""PairHMMEngine's flat bucketing: each pair's bucket, the host
route's thread start and the launch groups (span ``pairhmm.bucket``)
per call."""

from port_bench import spans


def read(rec):
    return spans.ms_per_call(rec, spans.total_s(rec, "pairhmm.bucket"))
