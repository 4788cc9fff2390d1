"""PairHMMEngine's epilogue: log10 of every result and the float64
recompute of underflows (span ``pairhmm.epilogue``) per call."""

from port_bench import spans


def read(rec):
    return spans.ms_per_call(rec, spans.total_s(rec, "pairhmm.epilogue"))
