"""PairHMMEngine's flat call (span ``pairhmm.call``) less its direct
children, per call: the layer's time that no span names."""

from port_bench import spans

CHILDREN = ("pairhmm.bucket", "pairhmm.pack", "pairhmm.stage", "pairhmm.launch",
            "pairhmm.wait", "pairhmm.host_join", "pairhmm.epilogue")


def read(rec):
    return spans.ms_per_call(rec, spans.self_s(rec, "pairhmm.call", CHILDREN))
