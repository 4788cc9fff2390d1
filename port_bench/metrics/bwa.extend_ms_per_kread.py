"""BwaMemDevicePipeline's extension phase (``anatomy["extend_s"]``: the
H2D copy, the fused launch and the result's D2H) per 1,000 reads."""


def read(rec):
    s = rec["delta"]["anatomy"].get("extend_s")
    if s is None or not rec["items"]:
        return None
    return 1e3 * s / (rec["items"] / 1e3)
