"""BwaMemDevicePipeline's SMEM phase (``anatomy["smem_s"]``: the pack,
``collect_arrays``' launches and fetches) per 1,000 reads."""


def read(rec):
    s = rec["delta"]["anatomy"].get("smem_s")
    if s is None or not rec["items"]:
        return None
    return 1e3 * s / (rec["items"] / 1e3)
