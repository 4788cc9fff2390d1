"""Share of the window's reads that BwaMemDevicePipeline reran on the
native host SMEM engine and then extended on the card
(``anatomy["rerun_reads"]``).  A program without the counter reads
None."""


def read(rec):
    n = rec["inputs"].get("bwa_reads")
    k = rec["delta"]["anatomy"].get("rerun_reads")
    if k is None or not n:
        return None
    return 100.0 * k / n
