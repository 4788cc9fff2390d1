"""Share of the window's reads that the BWA pipeline's SMEM retry at
wide caps flagged too, so that they took the native host SMEM engine
(``anatomy["rerun_host_reads"]``).  A program without the counter reads
None."""


def read(rec):
    n = rec["inputs"].get("bwa_reads")
    k = rec["delta"]["anatomy"].get("rerun_host_reads")
    if k is None or not n:
        return None
    return 100.0 * k / n
