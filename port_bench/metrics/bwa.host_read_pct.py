"""Share of the window's reads that the pipeline hands back in
``host_read_idx`` (SMEM buffers overflowed) for the host route."""


def read(rec):
    n = rec["inputs"].get("bwa_reads")
    if not n:
        return None
    return 100.0 * rec["inputs"]["bwa_host_reads"] / n
