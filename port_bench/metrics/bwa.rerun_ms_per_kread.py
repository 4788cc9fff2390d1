"""BwaMemDevicePipeline's native SMEM rerun of the reads the kernel flags
(span ``bwa.pipe.rerun``, beside ``bwa.pipe.smem``; their seeds then take
the card route) per 1,000 reads of the window.  A program without the
span reads None."""

from port_bench import spans


def read(rec):
    return spans.ms_per_kread(rec, spans.total_s(rec, "bwa.pipe.rerun"))
