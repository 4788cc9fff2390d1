"""The BWA host route's SMEM intervals as dicts (span ``bwa.host.smem``:
``SmemEngine.collect``, a card pass and the native rerun of the reads
that overflow it) per 1,000 reads of the window."""

from port_bench import spans


def read(rec):
    return spans.ms_per_kread(rec, spans.total_s(rec, "bwa.host.smem"))
