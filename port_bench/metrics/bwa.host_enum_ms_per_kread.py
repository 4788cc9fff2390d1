"""The BWA host route's Python seed loop, a task dict per occurrence
(span ``bwa.host.enum``) per 1,000 reads of the window."""

from port_bench import spans


def read(rec):
    return spans.ms_per_kread(rec, spans.total_s(rec, "bwa.host.enum"))
