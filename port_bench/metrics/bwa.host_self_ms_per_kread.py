"""The BWA host route (span ``bwa.host``: ``BwaMemSeeding.map_reads``)
less its direct children, per 1,000 reads of the window: the route's
time that no span names."""

from port_bench import spans

CHILDREN = ("bwa.host.smem", "bwa.host.enum", "bwa.host.extend", "bwa.host.hits")


def read(rec):
    return spans.ms_per_kread(rec, spans.self_s(rec, "bwa.host", CHILDREN))
