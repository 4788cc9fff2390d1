"""The BWA host route's ``SeedHit`` loop (span ``bwa.host.hits``) per
1,000 reads of the window."""

from port_bench import spans


def read(rec):
    return spans.ms_per_kread(rec, spans.total_s(rec, "bwa.host.hits"))
