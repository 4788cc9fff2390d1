"""The BWA host route's extension on the dict path of
``ExtendEngine.extend_seeds`` (span ``bwa.host.extend``) per 1,000 reads
of the window."""

from port_bench import spans


def read(rec):
    return spans.ms_per_kread(rec, spans.total_s(rec, "bwa.host.extend"))
