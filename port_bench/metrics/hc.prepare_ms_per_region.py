"""HaplotypeCallerCore's set-up of the cross products (span
``hc.prepare``, the reading of ``anatomy["host_s"]``) per region."""

from port_bench import spans


def read(rec):
    return spans.ms_per_region(rec, spans.total_s(rec, "hc.prepare"))
