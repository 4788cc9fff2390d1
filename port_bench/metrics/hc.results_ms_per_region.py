"""HaplotypeCallerCore's split of the flat results into each
region's likelihood matrix, CIGARs and best haplotype (span
``hc.results``) per region."""

from port_bench import spans


def read(rec):
    return spans.ms_per_region(rec, spans.total_s(rec, "hc.results"))
