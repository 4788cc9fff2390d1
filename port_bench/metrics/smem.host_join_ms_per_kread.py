"""SmemEngine's wait for its native rerun on the worker thread (span
``smem.host_join``, in ``collect``, so the host route's) per 1,000 reads
of the window."""

from port_bench import spans


def read(rec):
    return spans.ms_per_kread(rec, spans.total_s(rec, "smem.host_join"))
