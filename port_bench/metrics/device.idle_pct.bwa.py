"""100 minus the share of the traced window in which a kernel, copy or
set ran on the card (profiler trace)."""


def read(rec):
    t = rec.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
