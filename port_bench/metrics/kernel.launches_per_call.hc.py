"""Kernel launches a call: the change of the wrappers' ``LAUNCHES``
counters over the window, over the window's calls."""


def read(rec):
    if not rec["calls"]:
        return None
    return sum(rec["delta"]["launches"].values()) / rec["calls"]
