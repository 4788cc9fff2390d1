"""Reads mapped over the whole window's time, host-routed ones
included (host clock)."""


def read(rec):
    if rec["item_kind"] != "reads" or rec["window_s"] <= 0:
        return None
    return rec["items"] / rec["window_s"]
