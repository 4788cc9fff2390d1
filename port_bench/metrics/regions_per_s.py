"""Regions completed over the whole window's time (host clock)."""


def read(rec):
    if rec["item_kind"] != "regions" or rec["window_s"] <= 0:
        return None
    return rec["items"] / rec["window_s"]
