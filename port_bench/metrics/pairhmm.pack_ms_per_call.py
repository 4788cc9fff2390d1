"""PairHMMEngine's native byte pack (``Timer`` key ``pairhmm.pack``, a
host clock around it) per packed batch."""


def read(rec):
    t = rec["delta"]["timers"].get("pairhmm.pack")
    if not t or t["count"] <= 0:
        return None
    return 1e3 * t["total_s"] / t["count"]
