"""The program's spans (``Timer`` keys of ``acc_genomics_tpu_torch``) in
a run's record: ``rec["delta"]["timers"]``, each span's count and seconds
over the window.  A program that opens no such span reads None."""

from __future__ import annotations

from typing import Optional, Sequence


def total_s(rec: dict, span: str) -> Optional[float]:
    """The window's seconds in ``span``, or None when it was never opened."""
    t = rec["delta"]["timers"].get(span)
    if not t or t["count"] <= 0:
        return None
    return t["total_s"]


def self_s(rec: dict, span: str, children: Sequence[str]) -> Optional[float]:
    """``span``'s seconds less its direct children's: the time inside it
    that no span of the program names."""
    total = total_s(rec, span)
    if total is None:
        return None
    return total - sum(total_s(rec, c) or 0.0 for c in children)


def ms_per_region(rec: dict, s: Optional[float]) -> Optional[float]:
    if s is None or not rec["items"]:
        return None
    return 1e3 * s / rec["items"]


def ms_per_call(rec: dict, s: Optional[float]) -> Optional[float]:
    if s is None or not rec["calls"]:
        return None
    return 1e3 * s / rec["calls"]


def ms_per_kread(rec: dict, s: Optional[float]) -> Optional[float]:
    if s is None or not rec["items"]:
        return None
    return 1e3 * s / (rec["items"] / 1e3)
