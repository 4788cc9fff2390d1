"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), at its 700 W limit.

NVIDIA's data sheet: 67 TFLOP/s in float32 outside the tensor cores
(an FMA counts two), 3.35 TB/s of HBM3.  The data sheet gives no
integer ALU rate; int32 is taken as half the float32 rate (64 int32
lanes an SM against 128 float32 lanes, an IMAD counting two), which
gives no roofline share above its true one.  A card set below 700 W
(``power.limit``) runs slower; the share is stated against these peaks
with the card's limit beside it.
"""

from __future__ import annotations

import subprocess

FP32_FLOP_S = 67e12
INT32_OP_S = 33.5e12
HBM_BYTES_S = 3.35e12
POWER_W = 700.0


def roofline_pct(ops: float, op_rate: float, nbytes: float, seconds: float):
    """100 x the least time the chip could take (the larger of the
    operations over their peak rate and the bytes over the HBM rate)
    over ``seconds``; None without a time."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * max(ops / op_rate, nbytes / HBM_BYTES_S) / seconds


def card() -> dict:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    name, limit = (s.strip() for s in out.splitlines()[0].split(",")[:2])
    return dict(name=name, power_limit=limit)
