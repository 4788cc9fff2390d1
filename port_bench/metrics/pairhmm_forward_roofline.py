"""The PairHMM forward kernel's share of its roofline.

Work, from the inputs the window scored (every read-haplotype pair,
real cells only): 11 float32 operations a cell (match state: two
multiplies, an add and an FMA; insertion and deletion states: a
multiply and an FMA each; an FMA counts two), and each pair's read
bytes (bases and four quality planes), haplotype bytes and its float32
result once.  Time: the profiler's device time of
``pairhmm_forward_kernel`` over the traced window.
"""

import numpy as np

from port_bench import peaks

KERNEL = "pairhmm_forward_kernel"
FLOPS_A_CELL = 11


def work(lens, hlens):
    lens = np.asarray(lens, np.int64)
    hlens = np.asarray(hlens, np.int64)
    ops = FLOPS_A_CELL * float((lens * hlens).sum())
    nbytes = float((5 * lens + hlens + 4).sum())
    return ops, nbytes


def read(rec):
    t = rec.get("trace")
    if not t:
        return None
    secs = sum(s for n, s in t["kernel_s"].items() if KERNEL in n)
    if secs <= 0:
        return None
    ops, nbytes = work(rec["inputs"]["pairhmm_lens"], rec["inputs"]["pairhmm_hlens"])
    return peaks.roofline_pct(ops, peaks.FP32_FLOP_S, nbytes, secs)
