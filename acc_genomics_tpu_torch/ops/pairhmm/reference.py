"""NumPy oracle for the PairHMM forward algorithm.

Semantics follow the GATK 3.7 scalar baseline of the reference
(pairhmm/xlnx/host/baseline_impl.cpp:11-110): a 3-state (M/X/Y) forward
recurrence over the (read+1) x (hap+1) matrix, Y row 0 initialised to
INITIAL_CONSTANT / haplen, result = sum of the last row's M + X.

This is the golden model for every faster implementation.  Rows are
vectorised; the within-row Y recurrence (a first-order IIR filter with
constant coefficient) is evaluated by scipy.signal.lfilter, which performs
the identical sequential recurrence in the same dtype, so results are
bit-equal to a scalar loop.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from scipy.signal import lfilter

from acc_genomics_tpu_torch.ops.pairhmm.context import PairHMMContext
from acc_genomics_tpu_torch.utils.convert import BASE_N


def pairhmm_oracle(rs, q, i, d, c, hap, dtype=np.float64):
    """Forward probability for one (read, hap) pair.

    Args:
      rs:  (R,) read base codes (0..4, 4 = N)
      q/i/d/c: (R,) base/insert/delete/gap-continuation quality bytes
      hap: (H,) haplotype base codes (0..4)
      dtype: np.float32 or np.float64

    Returns the raw (pre-log) forward probability in ``dtype`` — the analog
    of compute_full_prob_baseline; callers convert with
    log10(result) - log10_initial_constant.
    """
    dt = np.dtype(dtype).type
    ctx = PairHMMContext(dtype)
    rs = np.asarray(rs)
    hap = np.asarray(hap)
    rlen, hlen = len(rs), len(hap)

    p_mm, p_gapm, p_mx, p_xx, p_my, p_yy = ctx.transitions(i, d, c)
    em_match, em_mis = ctx.emissions(q)

    # distm[r, c]: emission for read base r against hap base c
    is_match = (rs[:, None] == hap[None, :]) | (rs[:, None] == BASE_N) | (
        hap[None, :] == BASE_N
    )
    distm = np.where(is_match, em_match[:, None], em_mis[:, None]).astype(dtype)

    m_prev = np.zeros(hlen + 1, dtype=dtype)
    x_prev = np.zeros(hlen + 1, dtype=dtype)
    y_prev = np.full(hlen + 1, ctx.initial_constant / dt(hlen), dtype=dtype)

    for r in range(rlen):
        m_cur = np.zeros(hlen + 1, dtype=dtype)
        m_cur[1:] = distm[r] * (
            m_prev[:-1] * p_mm[r] + (x_prev[:-1] + y_prev[:-1]) * p_gapm[r]
        )
        x_cur = m_prev * p_mx[r] + x_prev * p_xx[r]
        # Y scan: y[c] = m_cur[c-1]*pMY + pYY*y[c-1], y[0] = 0 — exact IIR
        drive = m_cur[:-1] * p_my[r]
        y_cur = np.zeros(hlen + 1, dtype=dtype)
        y_cur[1:] = lfilter(
            np.array([1.0], dtype=dtype), np.array([1.0, -p_yy[r]], dtype=dtype), drive
        )
        m_prev, x_prev, y_prev = m_cur, x_cur, y_cur

    return dt((m_prev + x_prev).sum())


def pairhmm_loglik_oracle(rs, q, i, d, c, hap, dtype=np.float64):
    """log10 likelihood, matching the reference epilogue
    (FalconPairHMM.cpp:634-656): log10(result) - LOG10_INITIAL_CONSTANT."""
    ctx = PairHMMContext(dtype)
    res = pairhmm_oracle(rs, q, i, d, c, hap, dtype=dtype)
    return np.log10(np.float64(res)) - np.float64(ctx.log10_initial_constant)


def pairhmm_batch_oracle(testcases: Sequence[dict], dtype=np.float64):
    """Oracle over a list of dicts with keys rs,q,i,d,c,hap."""
    return np.array(
        [
            pairhmm_oracle(
                tc["rs"], tc["q"], tc["i"], tc["d"], tc["c"], tc["hap"], dtype
            )
            for tc in testcases
        ],
        dtype=dtype,
    )
