"""Plain PairHMM forward likelihoods (GATK's three-state forward algorithm).

The recurrence of GATK's scalar baseline: a (read + 1) x (hap + 1)
matrix of match (M), insertion (X) and deletion (Y) states, Y's row 0
set to INITIAL_CONSTANT / hap length, the result the sum of the last
row's M + X, reported as log10(result) - log10(INITIAL_CONSTANT).  The
quality tables (ph2pr, matchToMatch through GATK's Jacobian-log table
at 1e-4 steps) are a frozen copy of GATK's Context formulas.

The batch is computed by anti-diagonals: every cell of a diagonal
depends only on the two diagonals before it, so one diagonal of all the
pairs is a handful of tensor operations.  Plain ``torch`` on any device,
in float64 for the reference (INITIAL_CONSTANT 2^1020) or in a lower
precision for a control (2^120, the float32 constant, whose exponent
range bfloat16 shares).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

MAX_QUAL = 254
_JAC_STEP = 1e-4
_JAC_TOL = 8.0
_JAC_SIZE = int(_JAC_TOL / _JAC_STEP) + 1
BASE_N = 4


@functools.lru_cache(maxsize=None)
def match_to_match() -> np.ndarray:
    """(i, d) -> 1 - (10^(-i/10) + 10^(-d/10)) in GATK's approximate
    log10-sum, as a (128, 128) float64 table."""
    table = np.log10(1.0 + 10.0 ** (-np.arange(_JAC_SIZE) * _JAC_STEP))
    q = np.arange(128, dtype=np.float64)
    a, b = np.meshgrid(-0.1 * q, -0.1 * q, indexing="ij")
    small, big = np.minimum(a, b), np.maximum(a, b)
    diff = big - small
    ind = np.clip((diff / _JAC_STEP + 0.5).astype(np.int64), 0, _JAC_SIZE - 1)
    log10sum = np.where(diff >= _JAC_TOL, big, big + table[ind])
    with np.errstate(divide="ignore"):
        return 10.0 ** (np.log1p(-np.minimum(1.0, 10.0 ** log10sum)) / np.log(10.0))


def initial_constant(dtype: torch.dtype) -> float:
    return float(2.0 ** 1020) if dtype == torch.float64 else float(2.0 ** 120)


def forward_loglik(rs, q, i, d, c, lens, hap, hlens, dtype=torch.float64,
                   device="cpu", block: int = 4096) -> np.ndarray:
    """log10 likelihoods of P pairs.

    rs, q, i, d, c: (P, R) uint8 read codes and qualities (row k of pair
    p valid below lens[p]); hap: (P, H) uint8 codes (valid below
    hlens[p]).  Returns (P,) float64."""
    rs, q, i, d, c, hap = (np.asarray(a, np.uint8) for a in (rs, q, i, d, c, hap))
    lens, hlens = np.asarray(lens, np.int64), np.asarray(hlens, np.int64)
    out = np.empty(len(lens), np.float64)
    for lo in range(0, len(lens), block):
        sl = slice(lo, lo + block)
        out[sl] = _block(rs[sl], q[sl], i[sl], d[sl], c[sl], lens[sl], hap[sl],
                         hlens[sl], dtype, torch.device(device))
    return out


def _block(rs, q, i, d, c, lens, hap, hlens, dtype, dev) -> np.ndarray:
    P, R = rs.shape
    H = hap.shape[1]
    f64 = np.float64
    ph2pr = 10.0 ** (-np.arange(128, dtype=f64) / 10.0)
    iq, dq, cq, qq = (a.astype(np.int64) & 127 for a in (i, d, c, q))
    m2m = match_to_match()
    lo, hi = np.minimum(iq, dq), np.maximum(iq, dq)
    tabs = dict(
        pmm=m2m[hi, lo], pgapm=1.0 - ph2pr[cq], pmx=ph2pr[iq], pxx=ph2pr[cq],
        pmy=ph2pr[dq], pyy=ph2pr[cq], em=1.0 - ph2pr[qq], ex=ph2pr[qq] / 3.0,
    )
    t = {k: torch.from_numpy(v).to(dev).to(dtype) for k, v in tabs.items()}
    rs_t = torch.from_numpy(rs.astype(np.int64)).to(dev)
    hap_t = torch.from_numpy(hap.astype(np.int64)).to(dev)
    lens_t = torch.from_numpy(lens).to(dev)
    hlens_t = torch.from_numpy(hlens).to(dev)
    ic = initial_constant(dtype)
    y0 = (torch.tensor(ic, dtype=torch.float64, device=dev) / hlens_t.to(torch.float64)
          ).to(dtype)

    r = torch.arange(R + 1, device=dev)[None, :]  # (1, R + 1)
    zeros = torch.zeros((P, R + 1), dtype=dtype, device=dev)
    m1, x1, y1 = zeros.clone(), zeros.clone(), zeros.clone()  # diagonal d - 1
    m2, x2, y2 = zeros.clone(), zeros.clone(), zeros.clone()  # diagonal d - 2
    acc = torch.zeros(P, dtype=dtype, device=dev)
    last = lens_t[:, None] == r  # the row whose M + X is the result
    for diag in range(R + H + 1):
        col = diag - r  # (1, R + 1)
        valid = (col >= 0) & (col <= hlens_t[:, None])
        hb = torch.gather(hap_t, 1, (col[:, 1:] - 1).clamp(0, max(H - 1, 0)).expand(P, R))
        rb = rs_t
        match = (rb == hb) | (rb == BASE_N) | (hb == BASE_N)
        emit = torch.where(match, t["em"], t["ex"])
        m = torch.zeros_like(m1)
        x = torch.zeros_like(x1)
        y = torch.zeros_like(y1)
        m[:, 1:] = emit * (m2[:, :-1] * t["pmm"] + (x2[:, :-1] + y2[:, :-1]) * t["pgapm"])
        x[:, 1:] = m1[:, :-1] * t["pmx"] + x1[:, :-1] * t["pxx"]
        y[:, 1:] = m1[:, 1:] * t["pmy"] + y1[:, 1:] * t["pyy"]
        first_col = col == 0
        m = torch.where(first_col, 0.0, m)
        y = torch.where(first_col, 0.0, y)
        y[:, 0] = torch.where(valid[:, 0], y0, 0.0)
        m = torch.where(valid, m, 0.0)
        x = torch.where(valid, x, 0.0)
        y = torch.where(valid, y, 0.0)
        acc = acc + ((m + x) * last).sum(1)
        m2, x2, y2, m1, x1, y1 = m1, x1, y1, m, x, y
    res = acc.to(torch.float64).cpu().numpy()
    with np.errstate(divide="ignore"):
        return np.log10(res) - np.log10(ic)
