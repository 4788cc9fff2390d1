"""PairHMM numeric context: quality->probability tables.

Behavioural equivalent of the reference Context<NUMBER>
(pairhmm/xlnx/host/Context.h:13-190).  All tables are *computed at
import* — the reference ships a generated 16k-line m2m.h literal table;
we derive everything from the GATK formulas instead:

  ph2pr[q]            = 10^(-q/10)
  INITIAL_CONSTANT    = 2^120 (fp32) / 2^1020 (fp64)
  matchToMatchProb    = 1 - 10^log10(10^(-i/10) + 10^(-d/10)), via the
                        Jacobian-logarithm table with 1e-4 quantization
                        (Context.h:42-61) so transition probabilities are
                        bit-faithful to the GATK 3.7 contract.

The packed match-to-match table is triangular over (insQual, delQual)
pairs, indexed [maxQ*(maxQ+1)/2 + minQ] exactly as Context.h:123-134.
"""

from __future__ import annotations

import functools

import numpy as np

MAX_QUAL = 254
MAX_JACOBIAN_TOLERANCE = 8.0
JACOBIAN_LOG_TABLE_STEP = 1e-4
JACOBIAN_LOG_TABLE_SIZE = int(MAX_JACOBIAN_TOLERANCE / JACOBIAN_LOG_TABLE_STEP) + 1


def _jacobian_log_table() -> np.ndarray:
    k = np.arange(JACOBIAN_LOG_TABLE_SIZE, dtype=np.float64)
    return np.log10(1.0 + 10.0 ** (-k * JACOBIAN_LOG_TABLE_STEP))


def _approximate_log10_sum_log10(a: np.ndarray, b: np.ndarray, table: np.ndarray):
    small = np.minimum(a, b)
    big = np.maximum(a, b)
    diff = big - small
    # fastRound(diff * inv_step): round-half-away-from-zero on positive values
    ind = (diff / JACOBIAN_LOG_TABLE_STEP + 0.5).astype(np.int64)
    ind = np.clip(ind, 0, JACOBIAN_LOG_TABLE_SIZE - 1)
    return np.where(diff >= MAX_JACOBIAN_TOLERANCE, big, big + table[ind])


@functools.lru_cache(maxsize=None)
def _match_to_match(dtype_name: str) -> np.ndarray:
    """Triangular matchToMatch table: prob that neither an insertion (qual i)
    nor a deletion (qual j) opens, for all 0 <= j <= i <= 254."""
    table = _jacobian_log_table()
    n = ((MAX_QUAL + 1) * (MAX_QUAL + 2)) >> 1
    out = np.zeros(n, dtype=np.float64)
    i = np.repeat(np.arange(MAX_QUAL + 1), np.arange(1, MAX_QUAL + 2))
    j = np.concatenate([np.arange(k + 1) for k in range(MAX_QUAL + 1)])
    log10sum = _approximate_log10_sum_log10(-0.1 * i, -0.1 * j, table)
    with np.errstate(divide="ignore"):  # q=0 pairs: log1p(-1) -> -inf -> prob 0
        log10m2m = np.log1p(-np.minimum(1.0, 10.0 ** log10sum)) / np.log(10.0)
    out[:] = 10.0 ** log10m2m
    return out.astype(np.dtype(dtype_name))


class PairHMMContext:
    """Quality tables in a given dtype (float32 production, float64 oracle)."""

    def __init__(self, dtype=np.float32):
        self.dtype = np.dtype(dtype)
        q = np.arange(128, dtype=np.float64)
        if self.dtype == np.float32:
            # match Context<float>: powf in fp32
            self.ph2pr = (
                np.float32(10.0) ** (-(q.astype(np.float32)) / np.float32(10.0))
            ).astype(np.float32)
            self.initial_constant = np.float32(np.ldexp(1.0, 120))
            self.result_threshold = np.float32(np.ldexp(1.0, -110))
        else:
            self.ph2pr = (10.0 ** (-q / 10.0)).astype(np.float64)
            self.initial_constant = np.float64(np.ldexp(1.0, 1020))
            self.result_threshold = np.float64(0.0)
        self.log10_initial_constant = self.dtype.type(
            np.log10(np.float64(self.initial_constant))
        )
        self.match_to_match = _match_to_match(self.dtype.name)

    def mm_prob(self, ins_qual, del_qual):
        """set_mm_prob (Context.h:123-134) for int arrays in [0, 127]."""
        iq = np.asarray(ins_qual, dtype=np.int64)
        dq = np.asarray(del_qual, dtype=np.int64)
        lo = np.minimum(iq, dq)
        hi = np.maximum(iq, dq)
        # quals are masked to 7 bits upstream, so hi <= 127 <= MAX_QUAL always
        return self.match_to_match[((hi * (hi + 1)) >> 1) + lo]

    def transitions(self, i_quals, d_quals, c_quals):
        """Per-read-base transition probabilities.

        Returns (pMM, pGapM, pMX, pXX, pMY, pYY) arrays in self.dtype,
        matching baseline_impl.cpp:55-66 (quals pre-masked &127).
        """
        i_q = np.asarray(i_quals).astype(np.int64) & 127
        d_q = np.asarray(d_quals).astype(np.int64) & 127
        c_q = np.asarray(c_quals).astype(np.int64) & 127
        one = self.dtype.type(1.0)
        p_mm = self.mm_prob(i_q, d_q).astype(self.dtype)
        p_gapm = (one - self.ph2pr[c_q]).astype(self.dtype)
        p_mx = self.ph2pr[i_q]
        p_xx = self.ph2pr[c_q]
        p_my = self.ph2pr[d_q]
        p_yy = self.ph2pr[c_q]
        return p_mm, p_gapm, p_mx, p_xx, p_my, p_yy

    def emissions(self, q_quals):
        """Per-read-base emission probabilities (match, mismatch) =
        (1 - ph2pr[q], ph2pr[q]/3), quals &127 (baseline_impl.cpp:83-90)."""
        q = np.asarray(q_quals).astype(np.int64) & 127
        pe = self.ph2pr[q]
        return (self.dtype.type(1.0) - pe).astype(self.dtype), (
            pe / self.dtype.type(3.0)
        ).astype(self.dtype)
