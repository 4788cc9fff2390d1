"""Plain Smith-Waterman with backtrack to CIGAR (GATK SWPairwiseAlignment).

A frozen copy of the oracle the port was written against.

Semantics are the GATK SWPairwiseAlignment contract implemented by the
reference's golden path (htc-sw/host/FalconSW_AVX.cpp):

* affine-gap DP with running vertical/horizontal best-gap tracking and
  step-length backtrack codes (kd > 0 deletion of kd, -ki < 0 insertion
  of ki, 0 diagonal), cell priority diag >= right >= down on ties
  (calculateMatrixOneBatch, FalconSW_AVX.cpp:1693-1830),
* INDEL/LEADING_INDEL strategies initialise row/col 0 with open+extend
  ramps; scores clamp at MATRIX_MIN_CUTOFF,
* start-cell selection and CIGAR emission per overhang strategy
  (calculateCigarOneBatch, FalconSW_AVX.cpp:2303-2420).

The fill is row-vectorised with the deferred horizontal max-scan (valid because gap open costs more than extend, so a gap
  opened from inside another horizontal gap can never win — the same
  restructuring the reference proves with its built-in self-check,
  FalconSW_AVX.cpp:237-297).

CIGARs are lists of (length, state) with states MATCH=0, INSERTION=1,
DELETION=2, CLIP=4 (htc-sw/host/common.h:36-39).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np

OVERHANG_SOFTCLIP = 0
OVERHANG_INDEL = 1
OVERHANG_LEADING_INDEL = 2
OVERHANG_IGNORE = 3

STATE_MATCH = 0
STATE_INSERTION = 1
STATE_DELETION = 2
STATE_CLIP = 4


class SWParams(NamedTuple):
    """Runtime scoring weights (htc-sw/host/common.h:13-56).  Defaults are
    the production weights."""

    w_match: int = 200
    w_mismatch: int = -150
    w_open: int = -260
    w_extend: int = -11


DEFAULT_SW_PARAMS = SWParams()


MATRIX_MIN_CUTOFF = int(-1e8)
LOW_INIT = -(1 << 30)


def _init_matrices(nrow: int, ncol: int, strategy: int,
                   params: SWParams = DEFAULT_SW_PARAMS):
    sw = np.zeros((nrow, ncol), dtype=np.int64)
    if strategy in (OVERHANG_INDEL, OVERHANG_LEADING_INDEL):
        ramp = params.w_open + np.arange(ncol - 1, dtype=np.int64) * params.w_extend
        sw[0, 1:] = ramp
        rampr = params.w_open + np.arange(nrow - 1, dtype=np.int64) * params.w_extend
        sw[1:, 0] = rampr
    return sw


def sw_fill_rowwise(ref, alt, strategy: int,
                    params: SWParams = DEFAULT_SW_PARAMS):
    """Row-vectorised fill with deferred horizontal max-scan.  """
    W_MATCH, W_MISMATCH, W_OPEN, W_EXTEND = params
    ref = np.asarray(ref)
    alt = np.asarray(alt)
    nrow, ncol = len(ref) + 1, len(alt) + 1
    sw = _init_matrices(nrow, ncol, strategy, params)
    btrack = np.zeros((nrow, ncol), dtype=np.int64)
    best_gap_v = np.full(ncol, LOW_INIT, dtype=np.int64)
    gap_size_v = np.zeros(ncol, dtype=np.int64)
    jidx = np.arange(1, ncol, dtype=np.int64)
    for i in range(1, nrow):
        a = ref[i - 1]
        wd = np.where(alt == a, W_MATCH, W_MISMATCH).astype(np.int64)
        step_diag = sw[i - 1, :-1] + wd
        prev_gap = sw[i - 1, 1:] + W_OPEN
        best_gap_v[1:] += W_EXTEND
        take = prev_gap > best_gap_v[1:]
        best_gap_v[1:] = np.where(take, prev_gap, best_gap_v[1:])
        gap_size_v[1:] = np.where(take, 1, gap_size_v[1:] + 1)
        step_down = best_gap_v[1:]
        kd = gap_size_v[1:]

        diag_ge_down = step_diag >= step_down
        sw_prime = np.where(diag_ge_down, step_diag, step_down)

        # deferred horizontal scan over sw_prime (column 0 uses the real
        # first-column value of this row):
        #   step_right[j] = max_{0<=k<j} sw_prime_full[k] + OPEN + (j-k-1)*EXT
        # ties keep the smaller k (longer gap)
        sw_prime_full = np.concatenate(([sw[i, 0]], sw_prime))
        u = sw_prime_full[:-1] - jidx * W_EXTEND  # u[k] = sw'[k] - (k+1)*EXT
        run_max = np.maximum.accumulate(u)
        # argmax keeping first occurrence
        first_idx = np.arange(ncol - 1)
        is_new = np.concatenate(([True], u[1:] > run_max[:-1]))
        k_best = np.maximum.accumulate(np.where(is_new, first_idx, -1))
        step_right = run_max + W_OPEN + jidx * W_EXTEND
        ki = jidx - k_best

        # priority: diag >= right >= down
        use_diag = diag_ge_down & (step_diag >= step_right)
        use_right = ~use_diag & (step_right >= step_down)
        val = np.where(use_diag, step_diag, np.where(use_right, step_right, step_down))
        sw[i, 1:] = np.maximum(MATRIX_MIN_CUTOFF, val)
        btrack[i, 1:] = np.where(use_diag, 0, np.where(use_right, -ki, kd))
    return sw, btrack


def sw_backtrack(
    sw: np.ndarray, btrack: np.ndarray, strategy: int
) -> Tuple[List[Tuple[int, int]], int]:
    """CIGAR + alignment offset from filled matrices
    (calculateCigarOneBatch semantics)."""
    nrow, ncol = sw.shape
    ref_len, alt_len = nrow - 1, ncol - 1
    segment_length = 0
    if strategy == OVERHANG_INDEL:
        p1, p2 = ref_len, alt_len
    else:
        p2 = alt_len
        p1 = 0
        maxscore = -(1 << 62)
        for i in range(1, nrow):
            if sw[i, alt_len] >= maxscore:
                p1 = i
                maxscore = sw[i, alt_len]
        if strategy != OVERHANG_LEADING_INDEL:
            for j in range(1, ncol):
                cur = sw[ref_len, j]
                if cur > maxscore or (
                    cur == maxscore and abs(ref_len - j) < abs(p1 - p2)
                ):
                    p1 = ref_len
                    p2 = j
                    maxscore = cur
                    segment_length = alt_len - j

    elements: List[Tuple[int, int]] = []
    if segment_length > 0 and strategy == OVERHANG_SOFTCLIP:
        elements.append((segment_length, STATE_CLIP))
        segment_length = 0

    state = STATE_MATCH
    while True:
        btr = int(btrack[p1, p2])
        if btr > 0:
            new_state, step = STATE_DELETION, btr
        elif btr < 0:
            new_state, step = STATE_INSERTION, -btr
        else:
            new_state, step = STATE_MATCH, 1
        if new_state == STATE_MATCH:
            p1 -= 1
            p2 -= 1
        elif new_state == STATE_INSERTION:
            p2 -= step
        else:
            p1 -= step
        if new_state == state:
            segment_length += step
        else:
            elements.append((segment_length, state))
            segment_length = step
            state = new_state
        if not (p1 > 0 and p2 > 0):
            break

    if strategy == OVERHANG_SOFTCLIP:
        elements.append((segment_length, state))
        if p2 > 0:
            elements.append((p2, STATE_CLIP))
        offset = p1
    elif strategy == OVERHANG_IGNORE:
        elements.append((segment_length + p2, state))
        offset = p1 - p2
    else:
        elements.append((segment_length, state))
        if p1 > 0:
            elements.append((p1, STATE_DELETION))
        elif p2 > 0:
            elements.append((p2, STATE_INSERTION))
        offset = 0

    elements.reverse()
    # NOTE: zero-length elements are kept — the reference pushes them
    # verbatim (addCigarElement has no merge/skip) and compares exactly.
    return elements, offset


def sw_align(ref, alt, strategy: int = OVERHANG_SOFTCLIP,
             params: SWParams = DEFAULT_SW_PARAMS):
    """(cigar, offset) for one ref/alt pair."""
    sw, btrack = sw_fill_rowwise(ref, alt, strategy, params)
    return sw_backtrack(sw, btrack, strategy)
