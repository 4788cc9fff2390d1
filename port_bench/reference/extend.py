"""Plain BWA-MEM banded seed extension (ksw_extend2).

A frozen copy of the oracle the port was written against.

Behavioural spec of the reference's sw_extend / seed_proc
(bwa-sw/sdaccel/smithwaterman.cpp:75-273, 511-672), itself the
ksw_extend2 contract of BWA-MEM:

* scoring: +1 match / -4 mismatch / -1 vs ambiguous base (code 4),
  gap open 6 / extend 1 (both strands), clip penalty 5, base band 100,
* two-round adaptive banding (band doubles once if the first round's
  result looks band-limited), early break when a row's running max hits
  zero or the score stops improving,
* per-row band narrowing from the leading/trailing zero runs,
* outputs the 6-tuple (score, qle, tle, gtle, gscore, max_off) plus the
  band width actually used and the band cells evaluated.

Faithfulness notes (deliberately matched to the reference, since its
callers compare exact integers):
  - the eh rows are NOT reset between the two band rounds,
  - `m <= h` means ties move the max column mj to the later j,
  - gscore updates with `gscore <= h1` (later row wins ties),
  - the "M ? M+score : 0" rule kills extension through zero cells.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np


class ExtendParams(NamedTuple):
    """Runtime scoring options — the mem_opt_t analog
    (smem/host/host_types.h:9-47, bwa-sw/sdaccel/smithwaterman.cpp:29-35).
    The defaults are
    the production constants."""

    o_del: int = 6
    e_del: int = 1
    o_ins: int = 6
    e_ins: int = 1
    pen_clip: int = 5
    w: int = 100
    sc_match: int = 1
    sc_mismatch: int = -4
    sc_ambig: int = -1


DEFAULT_EXTEND_PARAMS = ExtendParams()


def score_matrix(params: ExtendParams = DEFAULT_EXTEND_PARAMS) -> np.ndarray:
    """5x5 score matrix over A/C/G/T/N nt4 codes (bwa_fill_scmat)."""
    mat = np.full((5, 5), params.sc_mismatch, dtype=np.int64)
    np.fill_diagonal(mat, params.sc_match)
    mat[4, :] = params.sc_ambig
    mat[:, 4] = params.sc_ambig
    return mat


def sw_extend_oracle(
    query: np.ndarray,
    target: np.ndarray,
    h0: int,
    w: int | None = None,
    max_ins: int | None = None,
    max_del: int | None = None,
    params: ExtendParams = DEFAULT_EXTEND_PARAMS,
) -> Dict[str, int]:
    """One extension in one direction.  query/target are nt4 codes.

    TRANSCRIBED (control flow, not identifiers) from the reference's
    sw_extend, bwa-sw/sdaccel/smithwaterman.cpp:75-273, for
    bit-exactness: the adaptive band narrowing (lead_zeros/trail_zeros
    runs), the un-reset eh rows between band rounds, and the tie rules
    are all results-affecting, and callers compare exact integers —
    so the loop structure must match the reference statement for
    statement.  Variable names are this codebase's; the reference's own
    names for the band-narrowing registers were forw_tmp/backw_tmp/
    forw_update/tmp_eme/aw_tmp/h1_reg."""
    O_DEL, E_DEL, O_INS, E_INS = (
        params.o_del, params.e_del, params.o_ins, params.e_ins
    )
    MAT = score_matrix(params)
    if w is None:
        w = params.w
    qlen, tlen = len(query), len(target)
    if max_ins is None:
        max_ins = qlen
    if max_del is None:
        max_del = qlen
    oe_del = O_DEL + E_DEL
    oe_ins = O_INS + E_INS

    eh_h = np.zeros(qlen + 2, dtype=np.int64)
    eh_e = np.zeros(qlen + 2, dtype=np.int64)

    max_score = h0
    max_i = max_j = -1
    max_ie = -1
    gscore = -1
    max_off = 0
    reg_score = h0
    band_w = w

    cells = 0  # band cells evaluated, both rounds
    k = 0
    is_break = False
    while k < 2 and not is_break:
        prev = reg_score
        band_w = w << k
        aw1 = min(band_w, max_ins, max_del)
        beg, end = 0, qlen
        row0_h = max(h0 - oe_ins, 0)
        h1_init = h0 - O_DEL
        for i in range(tlen):
            f = 0
            m = 0
            mj = -1
            q_i = target[i]
            if beg < i - aw1:
                beg = i - aw1
            if end > i + aw1 + 1:
                end = i + aw1 + 1
            if end > qlen:
                end = qlen
            if beg == 0:
                h1_init -= E_DEL
                h1 = max(h1_init, 0)
            else:
                h1 = 0
            trail_zeros = 0
            lead_zeros = 0
            lead_run_over = False
            cells += max(end - beg, 0)
            for j in range(beg, end):
                q_j = query[j]
                h_tmp = eh_h[j]
                e_tmp = eh_e[j]
                if i == 0:
                    e = 0
                    if j == 0:
                        h = M = h0
                    elif j == 1:
                        h = M = row0_h
                    else:
                        row0_h = max(row0_h - E_INS, 0)
                        h = M = row0_h
                else:
                    e = e_tmp
                    h = M = h_tmp
                h_left = h1
                M = (M + MAT[q_i, q_j]) if M != 0 else 0
                h = max(M, e, f)
                h1 = h
                t = max(M - oe_del, 0)
                e = max(e - E_DEL, t)
                t = max(M - oe_ins, 0)
                f = max(f - E_INS, t)
                eh_e[j] = e
                eh_h[j] = h_left
                if m <= h:
                    mj = j
                    m = h
                if not lead_run_over:
                    if h_left == 0 and e == 0:
                        lead_zeros += 1
                    else:
                        lead_run_over = True
                if h_left == 0 and e == 0:
                    trail_zeros += 1
                else:
                    trail_zeros = 0
            eh_h[end] = h1
            eh_e[end] = 0
            if h1 == 0:
                trail_zeros += 1
            else:
                trail_zeros = 0
            if end == qlen:
                if gscore <= h1:
                    max_ie = i
                    gscore = h1
            if m == 0:
                break
            if m > max_score:
                max_score = m
                max_i = i
                max_j = mj
                if max_off < abs(mj - i):
                    max_off = abs(mj - i)
            beg = beg + lead_zeros
            end = end - trail_zeros + 2 if end - trail_zeros + 2 < qlen else qlen

        reg_score = max_score
        if max_score == prev or max_off < (band_w >> 1) + (band_w >> 2):
            is_break = True
        k += 1

    return dict(
        score=int(reg_score),
        qle=int(max_j + 1),
        tle=int(max_i + 1),
        gtle=int(max_ie + 1),
        gscore=int(gscore),
        max_off=int(max_off),
        w=int(band_w),
        cells=int(cells),
    )


def extend_seed_oracle(
    read: np.ndarray,
    rseq: np.ndarray,
    seed_qbeg: int,
    seed_rbeg_off: int,
    seed_len: int,
    params: ExtendParams = DEFAULT_EXTEND_PARAMS,
) -> Dict[str, int]:
    """Left+right extension of a seed, resolving alignment coordinates
    (seed_proc semantics).

    read: nt4 codes of the full query read
    rseq: nt4 codes of the fetched reference span, with the seed starting
          at offset seed_rbeg_off within rseq
    Returns qBeg/qEnd (query coords), rBeg/rEnd (offsets relative to the
    seed's reference start/end), score, trueScore, width.
    """
    left_q = read[:seed_qbeg][::-1].copy()
    left_t = rseq[:seed_rbeg_off][::-1].copy()
    right_q = read[seed_qbeg + seed_len :].copy()
    right_t = rseq[seed_rbeg_off + seed_len :].copy()

    h0 = seed_len
    reg_score = seed_len
    q_beg, q_end = 0, len(right_q)
    r_beg, r_end = 0, 0
    true_score = reg_score
    aw = [params.w, params.w]

    cells = 0
    for side, (q, t) in enumerate(((left_q, left_t), (right_q, right_t))):
        sc0 = reg_score
        h0_side = h0 if side == 0 else sc0
        res = sw_extend_oracle(
            q, t, h0_side, max_ins=len(q), max_del=len(q), params=params
        )
        reg_score = res["score"]
        aw[side] = res["w"]
        cells += res["cells"]
        if res["gscore"] <= 0 or res["gscore"] <= reg_score - params.pen_clip:
            if side == 0:
                q_beg = seed_qbeg - res["qle"]
                r_beg = -res["tle"]
                true_score = reg_score
            else:
                q_end = res["qle"]
                r_end = res["tle"]
                true_score += reg_score - sc0
        else:
            if side == 0:
                q_beg = 0
                r_beg = -res["gtle"]
                true_score = res["gscore"]
            else:
                q_end = len(right_q)
                r_end = res["gtle"]
                true_score += res["gscore"] - sc0

    return dict(
        qBeg=int(q_beg),
        qEnd=int(q_end),
        rBeg=int(r_beg),
        rEnd=int(r_end),
        score=int(reg_score),
        trueScore=int(true_score),
        width=int(max(aw)),
        cells=int(cells),
    )
