"""Banded BWA-MEM seed extension: the CUDA kernel's wrapper and its plain
PyTorch twin.

Counterpart of the JAX package's ``ops/extend/kernel.py``
(``sw_extend_pallas``) with the same contract: ``q_tm`` (Q, B) and
``t_tm`` (T, B) integer base codes, time-major, pad and ambiguous bases
coded 4; ``qlen``, ``tlen``, ``h0``, ``max_ins``, ``max_del`` (B,) int32.
The result is the seven (B,) int32 fields ``KEYS`` of ksw_extend2, exact
integers.  ``sw_extend_rows`` returns them stacked as one (7, B) tensor,
``sw_extend`` as a dict.

``extend_seeds_fused`` is the fused seed-extension step of the JAX
package's ``BwaMemDevicePipeline`` (``models/bwa_mem.py``
``_extend_seeds_fused``): per seed, the suffix-array lookup, the left and
right extensions on spans read straight from the resident reads and
text, and the clip resolution, as one (8, N) int32 tensor in
``FUSED_KEYS`` order.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches csrc/sw_extend.cu on the current stream and adds one to
``LAUNCHES["sw_extend"]`` or ``LAUNCHES["sw_extend_fused"]``.  Tensors on
mixed devices raise.  Both run one warp a task (a seed: its left, then
its right extension) with the query across the lanes: up to
``REGISTER_QUERY`` columns in registers, past that in tiles of as many
columns in shared memory, so the query bucket (the read width of
``extend_seeds_fused``) holds at most ``MAX_QUERY`` columns on the
card.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Dict

import torch

from acc_genomics_tpu_torch import build
from acc_genomics_tpu_torch.device import check_tensor, same_device
from acc_genomics_tpu_torch.ops.extend.reference import (
    DEFAULT_EXTEND_PARAMS,
    ExtendParams,
)

KEYS = ("score", "qle", "tle", "gtle", "gscore", "max_off", "w")
FUSED_KEYS = ("qBeg", "qEndRel", "rBeg", "rEndRel", "score", "trueScore", "width",
              "pos")
NEG = -(1 << 29)
REGISTER_QUERY = 256  # query columns of a warp's registers (8 a lane)
MAX_QUERY = 100 * REGISTER_QUERY  # a warp's tiles in 227 KB of shared memory

# kernel launches per wrapper (CUDA tensors only); callers reset with clear()
LAUNCHES: collections.Counter = collections.Counter()

_SOURCES = ("ops/extend/csrc/sw_extend.cu",)
_P = ctypes.c_void_p
_I = ctypes.c_int


def build_kernels() -> Dict[str, build.BuiltLibrary]:
    """Build (at first use) and load the extension library, with the C
    entry point's argument types set."""
    built = build.load_library("sw_extend", _SOURCES)
    fn = built.lib.sw_extend
    if fn.argtypes is None:
        fn.argtypes = [_P] * 7 + [_I] * 11 + [_P] * 2
        fn.restype = ctypes.c_int
        fused = built.lib.sw_extend_fused
        fused.argtypes = ([_P, _P, _I, _P, _I] + [_P] * 5 + [_I] * 11
                          + [_P] * 2)
        fused.restype = ctypes.c_int
    return {"sw_extend": built}


# -- plain PyTorch version ---------------------------------------------------


def _cummax_log(u: torch.Tensor) -> torch.Tensor:
    """Inclusive running max along dim 0 as a log-step shift-max ladder."""
    n = u.shape[0]
    sh = 1
    while sh < n:
        shifted = torch.cat([torch.full_like(u[:sh], NEG), u[:-sh]])
        u = torch.maximum(u, shifted)
        sh <<= 1
    return u


def sw_extend_plain(q_tm, t_tm, qlen, tlen, h0, max_ins, max_del,
                    params: ExtendParams = DEFAULT_EXTEND_PARAMS,
                    count_cells: bool = False):
    """Lockstep port of the JAX ``jax_impl.sw_extend_batch``: one loop step
    per target row over all lanes, (Q + 2, B) eh rows, every per-cell rule
    a masked tensor op, and the in-row F chain
    f(j) = max_{k < j in band} max(M(k) - oe_ins, 0) - (j - 1 - k) * e_ins
    as a running max of ``t_ins(k) + k * e_ins``.  Rows past every lane's
    tlen are not visited, and round 2 is skipped when no lane needs it.
    Returns (7, B) int32 in ``KEYS`` order; with ``count_cells``, also the
    number of band cells computed (a 0-d int64 tensor: the work the data
    needed, which the kernel computes too)."""
    o_del, e_del, o_ins, e_ins = params.o_del, params.e_del, params.o_ins, params.e_ins
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    i32 = torch.int32
    dev = q_tm.device
    q = q_tm.to(i32)
    t = t_tm.to(i32)
    qmax, bsz = q.shape
    qlen, tlen, h0 = qlen.to(i32), tlen.to(i32), h0.to(i32)
    max_ins, max_del = max_ins.to(i32), max_del.to(i32)
    jj = torch.arange(qmax, dtype=i32, device=dev)[:, None]
    jj2 = torch.arange(qmax + 2, dtype=i32, device=dev)[:, None]
    eh_h = torch.zeros((qmax + 2, bsz), dtype=i32, device=dev)
    eh_e = torch.zeros_like(eh_h)
    neg1 = torch.full((bsz,), -1, dtype=i32, device=dev)
    max_score, max_i, max_j, max_ie = h0.clone(), neg1, neg1, neg1
    gscore, max_off = neg1, torch.zeros_like(h0)
    reg_score = h0
    aw_used = torch.full_like(h0, params.w)
    done = torch.zeros(bsz, dtype=torch.bool, device=dev)
    cells = torch.zeros((), dtype=torch.int64, device=dev)
    n_rows = min(int(tlen.max()), t.shape[0]) if bsz else 0
    amb = torch.tensor(params.sc_ambig, dtype=i32, device=dev)
    match = torch.tensor(params.sc_match, dtype=i32, device=dev)
    mism = torch.tensor(params.sc_mismatch, dtype=i32, device=dev)
    for k in (0, 1):
        if k == 1 and bool(done.all()):
            break
        prev = reg_score
        band_w = params.w << k
        aw1 = torch.clamp(torch.minimum(max_ins, max_del), max=band_w)
        round_active = ~done
        aw_used = torch.where(round_active, band_w, aw_used)
        row0_h = torch.clamp(h0 - oe_ins, min=0)
        row0_m = torch.where(jj == 0, h0[None, :],
                             torch.clamp(row0_h[None, :] - (jj - 1) * e_ins, min=0))
        beg = torch.zeros_like(h0)
        end = qlen.clone()
        h1_init = h0 - o_del
        alive = round_active.clone()
        for i in range(n_rows):
            t_i = t[i][None, :]
            beg = torch.maximum(beg, i - aw1)
            end = torch.minimum(torch.minimum(end, i + aw1 + 1), qlen)
            at0 = beg == 0
            h1_init = torch.where(alive & at0, h1_init - e_del, h1_init)
            h1_beg = torch.where(at0, torch.clamp(h1_init, min=0), 0)
            in_band = (jj >= beg[None, :]) & (jj < end[None, :])
            sc = torch.where((t_i >= 4) | (q >= 4), amb, torch.where(t_i == q, match, mism))
            m_in = row0_m if i == 0 else eh_h[:qmax]
            e_in = torch.zeros_like(q) if i == 0 else eh_e[:qmax]
            big_m = torch.where(m_in != 0, m_in + sc, 0)
            e_out = torch.maximum(e_in - e_del, torch.clamp(big_m - oe_del, min=0))
            t_ins = torch.clamp(big_m - oe_ins, min=0)
            run = _cummax_log(torch.where(in_band, t_ins + jj * e_ins, NEG))
            f = torch.cat([torch.full_like(run[:1], NEG), run[:-1]]) - (jj - 1) * e_ins
            h = torch.maximum(torch.maximum(big_m, e_in), torch.clamp(f, min=0))
            h = torch.where(in_band, h, 0)
            # H(i, j - 1): h shifted down one column, h1_beg injected at beg
            hprev = torch.cat([torch.zeros_like(h[:1]), h[:-1]])
            hprev = torch.where(jj == beg[None, :], h1_beg[None, :], hprev)
            nonempty = end > beg
            h_end = torch.where(jj == torch.clamp(end - 1, min=0)[None, :], h, NEG).amax(0)
            h1_last = torch.where(nonempty, h_end, h1_beg)
            # m, mj: the last argmax among the visited columns
            h_band = torch.where(in_band, h, -1)
            m = torch.clamp(h_band.amax(0), min=0)
            mj = torch.where(in_band & (h_band == m[None, :]), jj, -1).amax(0)
            # zero-run narrowing over (hprev == 0 & e_out == 0)
            not_z = in_band & ~((hprev == 0) & (e_out == 0))
            first = torch.where(not_z, jj, qmax).amin(0)
            forw = torch.minimum(torch.maximum(first, beg), end) - beg
            last = torch.where(not_z, jj, -1).amax(0)
            trail = torch.where(nonempty, end - 1 - torch.maximum(last, beg - 1), 0)
            backw = torch.where(h1_last == 0, trail + 1, 0)
            # eh rows: [beg, end) from this row, eh[end] = (h1, 0)
            row_active = alive & (i < tlen)
            if count_cells:
                cells += (in_band & row_active[None, :]).sum()
            new_h = torch.cat([torch.where(in_band, hprev, eh_h[:qmax]), eh_h[qmax:]])
            new_e = torch.cat([torch.where(in_band, e_out, eh_e[:qmax]), eh_e[qmax:]])
            at_end = jj2 == end[None, :]
            new_h = torch.where(at_end, h1_last[None, :], new_h)
            new_e = torch.where(at_end, 0, new_e)
            eh_h = torch.where(row_active[None, :], new_h, eh_h)
            eh_e = torch.where(row_active[None, :], new_e, eh_e)
            # gscore: the scalar loop tests j == qlen after the row sweep
            gupd = row_active & (torch.maximum(beg, end) == qlen) & (gscore <= h1_last)
            max_ie = torch.where(gupd, i, max_ie)
            gscore = torch.where(gupd, h1_last, gscore)
            brk = row_active & (m == 0)
            alive = alive & ~brk
            mupd = row_active & ~brk & (m > max_score)
            max_score = torch.where(mupd, m, max_score)
            max_i = torch.where(mupd, i, max_i)
            max_j = torch.where(mupd, mj, max_j)
            off = (mj - i).abs()
            max_off = torch.where(mupd & (off > max_off), off, max_off)
            beg = torch.where(row_active, beg + forw, beg)
            end = torch.where(row_active, torch.minimum(end - backw + 2, qlen), end)
        reg_score = torch.where(round_active, max_score, reg_score)
        brk = (max_score == prev) | (max_off < ((band_w >> 1) + (band_w >> 2)))
        done = done | (round_active & brk) | ~round_active
    out = torch.stack([reg_score, max_j + 1, max_i + 1, max_ie + 1, gscore,
                       max_off, aw_used]).to(i32)
    return (out, cells) if count_cells else out


# -- kernel wrapper ----------------------------------------------------------


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def sw_extend_rows(q_tm, t_tm, qlen, tlen, h0, max_ins, max_del,
                   params: ExtendParams = DEFAULT_EXTEND_PARAMS) -> torch.Tensor:
    """(7, B) int32 results in ``KEYS`` order (contract above).  On the
    card the codes go to the kernel as uint8 (a cast when they are not),
    and Q may not pass ``MAX_QUERY``."""
    dev = same_device(q_tm, t_tm, qlen, tlen, h0, max_ins, max_del)
    if dev.type == "cpu":
        return sw_extend_plain(q_tm, t_tm, qlen, tlen, h0, max_ins, max_del, params)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if q_tm.dim() != 2 or t_tm.dim() != 2 or q_tm.shape[1] != t_tm.shape[1]:
        raise ValueError("q_tm must be (Q, B) and t_tm (T, B)")
    qmax, bsz = q_tm.shape
    tmax = t_tm.shape[0]
    if qmax == 0 or tmax == 0:
        raise ValueError(f"empty bucket {qmax} x {tmax}")
    if qmax > MAX_QUERY:
        raise ValueError(f"query bucket {qmax} > {MAX_QUERY} columns: a warp's tiles "
                         "would not fit its shared memory")
    if q_tm.is_floating_point() or t_tm.is_floating_point():
        raise TypeError("base codes must be integers")
    q8 = q_tm.to(torch.uint8).contiguous()
    t8 = t_tm.to(torch.uint8).contiguous()
    for name, v in (("qlen", qlen), ("tlen", tlen), ("h0", h0),
                    ("max_ins", max_ins), ("max_del", max_del)):
        check_tensor(v, name, torch.int32, (bsz,))
    out = torch.empty((len(KEYS), bsz), dtype=torch.int32, device=dev)
    p = params
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = build_kernels()["sw_extend"].lib.sw_extend(
            *(_ptr(a) for a in (q8, t8, qlen, tlen, h0, max_ins, max_del)),
            qmax, tmax, bsz, p.o_del, p.e_del, p.o_ins, p.e_ins, p.w,
            p.sc_match, p.sc_mismatch, p.sc_ambig, _ptr(out),
            ctypes.c_void_p(stream))
        LAUNCHES["sw_extend"] += 1
    if err != 0:
        raise RuntimeError(f"sw_extend: CUDA launch failed with error {err}")
    return out


def sw_extend(q_tm, t_tm, qlen, tlen, h0, max_ins, max_del,
              params: ExtendParams = DEFAULT_EXTEND_PARAMS) -> Dict[str, torch.Tensor]:
    """The ``sw_extend_pallas`` contract: dict of (B,) int32 by ``KEYS``."""
    rows = sw_extend_rows(q_tm, t_tm, qlen, tlen, h0, max_ins, max_del, params)
    return dict(zip(KEYS, rows))


# -- the fused seed-extension step --------------------------------------------


def _span_codes(src, start, step: int, lens, width: int) -> torch.Tensor:
    """(width, N) codes ``src[start + step * j]`` for j < lens, 4 beyond."""
    j = torch.arange(width, device=src.device)[:, None]
    valid = j < lens[None, :]
    idx = torch.where(valid, start.long()[None, :] + step * j, 0)
    return torch.where(valid, src[idx].to(torch.int32), 4)


def extend_seeds_fused_plain(sa, text, reads, rlens, rows, qbeg, slen, readid,
                             flank: int,
                             params: ExtendParams = DEFAULT_EXTEND_PARAMS,
                             count_cells: bool = False):
    """Plain version of ``extend_seeds_fused``: the SA rows gathered, the
    reversed left spans and forward right spans built by index arithmetic
    (code 4 past each length), ``sw_extend_plain`` left (h0 = the seed
    length) then right (h0 = the left score), then the resolution.  With
    ``count_cells``, also the band cells of both extensions."""
    i32 = torch.int32
    n = rows.shape[0]
    if n == 0:
        out = torch.zeros((len(FUSED_KEYS), 0), dtype=i32, device=rows.device)
        return (out, torch.zeros((), dtype=torch.int64)) if count_cells else out
    width = reads.shape[1]
    pos = sa[rows.long()].to(i32)
    rid = readid.long()
    qbeg, slen = qbeg.to(i32), slen.to(i32)
    # the lengths of bwa_mem.py:136-139
    lq_len = qbeg
    rq_len = rlens[rid].to(i32) - qbeg - slen
    lt_len = torch.minimum(pos, qbeg + flank)
    rt_len = torch.minimum(text.shape[0] - pos - slen, rq_len + flank)
    # the lengths the kernel runs: queries within the read matrix, no
    # negative target
    lq_run, rq_run = lq_len.clamp(0, width), rq_len.clamp(0, width)
    lt_run, rt_run = lt_len.clamp(min=0), rt_len.clamp(min=0)
    flat = reads.reshape(-1)
    tw = max(int(lt_run.max()), int(rt_run.max()), 1)
    lq = _span_codes(flat, rid * width + qbeg - 1, -1, lq_run, width)
    rq = _span_codes(flat, rid * width + qbeg + slen, 1, rq_run, width)
    lt = _span_codes(text, pos - 1, -1, lt_run, tw)
    rt = _span_codes(text, pos + slen, 1, rt_run, tw)
    left, lcells = sw_extend_plain(lq, lt, lq_run, lt_run, slen, lq_len, lq_len,
                                   params, count_cells=True)
    right, rcells = sw_extend_plain(rq, rt, rq_run, rt_run, left[0], rq_len, rq_len,
                                    params, count_cells=True)
    lsc, lqle, ltle, lgtle, lg = left[:5]
    rsc, rqle, rtle, rgtle, rg = right[:5]
    pen = params.pen_clip
    l_clip = (lg <= 0) | (lg <= lsc - pen)
    r_clip = (rg <= 0) | (rg <= rsc - pen)
    true_l = torch.where(l_clip, lsc, lg)
    out = torch.stack([
        torch.where(l_clip, qbeg - lqle, 0),
        torch.where(r_clip, rqle, rq_len),
        torch.where(l_clip, -ltle, -lgtle),
        torch.where(r_clip, rtle, rgtle),
        rsc,
        true_l + torch.where(r_clip, rsc, rg) - lsc,
        torch.maximum(left[6], right[6]),
        pos,
    ]).to(i32)
    return (out, lcells + rcells) if count_cells else out


def extend_seeds_fused(sa, text, reads, rlens, rows, qbeg, slen, readid, flank: int,
                       params: ExtendParams = DEFAULT_EXTEND_PARAMS) -> torch.Tensor:
    """(8, N) int32 in ``FUSED_KEYS`` order for N seeds.

    sa (text_len + 1,) int32 suffix array and text (text_len,) uint8 codes,
    both strands; reads (n_reads, W) uint8 codes, read-major, pad 4;
    rlens (n_reads,) int32; rows, qbeg, slen, readid (N,) int32: each
    seed's SA row, query start and length, and read.  Per seed, with pos =
    sa[row]: the left extension of read[:qbeg] reversed against
    text[pos - min(pos, qbeg + flank):pos] reversed (h0 = slen), the right
    extension of read[qbeg + slen:rlen] against text[pos + slen:] up to
    rlen - qbeg - slen + flank bases (h0 = the left score), max_ins =
    max_del = the query length, then the ``pen_clip`` resolution."""
    dev = same_device(sa, text, reads, rlens, rows, qbeg, slen, readid)
    if dev.type == "cpu":
        return extend_seeds_fused_plain(sa, text, reads, rlens, rows, qbeg, slen,
                                        readid, flank, params)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n = rows.shape[0]
    if reads.dim() != 2 or reads.shape[1] == 0:
        raise ValueError(f"reads must be (n_reads, W) with W > 0, not {tuple(reads.shape)}")
    text_len = text.shape[0]
    if text_len >= 2**31:
        raise ValueError(f"text of {text_len} codes: int32 positions need < 2**31")
    check_tensor(sa, "sa", torch.int32, (text_len + 1,))
    check_tensor(text, "text", torch.uint8, (text_len,))
    check_tensor(reads, "reads", torch.uint8, tuple(reads.shape))
    check_tensor(rlens, "rlens", torch.int32, (reads.shape[0],))
    for name, v in (("rows", rows), ("qbeg", qbeg), ("slen", slen), ("readid", readid)):
        check_tensor(v, name, torch.int32, (n,))
    width = reads.shape[1]
    if width > MAX_QUERY:
        raise ValueError(f"read width {width} > {MAX_QUERY} columns: a warp's tiles "
                         "would not fit its shared memory")
    out = torch.empty((len(FUSED_KEYS), n), dtype=torch.int32, device=dev)
    if n == 0:  # nothing to launch
        return out
    p = params
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = build_kernels()["sw_extend"].lib.sw_extend_fused(
            _ptr(sa), _ptr(text), text_len, _ptr(reads), width,
            *(_ptr(a) for a in (rlens, rows, qbeg, slen, readid)),
            n, flank, p.o_del, p.e_del, p.o_ins, p.e_ins, p.w, p.sc_match,
            p.sc_mismatch, p.sc_ambig, p.pen_clip, _ptr(out),
            ctypes.c_void_p(stream))
        LAUNCHES["sw_extend_fused"] += 1
    if err != 0:
        raise RuntimeError(f"sw_extend_fused: CUDA launch failed with error {err}")
    return out
