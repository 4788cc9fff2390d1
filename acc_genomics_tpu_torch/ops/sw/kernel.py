"""HTC Smith-Waterman fill and backtrack walk: CUDA kernel wrappers and
their plain PyTorch twins.

Counterparts of the JAX package's ``ops/sw/kernel.py`` (``sw_fill_pallas``,
the fill) and ``ops/sw/walker.py`` (``sw_walk_device``, the walk).  The
layout is the port's own, shared by the kernels and the plain versions
(csrc/sw_fill.cu says why): one pair per row of the batch,

  ref (B, R), alt (B, C)   uint8 codes; reflen, altlen (B,) int32
  btrack (B, D, R)         int16 step codes, D = R + C - 1, interior cell
                           (i, j) at [b, i + j, i]: 0 diag, -k right
                           (insertion of k), +k down (deletion of k)
  lastrow (B, C)           int32 sw at interior (reflen - 1, j)
  altcol (B, R)            int32 sw at interior (i, altlen - 1)
  packed (SHIP_ELEMS + 2, B) int16, the walk's output, in the layout of
                           the JAX walker: len | state << 12 per element in
                           walk order, then the count, then the offset.

Only cells inside each pair's reflen x altlen region are defined; the
kernel writes nothing outside it.  A wrapper given CPU tensors runs its
plain version; given CUDA tensors it launches the kernel on the current
stream and adds one to ``LAUNCHES[<wrapper name>]``.  Tensors on mixed
devices raise.
"""

from __future__ import annotations

import collections
import concurrent.futures
import ctypes
from typing import Dict

import torch

from acc_genomics_tpu_torch import build
from acc_genomics_tpu_torch.device import check_tensor, same_device
from acc_genomics_tpu_torch.ops.sw.reference import (
    DEFAULT_SW_PARAMS,
    LOW_INIT,
    MATRIX_MIN_CUTOFF,
    OVERHANG_IGNORE,
    OVERHANG_INDEL,
    OVERHANG_LEADING_INDEL,
    OVERHANG_SOFTCLIP,
    STATE_CLIP,
    STATE_DELETION,
    STATE_INSERTION,
    STATE_MATCH,
    SWParams,
)

SHIP_ELEMS = 48  # element slots of the packed walk buffer (walker.py)
MAX_ROWS = 2048  # the fill kernel's bucket bounds (csrc/sw_fill.cu)
MAX_COLS = 2048

# kernel launches per wrapper (CUDA tensors only); callers reset with clear()
LAUNCHES: collections.Counter = collections.Counter()

_SOURCES = {
    "sw_fill": ("ops/sw/csrc/sw_fill.cu",),
    "sw_walk": ("ops/sw/csrc/sw_walk.cu",),
}
_P = ctypes.c_void_p
_I = ctypes.c_int


_kernels: Dict[str, build.BuiltLibrary] = {}


def build_kernels() -> Dict[str, build.BuiltLibrary]:
    """Build (at first use, both at once) and load the fill and walk
    libraries, with the C entry points' argument types set."""
    if not _kernels:
        with concurrent.futures.ThreadPoolExecutor(len(_SOURCES)) as pool:
            libs = dict(zip(_SOURCES, pool.map(
                lambda kv: build.load_library(*kv), _SOURCES.items())))
        fill, walk = libs["sw_fill"].lib, libs["sw_walk"].lib
        fill.sw_fill.argtypes = [_P] * 4 + [_I] * 8 + [_P] * 4
        fill.sw_fill.restype = ctypes.c_int
        walk.sw_walk.argtypes = [_P] * 5 + [_I] * 4 + [_P] * 2
        walk.sw_walk.restype = ctypes.c_int
        _kernels.update(libs)
    return _kernels


def btrack_region(reflen, altlen, rows: int, cols: int) -> torch.Tensor:
    """(B, R + C - 1, R) bool: the btrack entries inside each pair's
    reflen x altlen region, the only ones the fill defines."""
    dev = reflen.device
    d = torch.arange(rows + cols - 1, device=dev)[None, :, None]
    i = torch.arange(rows, device=dev)[None, None, :]
    rl = reflen.to(torch.int64)[:, None, None]
    al = altlen.to(torch.int64)[:, None, None]
    return (i < rl) & (d - i >= 0) & (d - i < al)


def _indel_init(strategy: int) -> bool:
    if strategy not in (OVERHANG_SOFTCLIP, OVERHANG_INDEL,
                        OVERHANG_LEADING_INDEL, OVERHANG_IGNORE):
        raise ValueError(f"unknown overhang strategy {strategy}")
    return strategy in (OVERHANG_INDEL, OVERHANG_LEADING_INDEL)


# -- plain PyTorch versions -------------------------------------------------


def sw_fill_plain(ref, alt, reflen, altlen, strategy: int,
                  params: SWParams = DEFAULT_SW_PARAMS):
    """Anti-diagonal fill over ``(B, R)`` tensors, one diagonal per step,
    with the kernel's state: per row the horizontal tracker, the previous
    cell and the diagonal input (``diag``: the up value the row read one
    diagonal earlier); the previous diagonal's sw and vertical tracker
    reach row i from row i - 1 through a shift by one row, whose row 0
    takes the matrix's row-0 boundary.  Rows update only inside each
    pair's region, as the kernel's threads do.  Returns (btrack, lastrow,
    altcol), zero outside the regions."""
    indel = _indel_init(strategy)
    w_match, w_mis, w_open, w_ext = (int(x) for x in params)
    bsz, rows = ref.shape
    cols = alt.shape[1]
    dev = ref.device
    i32 = torch.int32
    rl = reflen.to(i32).clamp(0, rows)[:, None]
    al = altlen.to(i32).clamp(0, cols)[:, None]
    ref_c, alt_c = ref.to(i32), alt.to(i32)
    ii = torch.arange(rows, dtype=i32, device=dev)[None, :]

    def ramp(jm):  # matrix sw[0][jm] and sw[jm][0]
        if not indel:
            return torch.zeros_like(jm)
        return torch.where(jm > 0, w_open + (jm - 1) * w_ext, 0)

    col_diag = ramp(ii)  # sw[i][0]: the diagonal input of cell (i, 0)
    col_left = ramp(ii + 1)  # sw[i + 1][0]: the left input of cell (i, 0)
    full = lambda v: torch.full((bsz, rows), v, dtype=i32, device=dev)
    sw1, diag, gsv1, gsh = full(0), full(0), full(0), full(0)
    bgv1, bgh = full(LOW_INIT), full(LOW_INIT)
    low1 = torch.full((bsz, 1), LOW_INIT, dtype=i32, device=dev)
    zero1 = torch.zeros((bsz, 1), dtype=i32, device=dev)
    btrack = torch.zeros((bsz, rows + cols - 1, rows), dtype=torch.int16, device=dev)
    # one spare column takes the writes of pairs without a cell there
    lastrow = torch.zeros((bsz, cols + 1), dtype=i32, device=dev)
    altcol = torch.zeros((bsz, rows + 1), dtype=i32, device=dev)
    n_diag = int((rl + al).max()) - 1 if bsz else 0
    for d in range(n_diag):
        j = d - ii
        valid = (ii < rl) & (j >= 0) & (j < al)
        alt_j = alt_c.index_select(1, j[0].clamp(0, cols - 1))
        row0 = zero1 + (w_open + d * w_ext if indel else 0)  # sw[0][d + 1]
        up = torch.cat([row0, sw1[:, :-1]], 1)
        bgv_in = torch.cat([low1, bgv1[:, :-1]], 1)
        gsv_in = torch.cat([zero1, gsv1[:, :-1]], 1)
        first = j == 0
        left = torch.where(first, col_left, sw1)
        step_diag = torch.where(first, col_diag, diag) + (
            (alt_j == ref_c).to(i32) * (w_match - w_mis) + w_mis)
        gap_v, ext_v = up + w_open, bgv_in + w_ext
        take_v = gap_v > ext_v  # strict: a tie keeps extending
        bgv = torch.where(take_v, gap_v, ext_v)
        gsv = torch.where(take_v, 1, gsv_in + 1)
        gap_h, ext_h = left + w_open, bgh + w_ext
        take_h = gap_h > ext_h
        bgh_n = torch.where(take_h, gap_h, ext_h)
        gsh_n = torch.where(take_h, 1, gsh + 1)
        use_diag = (step_diag >= bgv) & (step_diag >= bgh_n)
        use_right = ~use_diag & (bgh_n >= bgv)
        val = torch.where(use_diag, step_diag, torch.where(use_right, bgh_n, bgv))
        sw = val.clamp(min=MATRIX_MIN_CUTOFF)
        code = torch.where(use_diag, 0, torch.where(use_right, -gsh_n, gsv))
        btrack[:, d, :] = torch.where(valid, code, 0).to(torch.int16)
        sw1 = torch.where(valid, sw, sw1)
        diag = torch.where(valid, up, diag)
        bgv1 = torch.where(valid, bgv, bgv1)
        gsv1 = torch.where(valid, gsv, gsv1)
        bgh = torch.where(valid, bgh_n, bgh)
        gsh = torch.where(valid, gsh_n, gsh)
        jl = d - (rl - 1)  # the last row's cell on this diagonal
        at = torch.where((jl >= 0) & (jl < al), jl, cols)
        lastrow.scatter_(1, at, sw.gather(1, (rl - 1).clamp(0, rows - 1)))
        ia = d - (al - 1)  # the last column's cell
        at = torch.where((ia >= 0) & (ia < rl), ia, rows)
        altcol.scatter_(1, at, sw.gather(1, ia.clamp(0, rows - 1)))
    return btrack, lastrow[:, :cols].contiguous(), altcol[:, :rows].contiguous()


def sw_walk_plain(btrack, lastrow, altcol, reflen, altlen, strategy: int):
    """The walk vectorised over pairs, in the form of the JAX walker: the
    start cell from masked reductions (the last argmax of the last alt
    column; the argmin of 2|reflen - j| + (j > reflen) over the maximal
    cells of the last row, with its strict/tie gate), then one btrack
    cell per pair per step until every pair has left the matrix."""
    _indel_init(strategy)
    bsz, n_diag, rows = btrack.shape
    cols = lastrow.shape[1]
    dev = btrack.device
    i64 = torch.int64
    rl = reflen.to(i64).clamp(0, rows)
    al = altlen.to(i64).clamp(0, cols)
    low, big = LOW_INIT, 1 << 30

    ii = torch.arange(1, rows + 1, dtype=i64, device=dev)[None, :]
    vac = ii <= rl[:, None]
    va = torch.where(vac, altcol.to(i64), low)
    m1 = va.max(1).values
    p1_a = torch.where(vac & (va == m1[:, None]), ii, 0).max(1).values
    zero = torch.zeros(bsz, dtype=i64, device=dev)
    if strategy == OVERHANG_INDEL:
        p1, p2, seg = rl, al, zero
    elif strategy == OVERHANG_LEADING_INDEL:
        p1, p2, seg = p1_a, al, zero
    else:
        jj = torch.arange(1, cols + 1, dtype=i64, device=dev)[None, :]
        vlr = jj <= al[:, None]
        vr = torch.where(vlr, lastrow.to(i64), low)
        m_lr = vr.max(1).values
        elig = vlr & (vr == m_lr[:, None])
        key = 2 * (rl[:, None] - jj).abs() + (jj > rl[:, None]).to(i64)
        kmin = torch.where(elig, key, big).min(1).values
        jstar = torch.where(elig & (key == kmin[:, None]), jj, big).min(1).values
        upd = (m_lr > m1) | ((m_lr == m1) & ((kmin >> 1) < (p1_a - al).abs()))
        p1 = torch.where(upd, rl, p1_a)
        p2 = torch.where(upd, jstar, al)
        seg = torch.where(upd, al - jstar, 0)

    slots = torch.arange(SHIP_ELEMS, dtype=i64, device=dev)[:, None]
    elems = torch.zeros((SHIP_ELEMS, bsz), dtype=i64, device=dev)

    def put(elems, slot, length, state, mask):
        hit = (slots == slot.clamp(max=SHIP_ELEMS - 1)[None, :]) & mask[None, :]
        return torch.where(hit, (length | (state << 12))[None, :], elems)

    en = zero
    if strategy == OVERHANG_SOFTCLIP:
        flush = seg > 0
        elems = put(elems, en, seg, torch.full_like(seg, STATE_CLIP), flush)
        en = flush.to(i64)
        seg = zero
    state = torch.full((bsz,), STATE_MATCH, dtype=i64, device=dev)
    active = (p1 > 0) & (p2 > 0) & (rl > 0) & (al > 0)
    flat = btrack.reshape(-1)
    base = torch.arange(bsz, dtype=i64, device=dev) * (n_diag * rows)
    while bool(active.any()):
        d = (p1 + p2 - 2).clamp(0, n_diag - 1)
        code = flat[base + d * rows + (p1 - 1).clamp(0, rows - 1)].to(i64)
        new_state = torch.where(code > 0, STATE_DELETION,
                                torch.where(code < 0, STATE_INSERTION, STATE_MATCH))
        step = torch.where(code != 0, code.abs(), 1)
        # a match steps both by 1, a deletion ref rows, an insertion alt cols
        p1n = torch.where(new_state != STATE_INSERTION, p1 - step, p1)
        p2n = torch.where(new_state != STATE_DELETION, p2 - step, p2)
        changed = active & (new_state != state)
        elems = put(elems, en, seg, state, changed)
        en = torch.where(changed, en + 1, en)
        seg = torch.where(active, torch.where(changed, step, seg + step), seg)
        state = torch.where(changed, new_state, state)
        p1 = torch.where(active, p1n, p1)
        p2 = torch.where(active, p2n, p2)
        active = active & (p1 > 0) & (p2 > 0)

    every = torch.ones(bsz, dtype=torch.bool, device=dev)
    if strategy == OVERHANG_SOFTCLIP:
        elems = put(elems, en, seg, state, every)
        en = en + 1
        clip = p2 > 0
        elems = put(elems, en, p2, torch.full_like(p2, STATE_CLIP), clip)
        en = torch.where(clip, en + 1, en)
        offset = p1
    elif strategy == OVERHANG_IGNORE:
        elems = put(elems, en, seg + p2, state, every)
        en = en + 1
        offset = p1 - p2
    else:
        elems = put(elems, en, seg, state, every)
        en = en + 1
        dmask = p1 > 0
        imask = ~dmask & (p2 > 0)
        elems = put(elems, en, p1, torch.full_like(p1, STATE_DELETION), dmask)
        elems = put(elems, en, p2, torch.full_like(p2, STATE_INSERTION), imask)
        en = torch.where(dmask | imask, en + 1, en)
        offset = zero
    return torch.cat([elems, en[None, :], offset[None, :]]).to(torch.int16)


# -- kernel wrappers --------------------------------------------------------


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _geometry(rows: int, cols: int):
    if not 0 < rows <= MAX_ROWS or not 0 < cols <= MAX_COLS:
        raise ValueError(
            f"bucket {rows} x {cols} outside (0, {MAX_ROWS}] x (0, {MAX_COLS}]")


def _launch(name: str, fn, *args):
    dev = args[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*[_ptr(a) if isinstance(a, torch.Tensor) else a for a in args],
                 ctypes.c_void_p(stream))
        LAUNCHES[name] += 1
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def sw_fill(ref, alt, reflen, altlen, strategy: int,
            params: SWParams = DEFAULT_SW_PARAMS):
    """(btrack, lastrow, altcol) of a padded batch (layouts above).

    ref: (B, R) uint8; alt: (B, C) uint8; reflen/altlen: (B,) int32, at
    most R and C (the kernel clamps longer ones; callers bucket first)."""
    dev = same_device(ref, alt, reflen, altlen)
    if dev.type == "cpu":
        return sw_fill_plain(ref, alt, reflen, altlen, strategy, params)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    indel = _indel_init(strategy)
    if ref.dim() != 2 or alt.dim() != 2:
        raise ValueError("ref must be (B, R) and alt (B, C)")
    bsz, rows = ref.shape
    cols = alt.shape[1]
    _geometry(rows, cols)
    check_tensor(ref, "ref", torch.uint8, (bsz, rows))
    check_tensor(alt, "alt", torch.uint8, (bsz, cols))
    check_tensor(reflen, "reflen", torch.int32, (bsz,))
    check_tensor(altlen, "altlen", torch.int32, (bsz,))
    btrack = torch.empty((bsz, rows + cols - 1, rows), dtype=torch.int16, device=dev)
    lastrow = torch.empty((bsz, cols), dtype=torch.int32, device=dev)
    altcol = torch.empty((bsz, rows), dtype=torch.int32, device=dev)
    _launch("sw_fill", build_kernels()["sw_fill"].lib.sw_fill,
            ref, alt, reflen, altlen, rows, cols, bsz, int(indel),
            *(int(x) for x in params), btrack, lastrow, altcol)
    return btrack, lastrow, altcol


def sw_walk(btrack, lastrow, altcol, reflen, altlen, strategy: int):
    """The packed (SHIP_ELEMS + 2, B) int16 element buffer of the fill's
    outputs (layouts above)."""
    dev = same_device(btrack, lastrow, altcol, reflen, altlen)
    if dev.type == "cpu":
        return sw_walk_plain(btrack, lastrow, altcol, reflen, altlen, strategy)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _indel_init(strategy)
    if btrack.dim() != 3:
        raise ValueError("btrack must be (B, R + C - 1, R)")
    bsz, n_diag, rows = btrack.shape
    cols = n_diag - rows + 1
    _geometry(rows, cols)
    check_tensor(lastrow, "lastrow", torch.int32, (bsz, cols))
    check_tensor(altcol, "altcol", torch.int32, (bsz, rows))
    check_tensor(btrack, "btrack", torch.int16, (bsz, n_diag, rows))
    check_tensor(reflen, "reflen", torch.int32, (bsz,))
    check_tensor(altlen, "altlen", torch.int32, (bsz,))
    out = torch.empty((SHIP_ELEMS + 2, bsz), dtype=torch.int16, device=dev)
    _launch("sw_walk", build_kernels()["sw_walk"].lib.sw_walk,
            btrack, lastrow, altcol, reflen, altlen, rows, cols, bsz,
            int(strategy), out)
    return out
