"""ctypes bindings for the native host runtime (``csrc/accnative.cpp``).

The port's copy of the JAX package's ``native`` module, cut to the entry
points the port calls.  The library is compiled by
``acc_genomics_tpu_torch.build.build_native`` into the package's
``_build/`` directory (under an inter-process lock) and loaded from there
at first use.  Every wrapper returns None when the library cannot be
built or loaded, as the original does; ``build.ensure_native`` raises
with the compiler's output instead.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

_LIB_PATH: Optional[str] = None  # the file loaded, once loaded
_lib: Optional[ctypes.CDLL] = None
_tried = False

_i8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def load(path: str) -> ctypes.CDLL:
    """Load the library at ``path`` and set the argument types of the
    entry points below."""
    global _lib, _LIB_PATH
    lib = ctypes.CDLL(path)
    lib.sais_build.argtypes = [_i8p, ctypes.c_int64, _i64p]
    lib.pairhmm_pack.argtypes = [
        _i8p, _i8p, _i8p, _i8p, _i8p, _i64p, _i32p,
        _i8p, _i64p, _i32p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        _f32p, _f32p, ctypes.c_float,
        _f32p, _f32p, _f32p, _f32p, _f32p, _f32p, _f32p, _f32p,
        _i32p, _i32p, _f32p,
    ]
    fwd_common = [
        _i8p, _i8p, _i8p, _i8p, _i8p, _i64p, _i32p,
        _i8p, _i64p, _i32p, ctypes.c_int64,
    ]
    lib.pairhmm_forward_batch_f32.argtypes = fwd_common + [
        _f32p, _f32p, ctypes.c_float, _f32p,
    ]
    lib.pairhmm_forward_batch_f64.argtypes = fwd_common + [
        _f64p, _f64p, ctypes.c_double, _f64p,
    ]
    lib.sw_align_batch_native.argtypes = [
        _i8p, _i64p, _i32p, _i8p, _i64p, _i32p,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, _i32p, _i32p, _i32p,
    ]
    lib.pairhmm_pack_quals.argtypes = [
        _i8p, _i8p, _i8p, _i8p, _i8p, _i64p, _i32p,
        _i8p, _i64p, _i32p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_uint8,
        _i8p, _i8p, _i8p, _i8p, _i8p, _i8p,
    ]
    lib.pairhmm_expand_quals.argtypes = [
        _i8p, _i8p, _i8p, _i8p, _i8p, _i8p, _i32p, _i32p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        _f32p, _f32p, ctypes.c_float, _f32p, _i32p,
    ]
    lib.smem_collect_batch_native.argtypes = [
        _i32p, ctypes.c_int64, ctypes.c_int64, _i64p,
        _i8p, _i64p, _i32p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, _i64p, _i32p,
    ]
    lib.sw_extend_batch_native.argtypes = [
        _i8p, _i64p, _i32p, _i8p, _i64p, _i32p, _i32p,
        ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        _i32p,
    ]
    _lib, _LIB_PATH = lib, path
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built at the first call; None when it cannot be
    built (no second attempt in this process)."""
    global _tried
    if _lib is None and not _tried:
        _tried = True
        from acc_genomics_tpu_torch.build import ensure_native

        try:
            ensure_native()
        except (RuntimeError, OSError):
            return None
    return _lib


def available() -> bool:
    return get_lib() is not None


def suffix_array(text: np.ndarray) -> Optional[np.ndarray]:
    """SA-IS suffix array of a uint8 text; None if the lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    text = np.ascontiguousarray(text, dtype=np.uint8)
    sa = np.empty(len(text), dtype=np.int64)
    lib.sais_build(text, len(text), sa)
    return sa


def cat_u8(seqs):
    """Concatenate byte sequences into (flat uint8, int64 offs, int32 lens)
    — the wire-format triple every flat path consumes."""
    n = len(seqs)
    lens = np.array([len(s) for s in seqs], np.int32)
    offs = np.zeros(n, np.int64)
    if n > 1:
        np.cumsum(lens[:-1], out=offs[1:])
    flat = (
        np.ascontiguousarray(np.concatenate([np.asarray(s, np.uint8) for s in seqs]))
        if n
        else np.zeros(0, np.uint8)
    )
    return flat, offs, lens


def sw_align_host(refs, alts, strategy: int, params=None, max_elems: int = 1536):
    """Native host SW alignment (fill + backtrack).  Returns [(cigar,
    offset)] or None if the lib is unavailable.  Pairs whose element count
    overflows max_elems come back as None entries (callers rerun those on
    the oracle)."""
    lib = get_lib()
    if lib is None:
        return None
    if params is None:
        from acc_genomics_tpu_torch.ops.sw.reference import DEFAULT_SW_PARAMS

        params = DEFAULT_SW_PARAMS
    b = len(refs)
    rflat, roffs, rlens = cat_u8(refs)
    aflat, aoffs, alens = cat_u8(alts)
    out_elems = np.zeros((b, max_elems, 2), np.int32)
    out_n = np.zeros(b, np.int32)
    out_off = np.zeros(b, np.int32)
    lib.sw_align_batch_native(
        rflat, roffs, rlens, aflat, aoffs, alens,
        b, strategy,
        int(params.w_match), int(params.w_mismatch),
        int(params.w_open), int(params.w_extend),
        max_elems, out_elems.reshape(-1), out_n, out_off,
    )
    res = []
    for k in range(b):
        n = int(out_n[k])
        if n > max_elems:
            res.append(None)
            continue
        cigar = [(int(out_elems[k, j, 0]), int(out_elems[k, j, 1])) for j in range(n)]
        res.append((cigar, int(out_off[k])))
    return res


def pairhmm_pack_quals_flat(
    rs, q, i, d, c, offs, lens, hap, hoffs, hlens, rows, cols, hap_pad,
):
    """Byte-plane pack from already-flat (concatenated) inputs; offs/lens
    select each pair.  The six planes are packed into ONE contiguous
    (5*rows + rows + cols, bp) uint8 buffer.  Returns (q, i, d, c, rs,
    hap_ext) views into that buffer or None if the lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    bp = len(lens)
    ndiag = rows + cols
    big = np.empty((5 * rows + ndiag, bp), np.uint8)
    oq = big[0:rows]
    oi = big[rows : 2 * rows]
    od = big[2 * rows : 3 * rows]
    oc = big[3 * rows : 4 * rows]
    ors = big[4 * rows : 5 * rows]
    hap_ext = big[5 * rows :]
    lib.pairhmm_pack_quals(
        np.ascontiguousarray(rs, np.uint8), np.ascontiguousarray(q, np.uint8),
        np.ascontiguousarray(i, np.uint8), np.ascontiguousarray(d, np.uint8),
        np.ascontiguousarray(c, np.uint8),
        np.ascontiguousarray(offs, np.int64),
        np.ascontiguousarray(lens, np.int32),
        np.ascontiguousarray(hap, np.uint8),
        np.ascontiguousarray(hoffs, np.int64),
        np.ascontiguousarray(hlens, np.int32),
        bp, rows, cols, int(hap_pad),
        oq.reshape(-1), oi.reshape(-1), od.reshape(-1), oc.reshape(-1),
        ors.reshape(-1), hap_ext.reshape(-1),
    )
    return oq, oi, od, oc, ors, hap_ext


def pairhmm_pack_flat_f32(
    rs, q, i, d, c, offs, lens, hap, hoffs, hlens, rows, cols,
    ph2pr, m2m, initial_constant, out_f=None, out_i=None,
):
    """Flat-input fp32 coefficient pack into two contiguous buffers:

    big_f   (8*rows + 1, bp) float32: the p_mm p_gapm p_mx p_xx p_my p_yy
            em_match em_mis planes, then y0 in row 8*rows
    big_i   (rows + rows + cols, bp) int32: rs codes, then hap_ext

    The byte-plane pack runs first, then the table expansion.  ``out_f``
    and ``out_i`` (C-contiguous, of those shapes) receive the pack in
    place, e.g. views of a pinned staging buffer.  Returns (big_f, big_i)
    or None if the lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    packed = pairhmm_pack_quals_flat(
        rs, q, i, d, c, offs, lens, hap, hoffs, hlens, rows, cols, 5
    )
    oq, oi, od, oc, ors, hap_ext_u8 = packed
    bp = len(lens)
    ndiag = rows + cols
    big_f = np.empty((8 * rows + 1, bp), np.float32) if out_f is None else out_f
    big_i = np.empty((rows + ndiag, bp), np.int32) if out_i is None else out_i
    if (big_f.shape != (8 * rows + 1, bp) or big_i.shape != (rows + ndiag, bp)
            or not (big_f.flags.c_contiguous and big_i.flags.c_contiguous)):
        raise ValueError(f"out buffers {big_f.shape}, {big_i.shape} for rows {rows}, "
                         f"cols {cols}, {bp} lanes (C-contiguous)")
    lib.pairhmm_expand_quals(
        oq.reshape(-1), oi.reshape(-1), od.reshape(-1), oc.reshape(-1),
        ors.reshape(-1), hap_ext_u8.reshape(-1),
        np.ascontiguousarray(lens, np.int32),
        np.ascontiguousarray(hlens, np.int32),
        rows, cols, bp,
        np.ascontiguousarray(ph2pr, np.float32),
        np.ascontiguousarray(m2m, np.float32),
        float(initial_constant),
        big_f.reshape(-1), big_i.reshape(-1),
    )
    return big_f, big_i


def _flat_pairs(testcases, rows, cols, pad_to):
    """Concatenated per-pair arrays of ``testcases`` padded to ``pad_to``
    lanes: (rs, q, i, d, c, offs, lens, hap, hoffs, hlens, bp)."""
    b = len(testcases)
    bp = max(pad_to, b)
    lens = np.zeros(bp, np.int32)
    hlens = np.zeros(bp, np.int32)
    lens[:b] = [len(t["rs"]) for t in testcases]
    hlens[:b] = [len(t["hap"]) for t in testcases]
    if b and lens.max() >= rows:
        raise ValueError(f"read length {lens.max()} needs bucket > {rows} rows")
    if b and hlens.max() > cols:
        raise ValueError(f"hap length {hlens.max()} exceeds bucket cols {cols}")
    offs = np.zeros(bp, np.int64)
    hoffs = np.zeros(bp, np.int64)
    if bp > 1:
        np.cumsum(lens[:-1], out=offs[1:])
        np.cumsum(hlens[:-1], out=hoffs[1:])
    cat = lambda key: np.ascontiguousarray(
        np.concatenate([np.asarray(t[key], np.uint8) for t in testcases])
        if b else np.zeros(0, np.uint8)
    )
    return (cat("rs"), cat("q"), cat("i"), cat("d"), cat("c"), offs, lens,
            cat("hap"), hoffs, hlens, bp)


def pairhmm_pack_quals_native(testcases, rows, cols, hap_pad, pad_to: int = 0):
    """Native byte-plane pack (memcpy + blocked transpose): returns
    (q, i, d, c, rs, hap_ext, rslen, haplen) time-major uint8 arrays or
    None if the lib is unavailable."""
    if get_lib() is None:
        return None
    rs, q, i, d, c, offs, lens, hap, hoffs, hlens, _ = _flat_pairs(
        testcases, rows, cols, pad_to)
    packed = pairhmm_pack_quals_flat(
        rs, q, i, d, c, offs, lens, hap, hoffs, hlens, rows, cols, hap_pad
    )
    oq, oi, od, oc, ors, hap_ext = packed
    return oq, oi, od, oc, ors, hap_ext, lens, hlens


def pairhmm_pack_native(
    testcases, rows, cols, ph2pr, m2m, initial_constant, pad_to: int = 0
):
    """Native fill of the time-major PairHMM batch (float32).  Returns the
    same arrays as ops.pairhmm.pack or None if unavailable.  pad_to > b
    adds inert batch-padding lanes (absorbing rows, y0 = 0)."""
    lib = get_lib()
    if lib is None:
        return None
    rs, q, i, d, c, offs, lens, hap, hoffs, hlens, bp = _flat_pairs(
        testcases, rows, cols, pad_to)
    shape = (rows, bp)
    arrs = [np.empty(shape, np.float32) for _ in range(8)]
    rs_out = np.empty(shape, np.int32)
    hap_ext = np.empty((rows + cols, bp), np.int32)
    y0 = np.empty(bp, np.float32)
    lib.pairhmm_pack(
        rs, q, i, d, c, offs, lens, hap, hoffs, hlens,
        bp, rows, cols,
        np.ascontiguousarray(ph2pr, np.float32),
        np.ascontiguousarray(m2m, np.float32),
        float(initial_constant),
        *[a.reshape(-1) for a in arrs],
        rs_out.reshape(-1), hap_ext.reshape(-1), y0,
    )
    return arrs, rs_out, hap_ext, y0, lens, hlens


def smem_collect_host_arrays(fm, reads, params=None, max_out: int = 4096):
    """Native host 3-pass SMEM collection as arrays: (out_mem (B, max_out,
    5) int64 [x0 x1 s start end], each read's first ``out_n[k]`` rows in
    the order of ops.smem.reference.mem_collect_intv_oracle; out_n (B,)
    int32, past ``max_out`` for a read whose intervals the buffer cannot
    hold), or None if the lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if params is None:
        from acc_genomics_tpu_torch.ops.smem.reference import DEFAULT_SMEM_PARAMS

        params = DEFAULT_SMEM_PARAMS
    # fused (nblk, 8) probe table, cached ON the index object — an
    # id()-keyed dict would serve a stale table when CPython recycles a
    # freed FMIndex's address for the next genome
    tbl = getattr(fm, "_native_probe_tbl", None)
    if tbl is None:
        nblk = fm.bwt_packed.shape[0]
        tbl = np.empty((nblk, 8), np.int32)
        tbl[:, :4] = fm.occ_ckpt[:nblk].astype(np.int32)
        tbl[:, 4:] = fm.bwt_packed.view(np.int32)
        tbl = np.ascontiguousarray(tbl)
        fm._native_probe_tbl = tbl
    b = len(reads)
    flat, offs, lens = cat_u8(reads)
    # zero pages until written: a read touches only its own rows
    out_mem = np.zeros((b, max_out, 5), np.int64)
    out_n = np.zeros(b, np.int32)
    lib.smem_collect_batch_native(
        tbl, tbl.shape[0], int(fm.primary),
        np.ascontiguousarray(fm.L2, np.int64),
        flat, offs, lens, b,
        int(params.min_seed_len), int(params.split_len),
        int(params.split_width), int(params.max_mem_intv),
        max_out, out_mem.reshape(-1), out_n,
    )
    return out_mem, out_n


def smem_collect_host(fm, reads, params=None, max_out: int = 4096):
    """Native host 3-pass SMEM collection, bit-identical to
    ops.smem.reference.mem_collect_intv_oracle; returns [[interval
    dicts]] (None for a read past ``max_out`` intervals) or None if the
    lib is unavailable."""
    got = smem_collect_host_arrays(fm, reads, params, max_out)
    if got is None:
        return None
    out_mem, out_n = got
    res = []
    for k in range(len(reads)):
        n = int(out_n[k])
        if n > max_out:  # pathological read; caller falls back to oracle
            res.append(None)
            continue
        res.append(
            [
                dict(x0=x0, x1=x1, s=s, start=start, end=end)
                for x0, x1, s, start, end in out_mem[k, :n].tolist()
            ]
        )
    return res


def sw_extend_host(queries, targets, h0s, params=None):
    """Native host banded extension (ksw_extend2 loop).  Returns a dict of
    (B,) int64 arrays (score qle tle gtle gscore max_off w) or None."""
    lib = get_lib()
    if lib is None:
        return None
    if params is None:
        from acc_genomics_tpu_torch.ops.extend.reference import DEFAULT_EXTEND_PARAMS

        params = DEFAULT_EXTEND_PARAMS
    b = len(queries)
    qflat, qoffs, qlens = cat_u8(queries)
    tflat, toffs, tlens = cat_u8(targets)
    out = np.zeros((b, 7), np.int32)
    lib.sw_extend_batch_native(
        qflat, qoffs, qlens, tflat, toffs, tlens,
        np.ascontiguousarray(np.asarray(h0s, np.int32)), b,
        int(params.o_del), int(params.e_del),
        int(params.o_ins), int(params.e_ins),
        int(params.w), int(params.sc_match), int(params.sc_mismatch),
        int(params.sc_ambig),
        out.reshape(-1),
    )
    keys = ("score", "qle", "tle", "gtle", "gscore", "max_off", "w")
    return {k: out[:, j].astype(np.int64) for j, k in enumerate(keys)}


def pairhmm_forward(testcases, dtype=np.float32) -> Optional[np.ndarray]:
    """Native batch PairHMM forward (raw pre-log probabilities).  None if
    the lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    from acc_genomics_tpu_torch.ops.pairhmm.context import PairHMMContext

    dt = np.dtype(dtype)
    ctx = PairHMMContext(dt)
    b = len(testcases)
    rlens = np.array([len(t["rs"]) for t in testcases], np.int32)
    hlens = np.array([len(t["hap"]) for t in testcases], np.int32)
    roffs = np.zeros(b, np.int64)
    hoffs = np.zeros(b, np.int64)
    if b > 1:
        np.cumsum(rlens[:-1], out=roffs[1:])
        np.cumsum(hlens[:-1], out=hoffs[1:])
    cat = lambda key: np.ascontiguousarray(
        np.concatenate([np.asarray(t[key], np.uint8) for t in testcases])
        if b
        else np.zeros(0, np.uint8)
    )
    rs, q, i, d, c, hap = (cat(k) for k in ("rs", "q", "i", "d", "c", "hap"))
    out = np.empty(b, dt)
    fn = (
        lib.pairhmm_forward_batch_f32
        if dt == np.float32
        else lib.pairhmm_forward_batch_f64
    )
    fn(
        rs, q, i, d, c, roffs, rlens, hap, hoffs, hlens, b,
        np.ascontiguousarray(ctx.ph2pr, dt),
        np.ascontiguousarray(ctx.match_to_match, dt),
        dt.type(ctx.initial_constant), out,
    )
    return out
