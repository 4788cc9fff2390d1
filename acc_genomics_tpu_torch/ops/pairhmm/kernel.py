"""Batched PairHMM forward: CUDA kernel wrappers and their plain twins.

Counterparts of the JAX package's ``ops/pairhmm/kernel.py``
(``pairhmm_forward_pallas``, ``pairhmm_forward_pallas_from_quals``) and
``ops/pairhmm/jax_impl.py`` (``pairhmm_forward``).  The layout is the
JAX one, so both packages take the same packs: per-row arrays are
time-major ``(R, B)`` with absorbing rows past each read, ``hap_ext`` is
``(R + H, B)`` with HAP_PAD past each haplotype, and one pair sits in
each column ``b``.

A wrapper given CPU tensors runs its plain PyTorch version; given CUDA
tensors it launches the kernel of ``csrc/pairhmm_forward.cu`` on the
current stream and adds one to ``LAUNCHES[<wrapper name>]``.  Tensors on
mixed devices raise.  The kernel runs a segment of 8, 16 or 32 lanes a
pair (the smallest that holds R) and takes no per-block diagonal counts:
every pair runs its own trip count, chunk by chunk of 32 rows.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional

import numpy as np
import torch

from acc_genomics_tpu_torch import build
from acc_genomics_tpu_torch.device import check_tensor, same_device
from acc_genomics_tpu_torch.utils.convert import BASE_N, HAP_PAD

PAD_MASK = 16  # one-hot channel of padded hap columns (never matches)
MAX_ROWS = 1024  # up to 32 chunks of 32 rows a pair, as many as MAX_COLS
MAX_COLS = 1024  # a pair's hap columns in shared memory

# kernel launches per wrapper (CUDA tensors only); callers reset with clear()
LAUNCHES: collections.Counter = collections.Counter()

_SOURCES = ("ops/pairhmm/csrc/pairhmm_forward.cu",)
_HEADERS = ("ops/pairhmm/csrc/pairhmm_common.cuh",)
_P = ctypes.c_void_p
_I = ctypes.c_int


def build_kernels() -> build.BuiltLibrary:
    """Build (at first use) and load the kernel library, with the C
    entry points' argument types set."""
    built = build.load_library("pairhmm_forward", _SOURCES, _HEADERS)
    lib = built.lib
    if lib.pairhmm_forward_coef.argtypes is None:
        lib.pairhmm_forward_coef.argtypes = [_P] * 11 + [_I, _I, _I, _P, _P]
        lib.pairhmm_forward_coef.restype = ctypes.c_int
        lib.pairhmm_forward_quals.argtypes = (
            [_P] * 10 + [ctypes.c_float, _I, _I, _I, _I, _P, _P]
        )
        lib.pairhmm_forward_quals.restype = ctypes.c_int
    return built


# -- plain PyTorch versions -------------------------------------------------


def hap_to_mask(hap_codes: torch.Tensor) -> torch.Tensor:
    """Hap base codes -> one-hot match masks: 1 << code, 15 for N (matches
    everything), PAD_MASK for padding (matches nothing)."""
    h = hap_codes.to(torch.int32)
    one_hot = torch.bitwise_left_shift(torch.ones_like(h), h.clamp(0, BASE_N))
    return torch.where(
        h >= HAP_PAD, PAD_MASK, torch.where(h == BASE_N, 15, one_hot)
    ).to(torch.int32)


def pairhmm_forward_plain(
    p_mm, p_gapm, p_mx, p_xx, p_my, p_yy, em_match, em_mis, rs, hap_ext, y0,
):
    """Anti-diagonal recurrence over ``(R, B)`` tensors, one diagonal per
    step.  Cell (i, j) is updated at diagonal d = i + j:

        M[d](i) = distm(i, j) * (pMM M[d-2](i-1) + pGapM (X+Y)[d-2](i-1))
        X[d](i) = pMX M[d-1](i-1) + pXX X[d-1](i-1)
        Y[d](i) = pMY M[d-1](i)   + pYY Y[d-1](i)

    The state of row i - 1 reaches row i through one roll of the stacked
    (M, X, X+Y) planes per diagonal; the roll's row 0 takes the row -1
    boundary (0, 0, y0).  Cells not yet reached (j < 0) stay 0, which is
    the column -1 boundary.  The absorbing last row collects the result:
    the running sum of its X.
    """
    rows, bsz = p_mm.shape
    dt, dev = p_mm.dtype, p_mm.device
    n_diag = hap_ext.shape[0] - 1  # rows + cols - 1 reach every cell
    hmask = hap_to_mask(hap_ext)
    r = rs.to(torch.int32)
    rmask = torch.where(
        r == BASE_N, 15,
        torch.bitwise_left_shift(torch.ones_like(r), r.clamp(0, BASE_N)),
    )
    zero = torch.zeros((rows, bsz), dtype=dt, device=dev)
    boundary = torch.stack(
        [torch.zeros_like(y0, dtype=dt), torch.zeros_like(y0, dtype=dt),
         y0.to(dt)]
    )  # row -1 as seen through the roll: M, X, X+Y
    # shifted (M, X, X+Y) of diagonals d-1 and d-2: row i holds row i-1
    sh1 = torch.stack([zero, zero, zero])
    sh1[:, 0] = boundary
    sh2 = sh1.clone()
    m1, y1 = zero, zero  # unshifted M, Y of diagonal d-1
    hd = torch.full((rows, bsz), PAD_MASK, dtype=torch.int32, device=dev)
    acc = torch.zeros(bsz, dtype=dt, device=dev)
    for d in range(n_diag):
        # hap mask register: hd[i] = hapmask[d - i]
        hd = torch.roll(hd, 1, 0)
        hd[0] = hmask[d]
        match = (hd & rmask) != 0
        distm = torch.where(
            hd >= PAD_MASK, zero, torch.where(match, em_match, em_mis)
        )
        m_new = distm * (p_mm * sh2[0] + p_gapm * sh2[2])
        x_new = p_mx * sh1[0] + p_xx * sh1[1]
        y_new = p_my * m1 + p_yy * y1
        acc = acc + x_new[rows - 1]
        sh = torch.roll(torch.stack([m_new, x_new, x_new + y_new]), 1, 1)
        sh[:, 0] = boundary
        sh2, sh1 = sh1, sh
        m1, y1 = m_new, y_new
    return acc


def expand_quals_plain(
    q, i, d, c, rs, hap_ext, rslen, haplen, ph2pr, m2m, initial_constant,
    expand: str = "arith",
):
    """uint8 quals -> the 11 arguments of ``pairhmm_forward``: the
    coefficient planes (``ctx.transitions``/``emissions`` on tensors),
    absorbing rows past ``rslen`` (pMX = pXX = 1, the rest 0), int32
    codes and y0 = initial_constant / haplen (0 for inert lanes)."""
    rows, bsz = q.shape
    f32 = torch.float32
    qi, ii, di, ci = (t.to(torch.int32) & 127 for t in (q, i, d, c))
    if expand == "arith":
        cst = torch.tensor(np.float32(-np.log2(10.0) / 10.0), device=q.device)
        pe_q, pe_i, pe_d, pe_c = (
            torch.exp2(t.to(f32) * cst) for t in (qi, ii, di, ci)
        )
        p_mm = 1.0 - torch.clamp(pe_i + pe_d, max=1.0)
    elif expand == "gather":
        pe_q, pe_i, pe_d, pe_c = (ph2pr[t.long()] for t in (qi, ii, di, ci))
        lo = torch.minimum(ii, di).long()
        hi = torch.maximum(ii, di).long()
        p_mm = m2m[((hi * (hi + 1)) >> 1) + lo]
    else:
        raise ValueError(f"expand must be 'arith' or 'gather', not {expand!r}")
    valid = (
        torch.arange(rows, device=q.device)[:, None]
        < rslen.to(torch.int32)[None, :]
    )
    coef = [
        torch.where(valid, p_mm, 0.0),
        torch.where(valid, 1.0 - pe_c, 0.0),
        torch.where(valid, pe_i, 1.0),
        torch.where(valid, pe_c, 1.0),
        torch.where(valid, pe_d, 0.0),
        torch.where(valid, pe_c, 0.0),
        torch.where(valid, 1.0 - pe_q, 0.0),
        torch.where(valid, pe_q / 3.0, 0.0),
    ]
    ic = torch.as_tensor(initial_constant, dtype=f32, device=q.device)
    y0 = torch.where(haplen > 0, ic / haplen.to(f32), 0.0)
    rs_codes = torch.where(valid, rs.to(torch.int32), 0)
    return (*coef, rs_codes, hap_ext.to(torch.int32), y0)


def pairhmm_forward_from_quals_plain(
    q, i, d, c, rs, hap_ext, rslen, haplen, ph2pr, m2m, initial_constant,
    expand: str = "arith",
):
    return pairhmm_forward_plain(
        *expand_quals_plain(
            q, i, d, c, rs, hap_ext, rslen, haplen, ph2pr, m2m,
            initial_constant, expand,
        )
    )


# -- kernel wrappers --------------------------------------------------------


def _geometry(rs: torch.Tensor, hap_ext: torch.Tensor):
    if rs.dim() != 2 or hap_ext.dim() != 2:
        raise ValueError("rs must be (R, B) and hap_ext (R + H, B)")
    rows, bsz = rs.shape
    cols = hap_ext.shape[0] - rows
    if rows > MAX_ROWS:
        raise ValueError(f"rows {rows} > {MAX_ROWS}")
    if cols < 0 or cols > MAX_COLS:
        raise ValueError(f"hap columns {cols} outside [0, {MAX_COLS}]")
    return rows, cols, bsz


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def pairhmm_forward(
    p_mm, p_gapm, p_mx, p_xx, p_my, p_yy, em_match, em_mis, rs, hap_ext, y0,
) -> torch.Tensor:
    """Forward probabilities ``(B,)`` from fp32 coefficient planes.

    p_* / em_*: (R, B) float32; rs: (R, B) int32 codes; hap_ext:
    (R + H, B) int32 codes, HAP_PAD past each haplotype; y0: (B,) float32
    = initial_constant / haplen (0 for inert lanes, whose result is 0).
    All R rows run, so rows past a read must be absorbing (pack.py)."""
    args = (p_mm, p_gapm, p_mx, p_xx, p_my, p_yy, em_match, em_mis, rs,
            hap_ext, y0)
    dev = same_device(*args)
    if dev.type == "cpu":
        return pairhmm_forward_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    rows, cols, bsz = _geometry(rs, hap_ext)
    names = ("p_mm", "p_gapm", "p_mx", "p_xx", "p_my", "p_yy", "em_match",
             "em_mis")
    for t, name in zip(args[:8], names):
        check_tensor(t, name, torch.float32, (rows, bsz))
    check_tensor(rs, "rs", torch.int32, (rows, bsz))
    check_tensor(hap_ext, "hap_ext", torch.int32, (rows + cols, bsz))
    check_tensor(y0, "y0", torch.float32, (bsz,))
    out = torch.empty(bsz, dtype=torch.float32, device=dev)
    lib = build_kernels().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pairhmm_forward_coef(
            *[_ptr(t) for t in args], rows, cols, bsz, _ptr(out),
            ctypes.c_void_p(stream),
        )
        LAUNCHES["pairhmm_forward"] += 1
    _raise_on(err, "pairhmm_forward")
    return out


def pairhmm_forward_from_quals(
    q, i, d, c, rs, hap_ext, rslen, haplen, ph2pr, m2m, initial_constant,
    expand: str = "arith",
) -> torch.Tensor:
    """Forward probabilities ``(B,)`` from uint8 byte planes, expanding
    the quality bytes to coefficients inside the kernel.

    q/i/d/c/rs: (R, B) uint8; hap_ext: (R + H, B) uint8; rslen/haplen:
    (B,) int32.  expand="arith" computes ph2pr and matchToMatch
    (exp2 and the telescoped Jacobian identity); expand="gather" reads the
    128-entry ``ph2pr`` and triangular ``m2m`` float32 tables, which
    arith mode does not need (they may be None)."""
    if expand not in ("arith", "gather"):
        raise ValueError(f"expand must be 'arith' or 'gather', not {expand!r}")
    planes = (q, i, d, c, rs, hap_ext, rslen, haplen)
    tables = tuple(t for t in (ph2pr, m2m) if t is not None)
    dev = same_device(*planes, *tables)
    if dev.type == "cpu":
        return pairhmm_forward_from_quals_plain(
            *planes, ph2pr, m2m, initial_constant, expand
        )
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    rows, cols, bsz = _geometry(rs, hap_ext)
    for t, name in zip(planes[:5], ("q", "i", "d", "c", "rs")):
        check_tensor(t, name, torch.uint8, (rows, bsz))
    check_tensor(hap_ext, "hap_ext", torch.uint8, (rows + cols, bsz))
    check_tensor(rslen, "rslen", torch.int32, (bsz,))
    check_tensor(haplen, "haplen", torch.int32, (bsz,))
    gather = expand == "gather"
    if gather:
        if ph2pr is None or m2m is None:
            raise ValueError("expand='gather' needs the ph2pr and m2m tables")
        check_tensor(ph2pr, "ph2pr", torch.float32, (128,))
        if m2m.dtype != torch.float32 or m2m.numel() < 128 * 129 // 2:
            raise ValueError("m2m must be float32 with >= 8256 entries")
        if not m2m.is_contiguous():
            raise ValueError("m2m must be contiguous")
    out = torch.empty(bsz, dtype=torch.float32, device=dev)
    lib = build_kernels().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pairhmm_forward_quals(
            *[_ptr(t) for t in planes],
            _ptr(ph2pr if gather else None), _ptr(m2m if gather else None),
            ctypes.c_float(float(initial_constant)), int(gather),
            rows, cols, bsz, _ptr(out), ctypes.c_void_p(stream),
        )
        LAUNCHES["pairhmm_forward_from_quals"] += 1
    _raise_on(err, "pairhmm_forward_from_quals")
    return out
