"""Chunked PairHMM band kernel: the local body of the DP x SP pipeline.

Counterpart of the JAX package's ``ops/pairhmm/band_kernel.py``
(``pairhmm_band_chunk``).  One call advances a chunk of C read rows
across a slab of hc haplotype columns for every lane, taking the
previous chunk's bottom row (top streams) and the left neighbour's edge
column (edge streams) as boundaries and returning its own bottom row and
right edge; ``parallel/sharded.py`` composes it into the skewed superstep
pipeline.  The cell arithmetic is the forward kernel's.

Streams (the JAX layout): top position k holds column k - 1 of the row
above the chunk, position 0 the corner (r0 - 1, c0 - 1); edge position k
holds row r0 - 1 + k of the column left of the slab.  Every argument may
carry a leading slot axis S (one mesh position each), so one launch runs
all the shards a superstep has on a device: coef_rows (S, 8, C, B), the
rest (S, ..., B).

A wrapper given CPU tensors runs the plain PyTorch version; given CUDA
tensors it launches the kernel of ``csrc/pairhmm_band.cu`` on the current
stream and adds one to ``LAUNCHES["pairhmm_band_chunk"]``.  The kernel
takes C in ``CHUNK_ROWS``; the plain version any C.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from acc_genomics_tpu_torch import build
from acc_genomics_tpu_torch.device import check_tensor, same_device
from acc_genomics_tpu_torch.ops.pairhmm.kernel import PAD_MASK
from acc_genomics_tpu_torch.utils.convert import BASE_N

CHUNK_ROWS = (8, 16, 32)  # a chunk is one segment of a warp

# kernel launches (CUDA tensors only); callers reset with clear()
LAUNCHES: collections.Counter = collections.Counter()

_SOURCES = ("ops/pairhmm/csrc/pairhmm_band.cu",)
_P = ctypes.c_void_p
_I = ctypes.c_int


def build_kernels() -> build.BuiltLibrary:
    """Build (at first use) and load the band kernel library."""
    built = build.load_library("pairhmm_band", _SOURCES)
    fn = built.lib.pairhmm_band_chunk
    if fn.argtypes is None:
        fn.argtypes = [_P] * 15 + [_I] * 4 + [_P]
        fn.restype = ctypes.c_int
    return built


def band_bound_terms(chunk_rows: int, hc: int, lanes: int):
    """(bytes, fp32 operations) of one chunk over ``lanes`` lanes: the JAX
    cost estimate (``band_kernel.py:275-276``) without its padding of the
    steps to a multiple of 8: 13 operations a cell of every step, and the
    chunk rows' 9 planes plus 7 streams a step, 4 bytes each."""
    steps = hc + chunk_rows - 1
    return (9 * chunk_rows + 7 * steps) * lanes * 4, 13 * steps * chunk_rows * lanes


def pairhmm_band_chunk_plain(coef_rows, rs_rows, hap_mask, top_m, top_x, top_s,
                             edge_m, edge_y, edge_s):
    """One band chunk, vectorised over slots and lanes, one loop over the
    hc + C - 1 diagonal steps.  Returns (bot_m, bot_x, bot_s) (..., hc, B)
    and (redge_m, redge_y, redge_s) (..., C, B).

    Row li at step t holds column j = t - li.  The rows' state of the last
    two steps moves down one row a step (row 0 takes the top streams, as
    the kernel's lanes take the row above through a shuffle); at t < C the
    edge streams stand in for column -1 of row t.  Cells outside the slab
    are computed and never read."""
    C, B = rs_rows.shape[-2:]
    hc = hap_mask.shape[-2]
    lead = tuple(rs_rows.shape[:-2])
    dt, dev = coef_rows.dtype, coef_rows.device
    p_mm, p_gapm, p_mx, p_xx, p_my, p_yy, em_m, em_x = coef_rows.unbind(-3)
    r = rs_rows.to(torch.int32)
    rmask = torch.where(
        r == BASE_N, 15, torch.bitwise_left_shift(torch.ones_like(r), r.clamp(0, 31))
    )
    n_steps = hc + C - 1

    def padded(a, n, value):
        extra = n - a.shape[-2]
        return torch.cat([a, a.new_full(lead + (extra, B), value)], -2) if extra > 0 else a

    pm, px, ps = (padded(t.to(dt), n_steps + 1, 0) for t in (top_m, top_x, top_s))
    hm = padded(hap_mask.to(torch.int32), n_steps, PAD_MASK)

    def down(head, v):  # row li takes row li - 1 of v; row 0 takes head
        return torch.cat([head, v[..., :-1, :]], -2)

    zero = torch.zeros(lead + (C, B), dtype=dt, device=dev)
    m1 = x1 = y1 = s1 = m2 = s2 = zero
    hd = torch.full(lead + (C, B), PAD_MASK, dtype=torch.int32, device=dev)
    bot = torch.zeros((3,) + lead + (hc, B), dtype=dt, device=dev)
    redge = torch.zeros((3,) + lead + (C, B), dtype=dt, device=dev)
    for t in range(n_steps):
        up_m = down(pm[..., t + 1:t + 2, :], m1)
        up_x = down(px[..., t + 1:t + 2, :], x1)
        dg_m = down(pm[..., t:t + 1, :], m2)
        dg_s = down(ps[..., t:t + 1, :], s2)
        hd = down(hm[..., t:t + 1, :], hd)
        left_m, left_y = m1, y1
        if t < C:  # row t is at column 0: the left edge is column -1
            dg_m[..., t, :] = edge_m[..., t, :]
            dg_s[..., t, :] = edge_s[..., t, :]
            left_m, left_y = m1.clone(), y1.clone()
            left_m[..., t, :] = edge_m[..., t + 1, :]
            left_y[..., t, :] = edge_y[..., t + 1, :]
        distm = torch.where(
            hd >= PAD_MASK, 0.0, torch.where((hd & rmask) != 0, em_m, em_x)
        )
        m = distm * (p_mm * dg_m + p_gapm * dg_s)
        x = p_mx * up_m + p_xx * up_x
        y = p_my * left_m + p_yy * left_y
        s = x + y
        j = t - (C - 1)  # the bottom row's column
        if 0 <= j < hc:
            bot[0][..., j, :] = m[..., C - 1, :]
            bot[1][..., j, :] = x[..., C - 1, :]
            bot[2][..., j, :] = s[..., C - 1, :]
        li = t - (hc - 1)  # the row at the slab's last column
        if 0 <= li < C:
            redge[0][..., li, :] = m[..., li, :]
            redge[1][..., li, :] = y[..., li, :]
            redge[2][..., li, :] = s[..., li, :]
        m2, s2 = m1, s1
        m1, x1, y1, s1 = m, x, y, s
    return bot[0], bot[1], bot[2], redge[0], redge[1], redge[2]


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def pairhmm_band_chunk(coef_rows, rs_rows, hap_mask, top_m, top_x, top_s,
                       edge_m, edge_y, edge_s):
    """One band chunk for every lane (and slot): see the module docstring
    and ``pairhmm_band_chunk_plain``.  float32 coefficients and streams,
    int32 codes and masks; on the card every tensor contiguous."""
    args = (coef_rows, rs_rows, hap_mask, top_m, top_x, top_s, edge_m, edge_y, edge_s)
    dev = same_device(*args)
    if dev.type == "cpu":
        return pairhmm_band_chunk_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if coef_rows.dim() not in (3, 4):
        raise ValueError("coef_rows must be (8, C, B) or (S, 8, C, B)")
    single = coef_rows.dim() == 3
    if single:
        args = tuple(a.unsqueeze(0) for a in args)
        coef_rows, rs_rows, hap_mask, top_m, top_x, top_s, edge_m, edge_y, edge_s = args
    slots, n8, C, bsz = coef_rows.shape
    hc = hap_mask.shape[1] if hap_mask.dim() == 3 else -1
    if n8 != 8 or C not in CHUNK_ROWS or hc < 1:
        raise ValueError(f"chunk rows {C} not in {CHUNK_ROWS}, or 8 planes, or hc >= 1")
    check_tensor(coef_rows, "coef_rows", torch.float32, (slots, 8, C, bsz))
    check_tensor(rs_rows, "rs_rows", torch.int32, (slots, C, bsz))
    check_tensor(hap_mask, "hap_mask", torch.int32, (slots, hc, bsz))
    for t, name in ((top_m, "top_m"), (top_x, "top_x"), (top_s, "top_s")):
        check_tensor(t, name, torch.float32, (slots, hc + 1, bsz))
    for t, name in ((edge_m, "edge_m"), (edge_y, "edge_y"), (edge_s, "edge_s")):
        check_tensor(t, name, torch.float32, (slots, C + 1, bsz))
    bot = torch.empty((3, slots, hc, bsz), dtype=torch.float32, device=dev)
    redge = torch.empty((3, slots, C, bsz), dtype=torch.float32, device=dev)
    outs = (bot[0], bot[1], bot[2], redge[0], redge[1], redge[2])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = build_kernels().lib.pairhmm_band_chunk(
            *(_ptr(a) for a in args), *(_ptr(o) for o in outs),
            slots, C, hc, bsz, ctypes.c_void_p(stream))
        LAUNCHES["pairhmm_band_chunk"] += 1
    if err != 0:
        raise RuntimeError(f"pairhmm_band_chunk: CUDA launch failed with error {err}")
    return tuple(o[0] for o in outs) if single else outs
