"""PairHMM band kernel: the local body of the DP x SP pipeline.

Counterpart of the JAX package's ``ops/pairhmm/band_kernel.py``
(``pairhmm_band_chunk``).  ``pairhmm_band_chunk_plain`` is the chunk in
the JAX layout: one call advances a chunk of C read rows across a slab of
hc haplotype columns for every lane, taking the previous chunk's bottom
row (top streams) and the left neighbour's edge column (edge streams) as
boundaries and returning its own bottom row and right edge.  Top position
k holds column k - 1 of the row above the chunk, position 0 the corner
(r0 - 1, c0 - 1); edge position k holds row r0 - 1 + k of the column left
of the slab.  Every argument may carry a leading slot axis.

``pairhmm_band_superstep`` is what ``parallel/sharded.py`` launches: one
superstep of the pipeline on one device, every active slot (a mesh
position: shard ``k`` of a data group) running its chunk ``t - k`` of one
pack.  The pipeline state stays on the device between supersteps:

  tops  (2, 3, S, bd, hc) float32   the row above the chunk (M, X, S),
                                    lane-major; superstep t reads buffer
                                    t % 2 and writes its bottom row into
                                    the other; chunk 0 takes row -1
                                    (0, 0, y0) and reads nothing
  edges (3, S', bd, rows + 1)       each slot's right-edge column (M, Y,
                                    S), position r + 1 holding row r;
                                    S' >= S (the extra columns mirror left
                                    neighbours on other devices)
  res   (S, bd) float32             the last chunk's bottom-row X summed
                                    over the slab, in column order
  slots (S, 3) int32                per slot: shard k, lane offset of its
                                    data group, left column (-1: none)
  hap   (lanes, cols) uint8         haplotype codes, lane-major

Front ends: ``"coef"`` takes a pack.py fp32 pack, planes = the eight
coefficient planes, int32 codes (rows, lanes) and y0 (lanes,);
``"arith"`` and ``"gather"`` take byte planes, planes = q, i, d, c and
codes (rows, lanes) uint8, rslen and haplen (lanes,) int32, and expand
each row in the kernel as ``pairhmm_forward_from_quals`` does, with
``tables`` = (ph2pr, m2m, initial_constant).

A wrapper given CPU tensors runs the plain PyTorch version; given CUDA
tensors it launches the kernel of ``csrc/pairhmm_band.cu`` on the current
stream and adds one to ``LAUNCHES["pairhmm_band_superstep"]``.  The
kernel takes C in ``CHUNK_ROWS``; the plain version any C.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from acc_genomics_tpu_torch import build
from acc_genomics_tpu_torch.device import check_tensor, same_device
from acc_genomics_tpu_torch.ops.pairhmm.kernel import PAD_MASK, expand_quals_plain, hap_to_mask
from acc_genomics_tpu_torch.utils.convert import BASE_N

CHUNK_ROWS = (8, 16, 32)  # a chunk is one segment of a warp
FRONT_ENDS = ("coef", "arith", "gather")

# kernel launches (CUDA tensors only); callers reset with clear()
LAUNCHES: collections.Counter = collections.Counter()

_SOURCES = ("ops/pairhmm/csrc/pairhmm_band.cu",)
_HEADERS = ("ops/pairhmm/csrc/pairhmm_common.cuh",)
_P = ctypes.c_void_p
_I = ctypes.c_int


def build_kernels() -> build.BuiltLibrary:
    """Build (at first use) and load the band kernel library."""
    built = build.load_library("pairhmm_band", _SOURCES, _HEADERS)
    fn = built.lib.pairhmm_band_superstep
    if fn.argtypes is None:
        fn.argtypes = ([_I, _I, _P] + [_P] * 6 + [ctypes.c_float] + [_P] * 5
                       + [_I] * 11 + [_P])
        fn.restype = ctypes.c_int
    return built


def band_bound_terms(chunk_rows: int, hc: int, lanes: int):
    """(bytes, fp32 operations) of one chunk over ``lanes`` lanes: the JAX
    cost estimate (``band_kernel.py:275-276``) without its padding of the
    steps to a multiple of 8: 13 operations a cell of every step, and the
    chunk rows' 9 planes plus 7 streams a step, 4 bytes each."""
    steps = hc + chunk_rows - 1
    return (9 * chunk_rows + 7 * steps) * lanes * 4, 13 * steps * chunk_rows * lanes


def band_quals_bytes(chunk_rows: int, hc: int, lanes: int) -> int:
    """Bytes one chunk past chunk 0 of the byte front end must move over
    ``lanes`` lanes, each read or written once: the chunk rows' five byte
    planes, rslen and haplen, the slab's codes, the top row in (M, X, S)
    and the bottom row out, the left edge in (C + 1 rows) and the right
    edge out (C rows), fp32."""
    per_lane = (5 * chunk_rows + 8 + hc + 24 * hc
                + 12 * (chunk_rows + 1) + 12 * chunk_rows)
    return per_lane * lanes


def pairhmm_band_chunk_plain(coef_rows, rs_rows, hap_mask, top_m, top_x, top_s,
                             edge_m, edge_y, edge_s):
    """One band chunk in the JAX layout, vectorised over slots and lanes,
    one loop over the hc + C - 1 diagonal steps.  Returns (bot_m, bot_x,
    bot_s) (..., hc, B) and (redge_m, redge_y, redge_s) (..., C, B).

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


def _chunk_rows(front, planes, tables, r0, C, lanes):
    """(coef_rows (8, C, bd), codes (C, bd), y0 (bd,)) of chunk rows
    r0 .. r0 + C - 1 of the lanes ``lanes``, as the kernel's front end
    reads or expands them."""
    if front == "coef":
        coef = torch.stack([p[r0:r0 + C, lanes] for p in planes[:8]]).float()
        return coef, planes[8][r0:r0 + C, lanes].to(torch.int32), planes[9][lanes].float()
    q, i, d, c, rs, rslen, haplen = planes
    ph2pr, m2m, ic = tables
    rows = slice(r0, r0 + C)
    out = expand_quals_plain(q[rows, lanes], i[rows, lanes], d[rows, lanes], c[rows, lanes],
                             rs[rows, lanes], rs[rows, lanes], rslen[lanes] - r0,
                             haplen[lanes], ph2pr, m2m, ic, front)
    return torch.stack(out[:8]), out[8], out[10]


def superstep_chunks(front, planes, tables, hap, slots, tops, edges, t: int, first: int,
                     n_active: int, C: int):
    """The active slots' chunks of one superstep in the JAX layout, stacked
    over the slots: ``pairhmm_band_chunk_plain``'s nine arguments, cut
    from the pack and the pipeline state (row -1 and the corner (0, 0,
    y0) at chunk 0; zeros left of shard 0)."""
    _, _, _, bd, hc = tops.shape
    par = t % 2
    dt, dev = tops.dtype, tops.device
    parts = collections.defaultdict(list)
    for s, (k, off, left) in enumerate(slots[first:first + n_active].tolist(), start=first):
        c = t - k
        r0, lanes = c * C, slice(off, off + bd)
        coef, codes, y0 = _chunk_rows(front, planes, tables, r0, C, lanes)
        parts["coef"].append(coef)
        parts["rs"].append(codes)
        parts["hap"].append(hap_to_mask(hap[lanes, k * hc:(k + 1) * hc].t()))
        if c == 0:  # row -1
            top = [torch.zeros((hc + 1, bd), dtype=dt, device=dev)] * 2
            top.append(y0[None, :].expand(hc + 1, bd).to(dt))
        else:
            corner = torch.zeros((1, bd), dtype=dt, device=dev)
            top = [torch.cat([corner, tops[par, q, s].t()]) for q in range(3)]
        if left >= 0:
            edge = [edges[q, left, :, r0:r0 + C + 1].t().clone() for q in range(3)]
        else:
            edge = [torch.zeros((C + 1, bd), dtype=dt, device=dev) for _ in range(3)]
        if c == 0:  # the corner (-1, -1)
            edge[0][0] = 0.0
            edge[2][0] = y0
        for q in range(3):
            parts[f"top{q}"].append(top[q])
            parts[f"edge{q}"].append(edge[q])
    keys = ("coef", "rs", "hap", "top0", "top1", "top2", "edge0", "edge1", "edge2")
    return tuple(torch.stack(parts[k]) for k in keys)


def pairhmm_band_superstep_plain(front, planes, tables, hap, slots, tops, edges, res,
                                 t: int, first: int, n_active: int, C: int, n_chunks: int):
    """One superstep (module docstring) by ``pairhmm_band_chunk_plain`` on
    ``superstep_chunks``, the outputs put back into the state as the
    kernel leaves them."""
    if n_active == 0 or tops.shape[3] == 0:
        return
    outs = pairhmm_band_chunk_plain(*superstep_chunks(front, planes, tables, hap, slots, tops,
                                                      edges, t, first, n_active, C))
    par = t % 2
    for i, k in enumerate(slots[first:first + n_active, 0].tolist()):
        s, c = first + i, t - k
        for q in range(3):
            tops[1 - par, q, s] = outs[q][i].t()
            edges[q, s, :, c * C + 1:(c + 1) * C + 1] = outs[3 + q][i].t()
        if c == n_chunks - 1:
            res[s] = outs[1][i].sum(0)


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def pairhmm_band_superstep(front, planes, tables, hap, slots, tops, edges, res,
                           t: int, first: int, n_active: int, C: int, n_chunks: int):
    """Advance slots ``first .. first + n_active - 1`` by one chunk each
    (module docstring), in place in ``tops``, ``edges`` and ``res``."""
    if front not in FRONT_ENDS:
        raise ValueError(f"front must be one of {FRONT_ENDS}, not {front!r}")
    quals = front != "coef"
    tabs = tuple(x for x in tables[:2] if isinstance(x, torch.Tensor)) if quals else ()
    dev = same_device(*planes, *tabs, hap, slots, tops, edges, res)
    if dev.type == "cpu":
        return pairhmm_band_superstep_plain(front, planes, tables, hap, slots, tops, edges,
                                            res, t, first, n_active, C, n_chunks)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if C not in CHUNK_ROWS:
        raise ValueError(f"chunk rows {C} not in {CHUNK_ROWS}")
    _, _, n_slots, bd, hc = tops.shape
    rows, lanes = planes[0].shape
    cols = hap.shape[1]
    n_cols = edges.shape[1]
    if rows % C or n_chunks * C != rows or not 0 <= first <= first + n_active <= n_slots:
        raise ValueError(f"rows {rows}, chunk rows {C}, {n_chunks} chunks, slots "
                         f"{first}+{n_active} of {n_slots}")
    check_tensor(tops, "tops", torch.float32, (2, 3, n_slots, bd, hc))
    check_tensor(edges, "edges", torch.float32, (3, n_cols, bd, rows + 1))
    check_tensor(res, "res", torch.float32, (n_slots, bd))
    check_tensor(slots, "slots", torch.int32, (n_slots, 3))
    check_tensor(hap, "hap", torch.uint8, (lanes, cols))
    if quals:
        q, i, d, c, rs, rslen, haplen = planes
        for x, name in zip((q, i, d, c, rs), ("q", "i", "d", "c", "rs")):
            check_tensor(x, name, torch.uint8, (rows, lanes))
        check_tensor(rslen, "rslen", torch.int32, (lanes,))
        check_tensor(haplen, "haplen", torch.int32, (lanes,))
        ph2pr, m2m, ic = tables
        gather = front == "gather"
        if gather:
            check_tensor(ph2pr, "ph2pr", torch.float32, (128,))
            if m2m.dtype != torch.float32 or m2m.numel() < 128 * 129 // 2 \
                    or not m2m.is_contiguous():
                raise ValueError("m2m must be contiguous float32 with >= 8256 entries")
        coef8 = (q, i, d, c) + (None,) * 4
        args = (rs, None, rslen, haplen, ph2pr if gather else None,
                m2m if gather else None)
        ic = float(ic)
    else:
        *coef, rs, y0 = planes
        for x, name in zip(coef, ("p_mm", "p_gapm", "p_mx", "p_xx", "p_my", "p_yy",
                                  "em_m", "em_x")):
            check_tensor(x, name, torch.float32, (rows, lanes))
        check_tensor(rs, "rs", torch.int32, (rows, lanes))
        check_tensor(y0, "y0", torch.float32, (lanes,))
        coef8, args, ic = tuple(coef), (rs, y0, None, None, None, None), 0.0
    ptrs = ctypes.cast((ctypes.c_void_p * 8)(
        *(x.data_ptr() if x is not None else None for x in coef8)), ctypes.c_void_p)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = build_kernels().lib.pairhmm_band_superstep(
            FRONT_ENDS.index(front), C, ptrs, *(_ptr(x) for x in args),
            ctypes.c_float(ic), _ptr(hap), _ptr(slots), _ptr(tops), _ptr(edges),
            _ptr(res), n_slots, n_cols, first, n_active, t, rows, cols, hc, lanes, bd,
            n_chunks, ctypes.c_void_p(stream))
        LAUNCHES["pairhmm_band_superstep"] += 1
    if err != 0:
        raise RuntimeError(f"pairhmm_band_superstep: CUDA launch failed with error {err}")
