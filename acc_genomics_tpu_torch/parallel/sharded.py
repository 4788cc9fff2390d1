"""PairHMM over a ``(data, seq)`` mesh of torch devices.

Counterparts of the JAX package's ``parallel/sharded.py``:

* ``pairhmm_forward_dp``: the lanes of a pack cut into ``data``
  contiguous groups, each run by the forward kernel on its group's
  device; no communication (pairs are independent).
* ``pairhmm_forward_dpsp`` (an fp32 pack.py pack) and
  ``pairhmm_forward_dpsp_from_quals`` (uint8 byte planes, the
  coefficients expanded in the kernel): haplotype columns also cut over
  ``seq``, run as the skewed superstep pipeline of the band kernel
  (``_sp_pallas_local`` in the JAX package): at superstep t, shard k of
  every data group runs chunk c = t - k of its (C rows x hc columns)
  slab.  The result is the sum over shards of the last chunk's
  bottom-row X, summed in shard order.

The pipeline state (the rows above the chunks and the right-edge columns)
stays on each device between supersteps, and every active shard of a
device runs in one launch a superstep, so a device with every shard makes
n_chunks + n_seq - 1 launches and nothing else.  A shard reads its left
neighbour's edge column in place when both share a device; a neighbour on
another device sends the chunk's rows of its column with one copy.  The
JAX package's affine-scan form (its XLA fallback) has no counterpart: on
the CPU the band kernel's plain version runs the same pipeline.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from acc_genomics_tpu_torch.ops.pairhmm.band_kernel import pairhmm_band_superstep
from acc_genomics_tpu_torch.ops.pairhmm.kernel import pairhmm_forward
from acc_genomics_tpu_torch.parallel.mesh import Mesh, lane_groups


def pairhmm_forward_dp(mesh: Mesh, *packed) -> torch.Tensor:
    """Data-parallel forward of the 11 ``pack.arrays()`` tensors (lanes
    last); the lane count must divide by the data axis.  Returns (B,)
    float32 on the mesh's first device."""
    rows, bsz = packed[0].shape
    n_data = mesh.shape["data"]
    if bsz % n_data:
        raise ValueError(f"{bsz} lanes do not divide over {n_data} data shards")
    parts = []
    for d, (lo, hi) in enumerate(lane_groups(bsz, n_data)):
        if hi == lo:
            continue
        dev = mesh.devices[d, 0]
        group = [a[..., lo:hi].contiguous().to(dev) for a in packed]
        parts.append(pairhmm_forward(*group).to(mesh.first_device))
    if not parts:
        return torch.zeros(0, dtype=torch.float32, device=mesh.first_device)
    return torch.cat(parts)


class DevicePlan:
    """One device's slots and pipeline state (``band_kernel``'s layout).
    Slots are in (shard, data group) order, so the slots active at a
    superstep (a range of shards) are a contiguous range of positions.
    ``table`` holds each slot's (shard, lane offset, left column);
    ``mirrors`` names the (data group, shard) whose edge column each
    column past the slots' mirrors."""

    def __init__(self, dev, slots: List[Tuple[int, int]], table, mirrors: List[Tuple[int, int]],
                 front, planes, tables, hap, rows: int, hc: int, bd: int):
        self.dev, self.slots, self.mirrors = dev, slots, mirrors
        n = len(slots)
        f32 = dict(dtype=torch.float32, device=dev)
        self.front = front
        self.planes = tuple(p.to(dev) for p in planes)
        self.tables = tuple(x.to(dev) if isinstance(x, torch.Tensor) else x
                            for x in tables)
        self.hap = hap.to(dev)
        self.table = torch.tensor(table, dtype=torch.int32).reshape(n, 3).to(dev)
        self.tops = torch.empty((2, 3, n, bd, hc), **f32)
        self.edges = torch.zeros((3, n + len(mirrors), bd, rows + 1), **f32)
        self.res = torch.empty((n, bd), **f32)

    def step(self, t: int, n_chunks: int, C: int):
        """Superstep ``t``: one launch over the slots whose chunk t - k is
        in range."""
        pos = [i for i, (_, k) in enumerate(self.slots) if 0 <= t - k < n_chunks]
        if pos:
            pairhmm_band_superstep(self.front, self.planes, self.tables, self.hap, self.table,
                                   self.tops, self.edges, self.res, t, pos[0],
                                   pos[-1] + 1 - pos[0], C, n_chunks)


def band_geometry(rows: int, cols: int, bsz: int, C: int, n_data: int,
                  n_seq: int) -> Tuple[int, int, int]:
    """(hc, n_chunks, bd) of a pack on a (n_data, n_seq) grid; raises
    unless rows divide by C, columns by the seq axis, lanes by data."""
    if rows % C:
        raise ValueError(f"rows {rows} must divide by chunk size {C}")
    if cols < n_seq or cols % n_seq:
        raise ValueError(f"hap columns {cols} must divide over {n_seq} seq shards")
    if bsz % n_data:
        raise ValueError(f"{bsz} lanes do not divide over {n_data} data shards")
    return cols // n_seq, rows // C, bsz // n_data


def _band_pipeline(mesh: Mesh, front: str, planes, tables, hap_ext, C: int) -> torch.Tensor:
    """The DP x SP pipeline (module docstring) of one pack: ``planes`` are
    the front end's (``band_kernel``), ``hap_ext`` the pack's (rows + cols,
    lanes) haplotype codes.  Returns (lanes,) float32 on the mesh's first
    device."""
    rows, bsz = planes[0].shape
    cols = hap_ext.shape[0] - rows
    n_data, n_seq = mesh.shape["data"], mesh.shape["seq"]
    hc, n_chunks, bd = band_geometry(rows, cols, bsz, C, n_data, n_seq)
    out_dev = mesh.first_device
    if bsz == 0:
        return torch.zeros(0, dtype=torch.float32, device=out_dev)
    hap = hap_ext[:cols].to(torch.uint8).t().contiguous()  # lane-major codes

    by_dev: Dict[torch.device, List[Tuple[int, int]]] = {}
    for k in range(n_seq):
        for d in range(n_data):
            by_dev.setdefault(mesh.devices[d, k], []).append((d, k))
    where = {dk: (dev, i) for dev, slots in by_dev.items() for i, dk in enumerate(slots)}
    plans = {}
    for dev, slots in by_dev.items():
        table, mirrors = [], []  # left neighbours on other devices are mirrored
        for d, k in slots:
            left = -1
            if k > 0:
                ldev, lpos = where[d, k - 1]
                if ldev == dev:
                    left = lpos
                else:
                    left = len(slots) + len(mirrors)
                    mirrors.append((d, k - 1))
            table.append((k, d * bd, left))
        plans[dev] = DevicePlan(dev, slots, table, mirrors, front, planes, tables, hap,
                                rows, hc, bd)

    for t in range(n_chunks + n_seq - 1):
        for p in plans.values():
            p.step(t, n_chunks, C)
        for p in plans.values():  # the chunk's rows of a column on another device
            for m, (d, k) in enumerate(p.mirrors):
                c = t - k
                if 0 <= c < n_chunks:
                    sdev, spos = where[d, k]
                    rows_c = slice(c * C + 1, (c + 1) * C + 1)
                    p.edges[:, len(p.slots) + m, :, rows_c].copy_(
                        plans[sdev].edges[:, spos, :, rows_c])

    parts = []
    for d in range(n_data):
        total = None
        for k in range(n_seq):
            dev, i = where[d, k]
            part = plans[dev].res[i].to(out_dev)
            total = part if total is None else total + part
        parts.append(total)
    return torch.cat(parts)


def coef_planes(packed) -> tuple:
    """The fp32 front end's planes of the 11 ``pack.arrays()`` tensors."""
    (p_mm, p_gapm, p_mx, p_xx, p_my, p_yy, em_m, em_x, rs, hap_ext, y0) = packed
    planes = tuple(x.float().contiguous() for x in (p_mm, p_gapm, p_mx, p_xx, p_my, p_yy,
                                                    em_m, em_x))
    return planes + (rs.to(torch.int32).contiguous(), y0.float().contiguous())


def quals_planes(q, i, d, c, rs, rslen, haplen, expand: str) -> tuple:
    """The byte front end's planes; ``expand`` is "arith" or "gather"."""
    if expand not in ("arith", "gather"):
        raise ValueError(f"expand must be 'arith' or 'gather', not {expand!r}")
    planes = tuple(x.contiguous() for x in (q, i, d, c, rs))
    return planes + (rslen.to(torch.int32).contiguous(), haplen.to(torch.int32).contiguous())


def pairhmm_forward_dpsp(mesh: Mesh, *packed, C: int = 8) -> torch.Tensor:
    """DP x SP forward of the 11 ``pack.arrays()`` tensors over the mesh
    (the band pipeline with the fp32 front end).  Rows must divide by C,
    haplotype columns by the seq axis, lanes by the data axis.  Returns
    (B,) float32 on the mesh's first device."""
    return _band_pipeline(mesh, "coef", coef_planes(packed), (), packed[9], C)


def pairhmm_forward_dpsp_from_quals(mesh: Mesh, q, i, d, c, rs, hap_ext, rslen, haplen,
                                    ph2pr, m2m, initial_constant, expand: str = "arith",
                                    C: int = 8) -> torch.Tensor:
    """DP x SP forward of a byte-plane pack (``pack_pairhmm_quals``'s
    planes, as ``pairhmm_forward_from_quals`` takes them): the band kernel
    expands each chunk row's coefficients (``expand`` "arith" or "gather")
    and y0 = initial_constant / haplen itself.  Same geometry rules and
    result as ``pairhmm_forward_dpsp``."""
    planes = quals_planes(q, i, d, c, rs, rslen, haplen, expand)
    return _band_pipeline(mesh, expand, planes, (ph2pr, m2m, initial_constant), hap_ext, C)
