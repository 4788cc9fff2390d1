"""PairHMM over a ``(data, seq)`` mesh of torch devices.

Counterparts of the JAX package's ``parallel/sharded.py``:

* ``pairhmm_forward_dp``: the lanes of a pack cut into ``data``
  contiguous groups, each run by the forward kernel on its group's
  device; no communication (pairs are independent).
* ``pairhmm_forward_dpsp``: haplotype columns also cut over ``seq``, run
  as the skewed superstep pipeline of the band kernel
  (``_sp_pallas_local`` in the JAX package): at superstep t, shard k of
  every data group runs chunk c = t - k of its (C rows x hc columns)
  slab, then hands its right edge to shard k + 1.  A packet between two
  devices is one copy; between two shards of one device it is a buffer
  handoff.  The result is the sum over shards of the last chunk's
  bottom-row X, summed in shard order.

All active shards of one device run in one launch a superstep (a grid of
slots x lanes), so a device with every shard makes n_chunks + n_seq - 1
launches, not n_chunks x n_seq.  The JAX package's affine-scan form
(its XLA fallback) has no counterpart: on the CPU the band kernel's
plain version runs the same pipeline.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from acc_genomics_tpu_torch.ops.pairhmm.band_kernel import pairhmm_band_chunk
from acc_genomics_tpu_torch.ops.pairhmm.kernel import hap_to_mask, pairhmm_forward
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


class _DeviceShards:
    """The shards (slots) of one device and their pipeline state, slots in
    (shard, data group) order so that the slots active at a superstep (a
    range of shards) are a contiguous range of slot positions."""

    def __init__(self, dev, slots: List[Tuple[int, int]], C: int, hc: int, bd: int):
        self.dev = dev
        self.slots = slots  # (d, k) per position
        n = len(slots)
        f32 = dict(dtype=torch.float32, device=dev)
        # previous chunk's bottom row, position 0 the (shadowed) corner
        self.top = torch.zeros((3, n, hc + 1, bd), **f32)
        self.hap = torch.empty((n, hc, bd), dtype=torch.int32, device=dev)
        # left packet: rows r0 - 1 (prev) and r0 .. r0 + C - 1 (recv)
        self.prev = torch.zeros((3, n, 1, bd), **f32)
        self.recv = torch.zeros((3, n, C, bd), **f32)
        self.res = torch.zeros((n, bd), **f32)
        self.coef: Dict[int, torch.Tensor] = {}  # d -> (n_chunks, 8, C, bd)
        self.rs: Dict[int, torch.Tensor] = {}  # d -> (n_chunks, C, bd)

    def active(self, t: int, n_chunks: int) -> Tuple[int, int]:
        pos = [i for i, (_, k) in enumerate(self.slots) if 0 <= t - k < n_chunks]
        return (pos[0], pos[-1] + 1) if pos else (0, 0)


def pairhmm_forward_dpsp(mesh: Mesh, *packed, C: int = 8) -> torch.Tensor:
    """DP x SP forward of the 11 ``pack.arrays()`` tensors over the mesh
    (the skewed band-kernel pipeline, module docstring).  Rows must divide
    by C, haplotype columns by the seq axis, lanes by the data axis.
    Returns (B,) float32 on the mesh's first device."""
    (p_mm, p_gapm, p_mx, p_xx, p_my, p_yy, em_m, em_x, rs, hap_ext, y0) = packed
    rows, bsz = p_mm.shape
    cols = hap_ext.shape[0] - rows
    n_data, n_seq = mesh.shape["data"], mesh.shape["seq"]
    if rows % C:
        raise ValueError(f"rows {rows} must divide by chunk size {C}")
    if cols < n_seq or cols % n_seq:
        raise ValueError(f"hap columns {cols} must divide over {n_seq} seq shards")
    if bsz % n_data:
        raise ValueError(f"{bsz} lanes do not divide over {n_data} data shards")
    out_dev = mesh.first_device
    if bsz == 0:
        return torch.zeros(0, dtype=torch.float32, device=out_dev)
    hc, n_chunks, bd = cols // n_seq, rows // C, bsz // n_data
    coef = torch.stack([p_mm, p_gapm, p_mx, p_xx, p_my, p_yy, em_m, em_x]).float()
    hmask = hap_to_mask(hap_ext[:cols])
    y0 = y0.float()

    by_dev: Dict[torch.device, List[Tuple[int, int]]] = {}
    for k in range(n_seq):
        for d in range(n_data):
            by_dev.setdefault(mesh.devices[d, k], []).append((d, k))
    shards = {dev: _DeviceShards(dev, slots, C, hc, bd) for dev, slots in by_dev.items()}
    where = {}  # (d, k) -> (device shards, position)
    groups = lane_groups(bsz, n_data)
    for ds in shards.values():
        for i, (d, k) in enumerate(ds.slots):
            where[d, k] = (ds, i)
            lo, hi = groups[d]
            if d not in ds.coef:
                ds.coef[d] = (coef[:, :, lo:hi].reshape(8, n_chunks, C, bd)
                              .transpose(0, 1).contiguous().to(ds.dev))
                ds.rs[d] = rs[:, lo:hi].to(torch.int32).reshape(n_chunks, C, bd).to(ds.dev)
            ds.hap[i] = hmask[k * hc:(k + 1) * hc, lo:hi].to(ds.dev)
            yd = y0[lo:hi].to(ds.dev)
            ds.top[2, i, 1:] = yd  # row -1: M = X = 0, S = Y = y0
            ds.prev[2, i, 0] = yd  # the edge's row -1, and shard 0's corner
            if k > 0:
                ds.recv[2, i, -1] = yd

    for t in range(n_chunks + n_seq - 1):
        sent = {}  # (d, k) of an active shard -> its right edge (3 views)
        for ds in shards.values():
            a, b = ds.active(t, n_chunks)
            if a == b:
                continue
            steps = [(d, t - k) for d, k in ds.slots[a:b]]
            edge = torch.cat([ds.prev[:, a:b], ds.recv[:, a:b]], 2)
            outs = pairhmm_band_chunk(
                torch.stack([ds.coef[d][c] for d, c in steps]),
                torch.stack([ds.rs[d][c] for d, c in steps]),
                ds.hap[a:b], ds.top[0, a:b], ds.top[1, a:b], ds.top[2, a:b],
                edge[0], edge[1], edge[2],
            )
            for q in range(3):
                ds.top[q, a:b, 1:] = outs[q]
            for i, (d, c) in enumerate(steps):
                if c == n_chunks - 1:
                    ds.res[a + i] = outs[1][i].sum(0)
                sent[ds.slots[a + i]] = tuple(o[i] for o in outs[3:])
        for (d, k), packet in sent.items():
            if k + 1 < n_seq:
                ds, i = where[d, k + 1]
                ds.prev[:, i] = ds.recv[:, i, -1:]
                for q in range(3):
                    ds.recv[q, i].copy_(packet[q])
        if t == 0:
            # shard 0 sees column -1 as zeros; its S corner is y0 for chunk 0 only
            for d in range(n_data):
                ds, i = where[d, 0]
                ds.prev[:, i] = 0.0

    parts = []
    for d in range(n_data):
        total = None
        for k in range(n_seq):
            ds, i = where[d, k]
            part = ds.res[i].to(out_dev)
            total = part if total is None else total + part
        parts.append(total)
    return torch.cat(parts)
