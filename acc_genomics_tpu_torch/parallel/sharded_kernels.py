"""Data-parallel forms of the SMEM, extension and SW kernels.

Counterparts of the JAX package's ``parallel/sharded_kernels.py``.
Reads, seeds and alignment pairs are independent, so each form cuts the
batch's lanes into ``data`` contiguous groups (``mesh.lane_groups``),
runs the port's kernel on each group on that group's device (the first
device of its mesh row) and gathers the results, in order, on the mesh's
first device.  A batch has at least one lane.  Nothing crosses between
groups, so the results equal the single-device kernel's exactly.  The FM-index probe table is one
``DeviceIndex`` a distinct device (``replicate_index``), as the JAX
engine replicates the index over the mesh.

The JAX package's multi-read SMEM mesh form (``smem_collect_multi_dp``)
runs a TPU device, the Q-reads-a-lane machine, that the port does not
have; under a mesh the port runs its one-read-a-thread kernel.
"""

from __future__ import annotations

from typing import Dict

import torch

from acc_genomics_tpu_torch.ops.extend.kernel import sw_extend_rows
from acc_genomics_tpu_torch.ops.extend.reference import DEFAULT_EXTEND_PARAMS, ExtendParams
from acc_genomics_tpu_torch.ops.smem.index import FMIndex
from acc_genomics_tpu_torch.ops.smem.kernel import smem_collect
from acc_genomics_tpu_torch.ops.smem.reference import DEFAULT_SMEM_PARAMS, SmemParams
from acc_genomics_tpu_torch.ops.smem.table import DeviceIndex
from acc_genomics_tpu_torch.ops.sw.kernel import sw_fill, sw_walk
from acc_genomics_tpu_torch.ops.sw.reference import DEFAULT_SW_PARAMS, SWParams
from acc_genomics_tpu_torch.parallel.mesh import Mesh, lane_groups


def _groups(mesh: Mesh, n: int):
    """(device, lo, hi) of each non-empty data group of ``n`` lanes."""
    return [(mesh.devices[d, 0], lo, hi)
            for d, (lo, hi) in enumerate(lane_groups(n, mesh.shape["data"])) if hi > lo]


def replicate_index(mesh: Mesh, fm: FMIndex) -> Dict[torch.device, DeviceIndex]:
    """The probe table on each distinct device of the mesh, once."""
    return {dev: DeviceIndex.build(fm, dev) for dev in mesh.distinct_devices()}


def smem_collect_dp(mesh: Mesh, indexes: Dict[torch.device, DeviceIndex], seq, lens,
                    params: SmemParams = DEFAULT_SMEM_PARAMS):
    """SMEM collection with reads (the lanes of seq (L, B), lens (B,))
    over "data"; ``indexes`` from ``replicate_index``.  Returns
    ``smem_collect``'s (mem (5, cap, B), mem_n, flag, probes)."""
    parts = []
    for dev, lo, hi in _groups(mesh, seq.shape[1]):
        out = smem_collect(indexes[dev], seq[:, lo:hi].contiguous().to(dev),
                           lens[lo:hi].to(dev), params)
        parts.append([o.to(mesh.first_device) for o in out])
    return (torch.cat([p[0] for p in parts], 2),
            *(torch.cat([p[k] for p in parts]) for k in (1, 2, 3)))


def sw_extend_dp(mesh: Mesh, q_tm, t_tm, qlen, tlen, h0, max_ins, max_del,
                 params: ExtendParams = DEFAULT_EXTEND_PARAMS) -> torch.Tensor:
    """Banded seed extension (``sw_extend_rows``), tasks (the lanes of
    q_tm (Q, B) and t_tm (T, B)) over "data"; (7, B) int32."""
    parts = []
    for dev, lo, hi in _groups(mesh, q_tm.shape[1]):
        lanes = [a[lo:hi].to(dev) for a in (qlen, tlen, h0, max_ins, max_del)]
        parts.append(sw_extend_rows(q_tm[:, lo:hi].contiguous().to(dev),
                                    t_tm[:, lo:hi].contiguous().to(dev), *lanes,
                                    params).to(mesh.first_device))
    return torch.cat(parts, 1)


def sw_fill_dp(mesh: Mesh, ref, alt, reflen, altlen, strategy: int,
               params: SWParams = DEFAULT_SW_PARAMS):
    """The SW fill alone, pairs (the rows of ref (B, R) and alt (B, C)) over
    "data": ``sw_fill``'s (btrack, lastrow, altcol), pairs first; the
    backtrack is the caller's."""
    parts = []
    for dev, lo, hi in _groups(mesh, ref.shape[0]):
        fill = sw_fill(ref[lo:hi].to(dev), alt[lo:hi].to(dev), reflen[lo:hi].to(dev),
                       altlen[lo:hi].to(dev), strategy, params)
        parts.append([x.to(mesh.first_device) for x in fill])
    return tuple(torch.cat([p[k] for p in parts]) for k in range(3))


def sw_device_dp(mesh: Mesh, ref, alt, reflen, altlen, strategy: int,
                 params: SWParams = DEFAULT_SW_PARAMS) -> torch.Tensor:
    """The SW device path (fill, then walk), pairs (the rows of ref (B, R)
    and alt (B, C)) over "data"; the walk's packed (SHIP_ELEMS + 2, B)
    int16 element buffer."""
    parts = []
    for dev, lo, hi in _groups(mesh, ref.shape[0]):
        rl, al = reflen[lo:hi].to(dev), altlen[lo:hi].to(dev)
        fill = sw_fill(ref[lo:hi].to(dev), alt[lo:hi].to(dev), rl, al, strategy, params)
        parts.append(sw_walk(*fill, rl, al, strategy).to(mesh.first_device))
    return torch.cat(parts, 1)
