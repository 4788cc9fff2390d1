"""The mesh forms over a ``torch.distributed`` process group: one rank a
mesh position, each in its own process.

The counterpart of a JAX global mesh that spans processes
(``jax.distributed`` with ``shard_map``, tests/test_distributed_multiprocess.py).
The caller forms the group (``init_group`` wraps
``dist.init_process_group`` for drivers and tests) and starts one process
a rank; every rank passes the whole batch, as every JAX process holds the
whole array it shards.  Rank r of a ``(data, seq)`` grid of the group's
ranks takes data group ``r // seq`` of ``lane_groups(lanes, data)``
(``parallel/mesh.py``) and shard ``r % seq``, and runs the same kernel
wrappers as the single-process forms (``parallel/sharded.py`` and
``parallel/sharded_kernels.py``) on the device its inputs lie on, its
local device.  A rank returns its local part (the counterpart of JAX's
``addressable_shards``), or with ``gather=True`` the whole result on its
local device.

Collectives move host tensors over gloo: each rank copies its part to the
host and pads it to the longest lane group (``all_gather`` takes equal
sizes), as bytes, since gloo carries no int16; the result is trimmed
and put in lane order.  gloo runs on any host, and several ranks may
share one card, which NCCL refuses ("Duplicate GPU detected").  The
kernels still run on each rank's device.  A multi-card NCCL run is not
measured.

The DP x SP form (``pairhmm_forward_dpsp_pg``) is the one with traffic
between supersteps: the rank of shard k sends chunk c's rows of its right
edge column (3 x bd x C float32) to the rank of shard k + 1 after its
launch at superstep t = c + k (``isend``), and that rank receives them
into its mirror column before its launch at t + 1 (``recv``, then a copy
to the device on the launch stream).  The shards' results are gathered
and summed in shard order, so the answer is bit for bit the
single-process pipeline's.  This is the counterpart of the ``ppermute``
edge exchange of the JAX package's ``_sp_pallas_local`` on a mesh that
spans processes.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from acc_genomics_tpu_torch.ops.extend.kernel import sw_extend_rows
from acc_genomics_tpu_torch.ops.extend.reference import DEFAULT_EXTEND_PARAMS, ExtendParams
from acc_genomics_tpu_torch.ops.pairhmm.kernel import pairhmm_forward
from acc_genomics_tpu_torch.ops.smem.kernel import smem_collect
from acc_genomics_tpu_torch.ops.smem.reference import DEFAULT_SMEM_PARAMS, SmemParams
from acc_genomics_tpu_torch.ops.smem.table import DeviceIndex
from acc_genomics_tpu_torch.ops.sw.kernel import sw_fill, sw_walk
from acc_genomics_tpu_torch.ops.sw.reference import DEFAULT_SW_PARAMS, SWParams
from acc_genomics_tpu_torch.parallel.mesh import lane_groups
from acc_genomics_tpu_torch.parallel.sharded import (
    DevicePlan,
    band_geometry,
    coef_planes,
    quals_planes,
)


def init_group(rank: int, world_size: int, init_method: str):
    """Join the default process group over gloo, which the forms'
    collectives need (``init_method`` such as ``file:///tmp/store`` or
    ``tcp://localhost:<port>``)."""
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=world_size)


def _rank(group) -> Tuple[int, int]:
    return dist.get_rank(group), dist.get_world_size(group)


def _global(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def _all_gather_lanes(part: torch.Tensor, groups: Sequence[Tuple[int, int]],
                      group) -> torch.Tensor:
    """Every rank's ``part`` (lanes last; rank j holds ``groups[j]``) put
    together in lane order, on the host."""
    width = max(hi - lo for lo, hi in groups)
    host = part.cpu()
    pad = host.new_zeros(host.shape[:-1] + (width,))
    pad[..., :host.shape[-1]] = host
    raw = pad.view(torch.uint8)  # gloo has no int16: move bytes
    bufs = [torch.empty_like(raw) for _ in groups]
    dist.all_gather(bufs, raw, group=group)
    return torch.cat([b.view(host.dtype)[..., :hi - lo]
                      for b, (lo, hi) in zip(bufs, groups)], -1)


def _dp(n: int, run: Callable[[int, int], Tuple[torch.Tensor, ...]], group, gather: bool):
    """The data-parallel forms' shared body: this rank's lane group of
    ``n`` lanes, ``run(lo, hi)`` (its outputs with lanes last), and with
    ``gather`` every rank's outputs put together on this rank's device."""
    rank, world = _rank(group)
    if n < world:
        raise ValueError(f"{n} lanes cannot give each of {world} ranks one")
    groups = lane_groups(n, world)
    local = run(*groups[rank])
    if not gather:
        return local
    return tuple(_all_gather_lanes(x, groups, group).to(x.device) for x in local)


def pairhmm_forward_dp_pg(*packed, group=None, gather: bool = True) -> torch.Tensor:
    """``pairhmm_forward_dp`` over the group: this rank's lanes of the 11
    ``pack.arrays()`` tensors through the forward kernel.  (B,) float32,
    or this rank's lanes without ``gather``."""
    def run(lo, hi):
        return (pairhmm_forward(*[a[..., lo:hi].contiguous() for a in packed]),)

    return _dp(packed[0].shape[1], run, group, gather)[0]


def smem_collect_dp_pg(index: DeviceIndex, seq, lens,
                       params: SmemParams = DEFAULT_SMEM_PARAMS, group=None,
                       gather: bool = True):
    """``smem_collect_dp`` over the group, the whole index on every rank:
    ``smem_collect``'s (mem (5, cap, B), mem_n, flag, probes)."""
    def run(lo, hi):
        return smem_collect(index, seq[:, lo:hi].contiguous(), lens[lo:hi].contiguous(),
                            params)

    return _dp(seq.shape[1], run, group, gather)


def sw_extend_dp_pg(q_tm, t_tm, qlen, tlen, h0, max_ins, max_del,
                    params: ExtendParams = DEFAULT_EXTEND_PARAMS, group=None,
                    gather: bool = True) -> torch.Tensor:
    """``sw_extend_dp`` over the group: (7, B) int32."""
    def run(lo, hi):
        lanes = [a[lo:hi].contiguous() for a in (qlen, tlen, h0, max_ins, max_del)]
        return (sw_extend_rows(q_tm[:, lo:hi].contiguous(), t_tm[:, lo:hi].contiguous(),
                               *lanes, params),)

    return _dp(q_tm.shape[1], run, group, gather)[0]


def sw_device_dp_pg(ref, alt, reflen, altlen, strategy: int,
                    params: SWParams = DEFAULT_SW_PARAMS, group=None,
                    gather: bool = True) -> torch.Tensor:
    """``sw_device_dp`` over the group (fill, then walk): the walk's packed
    (SHIP_ELEMS + 2, B) int16 element buffer."""
    def run(lo, hi):
        rl, al = reflen[lo:hi].contiguous(), altlen[lo:hi].contiguous()
        fill = sw_fill(ref[lo:hi].contiguous(), alt[lo:hi].contiguous(), rl, al, strategy,
                       params)
        return (sw_walk(*fill, rl, al, strategy),)

    return _dp(ref.shape[0], run, group, gather)[0]


def _band_pipeline_pg(front: str, planes, tables, hap_ext, C: int, seq: int,
                      group: Optional[dist.ProcessGroup], gather: bool) -> torch.Tensor:
    """This rank's slot of the DP x SP pipeline (module docstring) on the
    device its planes lie on."""
    rank, world = _rank(group)
    if seq < 1 or world % seq:
        raise ValueError(f"{world} ranks do not form a grid of seq {seq}")
    n_data = world // seq
    d, k = divmod(rank, seq)
    rows, bsz = planes[0].shape
    cols = hap_ext.shape[0] - rows
    hc, n_chunks, bd = band_geometry(rows, cols, bsz, C, n_data, seq)
    if bd == 0:
        raise ValueError(f"{bsz} lanes cannot give each of {n_data} data groups one")
    lo, hi = d * bd, (d + 1) * bd
    mine = tuple(p[..., lo:hi].contiguous() for p in planes)
    hap = hap_ext[:cols, lo:hi].to(torch.uint8).t().contiguous()
    plan = DevicePlan(planes[0].device, [(d, k)], [(k, 0, 1 if k else -1)],
                      [(d, k - 1)] if k else [], front, mine, tables, hap, rows, hc, bd)

    sends = []
    for c in range(n_chunks):  # superstep t = c + k
        rows_c = slice(c * C + 1, (c + 1) * C + 1)
        if k > 0:  # the left shard's chunk c, sent after its superstep t - 1
            edge = torch.empty((3, bd, C), dtype=torch.float32)
            dist.recv(edge, _global(group, rank - 1), group=group)
            plan.edges[:, 1, :, rows_c].copy_(edge)
        plan.step(c + k, n_chunks, C)
        if k < seq - 1:
            edge = plan.edges[:, 0, :, rows_c].cpu().contiguous()
            sends.append((dist.isend(edge, _global(group, rank + 1), group=group), edge))
    for work, _ in sends:
        work.wait()

    parts = _all_gather_lanes(plan.res[0], [(r * bd, (r + 1) * bd) for r in range(world)],
                              group).view(n_data, seq, bd)
    totals = []
    for dd in range(n_data):  # the shards' sum, in shard order
        total = parts[dd, 0]
        for kk in range(1, seq):
            total = total + parts[dd, kk]
        totals.append(total)
    dev = planes[0].device
    return (torch.cat(totals) if gather else totals[d]).to(dev)


def pairhmm_forward_dpsp_pg(*packed, seq: int, C: int = 8, group=None,
                            gather: bool = True) -> torch.Tensor:
    """``pairhmm_forward_dpsp`` over the group's (data, seq) grid: (B,)
    float32, or this rank's data group's lanes without ``gather``."""
    return _band_pipeline_pg("coef", coef_planes(packed), (), packed[9], C, seq, group, gather)


def pairhmm_forward_dpsp_from_quals_pg(q, i, d, c, rs, hap_ext, rslen, haplen, ph2pr, m2m,
                                       initial_constant, expand: str = "arith", *, seq: int,
                                       C: int = 8, group=None,
                                       gather: bool = True) -> torch.Tensor:
    """``pairhmm_forward_dpsp_from_quals`` over the group's (data, seq)
    grid (byte planes; the band kernel expands the coefficients)."""
    planes = quals_planes(q, i, d, c, rs, rslen, haplen, expand)
    return _band_pipeline_pg(expand, planes, (ph2pr, m2m, initial_constant), hap_ext, C, seq,
                             group, gather)
