"""Entry check of the port: the counterpart of the repository's
``__graft_entry__.py``.

``entry(device)`` gives the batched PairHMM forward step (the flagship
kernel's coefficient front end) with example tensors on ``device``;
``dryrun_multichip(n, device)`` runs the mesh forms over a ``(data, seq)``
mesh of ``n`` copies of one device and holds each to its unsharded or
oracle counterpart.

  python -m acc_genomics_tpu_torch.entry [--devices N] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from acc_genomics_tpu_torch.io.synth import gen_pairhmm_pairs
from acc_genomics_tpu_torch.ops.pairhmm.pack import pack_pairhmm_batch


def _example_pack(n_pairs=256, rows=32, cols=64):
    tcs = gen_pairhmm_pairs(np.random.default_rng(0), n_pairs, max_read_len=rows - 1,
                            max_hap_len=cols)
    return pack_pairhmm_batch(tcs, rows=rows, cols=cols, dtype=np.float32)


def entry(device="cuda"):
    """(fn, example_args): the batched PairHMM forward
    (``ops/pairhmm/kernel.pairhmm_forward``) and the 11 tensors of a
    256-pair pack on ``device``."""
    from acc_genomics_tpu_torch.device import resolve_device
    from acc_genomics_tpu_torch.ops.pairhmm.convert import batch_to_torch
    from acc_genomics_tpu_torch.ops.pairhmm.kernel import pairhmm_forward

    return pairhmm_forward, batch_to_torch(_example_pack(), resolve_device(device))


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The mesh forms over ``make_mesh((n // seq, seq), [device] * n)``
    (seq 2 when n is even), each held to its reference: PairHMM DP x SP
    on the band kernel (fp32 and byte-plane front ends) against the
    unsharded forward; ``smem_collect_dp`` against the single-device
    kernel, and ``SmemEngine`` on the mesh against the oracle; extension
    DP against unsharded; the SW device path on the mesh against the
    oracle.  Raises on any mismatch."""
    from acc_genomics_tpu_torch.config import SmemConfig
    from acc_genomics_tpu_torch.device import resolve_device
    from acc_genomics_tpu_torch.engine.smem_engine import SmemEngine
    from acc_genomics_tpu_torch.ops.extend.kernel import sw_extend_rows
    from acc_genomics_tpu_torch.ops.pairhmm.context import PairHMMContext
    from acc_genomics_tpu_torch.ops.pairhmm.convert import (
        batch_to_torch,
        context_tables,
        quals_to_torch,
    )
    from acc_genomics_tpu_torch.ops.pairhmm.kernel import pairhmm_forward
    from acc_genomics_tpu_torch.ops.pairhmm.pack import pack_pairhmm_quals
    from acc_genomics_tpu_torch.ops.smem.index import FMIndex
    from acc_genomics_tpu_torch.ops.smem.kernel import smem_collect
    from acc_genomics_tpu_torch.ops.smem.reference import mem_collect_intv_oracle
    from acc_genomics_tpu_torch.ops.smem.table import DeviceIndex
    from acc_genomics_tpu_torch.ops.sw.batch import (
        sw_align_batch_decode,
        sw_align_batch_launch,
    )
    from acc_genomics_tpu_torch.ops.sw.reference import sw_align_oracle
    from acc_genomics_tpu_torch.parallel import (
        make_mesh,
        pairhmm_forward_dpsp,
        pairhmm_forward_dpsp_from_quals,
    )
    from acc_genomics_tpu_torch.parallel.sharded_kernels import (
        replicate_index,
        smem_collect_dp,
        sw_extend_dp,
    )

    dev = resolve_device(device)
    seq = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh((n_devices // seq, seq), devices=[dev] * n_devices)

    # PairHMM DP x SP on the band kernel against the unsharded forward
    n_pairs = max(2 * n_devices * 8, 128 * (n_devices // seq))
    tcs = gen_pairhmm_pairs(np.random.default_rng(0), n_pairs, max_read_len=15,
                            max_hap_len=32)
    pack = pack_pairhmm_batch(tcs, rows=16, cols=32, dtype=np.float32)
    args = batch_to_torch(pack, dev)
    want = pairhmm_forward(*args).cpu().numpy()
    out = pairhmm_forward_dpsp(mesh, *args).cpu().numpy()
    np.testing.assert_allclose(out, want, rtol=1e-5)
    ctx = PairHMMContext(np.float32)
    ph2pr, m2m, _ = context_tables(ctx, dev)
    qargs = quals_to_torch(pack_pairhmm_quals(tcs, rows=16, cols=32), dev)
    out_q = pairhmm_forward_dpsp_from_quals(
        mesh, *qargs, ph2pr, m2m, float(ctx.initial_constant), expand="gather",
    ).cpu().numpy()
    np.testing.assert_allclose(out_q, want, rtol=1e-5)

    # SMEM: data-parallel kernel against one device, the engine on the mesh
    # against the oracle
    rng = np.random.default_rng(1)
    B = 2 * mesh.shape["data"]
    genome = rng.integers(0, 4, 600).astype(np.uint8)
    fm = FMIndex.build(genome)
    seq_tm = np.full((32, B), 4, np.uint8)
    lens = np.full(B, 30, np.int32)
    for k in range(B):
        p = int(rng.integers(0, len(genome) - 30))
        seq_tm[:30, k] = genome[p : p + 30]
    seq_d, lens_d = torch.from_numpy(seq_tm).to(dev), torch.from_numpy(lens).to(dev)
    one = smem_collect(DeviceIndex.build(fm, dev), seq_d, lens_d)
    dp = smem_collect_dp(mesh, replicate_index(mesh, fm), seq_d, lens_d)
    for a, b in zip(one, dp):
        assert torch.equal(a.cpu(), b.cpu()), "SMEM DP vs single device"
    cfg = SmemConfig(batch_size=mesh.shape["data"], seq_length=32, read_buckets=(32,))
    eng_m = SmemEngine(fm, cfg, device=dev, mesh=mesh)
    m_reads = [seq_tm[:30, k].copy() for k in range(B)]
    for r, got in zip(m_reads, eng_m.collect(m_reads)):
        assert got == mem_collect_intv_oracle(fm, r, eng_m.params), "mesh SMEM vs oracle"

    # seed extension DP against unsharded
    q = torch.from_numpy(rng.integers(0, 4, (16, B)).astype(np.uint8)).to(dev)
    t = torch.from_numpy(rng.integers(0, 4, (24, B)).astype(np.uint8)).to(dev)
    ql, tl, h0 = (torch.full((B,), v, dtype=torch.int32, device=dev) for v in (16, 24, 10))
    e1 = sw_extend_rows(q, t, ql, tl, h0, ql, ql)
    e_dp = sw_extend_dp(mesh, q, t, ql, tl, h0, ql, ql)
    assert torch.equal(e1.cpu(), e_dp.cpu()), "extension DP vs unsharded"

    # the SW device path (fill, walk) over the mesh against the oracle
    n_sw = 2 * mesh.shape["data"]
    refs, alts = [], []
    for _ in range(n_sw):
        r = rng.integers(0, 4, 14).astype(np.uint8)
        a = r[:12].copy()
        a[5] = (a[5] + 1) % 4
        refs.append(r)
        alts.append(a)
    launched = sw_align_batch_launch(refs, alts, 0, rows=16, cols=16, device=dev, mesh=mesh)
    got = sw_align_batch_decode(launched.packed.cpu().numpy(), refs, alts, 0)
    for r, a, g in zip(refs, alts, got):
        assert g == sw_align_oracle(r, a, 0), "SW device path on the mesh vs oracle"

    print(f"dryrun_multichip OK: mesh {mesh.shape} of {n_devices} x {dev}: PairHMM "
          f"DP x SP ({pack.n_real} pairs, max rel diff "
          f"{np.max(np.abs(out - want) / np.maximum(want, 1e-30)):.2e}), SMEM DP "
          f"({B} reads) and SmemEngine on the mesh (oracle-exact), extension DP "
          f"({B} seeds), SW device path ({n_sw} pairs exact)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=4, help="mesh positions")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)
    fn, example = entry(args.device)
    print(f"entry(): {fn.__name__} on {len(example)} tensors -> "
          f"{tuple(fn(*example).shape)}")
    dryrun_multichip(args.devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
