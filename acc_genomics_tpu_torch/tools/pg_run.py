"""A rank of the two-process run of the process-group forms
(``parallel/distributed.py``).

Start one process for each of the two ranks, with the same flags but
``--rank`` (``run_ranks`` does):

  python -m acc_genomics_tpu_torch.tools.pg_run --rank R \\
      --store /tmp/run/store [--device cuda] [--shapes main] [--out DIR]

Every rank makes the same inputs from fixed seeds on its device, joins a
gloo group over the file store, and runs each form once:
``pairhmm_forward_dp_pg``, ``pairhmm_forward_dpsp_pg`` and its byte-plane
form on a (1, 2) grid, ``sw_device_dp_pg`` in the four
strategies, ``sw_extend_dp_pg`` and ``smem_collect_dp_pg``.  It holds
each gathered result against the single-process form on a mesh of its one
device repeated (exact; PairHMM DP rtol 1e-6) and its local part against
its lanes of the gathered result (exact), then times the forms.  Shapes:
``small`` (a few lanes, the CPU tests') or ``main`` (the card's main
paths: one bucket of bench.py's 8192-pair PairHMM batch, the 2,048 long
pairs of chip_smoke.py's mesh phase at 2 x 2048 columns, the SW bench
batch's first 4096-pair chunk, the 2048-task extension batch, 2048 reads
over a 1 Mbp index).

Prints one JSON line: the rank, its device, the checks, the kernel
launches of the checked runs, and its times (the inputs' set-up; each
form's call in ms, host clocks around synchronised calls, median of 3,
the single-process form on rank 0 while the other rank waits;
``edge_exchange_ms``: one DP x SP edge chunk's trip from the card
through gloo to the next rank's card, the exchange of one superstep).  With
``--out`` it writes ``rank<R>.npz`` (inputs, gathered results, local
parts).  Exits 1 when a check fails.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys
import time
from typing import List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from acc_genomics_tpu_torch.device import resolve_device
from acc_genomics_tpu_torch.engine.packing import pack_tm
from acc_genomics_tpu_torch.io.synth import (
    gen_pairhmm_input,
    gen_pairhmm_pairs,
    gen_reference_with_repeats,
    gen_smem_reads,
)
from acc_genomics_tpu_torch.ops.pairhmm.context import PairHMMContext
from acc_genomics_tpu_torch.ops.pairhmm.convert import (
    batch_to_torch,
    context_tables,
    quals_to_torch,
)
from acc_genomics_tpu_torch.ops.pairhmm.pack import pack_pairhmm_batch, pack_pairhmm_quals
from acc_genomics_tpu_torch.ops.smem.index import FMIndex
from acc_genomics_tpu_torch.ops.smem.table import DeviceIndex
from acc_genomics_tpu_torch.ops.sw.batch import pack_planes
from acc_genomics_tpu_torch.parallel import distributed as D
from acc_genomics_tpu_torch.parallel.mesh import lane_groups, make_mesh
from acc_genomics_tpu_torch.parallel.sharded import (
    pairhmm_forward_dp,
    pairhmm_forward_dpsp,
    pairhmm_forward_dpsp_from_quals,
)
from acc_genomics_tpu_torch.parallel.sharded_kernels import (
    replicate_index,
    smem_collect_dp,
    sw_device_dp,
    sw_extend_dp,
)

WORLD, SEQ = 2, 2  # ranks; the DP x SP grid's seq axis
LAUNCH_MODULES = ("pairhmm.kernel", "pairhmm.band_kernel", "sw.kernel", "extend.kernel",
                  "smem.kernel")


def _launch_counters():
    return [importlib.import_module(f"acc_genomics_tpu_torch.ops.{m}").LAUNCHES
            for m in LAUNCH_MODULES]


def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def make_inputs(shapes: str, dev) -> dict:
    """Each form's inputs on ``dev`` (the same in every rank), by name."""
    from acc_genomics_tpu_torch.tools.bench_shapes import (
        extend_batches,
        pairhmm_bench_groups,
        sw_bench_chunks,
    )

    ctx = PairHMMContext(np.float32)
    ph2pr, m2m, _ = context_tables(ctx, dev)
    out = {"ic": float(ctx.initial_constant), "ph2pr": ph2pr, "m2m": m2m}
    if shapes == "small":
        tcs = gen_pairhmm_pairs(np.random.default_rng(0), 16, max_read_len=15,
                                max_hap_len=24)
        out["dp"] = batch_to_torch(pack_pairhmm_batch(tcs, rows=16, cols=24,
                                                      dtype=np.float32, pad_lanes=False), dev)
        sp = gen_pairhmm_pairs(np.random.default_rng(1), 128, max_read_len=15, max_hap_len=32)
        rows, cols, out["C"] = 16, 32, 8
        rng = np.random.default_rng(0)
        B, R, C = 8, 24, 32
        refs = [rng.integers(0, 4, n).astype(np.uint8) for n in rng.integers(1, R + 1, B)]
        alts = [rng.integers(0, 4, n).astype(np.uint8) for n in rng.integers(1, C + 1, B)]
        ref, alt = np.empty((B, R), np.uint8), np.empty((B, C), np.uint8)
        rl, al = pack_planes(refs, R, ref), pack_planes(alts, C, alt)
        out["sw"] = _on(dev, ref, alt, rl, al)
        B, Q, T = 16, 32, 48
        q = rng.integers(0, 4, (Q, B)).astype(np.uint8)
        t = rng.integers(0, 4, (T, B)).astype(np.uint8)
        out["extend"] = _on(dev, q, t, *(np.full(B, v, np.int32) for v in (Q, T, 20, Q, Q)))
        genome = gen_reference_with_repeats(rng, 1200)
        seq, lens = pack_tm(gen_smem_reads(rng, genome, 16, read_len=60), 64, 16)
    else:
        groups = pairhmm_bench_groups()
        rows = max(groups, key=lambda b: len(groups[b]))
        out["dp"] = batch_to_torch(pack_pairhmm_batch(groups[rows], rows=rows, cols=384,
                                                      sort_by_haplen=True), dev)
        reads, haps = gen_pairhmm_input(np.random.default_rng(13), 256, 8, max_read_len=250,
                                        max_hap_len=4096, derived=True)
        sp = [dict(hap=h, **r) for r in reads for h in haps]
        rows, cols, out["C"] = 256, 4096, 32
        out["sw"] = list(sw_bench_chunks(dev)[2][0])
        bench = extend_batches(dev)[0]
        out["extend"] = [bench[k] for k in ("q", "t", "qlen", "tlen", "h0", "max_ins",
                                            "max_ins")]
        rng = np.random.default_rng(0)
        genome = gen_reference_with_repeats(rng, 1_000_000)
        seq, lens = pack_tm(gen_smem_reads(rng, genome, 2048, read_len=101), 128, 2048)
    out["dpsp"] = batch_to_torch(pack_pairhmm_batch(sp, rows=rows, cols=cols,
                                                    dtype=np.float32), dev)
    out["dpsp_quals"] = quals_to_torch(pack_pairhmm_quals(sp, rows=rows, cols=cols), dev)
    out["genome"] = [torch.from_numpy(genome)]
    out["fm"] = FMIndex.build(genome)
    out["index"] = DeviceIndex.build(out["fm"], dev)
    out["smem"] = _on(dev, seq, lens)
    return out


def forms(inp: dict, dev) -> dict:
    """name -> (process-group call, single-process call, lanes, exact):
    each call returns a tuple of tensors, lanes last."""
    dp_mesh = make_mesh((WORLD, 1), devices=[dev] * WORLD)
    sp_mesh = make_mesh((WORLD // SEQ, SEQ), devices=[dev] * WORLD)
    C = inp["C"]
    tabs = (inp["ph2pr"], inp["m2m"], inp["ic"])
    out = {
        "pairhmm_dp": (lambda g: (D.pairhmm_forward_dp_pg(*inp["dp"], gather=g),),
                       lambda: (pairhmm_forward_dp(dp_mesh, *inp["dp"]),),
                       inp["dp"][0].shape[1], False),
        "pairhmm_dpsp": (lambda g: (D.pairhmm_forward_dpsp_pg(*inp["dpsp"], seq=SEQ, C=C,
                                                              gather=g),),
                         lambda: (pairhmm_forward_dpsp(sp_mesh, *inp["dpsp"], C=C),),
                         inp["dpsp"][0].shape[1], True),
        "pairhmm_dpsp_quals": (
            lambda g: (D.pairhmm_forward_dpsp_from_quals_pg(*inp["dpsp_quals"], *tabs,
                                                            seq=SEQ, C=C, gather=g),),
            lambda: (pairhmm_forward_dpsp_from_quals(sp_mesh, *inp["dpsp_quals"], *tabs,
                                                     C=C),),
            inp["dpsp_quals"][0].shape[1], True),
        "sw_extend": (lambda g: (D.sw_extend_dp_pg(*inp["extend"], gather=g),),
                      lambda: (sw_extend_dp(dp_mesh, *inp["extend"]),),
                      inp["extend"][0].shape[1], True),
        "smem": (lambda g: D.smem_collect_dp_pg(inp["index"], *inp["smem"], gather=g),
                 lambda: smem_collect_dp(dp_mesh, replicate_index(dp_mesh, inp["fm"]),
                                         *inp["smem"]),
                 inp["smem"][0].shape[1], True),
    }
    for s in range(4):
        out[f"sw_device_{s}"] = (
            lambda g, s=s: (D.sw_device_dp_pg(*inp["sw"], s, gather=g),),
            lambda s=s: (sw_device_dp(dp_mesh, *inp["sw"], s),),
            inp["sw"][0].shape[0], True)
    return out


def local_lanes(name: str, n: int, rank: int):
    """[lo, hi) of the lanes that ``rank`` returns without gathering: its
    lane group, or for DP x SP its data group's lanes."""
    if name.startswith("pairhmm_dpsp"):
        bd = n // (WORLD // SEQ)
        d = rank // SEQ
        return d * bd, (d + 1) * bd
    return lane_groups(n, WORLD)[rank]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _median_ms(fn, dev, repeats: int = 3) -> float:
    times = []
    for _ in range(repeats):
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def edge_exchange_ms(inp: dict, rank: int, dev, rounds: int = 8) -> float:
    """One DP x SP edge chunk (3 x lanes x C float32) from rank 0's device
    through gloo into rank 1's device, as the pipeline moves it, per
    round (median of ``rounds``)."""
    lanes, C = inp["dpsp"][0].shape[1], inp["C"]
    edges = torch.zeros((3, 2, lanes, C + 1), dtype=torch.float32, device=dev)
    times = []
    for _ in range(rounds):
        dist.barrier()
        t0 = time.perf_counter()
        if rank == 0:
            dist.isend(edges[:, 0, :, 1:].cpu().contiguous(), 1).wait()
        elif rank == 1:
            buf = torch.empty((3, lanes, C), dtype=torch.float32)
            dist.recv(buf, 0)
            edges[:, 1, :, 1:].copy_(buf)
            _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run_ranks(tmp: str, device: str, shapes: str, timeout: float = 120,
              out: bool = False) -> List[Tuple[int, str]]:
    """Start the ranks of this module with the running interpreter,
    over a file store in the directory ``tmp`` (their output to
    ``rank<R>.log`` there, with ``out`` their npz files too); wait up to
    ``timeout`` seconds for all, kill any still running, and return
    [(returncode, output)] in rank order."""
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the group stays on this host
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    procs, logs = [], []
    try:
        for r in range(WORLD):
            logs.append(os.path.join(tmp, f"rank{r}.log"))
            with open(logs[-1], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "acc_genomics_tpu_torch.tools.pg_run",
                     "--rank", str(r),
                     "--store", os.path.join(tmp, "store"), "--device", device,
                     "--shapes", shapes] + (["--out", tmp] if out else []),
                    cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    result = []
    for p, path in zip(procs, logs):
        with open(path) as f:
            result.append((p.returncode, f.read()))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--store", required=True, help="path of the group's file store")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    ap.add_argument("--shapes", choices=("small", "main"), default="main")
    ap.add_argument("--out", help="directory for rank<R>.npz")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    inp = make_inputs(args.shapes, dev)
    setup_s = time.perf_counter() - t0
    D.init_group(args.rank, WORLD, f"file://{args.store}")
    try:
        table = forms(inp, dev)
        counters = _launch_counters()
        for c in counters:
            c.clear()
        results = {name: (pg(True), pg(False)) for name, (pg, _, _, _) in table.items()}
        _sync(dev)
        launches = {k: v for c in counters for k, v in c.items() if v}

        checks, saved = {}, {}
        for name, (pg, single, n, exact) in table.items():
            gathered, local = results[name]
            want = single()
            lo, hi = local_lanes(name, n, args.rank)
            ok = all(g.shape == w.shape for g, w in zip(gathered, want))
            if ok and exact:
                ok = all(torch.equal(g, w) for g, w in zip(gathered, want))
            elif ok:
                ok = bool(torch.allclose(gathered[0], want[0], rtol=1e-6, atol=0))
            ok = ok and all(torch.equal(x, g[..., lo:hi]) for x, g in zip(local, gathered))
            checks[name] = ok
            for j, (g, x) in enumerate(zip(gathered, local)):
                saved[f"{name}_gathered_{j}"] = g.cpu().numpy()
                saved[f"{name}_local_{j}"] = x.cpu().numpy()

        times = {"setup_s": setup_s}
        for name, (pg, single, _, _) in table.items():
            times[f"{name}_pg_ms"] = _median_ms(lambda: pg(True), dev)
            single_ms = _median_ms(single if args.rank == 0 else (lambda: None), dev)
            if args.rank == 0:
                times[f"{name}_single_ms"] = single_ms
        times["edge_exchange_ms"] = edge_exchange_ms(inp, args.rank, dev)
        times["supersteps"] = inp["dpsp"][0].shape[0] // inp["C"] + SEQ - 1
        dist.barrier()
    finally:
        dist.destroy_process_group()

    if args.out:
        for name in ("dp", "dpsp", "dpsp_quals", "sw", "extend", "smem", "genome"):
            for j, x in enumerate(inp[name]):
                saved[f"in_{name}_{j}"] = x.cpu().numpy()
        np.savez(f"{args.out}/rank{args.rank}.npz", **saved)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({"rank": args.rank, "device": name,
                      "checks": checks, "launches": launches, "times": times}), flush=True)
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
