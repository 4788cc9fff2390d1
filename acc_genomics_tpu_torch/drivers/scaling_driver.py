"""Scaling scoreboard: data-parallel PairHMM over 1..N mesh positions.

The port of ``drivers/scaling_driver.py``: one packed batch cut over a
growing "data" axis (``pairhmm_forward_dp`` on ``make_mesh((d, 1))`` for
d in 1, 2, 4, 8, 16 up to the device count), with GCUPS, speedup and
parallel efficiency for each d, and each d's result held to the
one-position result (rtol 1e-6 on the card; exact on the CPU, where the
forward's plain version runs lane by lane).  ``--devices N`` builds the
mesh from ``--device`` repeated N times, as ``entry.dryrun_multichip``
does: its positions then run one after another on one device, so the run
checks the sharded path and no speedup can show.

  python -m acc_genomics_tpu_torch.drivers.scaling_driver [--devices N] [--device cuda]
"""

import argparse
import sys
import time

import numpy as np
import torch

from acc_genomics_tpu_torch.device import resolve_device
from acc_genomics_tpu_torch.io.synth import gen_pairhmm_pairs
from acc_genomics_tpu_torch.ops.pairhmm.convert import batch_to_torch
from acc_genomics_tpu_torch.ops.pairhmm.pack import pack_pairhmm_batch
from acc_genomics_tpu_torch.parallel.mesh import make_mesh
from acc_genomics_tpu_torch.parallel.sharded import pairhmm_forward_dp

RTOL_CARD = 1e-6


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=1024)
    ap.add_argument("--rows", type=int, default=64)
    ap.add_argument("--cols", type=int, default=128)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--devices", type=int, default=0,
                    help="mesh positions on --device repeated (0: every visible card)")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.devices:
        devices = [dev] * args.devices
    elif dev.type == "cuda":
        devices = [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
    else:
        devices = [dev]
    tcs = gen_pairhmm_pairs(np.random.default_rng(0), args.pairs,
                            max_read_len=args.rows - 2, max_hap_len=args.cols)
    pack = pack_pairhmm_batch(tcs, rows=args.rows, cols=args.cols)
    arrays = batch_to_torch(pack, dev)
    if len(set(devices)) < len(devices):
        print(f"NOTE: the {len(devices)} mesh positions share {len(set(devices))} device(s) "
              f"({dev}) and run one after another: this run checks the sharded path; no "
              "speedup can show")

    base_rate, base_out, failures = None, None, 0
    for d in [d for d in (1, 2, 4, 8, 16) if d <= len(devices)]:
        mesh = make_mesh((d, 1), devices=devices[:d])
        out = pairhmm_forward_dp(mesh, *arrays)  # warm-up
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(args.reps):
            out = pairhmm_forward_dp(mesh, *arrays)
        _sync(dev)
        dt = (time.perf_counter() - t0) / args.reps
        got = out.cpu().numpy()
        if base_out is None:
            base_rate, base_out = pack.cells / dt / 1e9, got
        rtol = RTOL_CARD if dev.type == "cuda" else 0.0
        ok = got.shape == base_out.shape and np.allclose(got, base_out, rtol=rtol, atol=0)
        failures += not ok
        rate = pack.cells / dt / 1e9
        print(f"{d} device(s): {rate:8.3f} GCUPS  speedup {rate / base_rate:5.2f}x  "
              f"efficiency {rate / (base_rate * d):5.1%}  {'ok' if ok else 'MISMATCH'}")
    print(f"== {'FAILED' if failures else 'PASSED'}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
