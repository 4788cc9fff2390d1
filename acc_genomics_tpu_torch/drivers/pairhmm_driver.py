"""PairHMM end-to-end driver: golden comparison + GCUPS scoreboard.

The port of ``drivers/pairhmm_driver.py``, the analog of the reference's
pairhmm_test.cpp: synthetic mode (--syn N) generates the same input
distributions, real mode (--real dir) reads the reference text corpus
(input%d / output%d) through ``io/pairhmm_text.py``; the fp64 oracle (or
the corpus's golden output) is the golden, and every checked pair must
be within relative error 5e-3.

  python -m acc_genomics_tpu_torch.drivers.pairhmm_driver --syn 12 [--device cuda]
"""

import argparse
import glob
import os
import sys
import time

import numpy as np

from acc_genomics_tpu_torch.engine.genomics_engine import GenomicsEngine
from acc_genomics_tpu_torch.io.pairhmm_text import read_pairhmm_input, read_pairhmm_output
from acc_genomics_tpu_torch.io.synth import gen_pairhmm_input
from acc_genomics_tpu_torch.ops.pairhmm.reference import pairhmm_loglik_oracle
from acc_genomics_tpu_torch.tools.bench_shapes import flat_matrix_args
from acc_genomics_tpu_torch.utils.timer import Scoreboard

RTOL = 5e-3


def run_case(engine, reads, haps, golden=None, board=None, check_frac=1.0):
    """One matrix through the flat path (after a warm call): (pairs off by
    more than RTOL, worst relative error, cells/s, seconds)."""
    fargs = flat_matrix_args(reads, haps)
    engine.pairhmm_matrix_flat(*fargs)  # warm: allocator, pinned pool, stream
    t0 = time.perf_counter()
    lik = engine.pairhmm_matrix_flat(*fargs)
    dt = time.perf_counter() - t0
    cells = sum(len(r["rs"]) * len(h) for r in reads for h in haps)
    rate = board.record(cells, dt) if board else cells / dt
    flat = lik.reshape(-1)
    if golden is None:
        n_check = max(1, int(len(reads) * check_frac))
        golden = np.array([
            pairhmm_loglik_oracle(r["rs"], r["q"], r["i"], r["d"], r["c"], h)
            for r in reads[:n_check] for h in haps
        ])
        flat = lik[:n_check].reshape(-1)
    rel = np.abs(flat - golden) / np.maximum(np.abs(golden), 1e-12)
    return int((rel > RTOL).sum()), float(rel.max()), rate, dt


def run_big(engine, n_batches=6, n_reads=1024, n_haps=16):
    """Streamed run: ``n_batches`` batches of n_reads x n_haps pairs through
    ``compute_pairs_flat_stream`` (batch k + 1 packed and launched before
    batch k is fetched); wall GCUPS, and 8 pairs of batch 0 against the
    oracle.  Returns the pairs off."""
    rng = np.random.default_rng(1)
    raw_batches, fargs, cells = [], [], 0
    for _ in range(n_batches):
        reads, haps = gen_pairhmm_input(
            rng, n_reads, n_haps, max_read_len=150, max_hap_len=380, derived=True,
        )
        f = flat_matrix_args(reads, haps)
        rl, hl = f[5], f[7]
        cells += int((rl.astype(np.int64)[:, None] * hl[None, :]).sum())
        n_r, n_h = len(rl), len(hl)
        roffs = np.zeros(n_r, np.int64)
        np.cumsum(rl[:-1].astype(np.int64), out=roffs[1:])
        hoffs0 = np.zeros(n_h, np.int64)
        np.cumsum(hl[:-1].astype(np.int64), out=hoffs0[1:])
        fargs.append((f[0], f[1], f[2], f[3], f[4], np.repeat(rl, n_h), f[6],
                      np.tile(hl, n_r), np.repeat(roffs, n_h), np.tile(hoffs0, n_r)))
        raw_batches.append((reads, haps))
    eng = engine.pairhmm
    eng.compute_pairs_flat_stream(fargs)  # warm
    t0 = time.perf_counter()
    outs = eng.compute_pairs_flat_stream(fargs)
    dt = time.perf_counter() - t0
    reads, haps = raw_batches[0]
    lik0 = outs[0].reshape(len(reads), len(haps))
    bad = 0
    for k in range(min(8, len(reads))):
        r = reads[k]
        want = pairhmm_loglik_oracle(r["rs"], r["q"], r["i"], r["d"], r["c"], haps[0])
        if abs(lik0[k, 0] - want) > RTOL * abs(want):
            bad += 1
    print(f"big: {n_batches} x {n_reads}x{n_haps} pairs streamed, "
          f"{cells / 1e6:.0f}M cells in {dt:.2f}s -> {cells / dt / 1e9:.2f} GCUPS "
          f"{'FAIL' if bad else 'ok'}")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--syn", type=int, default=0, help="synthetic tests")
    ap.add_argument("--big", type=int, default=0,
                    help="streamed production-scale batches (pipelined)")
    ap.add_argument("--independent", action="store_true",
                    help="independent random reads/haps (underflow-heavy, the "
                    "reference GenInputs shape) instead of hap-derived reads")
    ap.add_argument("--real", type=str, default="", help="corpus directory")
    ap.add_argument("--check-frac", type=float, default=0.25)
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)

    engine = GenomicsEngine(device=args.device)
    board = Scoreboard()
    if args.big:
        failures = run_big(engine, n_batches=args.big)
        print("PASSED" if not failures else "FAILED")
        return 1 if failures else 0
    failures = 0
    if args.real:
        for inp in sorted(glob.glob(os.path.join(args.real, "input*"))):
            out = inp.replace("input", "output")
            reads, haps = read_pairhmm_input(inp)
            golden = read_pairhmm_output(out) if os.path.exists(out) else None
            n_bad, worst, rate, _ = run_case(engine, reads, haps, golden, board)
            failures += n_bad
            print(f"{os.path.basename(inp)}: {len(reads)}x{len(haps)} pairs "
                  f"{rate / 1e9:.2f} GCUPS worst rel err {worst:.2e} "
                  f"{'FAIL' if n_bad else 'ok'}")
    else:
        rng = np.random.default_rng(0)
        for t in range(max(args.syn, 1)):
            reads, haps = gen_pairhmm_input(rng, 16 * (t + 1), t + 1,
                                            derived=not args.independent)
            n_bad, worst, rate, _ = run_case(engine, reads, haps, board=board,
                                             check_frac=args.check_frac)
            failures += n_bad
            print(f"syn {t}: {len(reads)}x{len(haps)} pairs {rate / 1e9:.2f} GCUPS "
                  f"worst rel err {worst:.2e} {'FAIL' if n_bad else 'ok'}")
    print(f"== avg {board.average / 1e9:.2f} GCUPS peak {board.peak / 1e9:.2f} GCUPS "
          f"recomputed {engine.pairhmm.stats['recomputed']} "
          f"{'FAILED' if failures else 'PASSED'}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
