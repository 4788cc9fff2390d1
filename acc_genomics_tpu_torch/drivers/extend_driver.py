"""BWA-SW extension driver: exact comparison of seed extension records.

The port of ``drivers/extend_driver.py``, the analog of
bwa-sw/sdaccel/main_cl.cpp: batches of seeds run through the batched
engine, and each record (qBeg, qEnd, rBeg, rEnd, score, trueScore,
width) is compared exactly with the oracle; ``--records`` runs a binary
(read, chain, seed) dump in the reference's format and ``--golden``
compares with its result dump by seed index.

  python -m acc_genomics_tpu_torch.drivers.extend_driver [--tasks N] [--device cuda]
"""

import argparse
import sys
import time

import numpy as np

from acc_genomics_tpu_torch.engine.genomics_engine import GenomicsEngine
from acc_genomics_tpu_torch.io import bwasw_records as br
from acc_genomics_tpu_torch.ops.extend.reference import extend_seed_oracle


def gen_seeds(rng, n: int, read_len: int, genome_len: int = 20_000):
    """``n`` seeds on a random genome: reads with 4% errors around an
    exact seed of 19-24 bases, targets with 150 bases of flank."""
    genome = rng.integers(0, 4, genome_len).astype(np.uint8)
    seeds = []
    for _ in range(n):
        pos = int(rng.integers(200, len(genome) - 400))
        read = genome[pos : pos + read_len].copy()
        err = rng.random(read_len) < 0.04
        read[err] = (read[err] + rng.integers(1, 4, err.sum())) % 4
        qbeg = int(rng.integers(5, read_len - 30))
        slen = int(rng.integers(19, 25))
        read[qbeg : qbeg + slen] = genome[pos + qbeg : pos + qbeg + slen]
        span = genome[pos - 150 : pos + read_len + 150]
        seeds.append(dict(read=read, rseq=span, qbeg=qbeg, rbeg_off=150 + qbeg, len=slen))
    return seeds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tasks", type=int, default=128)
    ap.add_argument("--read-len", type=int, default=101)
    ap.add_argument("--records", metavar="FILE",
                    help="run a binary (read, chain, seed) record dump in the "
                    "reference's format (bwa-sw/sdaccel/main_cl.cpp); requires "
                    "--genome-npy")
    ap.add_argument("--genome-npy", help="forward nt4 reference for --records")
    ap.add_argument("--golden", help="5-int result dump to compare against")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)

    engine = GenomicsEngine(device=args.device)
    if args.records:
        genome = np.load(args.genome_npy)
        tasks = br.read_task_file(args.records)
        t0 = time.perf_counter()
        got = br.run_tasks(engine.extend, genome, tasks)
        print(f"{len(got)} tasks in {(time.perf_counter() - t0) * 1e3:.1f}ms")
        if args.golden:
            base = {r["seed_index"]: r for r in br.read_results(args.golden)}
            diffs = sum(1 for r in got if any(base[r["seed_index"]][k] != r[k] for k in r))
            print("Pass" if diffs == 0 else f"Failed ({diffs} diffs)")
            return 1 if diffs else 0
        return 0

    seeds = gen_seeds(np.random.default_rng(0), args.tasks, args.read_len)
    engine.extend_seeds(seeds)  # warm
    t0 = time.perf_counter()
    got = engine.extend_seeds(seeds)
    dt = time.perf_counter() - t0
    failures = sum(
        g != extend_seed_oracle(s["read"], s["rseq"], s["qbeg"], s["rbeg_off"], s["len"])
        for s, g in zip(seeds, got))
    print(f"{args.tasks} seeds in {dt * 1e3:.1f}ms ({args.tasks / dt:.0f} seeds/s) "
          f"{'FAILED ' + str(failures) if failures else 'PASSED'}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
