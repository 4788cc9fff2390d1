"""HTC-SW driver: batch-size sweep with exact CIGAR comparison.

The port of ``drivers/sw_driver.py``, the analog of
htc-sw/host/sw_host.cpp: a random reference (286 bp by default), alts
with +-5% length jitter and 10% mutations, batch sizes swept in powers of
two, each CIGAR and offset compared exactly with the oracle, a GCUPS
board.

  python -m acc_genomics_tpu_torch.drivers.sw_driver [--device cuda]
"""

import argparse
import sys
import time

import numpy as np

from acc_genomics_tpu_torch.engine.genomics_engine import GenomicsEngine
from acc_genomics_tpu_torch.io.synth import gen_sw_batch
from acc_genomics_tpu_torch.ops.sw.reference import sw_align_oracle
from acc_genomics_tpu_torch.utils.timer import Scoreboard


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref-len", type=int, default=286)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--strategy", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    engine = GenomicsEngine(device=args.device)
    board = Scoreboard()
    failures = 0
    batch = 1
    while batch <= args.max_batch:
        ref, alts = gen_sw_batch(rng, batch, ref_len=args.ref_len)
        t0 = time.perf_counter()
        got = engine.sw_align(ref, alts, args.strategy)
        dt = time.perf_counter() - t0
        rate = board.record(sum(len(ref) * len(a) for a in alts), dt)
        bad = sum(res != sw_align_oracle(ref, a, args.strategy) for a, res in zip(alts, got))
        failures += bad
        print(f"batch {batch}: {rate / 1e9:.3f} GCUPS {'FAIL' if bad else 'ok'}")
        batch *= 2
    print(f"== avg {board.average / 1e9:.3f} GCUPS peak {board.peak / 1e9:.3f} "
          f"{'FAILED' if failures else 'PASSED'}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
