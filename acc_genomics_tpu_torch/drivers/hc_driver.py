"""HaplotypeCaller-core driver: the composed SW + PairHMM region pipeline.

The port of ``drivers/hc_driver.py``: synthetic active regions (a
reference window, haplotypes as SNP/indel variants of it, reads sampled
from the haplotypes, ``io/synth.gen_region``) through
``HaplotypeCallerCore.process_regions``; the first regions' CIGARs are
compared exactly with the SW oracle and a sample of likelihoods with the
PairHMM oracle (5e-3), and the best haplotype of each read must be its
source for at least 55% of the reads.

  python -m acc_genomics_tpu_torch.drivers.hc_driver [--regions N] [--device cuda]
"""

import argparse
import sys
import time

import numpy as np

from acc_genomics_tpu_torch.engine.genomics_engine import GenomicsEngine
from acc_genomics_tpu_torch.io.synth import gen_region
from acc_genomics_tpu_torch.models.haplotype_caller import HaplotypeCallerCore
from acc_genomics_tpu_torch.ops.pairhmm.reference import pairhmm_loglik_oracle
from acc_genomics_tpu_torch.ops.sw.reference import sw_align_oracle

MIN_RECOVERY = 0.55


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--regions", type=int, default=16)
    ap.add_argument("--reads-per-region", type=int, default=24)
    ap.add_argument("--check-regions", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    hc = HaplotypeCallerCore(GenomicsEngine(device=args.device))
    regions, sources = [], []
    for _ in range(args.regions):
        ref, haps, reads, src = gen_region(rng, n_reads=args.reads_per_region)
        regions.append((ref, haps, reads))
        sources.append(src)

    hc.process_regions(regions)  # warm
    t0 = time.perf_counter()
    results = hc.process_regions(regions)
    dt = time.perf_counter() - t0

    failures = 0
    for (ref, haps, reads), res in list(zip(regions, results))[: args.check_regions]:
        for h, (cig, off) in zip(haps, res.hap_cigars):
            wc, wo = sw_align_oracle(ref, h, hc.overhang_strategy)
            if [tuple(e) for e in wc] != [tuple(e) for e in cig] or wo != off:
                failures += 1
        for r_i in range(0, len(reads), max(1, len(reads) // 4)):
            r = reads[r_i]
            for h_i, h in enumerate(haps):
                want = pairhmm_loglik_oracle(r["rs"], r["q"], r["i"], r["d"], r["c"], h)
                if abs(res.likelihoods[r_i, h_i] - want) / max(abs(want), 1e-12) > 5e-3:
                    failures += 1
    hits = sum(int((res.best_hap == np.asarray(src)).sum())
               for res, src in zip(results, sources))
    recov = hits / max(sum(len(s) for s in sources), 1)
    n_pairs = sum(len(r) * len(h) for _, h, r in regions)
    ok = not failures and recov >= MIN_RECOVERY
    print(f"== {args.regions} regions ({n_pairs} read-hap pairs) in {dt * 1e3:.0f} ms "
          f"({args.regions / dt:.1f} regions/s), best-hap recovery {recov:.2f} "
          f"{'PASSED' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
