"""BWA-MEM seeding pipeline driver: SMEM -> SA positions -> seed extension.

The port of ``drivers/bwamem_driver.py``: the composed workload the
reference accelerates for bwa-flow, through ``BwaMemDevicePipeline``
(or ``BwaMemSeeding`` with ``--host-model``).  Reports reads/s and
compares every seed record of the first ``--check`` reads of each batch
exactly with the oracle chain (SMEM intervals -> SA positions ->
extension).

  python -m acc_genomics_tpu_torch.drivers.bwamem_driver [--genome N] [--device cuda]
"""

import argparse
import sys
import time

import numpy as np

from acc_genomics_tpu_torch.engine.genomics_engine import GenomicsEngine
from acc_genomics_tpu_torch.io.synth import gen_smem_reads
from acc_genomics_tpu_torch.models import BwaMemDevicePipeline, BwaMemSeeding
from acc_genomics_tpu_torch.ops.extend.reference import extend_seed_oracle
from acc_genomics_tpu_torch.ops.smem.index import FMIndex
from acc_genomics_tpu_torch.ops.smem.reference import mem_collect_intv_oracle


def oracle_hits(fm, read, max_occ, flank, smem_params, ext_params):
    """The oracle chain for one read, with the pipelines' seed enumeration
    (interval order, occurrences ascending, at most ``max_occ``): each
    seed's (qbeg, qend, rbeg, rend, score, trueScore, width, occ)."""
    out = []
    for iv in mem_collect_intv_oracle(fm, read, smem_params):
        slen = iv["end"] - iv["start"]
        for pos in fm.sa[iv["x0"] : iv["x0"] + min(iv["s"], max_occ)]:
            pos = int(pos)
            lo = max(0, pos - iv["start"] - flank)
            hi = min(fm.seq_len, pos + slen + (len(read) - iv["end"]) + flank)
            res = extend_seed_oracle(read, fm.text[lo:hi], iv["start"], pos - lo, slen,
                                     ext_params)
            out.append((res["qBeg"], iv["end"] + res["qEnd"], pos + res["rBeg"],
                        pos + slen + res["rEnd"], res["score"], res["trueScore"],
                        res["width"], iv["s"]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome", type=int, default=2_000_000)
    ap.add_argument("--npz", help="load a cached FMIndex .npz (genome scale)")
    ap.add_argument("--reads", type=int, default=1024)
    ap.add_argument("--read-len", type=int, default=101)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--check", type=int, default=8)
    ap.add_argument("--host-model", action="store_true",
                    help="BwaMemSeeding (host-composed) instead of the device pipeline")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    eng = GenomicsEngine(device=args.device)
    t0 = time.perf_counter()
    if args.npz:
        fm = FMIndex.load(args.npz)
        eng.set_index(fm)
    else:
        fm = eng.load_reference(rng.integers(0, 4, args.genome).astype(np.uint8))
    genome = fm.text[: fm.seq_len // 2]
    print(f"index: {time.perf_counter() - t0:.1f}s ({fm.seq_len // 2} bases)")
    bm = BwaMemSeeding(eng) if args.host_model else BwaMemDevicePipeline(eng)

    bm.map_reads(gen_smem_reads(rng, genome, args.reads, read_len=args.read_len))  # warm
    total, total_hits, rates, failures = 0, 0, [], 0
    for b in range(args.batches):
        reads = gen_smem_reads(rng, genome, args.reads, read_len=args.read_len)
        t0 = time.perf_counter()
        hits = bm.map_reads(reads)
        dt = time.perf_counter() - t0
        total += len(reads)
        rates.append(len(reads) / dt)
        total_hits += sum(len(h) for h in hits)
        checked = 0
        for k in range(min(args.check, len(reads))):
            want = oracle_hits(fm, reads[k], bm.max_occ, bm.flank, eng.smem.params,
                               eng.extend.config.params())
            got = [(h.qbeg, h.qend, h.rbeg, h.rend, h.score, h.true_score, h.width, h.occ)
                   for h in hits[k]]
            checked += len(want)
            if got != want:
                failures += 1
                print(f"  MISMATCH read {k}: got {got[:3]}... want {want[:3]}...")
        print(f"batch {b}: {len(reads) / dt:.0f} reads/s, {sum(len(h) for h in hits)} "
              f"hits, {checked} oracle-checked seed records")
    print(f"== {float(np.median(rates)):.0f} reads/s seeding+extension (median of "
          f"{args.batches} batches), {total_hits / total:.2f} hits/read "
          f"{'FAILED' if failures else 'PASSED'}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
