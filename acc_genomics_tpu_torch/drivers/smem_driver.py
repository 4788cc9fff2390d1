"""SMEM end-to-end driver: exact golden comparison + reads/s scoreboard.

The port of ``drivers/smem_driver.py``, the analog of smem/main.cpp
randomTest.  It obtains an index (a synthetic genome, a FASTA file, an
on-disk ``bwa index`` prefix through ``io/bwa_index.py``, or a cached
``FMIndex`` .npz), runs batches of reads through the engine on the card
and the oracle on the host, compares the intervals exactly, and reports
reads/s, the probe traffic and the index's scale (build time, host RSS,
probe-table size).

  python -m acc_genomics_tpu_torch.drivers.smem_driver --genome 100000000
  python -m acc_genomics_tpu_torch.drivers.smem_driver --fasta ref.fa --save-npz ref.fm.npz
  python -m acc_genomics_tpu_torch.drivers.smem_driver --index /path/bwa/prefix
  python -m acc_genomics_tpu_torch.drivers.smem_driver --npz ref.fm.npz
"""

import argparse
import resource
import sys
import time

import numpy as np

from acc_genomics_tpu_torch.engine.genomics_engine import GenomicsEngine
from acc_genomics_tpu_torch.io.bwa_index import build_index_from_fasta, load_bwa_index
from acc_genomics_tpu_torch.io.synth import gen_reference_with_repeats, gen_smem_reads
from acc_genomics_tpu_torch.ops.smem.index import FMIndex
from acc_genomics_tpu_torch.ops.smem.reference import mem_collect_intv_oracle


def canon(ivs):
    return sorted((iv["x0"], iv["x1"], iv["s"], iv["start"], iv["end"]) for iv in ivs)


def rss_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def obtain_index(args, rng):
    """-> (fm, genome).  Prints the index's source and scale."""
    t0 = time.perf_counter()
    if args.npz:
        fm = FMIndex.load(args.npz)
        src = f"npz {args.npz}"
    elif args.index:
        fm, anns = load_bwa_index(args.index, validate=not args.no_validate)
        src = f"bwa index {args.index} ({len(anns.contigs)} contigs)"
    elif args.fasta:
        fm, anns = build_index_from_fasta(args.fasta)
        src = f"fasta {args.fasta} ({len(anns.contigs)} contigs)"
    else:
        fm = FMIndex.build(gen_reference_with_repeats(rng, args.genome))
        src = f"synthetic {args.genome} bp"
    dt = time.perf_counter() - t0
    if args.save_npz:
        fm.save(args.save_npz)
        print(f"index cached to {args.save_npz}")
    print(f"index [{src}]: {fm.seq_len} BWT entries, built/loaded in {dt:.1f}s, "
          f"host RSS {rss_gb():.2f} GB, probe table {fm.bwt_packed.shape[0] * 32 / 1e6:.0f} MB")
    return fm, fm.text[: fm.seq_len // 2]


def read_text_reads(path):
    """One ACGTN read a line (smem/main.cpp:71-93's getBatch format):
    ACGT -> 0..3, anything else N (4)."""
    lut = np.full(256, 4, np.uint8)
    for i, c in enumerate("ACGT"):
        lut[ord(c)] = lut[ord(c.lower())] = i
    with open(path) as f:
        return [lut[np.frombuffer(line.strip().encode(), np.uint8)]
                for line in f if line.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome", type=int, default=50_000, help="synthetic genome length (bp)")
    ap.add_argument("--fasta", help="build the index from a FASTA file")
    ap.add_argument("--index", help="load a `bwa index` prefix (.pac/.bwt/.sa)")
    ap.add_argument("--npz", help="load a cached FMIndex .npz")
    ap.add_argument("--save-npz", help="cache the built index to .npz")
    ap.add_argument("--no-validate", action="store_true",
                    help="skip the byte-level cross-check when loading a bwa index")
    ap.add_argument("--reads", type=int, default=2048)
    ap.add_argument("--reads-file", help="text read file, one ACGTN read per line; "
                    "overrides --reads")
    ap.add_argument("--read-len", type=int, default=101)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--check", type=int, default=32, help="reads golden-checked per batch")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    fm, genome = obtain_index(args, rng)
    engine = GenomicsEngine(device=args.device)
    t0 = time.perf_counter()
    engine.set_index(fm)
    print(f"index uploaded to {engine.device} in {time.perf_counter() - t0:.2f}s")

    file_reads = read_text_reads(args.reads_file) if args.reads_file else None
    if file_reads is not None:
        args.reads, args.batches = len(file_reads), 1

    def batch_reads():
        if file_reads is not None:
            return file_reads
        return gen_smem_reads(rng, genome, args.reads, read_len=args.read_len)

    engine.smem_collect(batch_reads())  # warm
    failures, total_reads, total_time = 0, 0, 0.0
    for b in range(args.batches):
        reads = batch_reads()
        t0 = time.perf_counter()
        got = engine.smem_collect(reads)
        dt = time.perf_counter() - t0
        total_reads += len(reads)
        total_time += dt
        for k in range(min(args.check, len(reads))):
            if canon(got[k]) != canon(mem_collect_intv_oracle(fm, reads[k])):
                failures += 1
        print(f"batch {b}: {len(reads)} reads {len(reads) / dt:.0f} reads/s "
              f"{sum(len(g) for g in got)} intervals "
              f"overflow reruns {engine.smem.stats['overflow_reruns']}")
    # two 32-byte probe-table rows an extension (smem/host/baseline.cpp's
    # per-bank DRAM accounting, smem/main.cpp:352-366)
    traffic = engine.smem.stats["probe_iters"] * 2 * 32
    print(f"== {total_reads / total_time:.0f} reads/s, "
          f"{traffic / total_time / 1e9:.2f} GB/s probe traffic "
          f"{'FAILED' if failures else 'PASSED'}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
