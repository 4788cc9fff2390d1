"""Adversarial multi-kernel fuzz: random shapes and edge cases through the
engines against the oracles, and a (1, 1) port mesh against the plain
engines.

The port of ``drivers/fuzz_driver.py``: PairHMM with N bases and extreme
qualities, SW in all four strategies on tiny and tied sequences, seed
extension with empty sides, SMEM on a repeat-heavy genome with boundary
and N reads.

  python -m acc_genomics_tpu_torch.drivers.fuzz_driver [--seeds 1 2 3] [--mesh] [--device cuda]
"""

import argparse
import sys

import numpy as np

from acc_genomics_tpu_torch.engine.genomics_engine import GenomicsEngine
from acc_genomics_tpu_torch.io.synth import gen_reference_with_repeats, gen_smem_reads
from acc_genomics_tpu_torch.ops.extend.reference import extend_seed_oracle
from acc_genomics_tpu_torch.ops.pairhmm.reference import pairhmm_loglik_oracle
from acc_genomics_tpu_torch.ops.smem.reference import mem_collect_intv_oracle
from acc_genomics_tpu_torch.ops.sw.reference import sw_align_oracle
from acc_genomics_tpu_torch.parallel.mesh import make_mesh


def fuzz_seed(seed: int, device="cuda") -> int:
    rng = np.random.default_rng(seed)
    eng = GenomicsEngine(device=device)
    bad = 0

    # PairHMM: random lengths, N bases, extreme quals
    for _ in range(4):
        reads, haps = [], []
        for _ in range(int(rng.integers(3, 9))):
            ln = int(rng.integers(5, 120))
            reads.append(dict(
                rs=rng.integers(0, 5, ln).astype(np.uint8),
                q=rng.integers(1, 64, ln).astype(np.uint8),
                i=rng.integers(1, 64, ln).astype(np.uint8),
                d=rng.integers(1, 64, ln).astype(np.uint8),
                c=rng.integers(1, 32, ln).astype(np.uint8)))
        for _ in range(3):
            haps.append(rng.integers(0, 5, int(rng.integers(8, 300))).astype(np.uint8))
        got = np.asarray(eng.pairhmm_matrix(reads, haps))
        for a, r in enumerate(reads):
            for b, h in enumerate(haps):
                want = pairhmm_loglik_oracle(r["rs"], r["q"], r["i"], r["d"], r["c"], h)
                if abs(got[a, b] - want) / max(abs(want), 1e-12) > 5e-3:
                    bad += 1
                    print(f"PAIRHMM MISMATCH ({a},{b}): {got[a, b]} want {want}")

    # SW: all strategies, tiny/tied sequences
    for _ in range(3):
        strat = int(rng.integers(0, 4))
        refs, alts = [], []
        for _ in range(6):
            r = rng.integers(0, 4, int(rng.integers(1, 60))).astype(np.uint8)
            if rng.random() < 0.5 and len(r) > 3:
                a = r[: max(1, int(rng.integers(1, 60)))].copy()
                if len(a) > 2:
                    a[rng.integers(0, len(a))] = (a[0] + 1) % 4
            else:
                a = rng.integers(0, 4, int(rng.integers(1, 60))).astype(np.uint8)
            refs.append(r)
            alts.append(a)
        for r, a, g in zip(refs, alts, eng.sw.align(refs, alts, strat)):
            wc, wo = sw_align_oracle(r, a, strat)
            if [tuple(e) for e in wc] != [tuple(e) for e in g[0]] or wo != g[1]:
                bad += 1
                print(f"SW MISMATCH strat={strat}")

    # extend: random seeds incl. zero-length extension sides
    genome = rng.integers(0, 4, 8000).astype(np.uint8)
    seeds = []
    for _ in range(24):
        pos = int(rng.integers(150, 7600))
        rl = int(rng.integers(25, 140))
        read = genome[pos: pos + rl].copy()
        err = rng.random(rl) < 0.06
        read[err] = (read[err] + rng.integers(1, 4, int(err.sum()))) % 4
        sl = int(rng.integers(19, min(25, rl)))
        qb = int(rng.integers(0, rl - sl + 1))
        read[qb:qb + sl] = genome[pos + qb:pos + qb + sl]
        fl = int(rng.integers(10, 150))
        span = genome[max(0, pos - fl): pos + rl + fl]
        seeds.append(dict(read=read, rseq=span, qbeg=qb,
                          rbeg_off=pos - max(0, pos - fl) + qb, len=sl))
    for s, g in zip(seeds, eng.extend_seeds(seeds)):
        w = extend_seed_oracle(s["read"], s["rseq"], s["qbeg"], s["rbeg_off"], s["len"])
        if any(g[k] != w[k] for k in w):
            bad += 1
            print(f"EXTEND MISMATCH {g} want {w}")

    # SMEM: repeat-heavy genome + boundary/N reads
    g2 = gen_reference_with_repeats(rng, 12000, repeat_len=30, n_repeats=10)
    eng.load_reference(g2)
    reads = gen_smem_reads(rng, g2, 24, read_len=90)
    reads[0] = g2[:90].copy()
    reads[1] = g2[-90:].copy()
    reads[2][45] = 4
    canon = lambda iv: sorted((d["x0"], d["x1"], d["s"], d["start"], d["end"]) for d in iv)
    for k, (r, g) in enumerate(zip(reads, eng.smem_collect(reads))):
        if canon(g) != canon(mem_collect_intv_oracle(eng.smem.fm, r)):
            bad += 1
            print(f"SMEM MISMATCH read {k}")
    return bad


def fuzz_mesh(seed: int, device="cuda") -> int:
    """A (1, 1) port mesh of ``device`` against the plain engines: PairHMM
    (haplotypes of 40, 200 and 700), SW and SMEM must agree."""
    rng = np.random.default_rng(seed)
    mesh = make_mesh((1, 1), devices=[device])
    plain, meshed = GenomicsEngine(device=device), GenomicsEngine(device=device, mesh=mesh)
    bad = 0
    reads, haps = [], []
    for _ in range(5):
        ln = int(rng.integers(10, 100))
        reads.append(dict(rs=rng.integers(0, 4, ln).astype(np.uint8),
                          q=rng.integers(6, 50, ln).astype(np.uint8),
                          i=rng.integers(30, 50, ln).astype(np.uint8),
                          d=rng.integers(30, 50, ln).astype(np.uint8),
                          c=np.full(ln, 10, np.uint8)))
    for hl in (40, 200, 700):
        haps.append(rng.integers(0, 4, hl).astype(np.uint8))
    a = np.asarray(plain.pairhmm_matrix(reads, haps))
    b = np.asarray(meshed.pairhmm_matrix(reads, haps))
    if not np.allclose(a, b, rtol=1e-5):
        bad += 1
        print("PAIRHMM mesh-identity mismatch")
    refs = [rng.integers(0, 4, int(rng.integers(20, 200))).astype(np.uint8)
            for _ in range(6)]
    alts = [r[: max(5, len(r) - 7)].copy() for r in refs]
    for al in alts:
        al[rng.integers(0, len(al))] = (al[0] + 1) % 4
    if plain.sw.align(refs, alts, 1) != meshed.sw.align(refs, alts, 1):
        bad += 1
        print("SW mesh-identity mismatch")
    g = rng.integers(0, 4, 6000).astype(np.uint8)
    plain.load_reference(g)
    meshed.load_reference(g)
    rd = [g[p:p + 70].copy() for p in rng.integers(0, 5900, 8)]
    if plain.smem_collect(rd) != meshed.smem_collect(rd):
        bad += 1
        print("SMEM mesh-identity mismatch")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[1])
    ap.add_argument("--mesh", action="store_true",
                    help="also check a (1, 1) mesh against the plain engines")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)
    bad = 0
    for s in args.seeds:
        bad += fuzz_seed(s, args.device)
        if args.mesh:
            bad += fuzz_mesh(s, args.device)
        print(f"seed {s}: {'ok' if bad == 0 else 'FAILURES'}")
    print("FUZZ PASSED" if bad == 0 else f"FUZZ FAILED ({bad})")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
