"""Synthetic workload generators mirroring the reference test programs.

* PairHMM: reads with N(30,5) base quals (floor 6), N(40,1) indel GOPs
  (floor 1), constant GCP 10, uniform lengths in [cap/4, cap]
  (pairhmm/xlnx/pairhmm_test.cpp:21-82).
* SW (HTC): random ~refLen reference, alts = ref with +-5% length jitter and
  10% point mutations (htc-sw/host/sw_host.cpp:145-182).
* SMEM: random A/C/G/T reads over a random reference with embedded exact
  repeats so SMEMs of useful length exist.
* HaplotypeCaller: active regions (``gen_region``, the generator of
  ``drivers/hc_driver.py``).

A copy of the JAX package's ``io/synth.py`` plus ``gen_region``: the same
draws from the same generator, so one seed gives the same data in both
packages.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def gen_pairhmm_input(
    rng: np.random.Generator,
    n_reads: int,
    n_haps: int,
    max_read_len: int = 191,
    max_hap_len: int = 1024,
    min_read_len: int | None = None,
    derived: bool = False,
    error_rate: float = 0.01,
):
    """Returns (reads, haps): reads is a list of dicts with rs/q/i/d/c arrays,
    haps a list of base-code arrays.

    derived=False generates independent random reads and haps like the
    reference's GenInputs (pairhmm/xlnx/pairhmm_test.cpp:21-82) — nearly
    every pair then underflows fp32 (P(read|hap) ~ 4^-len), which stresses
    the fp64 recompute path.  derived=True samples each read from a random
    haplotype window with ~error_rate mutations — the realistic GATK shape
    where recompute is the exception.
    """
    haps = []
    if derived:
        # GATK haplotypes are assembled variants of ONE locus: generate a
        # base sequence and emit haps as SNP/indel variants of it, so every
        # (read, hap) pair aligns (recompute stays the exception)
        base_len = int(rng.integers(max(2, max_hap_len // 2), max_hap_len + 1))
        base = rng.integers(0, 4, base_len).astype(np.uint8)
        for _ in range(n_haps):
            h = base.copy()
            snp = rng.random(len(h)) < 0.005
            h[snp] = (h[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
            if rng.random() < 0.5 and len(h) > 8:  # one short indel variant
                pos = int(rng.integers(1, len(h) - 4))
                if rng.random() < 0.5:
                    h = np.delete(h, slice(pos, pos + int(rng.integers(1, 4))))
                else:
                    ins = rng.integers(0, 4, int(rng.integers(1, 4))).astype(np.uint8)
                    h = np.insert(h, pos, ins)
            haps.append(h[:max_hap_len].astype(np.uint8))
    else:
        for _ in range(n_haps):
            ln = int(rng.integers(max(1, max_hap_len // 4), max_hap_len + 1))
            haps.append(rng.integers(0, 4, ln).astype(np.uint8))
    reads = []
    lo_r = min_read_len if min_read_len is not None else max(1, max_read_len // 4)
    for _ in range(n_reads):
        ln = int(rng.integers(lo_r, max_read_len + 1))
        if derived:
            h = haps[int(rng.integers(0, n_haps))]
            if len(h) >= ln:
                off = int(rng.integers(0, len(h) - ln + 1))
                rs = h[off : off + ln].copy()
            else:
                rs = np.resize(h, ln).copy()
            err = rng.random(ln) < error_rate
            rs[err] = (rs[err] + rng.integers(1, 4, int(err.sum()))) % 4
        else:
            rs = rng.integers(0, 4, ln).astype(np.uint8)
        reads.append(
            dict(
                rs=rs,
                q=np.clip(rng.normal(30.0, 5.0, ln), 6, 127).astype(np.uint8),
                i=np.clip(rng.normal(40.0, 1.0, ln), 1, 127).astype(np.uint8),
                d=np.clip(rng.normal(40.0, 1.0, ln), 1, 127).astype(np.uint8),
                c=np.full(ln, 10, dtype=np.uint8),
            )
        )
    return reads, haps


def gen_pairhmm_pairs(rng, n_pairs, max_read_len=63, max_hap_len=128):
    """Flat list of independent (read, hap) testcases for kernel tests."""
    reads, haps = gen_pairhmm_input(
        rng, n_pairs, n_pairs, max_read_len, max_hap_len
    )
    return [dict(hap=haps[k], **reads[k]) for k in range(n_pairs)]


def gen_sw_batch(
    rng: np.random.Generator,
    batch: int,
    ref_len: int = 286,
    mutation_rate: float = 0.10,
    len_jitter: float = 0.05,
) -> Tuple[np.ndarray, List[np.ndarray]]:
    """(ref_codes, [alt_codes...]) in PairHMM base coding (no Ns)."""
    ref = rng.integers(0, 4, ref_len).astype(np.uint8)
    alts = []
    for _ in range(batch):
        jitter = int(rng.integers(-int(ref_len * len_jitter), int(ref_len * len_jitter) + 1))
        ln = max(8, ref_len + jitter)
        if ln <= ref_len:
            alt = ref[:ln].copy()
        else:
            alt = np.concatenate([ref, rng.integers(0, 4, ln - ref_len).astype(np.uint8)])
        mut = rng.random(ln) < mutation_rate
        alt[mut] = (alt[mut] + rng.integers(1, 4, mut.sum())) % 4
        alts.append(alt.astype(np.uint8))
    return ref, alts


def gen_reference_with_repeats(
    rng: np.random.Generator, length: int, repeat_len: int = 40, n_repeats: int = 8
) -> np.ndarray:
    """Random nt4 genome with planted repeats (so SMEM searches hit
    multi-occurrence intervals, not just unique matches)."""
    genome = rng.integers(0, 4, length).astype(np.uint8)
    if n_repeats > 1 and length > 4 * repeat_len:
        motif = rng.integers(0, 4, repeat_len).astype(np.uint8)
        for _ in range(n_repeats):
            pos = int(rng.integers(0, length - repeat_len))
            genome[pos : pos + repeat_len] = motif
    return genome


def gen_smem_reads(
    rng: np.random.Generator,
    genome: np.ndarray,
    n_reads: int,
    read_len: int = 101,
    error_rate: float = 0.01,
    ambig_rate: float = 0.002,
) -> List[np.ndarray]:
    """Reads sampled from the genome with point errors and occasional Ns."""
    reads = []
    glen = len(genome)
    for _ in range(n_reads):
        pos = int(rng.integers(0, max(1, glen - read_len)))
        read = genome[pos : pos + read_len].copy()
        err = rng.random(len(read)) < error_rate
        read[err] = (read[err] + rng.integers(1, 4, err.sum())) % 4
        amb = rng.random(len(read)) < ambig_rate
        read[amb] = 4
        reads.append(read.astype(np.uint8))
    return reads


def gen_region(rng, ref_len=300, n_haps=4, n_reads=24, read_len=101):
    """(ref, haps, reads, src): a reference window, ``n_haps`` haplotypes
    (1% SNPs, half with a 1-3 base indel), and reads sampled from them with
    0.5% base errors; ``src`` is each read's source haplotype."""
    ref = rng.integers(0, 4, ref_len).astype(np.uint8)
    haps = []
    for _ in range(n_haps):
        h = ref.copy()
        snp = rng.random(len(h)) < 0.01
        h[snp] = (h[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
        if rng.random() < 0.5:
            pos = int(rng.integers(1, len(h) - 4))
            if rng.random() < 0.5:
                h = np.delete(h, slice(pos, pos + int(rng.integers(1, 4))))
            else:
                ins = rng.integers(0, 4, int(rng.integers(1, 4))).astype(np.uint8)
                h = np.insert(h, pos, ins)
        haps.append(h.astype(np.uint8))
    reads = []
    src = []
    for _ in range(n_reads):
        k = int(rng.integers(0, n_haps))
        h = haps[k]
        off = int(rng.integers(0, max(1, len(h) - read_len)))
        rs = h[off : off + read_len].copy()
        err = rng.random(len(rs)) < 0.005
        rs[err] = (rs[err] + rng.integers(1, 4, int(err.sum()))) % 4
        reads.append(
            dict(
                rs=rs,
                q=np.clip(rng.normal(30, 5, len(rs)), 6, 127).astype(np.uint8),
                i=np.clip(rng.normal(40, 1, len(rs)), 1, 127).astype(np.uint8),
                d=np.clip(rng.normal(40, 1, len(rs)), 1, 127).astype(np.uint8),
                c=np.full(len(rs), 10, np.uint8),
            )
        )
        src.append(k)
    return ref, haps, reads, src
