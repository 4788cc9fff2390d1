"""Sequencing reads of a sample drawn against a genome, vectorised.

The sample differs from the genome by heterozygous SNPs and small
indels (a read carries each with probability one half, so the per-base
rates a read sees are half the sample's); the sequencer adds
substitutions and N calls.  Half of the reads come from the reverse
strand.  Read starts are uniform over the genome (``origin`` "uniform")
or uniform over the bases of the planted copies of the named repeat
families (``origin`` "repeats").
"""

from __future__ import annotations

import numpy as np


def read_starts(rng, n: int, glen: int, span: int, mix: dict, copies: dict) -> np.ndarray:
    if mix["origin"] == "uniform":
        return rng.integers(0, glen - span, n)
    if mix["origin"] != "repeats":
        raise ValueError(f"unknown read origin {mix['origin']!r}")
    starts = np.concatenate([copies[f][0] for f in mix["families"]])
    lens = np.concatenate([copies[f][1] for f in mix["families"]])
    room = np.maximum(lens - span + 1, 0)
    keep = (room > 0) & (starts + span <= glen)
    starts, room = starts[keep], room[keep]
    k = np.searchsorted(np.cumsum(room), rng.integers(0, int(room.sum()), n), side="right")
    return starts[k] + rng.integers(0, room[k])


def make_reads(rng, genome: np.ndarray, copies: dict, mix: dict, n: int) -> np.ndarray:
    """(n, read_len) uint8 codes (4 = N)."""
    rl = int(mix["read_len"])
    lo, hi = mix["indel_len"]
    span = rl + hi
    starts = read_starts(rng, n, len(genome), span, mix, copies)
    win = genome[starts[:, None] + np.arange(span)[None, :]]
    reads = win[:, :rl].copy()
    # a small indel a read carries (het: half of the sample's rate)
    has = rng.random(n) < 1 - (1 - mix["het_indel"] / 2) ** rl
    for k in np.flatnonzero(has):
        pos = int(rng.integers(1, rl - 1))
        ln = int(rng.integers(lo, hi + 1))
        if rng.random() < 0.5:  # deletion
            reads[k] = np.concatenate([win[k, :pos], win[k, pos + ln: pos + ln + rl - pos]])
        else:
            ins = rng.integers(0, 4, ln).astype(np.uint8)
            reads[k] = np.concatenate([win[k, :pos], ins, win[k, pos:]])[:rl]
    snp = rng.random(reads.shape) < mix["het_snp"] / 2 + mix["sub_error"]
    reads[snp] = (reads[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
    rev = rng.random(n) < 0.5
    reads[rev] = 3 - reads[rev, ::-1]
    reads[rng.random(reads.shape) < mix["n_rate"]] = 4
    return reads
