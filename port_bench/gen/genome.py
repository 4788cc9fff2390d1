"""A synthetic, N-free genome with a human-like repeat spectrum.

Grown from the repo's ``gen_reference_with_repeats`` (random bases with
planted exact repeats): the background is drawn base by base at the
configured GC share, then copies of four families are written over it,
each copy on a random strand and diverged from its source by its own
substitution rate:

* Alu-like: copies of 300 bases from a few subfamily consensi;
* L1-like: 3' ends of a 6 kb consensus, 5'-truncated to log-uniform
  lengths;
* segmental duplications: copies of segments of the genome itself (after
  the transposons, so they carry them), log-uniform lengths;
* microsatellites: units of 1-6 bases repeated over 20-100 bases.

Every step is vectorised; the genome of 64 Mbp takes seconds.  The seed
is the configuration's, not the run's: the genome is the deployment.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

FAMILIES = ("alu", "l1", "segdup", "microsat")


def _bases(rng, n: int, gc: float) -> np.ndarray:
    p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    return rng.choice(4, size=n, p=p).astype(np.uint8)


def _lengths(rng, spec: dict, target: int) -> np.ndarray:
    """Copy lengths until their sum reaches ``target`` bases."""
    lo, hi = spec["len"]
    est = max(int(target / max((lo + hi) / 4, 1)) + 16, 16)
    while True:
        if spec.get("log_uniform"):
            lens = np.exp(rng.uniform(np.log(lo), np.log(hi), est)).astype(np.int64)
        else:
            lens = rng.integers(lo, hi + 1, est)
        csum = np.cumsum(lens)
        if csum[-1] >= target:
            return lens[: int(np.searchsorted(csum, target)) + 1]
        est *= 2


def _write(genome, rng, src_idx_fn, lens, spec) -> np.ndarray:
    """Write copies of lengths ``lens`` at random places; ``src_idx_fn(
    copy_id, local)`` gives each base's source.  Returns their starts."""
    n = len(genome)
    lens = np.minimum(lens, n)
    starts = rng.integers(0, n - lens + 1)
    rev = rng.random(len(lens)) < 0.5
    div = rng.uniform(*spec["divergence"], len(lens))
    cid = np.repeat(np.arange(len(lens)), lens)
    local = np.arange(len(cid)) - np.repeat(np.cumsum(lens) - lens, lens)
    read_local = np.where(rev[cid], lens[cid] - 1 - local, local)
    seq = src_idx_fn(cid, read_local)
    seq = np.where(rev[cid], 3 - seq, seq).astype(np.uint8)
    mut = rng.random(len(seq)) < div[cid]
    seq[mut] = (seq[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
    genome[starts[cid] + local] = seq
    return starts


def make_genome(spec: dict) -> Tuple[np.ndarray, Dict[str, Tuple[np.ndarray, np.ndarray]]]:
    """(genome (length,) uint8 codes 0..3, {family: (starts, lengths)} of
    the planted copies) for the configuration's ``genome`` block."""
    rng = np.random.default_rng(int(spec["seed"]))
    n = int(spec["length"])
    gc = float(spec["gc"])
    genome = _bases(rng, n, gc)
    fams = spec["families"]
    copies = {}

    f = fams["alu"]
    cons = _bases(rng, f["subfamilies"] * f["unit"], gc).reshape(f["subfamilies"], f["unit"])
    lens = np.full(int(f["fraction"] * n / f["unit"]) + 1, f["unit"], np.int64)
    sub = rng.integers(0, f["subfamilies"], len(lens))
    copies["alu"] = (_write(genome, rng, lambda c, j: cons[sub[c], j], lens, f), lens)

    f = fams["l1"]
    cons1 = _bases(rng, f["unit"], gc)
    lens = _lengths(rng, f, int(f["fraction"] * n))
    copies["l1"] = (_write(genome, rng, lambda c, j: cons1[f["unit"] - lens[c] + j],
                           lens, f), lens)

    f = fams["segdup"]
    lens = _lengths(rng, f, int(f["fraction"] * n))
    src = rng.integers(0, n - lens + 1)
    snapshot = genome.copy()
    copies["segdup"] = (_write(genome, rng, lambda c, j: snapshot[src[c] + j], lens, f),
                        lens)
    del snapshot

    f = fams["microsat"]
    lens = _lengths(rng, f, int(f["fraction"] * n))
    ulen = rng.integers(f["unit_len"][0], f["unit_len"][1] + 1, len(lens))
    units = _bases(rng, len(lens) * 6, gc).reshape(len(lens), 6)
    copies["microsat"] = (_write(genome, rng, lambda c, j: units[c, j % ulen[c]], lens, f),
                          lens)
    return genome, copies
