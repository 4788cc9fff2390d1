"""HaplotypeCaller active regions, vectorised.

Grown from the repo's ``gen_region`` (a reference window, haplotypes
with variants, reads drawn from the haplotypes): the shapes here are a
WGS deployment's.  Per region: an active region of uniform length, padded
on both sides into the reference window.  The sample's variant sites in
the window: one inside the active region (the one that made it active)
and a Poisson number more at the configured rate, each a SNP or, at the
configured share, a short insertion or deletion.  The assembly graph of
``v`` separate sites is a chain of ``v`` bubbles, so the haplotypes are
every combination of reference and alternate alleles: ``2**v``, the
first the reference window, up to ``max_haplotypes``.  Reads of the
configured length start anywhere they overlap a haplotype, as many as
the coverage puts there, and are hard-clipped to it (to the padded
window); clipped reads shorter than ``min_read_len`` are dropped.  Base
qualities are binned, substitutions at the configured error rate,
indel and gap-continuation qualities constant.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _sites(rng, active: int, pad: int, v: dict) -> list:
    """[(position, kind, length)] of a region's variant sites in window
    coordinates, sorted, at least ``max indel length + 1`` apart; kind 0
    SNP, 1 insertion, 2 deletion."""
    win = active + 2 * pad
    lo, hi = v["indel_len"]
    gap = hi + 1
    pos = [pad + int(rng.integers(0, active))]
    pos += rng.integers(1, win - gap, rng.poisson(v["rate"] * win)).tolist()
    kept = []
    for p in sorted(pos):
        if not kept or p - kept[-1] >= gap:
            kept.append(p)
    kept = kept[: int(np.log2(v["max_haplotypes"]))]
    out = []
    for p in kept:
        if rng.random() < v["indel_share"]:
            out.append((p, 1 + int(rng.random() < 0.5), int(rng.integers(lo, hi + 1))))
        else:
            out.append((p, 0, 0))
    return out


def _haplotypes(rng, ref: np.ndarray, sites: list) -> List[np.ndarray]:
    """Every combination of the sites' alleles; haplotype ``h`` carries
    site ``i``'s alternate where bit ``i`` of ``h`` is set."""
    alts = []
    for p, kind, ln in sites:
        if kind == 0:
            alts.append(np.array([(int(ref[p]) + int(rng.integers(1, 4))) % 4], np.uint8))
        elif kind == 1:
            alts.append(np.concatenate([ref[p:p + 1], rng.integers(0, 4, ln).astype(np.uint8)]))
        else:
            alts.append(ref[p:p + 1])
    haps = []
    for h in range(1 << len(sites)):
        parts, at = [], 0
        for i, (p, kind, ln) in enumerate(sites):
            if h >> i & 1:
                parts += [ref[at:p], alts[i]]
                at = p + 1 + (ln if kind == 2 else 0)
        parts.append(ref[at:])
        haps.append(np.concatenate(parts).astype(np.uint8))
    return haps


def make_regions(rng, cfg: dict, n: int) -> List[Tuple[np.ndarray, List[np.ndarray], List[dict]]]:
    """``n`` regions [(reference window, haplotypes, reads)], each read a
    dict of rs, q, i, d, c uint8 arrays (views into shared buffers)."""
    r, v, a = cfg["region"], cfg["variants"], cfg["assumed"]
    rl, pad = int(r["read_len"]), int(r["padding"])
    act = rng.integers(r["active_min"], r["active_max"] + 1, n)
    win = act + 2 * pad
    gc = a["gc"]
    p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]
    refs = [rng.choice(4, size=int(w), p=p).astype(np.uint8) for w in win]
    haps = [_haplotypes(rng, ref, _sites(rng, int(ac), pad, v)) for ref, ac in zip(refs, act)]
    n_haps = np.array([len(h) for h in haps])

    # reads over each region's haplotypes: every start that overlaps one
    n_draw = rng.poisson(r["coverage"] * (win + rl - 1) / rl)
    tot = int(n_draw.sum())
    region = np.repeat(np.arange(n), n_draw)
    hap_k = (rng.random(tot) * n_haps[region]).astype(np.int64)
    flat = np.concatenate([h for hs in haps for h in hs])
    hlen = np.array([len(h) for hs in haps for h in hs])
    first = np.cumsum(n_haps) - n_haps  # each region's first haplotype
    g = first[region] + hap_k
    hoff = np.cumsum(hlen) - hlen
    start = (rng.random(tot) * (hlen[g] + rl - 1)).astype(np.int64) - (rl - 1)
    pos = start[:, None] + np.arange(rl)[None, :]
    rs = flat[hoff[g][:, None] + np.clip(pos, 0, hlen[g][:, None] - 1)]
    a_clip = np.maximum(0, -start)
    b_clip = np.minimum(rl, hlen[g] - start)

    bins, probs = zip(*a["base_quals"])
    q = np.asarray(bins, np.uint8)[
        rng.choice(len(bins), size=(tot, rl), p=np.asarray(probs) / np.sum(probs))]
    err = rng.random((tot, rl)) < a["read_error"]
    rs[err] = (rs[err] + rng.integers(1, 4, int(err.sum()))) % 4
    iq = np.full((tot, rl), r["indel_qual"], np.uint8)
    c = np.full((tot, rl), r["gcp"], np.uint8)

    keep = (b_clip - a_clip >= int(r["min_read_len"])).tolist()
    lo, hi = a_clip.tolist(), b_clip.tolist()
    out, k = [], 0
    for j in range(n):
        reads = []
        for t in range(k, k + int(n_draw[j])):
            if keep[t]:
                s = slice(lo[t], hi[t])
                qi = iq[t, s]
                reads.append(dict(rs=rs[t, s], q=q[t, s], i=qi, d=qi, c=c[t, s]))
        k += int(n_draw[j])
        out.append((refs[j], haps[j], reads))
    return out
