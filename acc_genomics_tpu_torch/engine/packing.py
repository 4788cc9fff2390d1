"""Time-major packing of variable-length code sequences (the SMEM and
extension engines' read, query and target planes)."""

from __future__ import annotations

import numpy as np


def pack_tm(seqs, L: int, bsz: int):
    """Pad-pack a list of 1-D code arrays into a time-major (L, bsz) uint8
    buffer (pad 4) with one scatter; returns (buf, lens (len(seqs),)
    int32).  A copy of the JAX extend engine's ``_pack_tm``: the flat
    index of sequence j's element i is j * L + i, built by one cumsum, and
    one transpose restores time-major.  Negative-stride views (the
    reversed left queries and targets) concatenate as they are."""
    n = len(seqs)
    lens = np.fromiter((len(s) for s in seqs), np.int64, n)
    tot = int(lens.sum())
    flat = np.full(bsz * L, 4, np.uint8)
    if tot:
        cat = np.concatenate(seqs).astype(np.uint8, copy=False)
        jarr = np.flatnonzero(lens)
        lnz = lens[jarr]
        d = np.ones(tot, np.int64)
        d[0] = jarr[0] * L
        if len(jarr) > 1:
            d[np.cumsum(lnz[:-1])] = (jarr[1:] - jarr[:-1]) * L - lnz[:-1] + 1
        flat[np.cumsum(d)] = cat
    return np.ascontiguousarray(flat.reshape(bsz, L).T), lens.astype(np.int32)
