"""Time-major packing of variable-length code sequences (the SMEM and
extension engines' read, query and target planes)."""

from __future__ import annotations

import numpy as np


def pack_rows(seqs, L: int, bsz: int):
    """Pad-pack a list of 1-D code arrays into a row-major (bsz, L) uint8
    buffer (pad 4) with one scatter; returns (buf, lens (len(seqs),)
    int32).  The flat index of sequence j's element i is j * L + i, built
    by one cumsum (the JAX extend engine's ``_pack_tm``).  Negative-stride
    views (the reversed left queries and targets) concatenate as they
    are."""
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
    return flat.reshape(bsz, L), lens.astype(np.int32)


def pack_tm(seqs, L: int, bsz: int):
    """``pack_rows`` transposed: a time-major (L, bsz) uint8 buffer."""
    rows, lens = pack_rows(seqs, L, bsz)
    return np.ascontiguousarray(rows.T), lens
