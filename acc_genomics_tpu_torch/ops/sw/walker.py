"""Host decode of the packed walk buffer.

The port of ``decode_elements`` of the JAX package's ``ops/sw/walker.py``
(which imports jax): the same results, overflow mask included, gathered
with whole-array NumPy operations instead of a loop over NumPy scalars
(half the time at 8192 pairs of a few elements each).
"""

from __future__ import annotations

import numpy as np

from acc_genomics_tpu_torch.ops.sw.kernel import SHIP_ELEMS


def decode_elements(packed, n_real):
    """Packed walk-order element buffer (SHIP_ELEMS+2, B) -> [(cigar,
    offset)] in CIGAR order.  Returns (results, overflow mask); overflow
    pairs (more than SHIP_ELEMS elements) are None and need a host rerun."""
    packed = np.asarray(packed)
    overflow = packed[SHIP_ELEMS] > SHIP_ELEMS
    keep = ~overflow[:n_real]
    n = np.where(keep, packed[SHIP_ELEMS, :n_real], 0).astype(np.int64)
    ends = np.cumsum(n)
    starts = ends - n
    # every kept element in one flat list, CIGAR order within each pair:
    # flat entry r of pair k is its walk slot ends[k] - 1 - r
    pair = np.repeat(np.arange(n_real), n)
    codes = packed[ends[pair] - 1 - np.arange(len(pair)), pair]
    flat = list(zip((codes & 0x0FFF).tolist(), ((codes >> 12) & 0x7).tolist()))
    offset = packed[SHIP_ELEMS + 1, :n_real].tolist()
    out = [
        (flat[s:e], o) if k else None
        for s, e, o, k in zip(starts.tolist(), ends.tolist(), offset, keep.tolist())
    ]
    return out, overflow
