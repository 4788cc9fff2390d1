"""Synthetic HaplotypeCaller active regions.

``gen_region`` is the generator of ``drivers/hc_driver.py`` (which cannot
be imported without JAX): the same draws from the same generator, so one
seed gives the same regions in both packages.
"""

from __future__ import annotations

import numpy as np


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
