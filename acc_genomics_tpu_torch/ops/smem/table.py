"""The fused FM-index probe table of the SMEM kernel.

The ``occ_rate=64`` table of the JAX package's ``device_index_fused``
(``ops/smem/machine.py:76-127``, a module that imports jax), built with
numpy: row r = [cnt0..3, word0..3] int32, the occurrence counts of A, C,
G and T before BWT block r and the block's 64 bases as four big-endian
2-bit packed words (16 bases a word, ``FMIndex.bwt_packed``).  One probe
of the kernel reads one 32-byte row.  The native host engine
(``native.smem_collect_host``) reads the same layout.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from acc_genomics_tpu_torch.ops.smem.index import FMIndex


def probe_table(fm: FMIndex) -> np.ndarray:
    """(nblk, 8) int32 rows [cnt0..3, word0..3]."""
    if fm.seq_len >= 2**31 - 1:
        raise ValueError(f"text of {fm.seq_len} bases: int32 counts overflow")
    nblk = fm.bwt_packed.shape[0]
    tbl = np.empty((nblk, 8), np.int32)
    tbl[:, :4] = fm.occ_ckpt[:nblk].astype(np.int32)
    tbl[:, 4:] = fm.bwt_packed.view(np.int32)
    return tbl


@dataclasses.dataclass
class DeviceIndex:
    """The probe table, the cumulative counts and the sentinel row of an
    index, on one device."""

    tbl: torch.Tensor  # (nblk, 8) int32
    l2: torch.Tensor  # (5,) int32: L2[c] = bases of the text below c
    l2_values: Tuple[int, ...]  # the same five counts on the host
    primary: int  # BWT row of the full-text suffix (skipped in the BWT)

    @classmethod
    def build(cls, fm: FMIndex, device) -> "DeviceIndex":
        """Put the index on ``device`` once."""
        tbl = torch.from_numpy(probe_table(fm)).to(device)
        l2 = torch.from_numpy(fm.L2.astype(np.int32)).to(device)
        return cls(tbl, l2, tuple(int(v) for v in fm.L2), int(fm.primary))
