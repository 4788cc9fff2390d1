"""Carry the PairHMM host state across to torch tensors.

The "weights" of PairHMM are its quality tables (``PairHMMContext``) and
the host packs (``PackedPairHMMBatch``, ``PackedPairHMMQuals``), whose
layout is the JAX package's.  These functions put them on a device with
no change of layout, so one pack feeds both packages.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from acc_genomics_tpu_torch.ops.pairhmm.context import PairHMMContext
from acc_genomics_tpu_torch.ops.pairhmm.pack import (
    PackedPairHMMBatch,
    PackedPairHMMQuals,
)


def _to(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def context_tables(
    ctx: PairHMMContext, device
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(ph2pr (128,), match_to_match (triangular), initial_constant ())
    in the context's dtype on ``device``."""
    return (
        _to(ctx.ph2pr, device),
        _to(ctx.match_to_match, device),
        torch.tensor(ctx.initial_constant, device=device),
    )


def batch_to_torch(pack: PackedPairHMMBatch, device) -> Tuple[torch.Tensor, ...]:
    """The 11 ``pack.arrays()`` (coefficient planes, rs, hap_ext, y0) in
    ``pairhmm_forward``'s argument order."""
    return tuple(_to(a, device) for a in pack.arrays())


def quals_to_torch(pack: PackedPairHMMQuals, device) -> Tuple[torch.Tensor, ...]:
    """(q, i, d, c, rs, hap_ext, rslen, haplen) in
    ``pairhmm_forward_from_quals``'s argument order."""
    return tuple(
        _to(a, device)
        for a in (pack.q, pack.i, pack.d, pack.c, pack.rs, pack.hap_ext,
                  pack.rslen, pack.haplen)
    )
