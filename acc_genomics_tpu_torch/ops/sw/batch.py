"""One bucket of SW pairs: pack, launch the fill and the walk, decode.

The port of the launch/decode split of the JAX package's
``ops/sw/kernel.py`` (``sw_align_batch_launch`` / ``_decode``): the launch
returns the packed element buffer still on the device, so a caller can
launch many buckets and fetch all their buffers at once.  Pairs keep
their input order (no length sort: every pair runs its own trip count).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from acc_genomics_tpu_torch.ops.sw.kernel import sw_fill, sw_walk
from acc_genomics_tpu_torch.ops.sw.walker import decode_elements
from acc_genomics_tpu_torch.parallel.sharded_kernels import sw_device_dp
from acc_genomics_tpu_torch.ops.sw.reference import (
    DEFAULT_SW_PARAMS,
    SWParams,
    sw_align_oracle,
)

PAD_CODE = 255  # past each sequence; the kernels never read it


def pack_planes(seqs: Sequence[np.ndarray], width: int, out: np.ndarray) -> np.ndarray:
    """Write ``seqs`` as the rows of the uint8 plane ``out`` (len(seqs),
    width), padded with PAD_CODE; returns their int32 lengths.  One row
    copy per sequence: a single gather over a 4096 x 320 plane, with its
    index arrays, took about 7 times as long on the CPU."""
    lens = np.fromiter((len(s) for s in seqs), np.int32, len(seqs))
    if len(seqs) and int(lens.max()) > width:
        raise ValueError(f"sequence of length {int(lens.max())} exceeds bucket {width}")
    out.fill(PAD_CODE)
    for row, s, n in zip(out, seqs, lens):
        row[:n] = s
    return lens


@dataclasses.dataclass
class Launched:
    """A launched bucket: ``packed`` is the (SHIP_ELEMS + 2, B) int16
    buffer on the device; ``staged`` is the host buffer its inputs were
    uploaded from, kept alive until the caller has fetched."""

    packed: torch.Tensor
    staged: torch.Tensor


def _meta_at(n: int, rows: int, cols: int) -> int:
    """Where a bucket's int32 lengths start in its staging buffer (aligned)."""
    return -(-n * (rows + cols) // 16) * 16


def sw_align_batch_stage(refs, alts, rows: int, cols: int, pin: bool) -> torch.Tensor:
    """One bucket's staging buffer (pinned with ``pin``): the (n, rows)
    ref plane, the (n, cols) alt plane, then their int32 lengths."""
    n = len(refs)
    meta_at = _meta_at(n, rows, cols)
    staged = torch.empty(meta_at + 8 * n, dtype=torch.uint8, pin_memory=pin)
    hv = staged.numpy()
    meta = hv[meta_at:].view(np.int32).reshape(2, n)
    meta[0] = pack_planes(refs, rows, hv[: n * rows].reshape(n, rows))
    meta[1] = pack_planes(alts, cols, hv[n * rows : n * (rows + cols)].reshape(n, cols))
    return staged


def sw_align_batch_launch(
    refs, alts, strategy: int, rows: int, cols: int, device: torch.device,
    params: SWParams = DEFAULT_SW_PARAMS, mesh=None, staged=None,
) -> Launched:
    """Pack one bucket into a staging buffer (pinned on CUDA), upload it
    with one copy and launch the fill and the walk on the current stream,
    without fetching.  ``staged``: the bucket's buffer from
    ``sw_align_batch_stage``, packed here when None.  With a ``mesh`` the
    pairs run data-parallel over it (``sw_device_dp``) and ``packed``
    lands on its first device."""
    n = len(refs)
    if staged is None:
        staged = sw_align_batch_stage(refs, alts, rows, cols, device.type == "cuda")
    meta_at = _meta_at(n, rows, cols)
    dev = staged.to(device, non_blocking=True)
    ref = dev[: n * rows].view(n, rows)
    alt = dev[n * rows : n * (rows + cols)].view(n, cols)
    lens = dev[meta_at:].view(torch.int32).view(2, n)
    if mesh is not None:
        return Launched(sw_device_dp(mesh, ref, alt, lens[0], lens[1], strategy, params),
                        staged)
    btrack, lastrow, altcol = sw_fill(ref, alt, lens[0], lens[1], strategy, params)
    packed = sw_walk(btrack, lastrow, altcol, lens[0], lens[1], strategy)
    return Launched(packed, staged)


def sw_align_batch_decode(
    packed_np: np.ndarray, refs, alts, strategy: int,
    params: SWParams = DEFAULT_SW_PARAMS,
) -> List[Tuple[list, int]]:
    """Host half: decode a fetched packed buffer into per-pair (cigar,
    offset), rerunning element-overflow pairs on the oracle."""
    out, overflow = decode_elements(packed_np, len(refs))
    for k in np.flatnonzero(overflow):
        out[k] = sw_align_oracle(refs[k], alts[k], strategy, params=params)
    return out
