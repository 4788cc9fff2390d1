"""PairHMM byte planes built on the card from a batch's unique streams.

The flat route's byte planes are one time-major ``(6 * rows + cols, bp)``
uint8 region a bucket (q, i, d, c, rs, then hap_ext; the layout of
``native.pairhmm_pack_quals_flat``).  Packed on the host, each pair's read
is copied once for every haplotype it meets.  Here the batch's read and
haplotype streams go up once each, unpadded, with a side-band of each
lane's offsets and lengths and a table of the buckets, and one launch of
``csrc/pairhmm_gather.cu`` writes every bucket's region on the card.

``GatherLayout`` places the pieces in one staged buffer (one H2D copy)
and takes the forward kernel's views from the gathered buffer.
``pairhmm_gather`` given the upload on the CPU runs its plain PyTorch
version; given it on a card it launches the kernel on the current stream
(pointers into the upload, no tensor views to build) and adds one to
``kernel.LAUNCHES["pairhmm_gather"]``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from acc_genomics_tpu_torch import build
from acc_genomics_tpu_torch.ops.pairhmm.kernel import LAUNCHES
from acc_genomics_tpu_torch.utils.convert import HAP_PAD

TABLE_COLS = 5  # a bucket: region offset, rows, cols, bp, first lane
MAX_BUCKETS = 65535  # the kernel's grid.y

_SOURCES = ("ops/pairhmm/csrc/pairhmm_gather.cu",)
_P = ctypes.c_void_p
_I = ctypes.c_int


def build_kernels() -> build.BuiltLibrary:
    """Build (at first use) and load the gather's library."""
    built = build.load_library("pairhmm_gather", _SOURCES)
    lib = built.lib
    if lib.pairhmm_gather.argtypes is None:
        lib.pairhmm_gather.argtypes = [_P] * 10 + [_I, _I, _I, _P, _P]
        lib.pairhmm_gather.restype = ctypes.c_int
    return built


@dataclasses.dataclass
class GatherLayout:
    """One flat batch's upload and the map of its gathered planes.

    The staged buffer holds, at 8-byte aligned offsets: offs and hoffs of
    every lane (int64, launch order), the bucket table, meta (int32: each
    bucket's lens then hlens, the ``(2, bp)`` the forward kernel reads),
    then the streams q, i, d, c, rs and hap as given.  ``planes_bytes``:
    the gathered buffer, the buckets' regions back to back."""

    table: np.ndarray  # (n_buckets, TABLE_COLS) int64
    lanes: int
    planes_bytes: int
    table_at: int
    meta_at: int
    stream_at: Tuple[int, ...]  # q, i, d, c, rs, hap; the end last

    @classmethod
    def plan(cls, shapes: Sequence[Tuple[int, int, int]],
             stream_bytes: Sequence[int]) -> "GatherLayout":
        """``shapes``: (rows, cols, bp) of each bucket in launch order;
        ``stream_bytes``: the sizes of q, i, d, c, rs and hap."""
        table = np.zeros((len(shapes), TABLE_COLS), np.int64)
        region = lane = 0
        for b, (rows, cols, bp) in enumerate(shapes):
            table[b] = (region, rows, cols, bp, lane)
            region += (6 * rows + cols) * bp
            lane += bp
        table_at = 16 * lane  # after offs and hoffs
        meta_at = table_at + 8 * table.size
        stream_at = np.cumsum([meta_at + 8 * lane, *stream_bytes]).tolist()
        return cls(table, lane, region, table_at, meta_at, tuple(stream_at))

    @property
    def nbytes(self) -> int:
        return self.stream_at[-1]

    def fill(self, hv: np.ndarray, streams, offs, lens, hoffs, hlens, sels):
        """Write the upload into ``hv`` (uint8, ``nbytes``): ``streams``
        (q, i, d, c, rs, hap); ``sels``: each bucket's pairs in lane
        order, indexing offs, lens, hoffs and hlens."""
        lane_pairs = np.concatenate(sels) if len(sels) else np.zeros(0, np.int64)
        n = self.lanes
        side = hv[: self.table_at].view(np.int64)
        np.take(offs, lane_pairs, out=side[:n])
        np.take(hoffs, lane_pairs, out=side[n:])
        hv[self.table_at : self.meta_at].view(np.int64)[:] = self.table.reshape(-1)
        meta = hv[self.meta_at : self.meta_at + 8 * n].view(np.int32)
        for sel, (_, _, _, bp, lane0) in zip(sels, self.table):
            meta[2 * lane0 : 2 * lane0 + bp] = lens[sel]
            meta[2 * lane0 + bp : 2 * lane0 + 2 * bp] = hlens[sel]
        for s, a, b in zip(streams, self.stream_at, self.stream_at[1:]):
            hv[a:b] = s

    def meta(self, dev: torch.Tensor) -> torch.Tensor:
        """Every bucket's lens and hlens (int32) in the upload ``dev``."""
        return dev[self.meta_at : self.meta_at + 8 * self.lanes].view(torch.int32)

    def bucket(self, b: int, planes: torch.Tensor, dev: torch.Tensor):
        """Bucket ``b``'s q, i, d, c, rs, hap_ext, lens and hlens views."""
        region, rows, cols, bp, lane0 = (int(x) for x in self.table[b])
        view = planes[region : region + (6 * rows + cols) * bp].view(6 * rows + cols, bp)
        lens, hlens = self.meta(dev)[2 * lane0 : 2 * lane0 + 2 * bp].view(2, bp)
        return (*(view[k * rows : (k + 1) * rows] for k in range(5)), view[5 * rows :],
                lens, hlens)


def _gather_rows(src, offs, lens, nrow: int, pad: int) -> torch.Tensor:
    """(nrow, lanes): byte r of each lane's run of ``src`` for r < len,
    else ``pad``."""
    r = torch.arange(nrow, dtype=torch.int64, device=src.device)[:, None]
    ext = torch.cat([src, torch.tensor([pad], dtype=torch.uint8, device=src.device)])
    idx = torch.where(r < lens.to(torch.int64)[None, :], offs[None, :] + r, src.numel())
    return ext[idx]


def pairhmm_gather_plain(upload: torch.Tensor, layout: GatherLayout,
                         hap_pad: int = HAP_PAD) -> torch.Tensor:
    """``pairhmm_gather`` in plain PyTorch, on ``upload``'s device."""
    n = layout.lanes
    side = upload[: layout.table_at].view(torch.int64)
    table = upload[layout.table_at : layout.meta_at].view(torch.int64).view(-1, TABLE_COLS)
    streams = [upload[a:b] for a, b in zip(layout.stream_at, layout.stream_at[1:])]
    meta = layout.meta(upload)
    out = torch.empty(layout.planes_bytes, dtype=torch.uint8, device=upload.device)
    for region, rows, cols, bp, lane0 in table.tolist():
        lanes = slice(lane0, lane0 + bp)
        lens, hlens = meta[2 * lane0 : 2 * lane0 + 2 * bp].view(2, bp)
        view = out[region : region + (6 * rows + cols) * bp].view(6 * rows + cols, bp)
        for k, src in enumerate(streams[:5]):
            view[k * rows : (k + 1) * rows] = _gather_rows(src, side[:n][lanes], lens, rows, 0)
        view[5 * rows :] = _gather_rows(streams[5], side[n:][lanes], hlens, rows + cols,
                                        hap_pad)
    return out


def pairhmm_gather(upload: torch.Tensor, layout: GatherLayout,
                   hap_pad: int = HAP_PAD) -> torch.Tensor:
    """``(layout.planes_bytes,)`` uint8: bucket b's byte-plane region,
    ``(6 * rows + cols, bp)``, at byte ``layout.table[b, 0]`` (module
    docstring), from ``upload``: the 1-D uint8 buffer that
    ``layout.fill`` wrote, on the device.  The offsets, lengths and table
    in it are the layout's: the kernel reads and writes where they point."""
    if upload.dtype != torch.uint8 or upload.dim() != 1 or not upload.is_contiguous():
        raise ValueError("upload must be a contiguous 1-D uint8 tensor")
    if upload.numel() < layout.nbytes:
        raise ValueError(f"upload of {upload.numel()} bytes, the layout needs {layout.nbytes}")
    dev = upload.device
    if dev.type == "cpu":
        return pairhmm_gather_plain(upload, layout, hap_pad)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    base = upload.data_ptr()
    n_buckets = len(layout.table)
    if base % 8 or not n_buckets <= MAX_BUCKETS:
        raise ValueError(f"upload at {base:#x} (8-byte aligned), {n_buckets} buckets "
                         f"(at most {MAX_BUCKETS})")
    max_lanes = int(layout.table[:, 3].max()) if n_buckets else 0
    out = torch.empty(layout.planes_bytes, dtype=torch.uint8, device=dev)
    at = (*layout.stream_at[:6], 0, 8 * layout.lanes, layout.meta_at, layout.table_at)
    lib = build_kernels().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pairhmm_gather(
            *[ctypes.c_void_p(base + a) for a in at], n_buckets, max_lanes, int(hap_pad),
            ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream),
        )
        LAUNCHES["pairhmm_gather"] += 1
    if err != 0:
        raise RuntimeError(f"pairhmm_gather: CUDA launch failed with error {err}")
    return out
