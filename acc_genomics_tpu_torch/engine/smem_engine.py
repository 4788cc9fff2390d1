"""Single-card SMEM engine: the FM-index probe table resident on the card,
batched 3-pass collection.

The port of ``acc_genomics_tpu/engine/smem_engine.py`` on its single-
device route:

* the probe table goes to the card once, at construction;
* reads group by length bucket (``config.read_buckets`` up to
  ``config.seq_length``) and launch in batches of at most
  ``config.batch_size`` reads, one thread a read;
* every batch is staged, then every batch launched, before anything is
  fetched; then one small D2H copy brings every read's count, flag and
  probe count, and one more brings exactly the live intervals, gathered
  on the card; with no interval anywhere nothing is gathered or copied;
* ``retry_arrays`` gives reads the kernel flagged (a chain or the output
  past its cap) a second launch at caps taken from their batch (chains
  as long as the widest read, the output at ``max_intv_alloc``), and only
  reads past ``seq_length`` and what that launch still flags take the
  native host engine;
* with a ``mesh``, the probe table goes to each of its distinct devices
  once and each batch's reads run data-parallel over its "data" axis
  (``parallel/sharded_kernels.smem_collect_dp``), on the same kernel.

The TPU engine's multi-read lanes, 2-bit read pool and ragged-gather
bucketing exist because of lockstep lanes and a slow link; the port has
neither.  On ``device="cpu"`` the same route runs the kernel's plain
version.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from acc_genomics_tpu_torch.build import ensure_native
from acc_genomics_tpu_torch.device import resolve_device
from acc_genomics_tpu_torch.engine.packing import pack_tm
from acc_genomics_tpu_torch.ops.smem.kernel import chain_room, smem_collect
from acc_genomics_tpu_torch.ops.smem.table import DeviceIndex
from acc_genomics_tpu_torch import native
from acc_genomics_tpu_torch.config import SmemConfig
from acc_genomics_tpu_torch.parallel.sharded_kernels import replicate_index, smem_collect_dp
from acc_genomics_tpu_torch.ops.smem.index import FMIndex
from acc_genomics_tpu_torch.ops.smem.reference import mem_collect_intv_oracle
from acc_genomics_tpu_torch.utils.timer import Timer


def _iv_array(ivs: List[dict]) -> np.ndarray:
    """Interval dicts -> (k, 5) int64 [x0, x1, s, start, end]."""
    return np.array([[iv["x0"], iv["x1"], iv["s"], iv["start"], iv["end"]] for iv in ivs],
                    np.int64).reshape(-1, 5)


def merge_intervals(flat, counts, idx, sub_flat, sub_counts):
    """Read-major intervals with those of reads ``idx`` (none of them in
    ``flat``) taken from ``sub_flat``, read-major over ``idx``, and
    ``sub_counts``."""
    src = np.cumsum(counts) - counts  # each read's first row in the sources
    src[idx] = len(flat) + np.cumsum(sub_counts) - sub_counts
    counts = counts.copy()
    counts[idx] = sub_counts
    rows = np.repeat(src - (np.cumsum(counts) - counts), counts)
    rows += np.arange(len(rows))
    return np.concatenate([flat, sub_flat])[rows], counts


def split_dicts(flat: np.ndarray, counts: np.ndarray) -> List[List[dict]]:
    """(tot, 5) intervals, read-major, and per-read counts -> per-read
    lists of interval dicts (one ``tolist`` for the whole batch)."""
    ivs = [{"x0": a, "x1": b, "s": c, "start": d, "end": e}
           for a, b, c, d, e in flat.tolist()]
    out, o = [], 0
    for c in counts.tolist():
        out.append(ivs[o:o + c])
        o += c
    return out


class SmemEngine:
    """3-pass SMEM intervals per read, exact and in the oracle's order."""

    def __init__(self, fm: FMIndex, config: SmemConfig = SmemConfig(), device="cuda",
                 mesh=None):
        self.fm = fm
        self.config = config
        self.device = resolve_device(device)
        self.mesh = mesh
        if not ensure_native():
            raise RuntimeError(
                "the native host library (acc_genomics_tpu_torch/native) is "
                "unavailable: the host reruns need it"
            )
        with Timer("smem.index_upload"):
            if mesh is not None:
                self.indexes = replicate_index(mesh, fm)
            else:
                self.index = DeviceIndex.build(fm, self.device)
        self.params = config.params()
        # probe_iters: FM-index extensions taken on the card (two occ
        # probes each), summed over reads; retry_host: reads that
        # retry_arrays handed to the native host engine
        self.stats = {"reads": 0, "overflow_reruns": 0, "probe_iters": 0, "retry_host": 0}
        # the bytes each call moves over the link
        self.anatomy = dict(h2d_bytes=0, d2h_bytes=0)

    def reset_anatomy(self):
        for k in self.anatomy:
            self.anatomy[k] = 0

    def _buckets(self) -> Tuple[int, ...]:
        """The read buckets below ``seq_length``, then ``seq_length`` itself
        (so every read up to it has a bucket)."""
        seq_len = self.config.seq_length
        return tuple(b for b in sorted(self.config.read_buckets) if b < seq_len) + (seq_len,)

    def _stage(self, seq_tm: np.ndarray, lens: np.ndarray) -> torch.Tensor:
        """One batch in one buffer (pinned on CUDA): the int32 lengths,
        then the (L, n) plane."""
        L, n = seq_tm.shape
        staged = torch.empty(4 * n + L * n, dtype=torch.uint8,
                             pin_memory=self.device.type == "cuda")
        hv = staged.numpy()
        hv[: 4 * n].view(np.int32)[:] = lens
        hv[4 * n:].reshape(L, n)[:] = seq_tm
        return staged

    def _launch(self, staged: torch.Tensor, L: int, n: int, params):
        """Upload one staged batch and launch the kernel; nothing is
        fetched."""
        dev = staged.to(self.device, non_blocking=True)
        self.anatomy["h2d_bytes"] += staged.numel()
        seq, lens = dev[4 * n:].view(L, n), dev[: 4 * n].view(torch.int32)
        if self.mesh is not None:
            return smem_collect_dp(self.mesh, self.indexes, seq, lens, params)
        return smem_collect(self.index, seq, lens, params)

    def _run(self, batches: Sequence[Tuple[np.ndarray, np.ndarray]], params=None):
        """Stage and launch every (seq_tm, lens) batch at ``params`` (the
        engine's by default), then fetch: (flat (tot, 5) int64 [x0, x1, s,
        start, end] read-major over all batches, counts (N,) int64, flags
        (N,) bool), reads in batch order.  Flagged reads count 0."""
        params = self.params if params is None else params
        with Timer("smem.pack"):
            staged = [self._stage(seq, lens) for seq, lens in batches]
        with Timer("smem.launch"):
            launched = [self._launch(st, *seq.shape, params)
                        for st, (seq, _) in zip(staged, batches)]
        if not launched:
            return np.zeros((0, 5), np.int64), np.zeros(0, np.int64), np.zeros(0, bool)
        # the counts' D2H copy waits for the kernels
        with Timer("smem.wait"):
            counts_dev = torch.cat([torch.stack(o[1:]) for o in launched], 1)
            counts = counts_dev.cpu().numpy()
        self.anatomy["d2h_bytes"] += counts.nbytes
        with Timer("smem.fetch"):
            self.stats["probe_iters"] += int(counts[2].sum(dtype=np.int64))
            flags = counts[1] != 0
            live = np.where(flags, 0, counts[0]).astype(np.int64)
            tot = int(live.sum())
            flat = np.zeros((0, 5), np.int64)
            if tot:
                parts, col = [], 0
                for mem, mem_n, flag, _ in launched:
                    bsz = mem.shape[2]
                    nn = torch.where(flag != 0, 0, mem_n)
                    used = int(live[col: col + bsz].max(initial=0))
                    col += bsz
                    if used:
                        rows = torch.arange(used, device=mem.device)[None, :]
                        parts.append(mem[:, :used].permute(2, 1, 0)[rows < nn[:, None]])
                fetched = torch.cat(parts).cpu().numpy()
                self.anatomy["d2h_bytes"] += fetched.nbytes
                flat = fetched.astype(np.int64)
        return flat, live, flags

    def host_arrays(self, reads: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
        """The native host engine's intervals of ``reads``, nothing on the
        card: (flat (tot, 5) int64 [x0, x1, s, start, end], read-major in
        read order and each read's in the oracle's order; counts (N,)
        int64).  A read past the host buffer takes the oracle."""
        out_mem, out_n = native.smem_collect_host_arrays(self.fm, list(reads), self.params)
        cap = out_mem.shape[1]
        counts = out_n.astype(np.int64)
        if (counts > cap).any():
            per = [out_mem[k, :c] if c <= cap else _iv_array(
                mem_collect_intv_oracle(self.fm, reads[k], self.params))
                for k, c in enumerate(counts.tolist())]
            counts = np.fromiter(map(len, per), np.int64, len(per))
            return np.concatenate(per or [np.zeros((0, 5), np.int64)]), counts
        rows = np.repeat(np.arange(len(counts)) * cap - (np.cumsum(counts) - counts), counts)
        rows += np.arange(len(rows))
        return out_mem.reshape(-1, 5)[rows], counts

    def retry_arrays(self, reads: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
        """``host_arrays``' intervals of ``reads``, for reads the kernel
        flagged at the configured caps: one more launch, at the width of
        the longest read rounded up to 16 with chains of that width + 1
        rows (no chain of a read outgrows it; at most ``chain_room``) and
        ``max_intv_alloc`` output rows.  Reads past ``seq_length``, and
        those the wide launch still flags, take ``host_arrays`` (counted
        in ``stats["retry_host"]``)."""
        n = len(reads)
        lens = np.fromiter((len(r) for r in reads), np.int64, n)
        counts = np.zeros(n, np.int64)
        flat = np.zeros((0, 5), np.int64)
        card = np.flatnonzero(lens <= self.config.seq_length)
        left = np.flatnonzero(lens > self.config.seq_length)
        if len(card):
            width = -(-max(int(lens[card].max()), 1) // 16) * 16
            params = self.params._replace(curr_cap=min(width + 1, chain_room(width)),
                                          mem_cap=self.params.max_intv_alloc)
            seg = max(int(self.config.batch_size), 1)
            seq_tm, rlens = pack_tm([reads[k] for k in card], width, len(card))
            flat, live, flags = self._run(
                [(seq_tm[:, lo:lo + seg], rlens[lo:lo + seg])
                 for lo in range(0, len(card), seg)], params)
            counts[card] = live
            left = np.union1d(left, card[flags])
        if len(left):
            self.stats["retry_host"] += len(left)
            with Timer("smem.retry_host"):
                hflat, hcounts = self.host_arrays([reads[k] for k in left])
            flat, counts = merge_intervals(flat, counts, left, hflat, hcounts)
        return flat, counts

    def collect(self, reads: Sequence[np.ndarray]) -> List[List[dict]]:
        """3-pass SMEM intervals of each read, as interval dicts."""
        flat, counts = self.collect_flat(reads)
        with Timer("smem.split"):
            return split_dicts(flat, counts)

    def collect_flat(self, reads: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
        """The intervals of ``collect`` as arrays: (flat (tot, 5) int64
        [x0, x1, s, start, end], read-major in read order and each read's
        in the oracle's order; counts (N,) int64).  One launch for every
        read up to ``seq_length``, by length bucket; the reads it flags and
        those past ``seq_length`` take one ``retry_arrays``."""
        n = len(reads)
        self.stats["reads"] += n
        seq_len = self.config.seq_length
        buckets = self._buckets()
        lens = np.fromiter((len(r) for r in reads), np.int64, n)
        which = np.searchsorted(buckets, lens)  # the first bucket >= len
        seg = max(int(self.config.batch_size), 1)
        order, batches = [], []
        with Timer("smem.pack"):
            for b in np.unique(which[lens <= seq_len]).tolist():
                idxs = np.flatnonzero(which == b)
                for lo in range(0, len(idxs), seg):
                    part = idxs[lo:lo + seg]
                    order.append(part)
                    batches.append(pack_tm([reads[k] for k in part], buckets[b], len(part)))
        order = np.concatenate(order) if order else np.zeros(0, np.int64)
        flat, live, flags = self._run(batches)
        self.stats["overflow_reruns"] += int(flags.sum())
        past = lens > seq_len
        past[order[flags]] = True
        redo = np.flatnonzero(past)
        rflat, rcounts = self.retry_arrays([reads[k] for k in redo])
        # every read once: the card's clean reads (rows in batch order,
        # the flagged ones' empty), then the retried ones
        return merge_intervals(np.zeros((0, 5), np.int64), np.zeros(n, np.int64),
                               np.concatenate([order[~flags], redo]),
                               np.concatenate([flat, rflat]),
                               np.concatenate([live[~flags], rcounts]))

    def collect_arrays(self, seq_tm: np.ndarray, lens: np.ndarray):
        """Raw-array collection for device pipelines: seq_tm (L, B) uint8
        codes, lens (B,).  Returns (flat (tot, 5) int64 [x0, x1, s, start,
        end], read-major in batch order; counts (B,) int64; flags (B,)
        bool).  Flagged reads count 0 here; callers take them through
        ``retry_arrays``."""
        seq_tm = np.asarray(seq_tm, np.uint8)
        lens = np.asarray(lens, np.int32)
        bsz = seq_tm.shape[1]
        self.stats["reads"] += bsz
        seg = max(int(self.config.batch_size), 1)
        flat, counts, flags = self._run(
            [(seq_tm[:, lo:lo + seg], lens[lo:lo + seg]) for lo in range(0, bsz, seg)])
        self.stats["overflow_reruns"] += int(flags.sum())
        return flat, counts, flags
