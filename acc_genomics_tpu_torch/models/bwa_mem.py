"""BWA-MEM seeding and extension on the port's engines.

The port of ``acc_genomics_tpu/models/bwa_mem.py``.  ``BwaMemSeeding``
composes on the host: SMEM intervals of every read
(``SmemEngine.collect``), then the seeds each interval names (its first
``max_occ`` suffix-array rows, in row order), each with its reference
span of the read's length plus ``flank`` on both sides, then left and
right extension of every seed in one call (``ExtendEngine.extend_seeds``).
``BwaMemDevicePipeline`` gives the same results with the suffix array and
the text resident on the card: intervals as arrays
(``SmemEngine.collect_arrays``, and ``SmemEngine.retry_arrays`` for the
reads whose chain or output overflows the kernel's caps), a vectorised
seed enumeration, and one launch of the fused extension step per call.
Chaining and pairing stay with the caller.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from acc_genomics_tpu_torch.engine.packing import pack_rows
from acc_genomics_tpu_torch.engine.smem_engine import merge_intervals
from acc_genomics_tpu_torch.ops.extend.kernel import FUSED_KEYS, extend_seeds_fused
from acc_genomics_tpu_torch.utils.timer import Timer


@dataclasses.dataclass
class SeedHit:
    read_id: int
    qbeg: int
    qend: int
    rbeg: int  # text coordinate of the alignment's start
    rend: int
    score: int
    true_score: int
    width: int
    occ: int  # occurrence count of the originating SMEM


class BwaEngines(NamedTuple):
    """The two engines ``BwaMemSeeding`` needs (any objects with
    ``collect`` and ``extend_seeds``; ``smem.fm`` is the index)."""

    smem: object
    extend: object


class BwaMemSeeding:
    def __init__(self, engine, max_occ: int = 8, flank: int = 100):
        """``engine``: anything with ``.smem`` and ``.extend`` (``BwaEngines``)."""
        self.engine = engine
        self.max_occ = max_occ
        self.flank = flank

    def _positions(self, fm, iv) -> np.ndarray:
        """Text positions of an interval's first ``max_occ`` occurrences."""
        return fm.sa[iv["x0"]: iv["x0"] + min(iv["s"], self.max_occ)]

    def map_reads(self, reads: Sequence[np.ndarray]) -> List[List[SeedHit]]:
        with Timer("bwa.host"):
            fm = self.engine.smem.fm
            with Timer("bwa.host.smem"):
                intervals = self.engine.smem.collect(list(reads))
            with Timer("bwa.host.enum"):
                tasks, meta = [], []
                text_len = fm.seq_len
                for rid, (read, ivs) in enumerate(zip(reads, intervals)):
                    for iv in ivs:
                        slen = iv["end"] - iv["start"]
                        for pos in self._positions(fm, iv):
                            pos = int(pos)
                            span_lo = max(0, pos - iv["start"] - self.flank)
                            span_hi = min(text_len,
                                          pos + slen + (len(read) - iv["end"]) + self.flank)
                            tasks.append(dict(read=read, rseq=fm.text[span_lo:span_hi],
                                              qbeg=iv["start"], rbeg_off=pos - span_lo,
                                              len=slen))
                            meta.append((rid, iv, pos))
            with Timer("bwa.host.extend"):
                results = self.engine.extend.extend_seeds(tasks) if tasks else []
            with Timer("bwa.host.hits"):
                out: List[List[SeedHit]] = [[] for _ in reads]
                for (rid, iv, pos), res in zip(meta, results):
                    out[rid].append(SeedHit(
                        read_id=rid,
                        qbeg=res["qBeg"],
                        qend=iv["end"] + res["qEnd"],
                        rbeg=pos + res["rBeg"],
                        rend=pos + (iv["end"] - iv["start"]) + res["rEnd"],
                        score=res["score"],
                        true_score=res["trueScore"],
                        width=res["width"],
                        occ=iv["s"],
                    ))
            return out


def _no_seeds(host_idx):
    empty = np.zeros(0, np.int32)
    return (np.zeros((len(FUSED_KEYS), 0), np.int32), empty, (empty,) * 3, host_idx)


class BwaMemDevicePipeline:
    """Device-resident BWA-MEM seeding and extension.

    The same results as :class:`BwaMemSeeding` (same seed enumeration, the
    same extension semantics), with the suffix array (int32) and the text
    (uint8, both strands) put on the engine's device once, here.  A call
    costs the SMEM round trips of ``collect_arrays``, a second SMEM launch
    at wide caps for the reads it flags (``SmemEngine.retry_arrays``; the
    native host engine for any that launch flags too), one H2D copy of
    every read's seeds and the reads, one launch of ``extend_seeds_fused``
    and one D2H copy of its (8, N) result.  Only reads longer than the
    call's bucket take ``BwaMemSeeding``.
    ``engine``: anything with ``.smem`` (an ``SmemEngine`` with its index)
    and ``.extend`` (an ``ExtendEngine``), such as ``GenomicsEngine`` or
    ``BwaEngines``.
    """

    def __init__(self, engine, max_occ: int = 8, flank: int = 100):
        self.engine = engine
        self.max_occ = max_occ
        self.flank = flank
        fm = engine.smem.fm
        self.fm = fm
        if fm.seq_len >= 2**31:
            raise ValueError(f"text of {fm.seq_len}: int32 positions need < 2**31")
        self.device = engine.smem.device
        self.sa_dev = torch.from_numpy(fm.sa.astype(np.int32)).to(self.device)
        self.text_dev = torch.from_numpy(np.ascontiguousarray(fm.text, np.uint8)).to(
            self.device)
        self.params = engine.extend.config.params()
        self.stats = {"reads": 0, "seeds": 0, "device_calls": 0}
        # per-phase anatomy, the readings of the spans bwa.pipe.smem
        # (collect_arrays, its launches and fetches), bwa.pipe.rerun (the
        # SMEM retry of the reads the kernel flags), bwa.pipe.enum (the
        # host seed enumeration and staging) and bwa.pipe.extend (the H2D
        # copy, the launch and the result's D2H copy); rerun_reads counts
        # the flagged reads, rerun_host_reads those of them the retry's
        # launch flags too (they take the native host engine)
        self.anatomy = dict(smem_s=0.0, rerun_s=0.0, enum_s=0.0, extend_s=0.0,
                            h2d_bytes=0, d2h_bytes=0, rerun_reads=0, rerun_host_reads=0)

    def reset_anatomy(self):
        for k in self.anatomy:
            self.anatomy[k] = 0.0 if k.endswith("_s") else 0

    def _bucket(self, reads) -> int:
        """The first read bucket that holds the longest read, else
        ``seq_length`` (longer reads then go to the host route)."""
        cfg = self.engine.smem.config
        max_rlen = max((len(r) for r in reads), default=0)
        return next((b for b in cfg.read_buckets if max_rlen <= b), cfg.seq_length)

    def map_reads_arrays(self, reads: Sequence[np.ndarray]):
        """-> (hits (8, N) int32 [qBeg qEndRel rBeg rEndRel score trueScore
        width pos], seed readid (N,), seed meta (qbeg, slen, occ) arrays,
        host_read_idx for the host route: the reads longer than the
        bucket).  Seeds are in enumeration order: read-major, interval
        order, occurrence ascending.  ``map_reads`` wraps it into SeedHit
        lists."""
        with Timer("bwa.pipe.smem") as smem:
            width = self._bucket(reads)
            n_reads = len(reads)
            self.stats["reads"] += n_reads
            host_idx = [k for k, r in enumerate(reads) if len(r) > width]
            empty = np.zeros(0, np.uint8)
            rows_rm, rlens = pack_rows([empty if len(r) > width else r for r in reads],
                                       width, n_reads)
            flat, counts, overflow = self.engine.smem.collect_arrays(
                np.ascontiguousarray(rows_rm.T), rlens)
        self.anatomy["smem_s"] += smem.elapsed
        # the flagged reads' intervals from the retry at wide caps, merged
        # read-major with the card's
        rerun = np.flatnonzero(overflow)
        if len(rerun):
            smem_eng = self.engine.smem
            host_before = smem_eng.stats["retry_host"]
            with Timer("bwa.pipe.rerun") as rr:
                rflat, rcounts = smem_eng.retry_arrays([reads[k] for k in rerun])
            self.anatomy["rerun_s"] += rr.elapsed
            self.anatomy["rerun_reads"] += len(rerun)
            self.anatomy["rerun_host_reads"] += smem_eng.stats["retry_host"] - host_before
            flat, counts = merge_intervals(flat, counts, rerun, rflat, rcounts)

        with Timer("bwa.pipe.enum") as enum:
            enumerated = self._enumerate(flat, counts, rows_rm, rlens)
        self.anatomy["enum_s"] += enum.elapsed
        if enumerated is None:
            return _no_seeds(host_idx)
        staged, tot, b_idx, qbeg, slen, occ = enumerated

        with Timer("bwa.pipe.extend") as extend:
            dev = staged.to(self.device, non_blocking=True)
            self.anatomy["h2d_bytes"] += staged.numel()
            n32 = 4 * tot + n_reads
            d32 = dev[: 4 * n32].view(torch.int32)
            seeds = d32[: 4 * tot].view(4, tot)
            out = extend_seeds_fused(
                self.sa_dev, self.text_dev, dev[4 * n32:].view(n_reads, width),
                d32[4 * tot:], seeds[0], seeds[1], seeds[2], seeds[3], self.flank,
                self.params)
            with Timer("bwa.pipe.fetch"):
                hits = out.cpu().numpy()
            self.anatomy["d2h_bytes"] += hits.nbytes
        self.anatomy["extend_s"] += extend.elapsed
        return hits, b_idx, (qbeg, slen, occ), host_idx

    def _enumerate(self, flat, counts, rows_rm, rlens):
        """The vectorised seed enumeration (the host model's order) over
        read-major intervals ``flat`` (tot, 5) [x0, x1, s, start, end] and
        each read's ``counts``, and the one staged buffer (pinned on CUDA):
        the int32 seed arrays (rows, qbeg, slen, read) and read lengths,
        then the read-major read matrix.  -> (staged, the seed count, each
        seed's read, qbeg, slen, occ), or None without a seed."""
        if len(flat) == 0:
            return None
        occ_iv = np.minimum(flat[:, 2], self.max_occ)
        tot = int(occ_iv.sum())
        self.stats["seeds"] += tot
        if tot == 0:
            return None
        # each seed's occurrence within its interval
        j = np.arange(tot) - np.repeat(np.cumsum(occ_iv) - occ_iv, occ_iv)
        b_idx = np.repeat(np.repeat(np.arange(len(counts), dtype=np.int32), counts), occ_iv)
        rows = (np.repeat(flat[:, 0], occ_iv) + j).astype(np.int32)
        qbeg = np.repeat(flat[:, 3], occ_iv).astype(np.int32)
        slen = np.repeat(flat[:, 4], occ_iv).astype(np.int32) - qbeg
        occ = np.repeat(flat[:, 2], occ_iv).astype(np.int32)

        n32 = 4 * tot + len(rlens)
        staged = torch.empty(4 * n32 + rows_rm.size, dtype=torch.uint8,
                             pin_memory=self.device.type == "cuda")
        hv = staged.numpy()
        hv[: 4 * n32].view(np.int32)[:] = np.concatenate([rows, qbeg, slen, b_idx, rlens])
        hv[4 * n32:] = rows_rm.reshape(-1)
        self.stats["device_calls"] += 1
        return staged, tot, b_idx, qbeg, slen, occ

    def map_reads(self, reads: Sequence[np.ndarray]) -> List[List[SeedHit]]:
        hits, rid, (qbeg, slen, occ), host_idx = self.map_reads_arrays(reads)
        out: List[List[SeedHit]] = [[] for _ in reads]
        qend = (qbeg + slen + hits[1]).tolist()
        rbeg = (hits[7] + hits[2]).tolist()
        rend = (hits[7] + slen + hits[3]).tolist()
        for t, (r, q0, score, ts, w, oc) in enumerate(zip(
                rid.tolist(), hits[0].tolist(), hits[4].tolist(), hits[5].tolist(),
                hits[6].tolist(), occ.tolist())):
            out[r].append(SeedHit(read_id=r, qbeg=q0, qend=qend[t], rbeg=rbeg[t],
                                  rend=rend[t], score=score, true_score=ts,
                                  width=w, occ=oc))
        if host_idx:
            sub = BwaMemSeeding(self.engine, self.max_occ, self.flank).map_reads(
                [reads[k] for k in host_idx])
            for r, hlist in zip(host_idx, sub):
                out[r] = [dataclasses.replace(h, read_id=r) for h in hlist]
        return out
