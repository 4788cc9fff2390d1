"""Single-card PairHMM engine: bucket -> pack -> CUDA kernel -> epilogue.

The port of ``acc_genomics_tpu/engine/pairhmm_engine.py`` (the redesign
of the reference's FalconPairHMM::computePairhmm dispatch):

* length bucketing (engine/bucketing.py) and haplen-sorted lanes;
* a dispatch gate (the worthFPGA analog): small batches of the dict path
  run on the native host engine, under a static cell count or, once a
  calibrated ``DispatchCostModel`` is installed (``set_cost_model``,
  ``calibrate_dispatch``), when its predicted host time is the shorter;
* pairs beyond the largest bucket run on the native host engine, on a
  worker thread concurrent with the device buckets;
* with a ``mesh`` (``parallel/mesh.py``), the buckets are packed as fp32
  coefficient planes and run data-parallel (``pairhmm_forward_dp``), and
  a pair whose haplotype is past ``max_hap_len`` but within
  ``max_hap_len`` x seq runs on the DP x SP band pipeline instead of the
  host: byte planes, staged and uploaded like the buckets below, the
  band kernel expanding the coefficients
  (``pairhmm_forward_dpsp_from_quals``) at a chunk of ``sp_chunk_rows``
  rows; the flat entry points take the dict path;
* the device route runs the kernel on uint8 byte planes (quals, codes,
  hap) and the kernel expands the coefficients itself
  (``config.quals_expand``).  The flat path uploads the batch's read and
  haplotype streams once each and builds the planes on the card
  (``ops/pairhmm/gather.py``); the dict path packs them on the host.
  With ``config.upload="f32"`` the flat path ships the native fp32
  coefficient pack instead and runs the kernel's coefficient front end
  (``pairhmm_forward``);
* fp32 results below ``config.min_accepted`` are recomputed in fp64 on
  the host (native), and the output is log10(result) - log10(IC).

Each batch is staged in one host buffer (pinned on CUDA), uploaded with
one H2D copy, run as one kernel launch per bucket on the engine's own
stream, and fetched with one D2H copy that finalize waits for, so host
work on the next batch overlaps the card's work on this one.  On
``device="cpu"`` the same route runs the kernel's plain PyTorch version.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from acc_genomics_tpu_torch.build import ensure_native
from acc_genomics_tpu_torch.device import resolve_device
from acc_genomics_tpu_torch.engine.bucketing import plan_buckets
from acc_genomics_tpu_torch.io.synth import gen_pairhmm_pairs
from acc_genomics_tpu_torch.ops.pairhmm.band_kernel import CHUNK_ROWS
from acc_genomics_tpu_torch.ops.pairhmm.convert import batch_to_torch, context_tables
from acc_genomics_tpu_torch.ops.pairhmm.kernel import (
    pairhmm_forward,
    pairhmm_forward_from_quals,
)
from acc_genomics_tpu_torch import native
from acc_genomics_tpu_torch.config import PairHMMConfig
from acc_genomics_tpu_torch.ops.pairhmm.context import PairHMMContext
from acc_genomics_tpu_torch.ops.pairhmm.gather import GatherLayout, pairhmm_gather
from acc_genomics_tpu_torch.ops.pairhmm.pack import pack_pairhmm_batch, pack_pairhmm_quals
from acc_genomics_tpu_torch.parallel.sharded import (
    pairhmm_forward_dp,
    pairhmm_forward_dpsp_from_quals,
)
from acc_genomics_tpu_torch.utils.timer import Timer

# the preferred C of the band pipeline on the SP route.  C changes no bit
# of the result; of the three, 32 gave the shortest pipeline on
# chip_smoke.py's phase-15 pack on an H100 (fewest supersteps; PERF.md).
SP_CHUNK_ROWS = 32


def sp_chunk_rows(rows: int) -> int:
    """C of the band pipeline for an SP pack of ``rows`` rows (the largest
    read bucket): SP_CHUNK_ROWS when it divides ``rows``, else the largest
    C of CHUNK_ROWS that does."""
    for c in (SP_CHUNK_ROWS, *sorted(CHUNK_ROWS, reverse=True)):
        if rows % c == 0:
            return c
    raise ValueError(f"rows {rows} must divide by a chunk size of {CHUNK_ROWS}")


def _starts(lens: np.ndarray, offs: Optional[np.ndarray]) -> np.ndarray:
    """``offs`` as contiguous int64, or, when None, the starts of
    back-to-back runs of ``lens``."""
    if offs is not None:
        return np.ascontiguousarray(offs, np.int64)
    starts = np.zeros(len(lens), np.int64)
    if len(lens) > 1:
        np.cumsum(lens[:-1].astype(np.int64), out=starts[1:])
    return starts


@dataclasses.dataclass
class DispatchCostModel:
    """Calibrated host-vs-device dispatch gate, the worthFPGA analog
    (FalconPairHMM.cpp:112-139, which compares the measured AVX time
    against PCIe + prep + compute + recompute with live constants).
    Predicted times:

        host_s(cells)          = cells / (host_gcups * cores)
        device_s(cells, bytes) = fixed_s + cells / device_gcups
                                         + bytes / link_gb_s

    ``host_gcups``: the native forward's rate on ``cores`` cores; ``device_gcups``:
    the kernel's rate on the engine's buckets; ``link_gb_s``: the H2D
    rate; ``fixed_s``: launch, copies and synchronisation of one engine
    call.  :meth:`from_e2e_bench` takes a PairHMM end-to-end bench's
    result dict, :meth:`calibrate` measures the host and the link here.
    """

    # defaults: chip_smoke.py's phase 16 (calibrate_dispatch on the card)
    # on one NVIDIA H100 80GB HBM3 at 700.00 W and its 8-core host, the
    # run of 2026-10-17; calibrate() measures the host and the link anew
    host_gcups: float = 0.5522  # the native forward on 64 pairs, all threads
    device_gcups: float = 555.725  # the kernel on the 16,384-pair engine batch
    link_gb_s: float = 32.825  # 4 MiB pinned H2D, synchronised
    fixed_s: float = 0.005022  # a 16-pair call on the card, less its cells
    cores: int = 1

    def host_s(self, cells: int) -> float:
        return cells / (self.host_gcups * max(self.cores, 1)) / 1e9

    def device_s(self, cells: int, nbytes: int) -> float:
        return (
            self.fixed_s
            + cells / self.device_gcups / 1e9
            + nbytes / (self.link_gb_s * 1e9)
        )

    def device_worthwhile(self, cells: int, nbytes: int) -> bool:
        return self.device_s(cells, nbytes) < self.host_s(cells)

    @classmethod
    def from_e2e_bench(cls, res: dict, cores: Optional[int] = None) -> "DispatchCostModel":
        """Build from a PairHMM end-to-end bench's result dict (keys
        ``cells``, ``n_batches``, ``link_gcups``, ``device_gcups``, and
        ``host_gcups`` and ``single_batch_latency_s`` where measured)."""
        cells = res["cells"] / max(res.get("n_batches", 8), 1)
        # link_gcups = cells a batch per link-second at ~44 cells a byte
        link_gb_s = res["link_gcups"] * 1e9 / 44 / 1e9
        latency_s = res.get("single_batch_latency_s",
                            cls.fixed_s + cells / res["device_gcups"] / 1e9)
        return cls(
            host_gcups=max(res.get("host_gcups", cls.host_gcups), 1e-3),
            device_gcups=res["device_gcups"],
            link_gb_s=max(link_gb_s, 1e-4),
            fixed_s=max(latency_s - cells / res["device_gcups"] / 1e9, 1e-3),
            cores=cores or os.cpu_count() or 1,
        )

    def calibrate(self, device) -> "DispatchCostModel":
        """Measure the host rate (the native forward on 64 pairs, after a
        warm call) and the link rate (a 4 MiB copy from pinned host
        memory to ``device``, synchronised) on this host; the device
        rate and the fixed cost stay as set.  The native forward runs on
        all of the host's threads, so the measured rate is the whole
        host's and ``cores`` is 1 (the JAX package's calibrate multiplies
        it by the core count once more)."""
        device = resolve_device(device)
        tcs = gen_pairhmm_pairs(np.random.default_rng(0), 64, max_read_len=120,
                                max_hap_len=300)
        cells = sum(len(t["rs"]) * len(t["hap"]) for t in tcs)
        native.pairhmm_forward(tcs, np.float32)  # warm
        t0 = time.perf_counter()
        native.pairhmm_forward(tcs, np.float32)
        host = cells / (time.perf_counter() - t0) / 1e9
        cuda = device.type == "cuda"
        buf = torch.zeros(4 << 20, dtype=torch.uint8, pin_memory=cuda)

        def copy():
            buf.to(device, non_blocking=cuda, copy=True)
            if cuda:
                torch.cuda.synchronize(device)

        copy()  # warm
        t0 = time.perf_counter()
        copy()
        dt = time.perf_counter() - t0
        return dataclasses.replace(
            self, host_gcups=host, link_gb_s=max(buf.numel() / dt / 1e9, 1e-4), cores=1,
        )


@dataclasses.dataclass
class _Bucket:
    """One launch: the (5*rows + rows + cols, bp) byte region q, i, d, c,
    rs, hap_ext, which ``planes`` stack to; lane k holds pair ``sel[k]``
    (lanes past ``len(sel)`` are padding).  ``sp_chunk_rows`` > 0 runs it
    on the mesh's DP x SP band pipeline at that C, else on the forward
    kernel."""

    sel: np.ndarray
    planes: List[np.ndarray]
    lens: np.ndarray  # (bp,) int32
    hlens: np.ndarray  # (bp,) int32
    rows: int
    cols: int
    sp_chunk_rows: int = 0

    @property
    def nrow(self) -> int:
        return 6 * self.rows + self.cols


@dataclasses.dataclass
class _Pending:
    """Results of a launched set of buckets, fetched at finalize."""

    sels: List[np.ndarray]
    out_host: torch.Tensor  # (sum bp,) float32 (pinned on CUDA)
    done: Optional[torch.cuda.Event]
    staged: torch.Tensor  # host staging buffer, alive until the copy ends
    h2d_bytes: int

    def scatter(self, raw: np.ndarray) -> int:
        """Wait for the D2H copy and write each lane's result into raw;
        returns the bytes fetched."""
        with Timer("pairhmm.wait"):
            if self.done is not None:
                self.done.synchronize()
        res = self.out_host.numpy()
        col = 0
        for sel in self.sels:
            raw[sel] = res[col : col + len(sel)]
            col += len(sel)
        return res.nbytes


@dataclasses.dataclass
class _FlatBatch:
    """A launched flat batch: finalize fetches, joins and runs the epilogue."""

    streams: tuple  # rs, q, i, d, c, offs, lens, hap, hoffs, hlens
    raw: np.ndarray
    pending: Optional[_Pending]
    host_thread: Optional[threading.Thread]
    host_err: list


class PairHMMEngine:
    """Computes log10 P(read | hap) for batches of (read, hap) pairs."""

    def __init__(
        self, config: PairHMMConfig = PairHMMConfig(), device="cuda", mesh=None,
    ):
        if config.upload not in ("quals", "f32"):
            raise ValueError(f"upload {config.upload!r}")
        if config.quals_expand not in ("arith", "gather"):
            raise ValueError(f"quals_expand {config.quals_expand!r}")
        self.config = config
        self.device = resolve_device(device)
        if not ensure_native():
            raise RuntimeError(
                "the native host library (acc_genomics_tpu_torch/native) is "
                "unavailable: the flat path, the host engine and the fp64 "
                "recompute need it"
            )
        self.ctx32 = PairHMMContext(np.float32)
        # dispatch gate (worthFPGA analog), two tiers: the static cell
        # count below, and, once a calibrated DispatchCostModel is
        # installed, its predicted host and device times
        self.min_device_cells = 2_000_000
        self.cost_model: Optional[DispatchCostModel] = None
        self.stats = {"pairs": 0, "recomputed": 0, "cells": 0, "device_calls": 0}
        ph2pr, m2m, _ = context_tables(self.ctx32, self.device)
        self._tables = (ph2pr, m2m)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        # optional device mesh: buckets shard over its "data" axis, long
        # haplotypes over its "seq" axis as well
        self.mesh = mesh
        self._data_size = mesh.shape["data"] if mesh is not None else 1
        self._seq_size = mesh.shape["seq"] if mesh is not None else 1

    # -- dispatch calibration ---------------------------------------------

    def set_cost_model(self, model: Optional[DispatchCostModel]):
        """Install (or clear, with None) the calibrated dispatch gate."""
        self.cost_model = model

    def calibrate_dispatch(
        self, device_gcups: Optional[float] = None, fixed_s: Optional[float] = None,
    ) -> DispatchCostModel:
        """Measure the host and link constants on this host
        (``DispatchCostModel.calibrate`` on the engine's device) and install
        the calibrated gate.  ``device_gcups`` and ``fixed_s`` default to
        the model's, measured on an H100."""
        given = dict(device_gcups=device_gcups, fixed_s=fixed_s)
        base = DispatchCostModel(**{k: v for k, v in given.items() if v is not None})
        self.cost_model = base.calibrate(self.device)
        return self.cost_model

    def _on_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    # -- device route -----------------------------------------------------

    def _stage_and_run(self, sels, nbytes: int, fill, run) -> _Pending:
        """One host buffer of ``nbytes`` (pinned on CUDA) filled by
        ``fill(view)``, one H2D copy of it, ``run(device_buffer)``
        launching one result tensor a bucket on the engine's stream (its
        launches in a ``pairhmm.launch`` span of its own), and one D2H
        copy of all results, which the returned _Pending waits for."""
        with Timer("pairhmm.stage"):
            staged = torch.empty(nbytes, dtype=torch.uint8, pin_memory=self._cuda)
            fill(staged.numpy())
        with self._on_stream():
            with Timer("pairhmm.launch"):
                dev = staged.to(self.device, non_blocking=True)
            outs = run(dev)
        with Timer("pairhmm.launch"), self._on_stream():
            allres = torch.cat(outs)
            done = None
            if self._cuda:
                out_host = torch.empty(
                    allres.shape, dtype=allres.dtype, pin_memory=True
                )
                out_host.copy_(allres, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self._stream)
            else:
                out_host = allres
        return _Pending(list(sels), out_host, done, staged, nbytes)

    def _launch(self, buckets: Sequence[_Bucket]) -> _Pending:
        """Stage every bucket's byte planes in one host buffer, upload it
        once, launch one kernel (or one band pipeline) per bucket and
        start one D2H copy of all results."""
        with Timer("pairhmm.launch"):
            u8_offs, off = [], 0
            for b in buckets:
                u8_offs.append(off)
                off += b.nrow * len(b.lens)
            off = -(-off // 16) * 16  # int32 side-band aligned
            meta_offs = []
            for b in buckets:
                meta_offs.append(off)
                off += 8 * len(b.lens)

        def fill(hv):
            for b, uo, mo in zip(buckets, u8_offs, meta_offs):
                o = uo
                for p in b.planes:
                    hv[o : o + p.size] = p.reshape(-1)
                    o += p.size
                meta = hv[mo : mo + 8 * len(b.lens)].view(np.int32)
                meta[: len(b.lens)] = b.lens
                meta[len(b.lens) :] = b.hlens

        expand = self.config.quals_expand
        ic = float(self.ctx32.initial_constant)

        @Timer("pairhmm.launch")
        def run(dev):
            outs = []
            for b, uo, mo in zip(buckets, u8_offs, meta_offs):
                rows, bp = b.rows, len(b.lens)
                region = dev[uo : uo + b.nrow * bp].view(b.nrow, bp)
                q, i, d, c, rs = (region[k * rows : (k + 1) * rows] for k in range(5))
                hap_ext = region[5 * rows :]
                meta = dev[mo : mo + 8 * bp].view(torch.int32).view(2, bp)
                if b.sp_chunk_rows:
                    res = pairhmm_forward_dpsp_from_quals(
                        self.mesh, q, i, d, c, rs, hap_ext, meta[0], meta[1],
                        *self._tables, ic, expand=expand, C=b.sp_chunk_rows,
                    ).to(self.device)
                else:
                    res = pairhmm_forward_from_quals(
                        q, i, d, c, rs, hap_ext, meta[0], meta[1],
                        *self._tables, ic, expand=expand,
                    )
                    self.stats["device_calls"] += 1
                outs.append(res[: len(b.sel)])
            return outs

        return self._stage_and_run([b.sel for b in buckets], off, fill, run)

    def _launch_gathered(self, streams, groups) -> _Pending:
        """The flat byte-plane route: the batch's streams, each lane's
        offsets and lengths and the bucket table staged in one buffer
        (``GatherLayout``) and uploaded once, one launch of the gather
        building every bucket's byte planes on the device, one forward
        launch a bucket on its views.  ``streams``: the flat (rs, q, i, d,
        c, offs, lens, hap, hoffs, hlens); ``groups``: (sel, rows, cols)
        per bucket, sel in launch order."""
        rs, q, i, d, c, offs, lens, hap, hoffs, hlens = streams
        planes = (q, i, d, c, rs, hap)
        sels = [sel for sel, _, _ in groups]
        with Timer("pairhmm.stage"):
            layout = GatherLayout.plan([(rows, cols, len(sel)) for sel, rows, cols in groups],
                                       [len(p) for p in planes])

        def fill(hv):
            layout.fill(hv, planes, offs, lens, hoffs, hlens, sels)

        expand = self.config.quals_expand
        ic = float(self.ctx32.initial_constant)

        def run(dev):
            with Timer("pairhmm.pack"):
                gathered = pairhmm_gather(dev, layout)
            self.stats["card_packed"] = self.stats.get("card_packed", 0) + layout.lanes
            with Timer("pairhmm.launch"):
                outs = []
                for b in range(len(groups)):
                    outs.append(pairhmm_forward_from_quals(
                        *layout.bucket(b, gathered, dev), *self._tables, ic, expand=expand))
                    self.stats["device_calls"] += 1
            return outs

        return self._stage_and_run(sels, layout.nbytes, fill, run)

    def _launch_f32(self, streams, groups) -> _Pending:
        """The f32 upload: each bucket's native fp32 coefficient pack
        (``native.pairhmm_pack_flat_f32``) written straight into one
        staged buffer, one H2D copy, one launch of the coefficient front
        end (``pairhmm_forward``) per bucket.  ``streams``: the flat
        (rs, q, i, d, c, offs, lens, hap, hoffs, hlens); ``groups``:
        (sel, rows, cols) per bucket, sel in launch order."""
        rs, q, i, d, c, offs, lens, hap, hoffs, hlens = streams
        with Timer("pairhmm.launch"):
            regions, off = [], 0
            for sel, rows, cols in groups:
                nf = (8 * rows + 1) * len(sel)
                regions.append((off, off + 4 * nf))
                off += 4 * (nf + (2 * rows + cols) * len(sel))
        ctx = self.ctx32

        def fill(hv):
            for (sel, rows, cols), (fo, io) in zip(groups, regions):
                bp = len(sel)
                out_f = hv[fo:io].view(np.float32).reshape(8 * rows + 1, bp)
                out_i = hv[io : io + 4 * (2 * rows + cols) * bp].view(np.int32)
                packed = native.pairhmm_pack_flat_f32(
                    rs, q, i, d, c, offs[sel], lens[sel], hap, hoffs[sel],
                    hlens[sel], rows, cols, ctx.ph2pr, ctx.match_to_match,
                    ctx.initial_constant, out_f=out_f,
                    out_i=out_i.reshape(2 * rows + cols, bp),
                )
                if packed is None:
                    raise RuntimeError("upload='f32' needs the native host library")

        @Timer("pairhmm.launch")
        def run(dev):
            outs = []
            for (sel, rows, cols), (fo, io) in zip(groups, regions):
                bp = len(sel)
                big_f = dev[fo:io].view(torch.float32).view(8 * rows + 1, bp)
                big_i = dev[io : io + 4 * (2 * rows + cols) * bp].view(
                    torch.int32).view(2 * rows + cols, bp)
                planes = [big_f[k * rows : (k + 1) * rows] for k in range(8)]
                outs.append(pairhmm_forward(
                    *planes, big_i[:rows], big_i[rows:], big_f[8 * rows]))
                self.stats["device_calls"] += 1
            return outs

        return self._stage_and_run([g[0] for g in groups], off, fill, run)

    # -- dict path ----------------------------------------------------------

    def compute_pairs(self, testcases: Sequence[dict]) -> np.ndarray:
        """log10-likelihood for each testcase dict (rs,q,i,d,c,hap): fp32
        on the device, fp64 host recompute below MIN_ACCEPTED."""
        with Timer("pairhmm.call"):
            return self._compute_pairs(testcases)

    def _compute_pairs(self, testcases: Sequence[dict]) -> np.ndarray:
        n = len(testcases)
        if n == 0:
            return np.zeros(0, np.float64)
        with Timer("pairhmm.bucket"):
            self.stats["pairs"] += n
            read_lens = [len(t["rs"]) for t in testcases]
            hap_lens = [len(t["hap"]) for t in testcases]

            total_cells = sum(r * h for r, h in zip(read_lens, hap_lens))
            if self.cost_model is not None:
                # the byte-plane upload: five planes a read, one a hap, the
                # int32 side-band
                est_bytes = 5 * sum(read_lens) + sum(hap_lens) + 12 * n
                use_host = not self.cost_model.device_worthwhile(total_cells, est_bytes)
            else:
                use_host = total_cells < self.min_device_cells
            if not use_host:
                # on a mesh with a seq axis, a pair whose haplotype (not
                # read) is past the bucket cap runs on the DP x SP shards
                # instead of the host
                sp_cap = self.config.max_hap_len * self._seq_size
                fits, sp_idx, over = [], [], []
                for k in range(n):
                    if read_lens[k] > self.config.max_read_len:
                        over.append(k)
                    elif hap_lens[k] <= self.config.max_hap_len:
                        fits.append(k)
                    elif self._seq_size > 1 and hap_lens[k] <= sp_cap:
                        sp_idx.append(k)
                    else:
                        over.append(k)
                raw = np.zeros(n, np.float32)
                host_thread, host_err = None, []
                if over:
                    # host engine on a worker thread, concurrent with the
                    # device buckets (the native forward releases the GIL)
                    self.stats["host_fallback"] = (
                        self.stats.get("host_fallback", 0) + len(over))

                    def host_work():
                        try:
                            with Timer("pairhmm.host_forward"):
                                raw[over] = native.pairhmm_forward(
                                    [testcases[k] for k in over], np.float32
                                )
                        except BaseException as e:  # re-raised after join
                            host_err.append(e)

                    host_thread = threading.Thread(target=host_work)
                    host_thread.start()

                plan = plan_buckets(
                    [read_lens[k] for k in fits],
                    [hap_lens[k] for k in fits],
                    self.config.read_buckets,
                    self.config.hap_buckets,
                )
                fits_arr = np.asarray(fits, dtype=np.int64)
        if use_host:
            with Timer("pairhmm.host_forward"):
                host = native.pairhmm_forward(testcases, np.float32)
            self.stats["host_native_calls"] = (
                self.stats.get("host_native_calls", 0) + 1
            )
            self.stats["cells"] += total_cells
            return self._epilogue(testcases, host)

        if self.mesh is not None:
            self._run_mesh(testcases, plan, fits_arr, sp_idx, raw)
        else:
            self._run_quals(testcases, plan, fits_arr, raw)
        with Timer("pairhmm.host_join"):
            if host_thread is not None:
                host_thread.join()
                if host_err:
                    raise host_err[0]
        return self._epilogue(testcases, raw)

    def _run_quals(self, testcases, plan, fits_arr, raw: np.ndarray):
        """The byte-plane route: one quals pack a bucket, all launched
        from one staged upload, results scattered into ``raw``."""
        buckets = []
        with Timer("pairhmm.pack_py"):
            for (rows, cols), idxs in plan.groups.items():
                max_pairs = self.config.max_batch_pairs
                for lo in range(0, len(idxs), max_pairs):
                    chunk = fits_arr[idxs[lo : lo + max_pairs]]
                    pack = pack_pairhmm_quals(
                        [testcases[k] for k in chunk], rows=rows, cols=cols,
                        pad_lanes=False, sort_by_haplen=True,
                    )
                    self.stats["cells"] += pack.cells
                    sel = chunk if pack.perm is None else chunk[pack.perm]
                    buckets.append(
                        _Bucket(
                            sel,
                            [pack.q, pack.i, pack.d, pack.c, pack.rs, pack.hap_ext],
                            pack.rslen, pack.haplen, rows, cols,
                        )
                    )
        if buckets:
            self._launch(buckets).scatter(raw)

    def _run_mesh(self, testcases, plan, fits_arr, sp_idx, raw: np.ndarray):
        """The mesh route: each bucket packed as fp32 coefficient planes and
        run data-parallel; the long haplotypes (``sp_idx``) packed as byte
        planes at the largest read bucket and ``seq`` x 128-aligned
        columns, staged and uploaded once (``_launch``) and run on the
        DP x SP pipeline.  Every result lands in ``raw``."""
        packs, sp_pending = [], None
        with self._on_stream():
            if sp_idx:
                self.stats["sp_pairs"] = self.stats.get("sp_pairs", 0) + len(sp_idx)
                with Timer("pairhmm.sp_pack"):
                    rows = self.config.read_buckets[-1]
                    C = self.stats["sp_chunk_rows"] = sp_chunk_rows(rows)
                    step = self._seq_size * 128
                    max_hl = max(len(testcases[k]["hap"]) for k in sp_idx)
                    cols = -(-max_hl // step) * step
                    pack = pack_pairhmm_quals(
                        [testcases[k] for k in sp_idx], rows=rows, cols=cols,
                        lane_multiple=self._data_size,
                    )
                sp_pending = self._launch([_Bucket(
                    np.asarray(sp_idx, np.int64),
                    [pack.q, pack.i, pack.d, pack.c, pack.rs, pack.hap_ext],
                    pack.rslen, pack.haplen, rows, cols, C,
                )])
                self.stats["h2d_bytes"] = self.stats.get("h2d_bytes", 0) + sp_pending.h2d_bytes
            with Timer("pairhmm.pack_py"):
                for (rows, cols), idxs in plan.groups.items():
                    max_pairs = self.config.max_batch_pairs
                    for lo in range(0, len(idxs), max_pairs):
                        chunk = fits_arr[idxs[lo : lo + max_pairs]]
                        pack = pack_pairhmm_batch(
                            [testcases[k] for k in chunk], rows=rows, cols=cols,
                            dtype=np.float32, lane_multiple=self._data_size,
                        )
                        self.stats["cells"] += pack.cells
                        self.stats["device_calls"] += 1
                        packs.append((chunk, pack))
            with Timer("pairhmm.launch"):
                res = [pairhmm_forward_dp(self.mesh, *batch_to_torch(pack, self.device))
                       for _, pack in packs]
            # the D2H copy of the results waits for the card
            with Timer("pairhmm.fetch"):
                if packs:
                    allres = torch.cat(res).cpu().numpy()
                    col = 0
                    for (chunk, pack), r in zip(packs, res):
                        raw[chunk] = pack.unsort(allres[col : col + len(r)])
                        col += len(r)
                if sp_pending is not None:
                    sp_pending.scatter(raw)

    def _epilogue(self, testcases, raw: np.ndarray) -> np.ndarray:
        """log10 conversion + fp64 recompute of fp32 underflows (the
        AVX-double recompute contract, FalconPairHMM.cpp:634-656)."""
        with Timer("pairhmm.epilogue"):
            n = len(testcases)
            out = np.empty(n, np.float64)
            ok = raw >= np.float32(self.config.min_accepted)
            with np.errstate(divide="ignore"):
                out[ok] = np.log10(raw[ok].astype(np.float64)) - np.float64(
                    self.ctx32.log10_initial_constant
                )
            bad = np.flatnonzero(~ok)
            self.stats["recomputed"] += len(bad)
            if len(bad):
                ctx64 = PairHMMContext(np.float64)
                with Timer("pairhmm.recompute64"):
                    r64 = native.pairhmm_forward(
                        [testcases[i] for i in bad], np.float64
                    )
                    out[bad] = np.log10(r64) - np.float64(
                        ctx64.log10_initial_constant
                    )
            return out

    def compute_matrix(self, reads: Sequence[dict], haps: Sequence[np.ndarray]) -> np.ndarray:
        """All read x hap likelihoods, read-major."""
        tcs = [dict(hap=h, **r) for r in reads for h in haps]
        return self.compute_pairs(tcs).reshape(len(reads), len(haps))

    # -- flat ingestion path ----------------------------------------------

    def compute_pairs_flat(
        self,
        rs: np.ndarray, q: np.ndarray, i: np.ndarray, d: np.ndarray,
        c: np.ndarray, lens: np.ndarray,
        hap: np.ndarray, hlens: np.ndarray,
        offs: Optional[np.ndarray] = None,
        hoffs: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """log10-likelihoods from concatenated (wire-format) inputs: the
        per-read byte streams rs/q/i/d/c concatenated in pair order (lens
        gives each read length, offs optional start offsets), hap likewise
        (hlens, hoffs).  Bucketing, sorting, packing and the fp64
        recompute run on flat arrays with no per-pair Python."""
        with Timer("pairhmm.call"):
            return self._flat_finalize(
                self._flat_launch(rs, q, i, d, c, lens, hap, hlens, offs, hoffs)
            )

    def _flat_launch(
        self, rs, q, i, d, c, lens, hap, hlens, offs=None, hoffs=None
    ):
        """Pack + launch all buckets of one flat batch without fetching;
        _flat_finalize completes it.  Returns a _FlatBatch, or an ndarray
        when the batch needed no launch."""
        lens = np.asarray(lens, np.int32)
        hlens = np.asarray(hlens, np.int32)
        n = len(lens)
        if n == 0:
            return np.zeros(0, np.float64)
        offs, hoffs = _starts(lens, offs), _starts(hlens, hoffs)
        if self.mesh is not None:  # the mesh route runs on the dict path
            tcs = [
                dict(rs=rs[offs[k]:offs[k] + lens[k]], q=q[offs[k]:offs[k] + lens[k]],
                     i=i[offs[k]:offs[k] + lens[k]], d=d[offs[k]:offs[k] + lens[k]],
                     c=c[offs[k]:offs[k] + lens[k]],
                     hap=hap[hoffs[k]:hoffs[k] + hlens[k]])
                for k in range(n)
            ]
            return self._compute_pairs(tcs)
        with Timer("pairhmm.bucket"):
            self.stats["pairs"] += n
            rs, q, i, d, c, hap = (
                np.ascontiguousarray(a, np.uint8) for a in (rs, q, i, d, c, hap)
            )
            self.stats["cells"] += int((lens.astype(np.int64) * hlens).sum())

            rbuckets = np.asarray(self.config.read_buckets, np.int32)
            cbuckets = np.asarray(self.config.hap_buckets, np.int32)
            # bucket of each pair (vectorized); oversize -> host
            rb = np.searchsorted(rbuckets - 1, lens, side="left")
            cb = np.searchsorted(cbuckets, hlens, side="left")
            over = (rb >= len(rbuckets)) | (cb >= len(cbuckets))

            raw = np.zeros(n, np.float32)
            host_thread, host_err = None, []
            over_idx = np.flatnonzero(over)
            if len(over_idx):
                self.stats["host_fallback"] = (
                    self.stats.get("host_fallback", 0) + len(over_idx)
                )

                def host_work():
                    try:
                        with Timer("pairhmm.host_forward"):
                            out = np.empty(len(over_idx), np.float32)
                            native.get_lib().pairhmm_forward_batch_f32(
                                rs, q, i, d, c,
                                np.ascontiguousarray(offs[over_idx]),
                                np.ascontiguousarray(lens[over_idx]),
                                hap, np.ascontiguousarray(hoffs[over_idx]),
                                np.ascontiguousarray(hlens[over_idx]), len(over_idx),
                                np.ascontiguousarray(self.ctx32.ph2pr, np.float32),
                                np.ascontiguousarray(self.ctx32.match_to_match, np.float32),
                                np.float32(self.ctx32.initial_constant), out,
                            )
                            raw[over_idx] = out
                    except BaseException as e:  # re-raised after join
                        host_err.append(e)

                host_thread = threading.Thread(target=host_work)
                host_thread.start()

            code = rb * (len(cbuckets) + 1) + cb  # group id per pair
            groups = []
            for g in np.unique(code[~over]):
                idxs = np.flatnonzero((code == g) & ~over)
                gr, gc = divmod(int(g), len(cbuckets) + 1)
                rows, cols = int(rbuckets[gr]), int(cbuckets[gc])
                max_pairs = self.config.max_batch_pairs
                for lo in range(0, len(idxs), max_pairs):
                    sel = idxs[lo : lo + max_pairs]
                    # longest haplotypes launch first (tail balance)
                    groups.append((sel[np.argsort(-hlens[sel], kind="stable")], rows, cols))
        streams = (rs, q, i, d, c, offs, lens, hap, hoffs, hlens)
        pending = None
        if groups and self.config.upload == "f32":
            pending = self._launch_f32(streams, groups)
        elif groups:
            pending = self._launch_gathered(streams, groups)
        if pending is not None:
            self.stats["h2d_bytes"] = (
                self.stats.get("h2d_bytes", 0) + pending.h2d_bytes
            )
        return _FlatBatch(streams, raw, pending, host_thread, host_err)

    def _flat_finalize(self, batch) -> np.ndarray:
        """Fetch + scatter + fp64 epilogue for a _flat_launch result."""
        if isinstance(batch, np.ndarray):
            return batch
        if batch.pending is not None:
            self.stats["d2h_bytes"] = (
                self.stats.get("d2h_bytes", 0) + batch.pending.scatter(batch.raw)
            )
        with Timer("pairhmm.host_join"):
            if batch.host_thread is not None:
                batch.host_thread.join()
                if batch.host_err:
                    raise batch.host_err[0]
        return self._epilogue_flat(*batch.streams, batch.raw)

    def _epilogue_flat(
        self, rs, q, i, d, c, offs, lens, hap, hoffs, hlens, raw
    ) -> np.ndarray:
        """log10 + fp64 recompute on flat arrays (no per-pair dicts)."""
        with Timer("pairhmm.epilogue"):
            n = len(lens)
            out = np.empty(n, np.float64)
            ok = raw >= np.float32(self.config.min_accepted)
            with np.errstate(divide="ignore"):
                out[ok] = np.log10(raw[ok].astype(np.float64)) - np.float64(
                    self.ctx32.log10_initial_constant
                )
            bad = np.flatnonzero(~ok)
            self.stats["recomputed"] += len(bad)
            if len(bad):
                ctx64 = PairHMMContext(np.float64)
                r64 = np.empty(len(bad), np.float64)
                with Timer("pairhmm.recompute64"):
                    native.get_lib().pairhmm_forward_batch_f64(
                        rs, q, i, d, c,
                        np.ascontiguousarray(offs[bad]),
                        np.ascontiguousarray(lens[bad]),
                        hap, np.ascontiguousarray(hoffs[bad]),
                        np.ascontiguousarray(hlens[bad]), len(bad),
                        np.ascontiguousarray(ctx64.ph2pr, np.float64),
                        np.ascontiguousarray(ctx64.match_to_match, np.float64),
                        np.float64(ctx64.initial_constant), r64,
                    )
                    out[bad] = np.log10(r64) - np.float64(
                        ctx64.log10_initial_constant
                    )
            return out

    def compute_pairs_flat_stream(self, batches) -> list:
        """Pipelined multi-batch flat computation: batch k+1 is packed and
        launched before batch k is fetched, so host packing overlaps the
        card's work; at most two batches are in flight.

        batches: iterable of (rs, q, i, d, c, lens, hap, hlens) tuples.
        Returns a list of per-batch log10-likelihood arrays."""
        states: list = []
        outs: list = []
        for b in batches:
            with Timer("pairhmm.stream_launch"):
                states.append(self._flat_launch(*b))
            if len(states) > 1:
                with Timer("pairhmm.stream_finalize"):
                    outs.append(self._flat_finalize(states.pop(0)))
        while states:
            with Timer("pairhmm.stream_finalize"):
                outs.append(self._flat_finalize(states.pop(0)))
        return outs

    def compute_matrix_flat(
        self, rs, q, i, d, c, read_lens, hap, hap_lens
    ) -> np.ndarray:
        """All read x hap likelihoods from flat per-read / per-hap streams.
        Pair (r, h) is addressed by (read offset r, hap offset h), so no
        data is replicated on the host."""
        read_lens = np.asarray(read_lens, np.int32)
        hap_lens = np.asarray(hap_lens, np.int32)
        n_r, n_h = len(read_lens), len(hap_lens)
        roffs, hoffs0 = _starts(read_lens, None), _starts(hap_lens, None)
        res = self.compute_pairs_flat(
            rs, q, i, d, c,
            np.repeat(read_lens, n_h), hap, np.tile(hap_lens, n_r),
            offs=np.repeat(roffs, n_h), hoffs=np.tile(hoffs0, n_r),
        )
        return res.reshape(n_r, n_h)
