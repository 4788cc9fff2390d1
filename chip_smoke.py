"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, all at
once.  PairHMM: checks the forward kernel against its plain PyTorch
version at the benchmark shapes, on the edges of its segment design
(buckets of 1 to 1024 rows, haplotypes of 1 and 1024 columns, unpadded
packs whose last warp is partly filled, all three front ends) and at the
shapes the engine launches,
drives the PairHMM engine's main path (compute_matrix_flat,
compute_pairs_flat_stream) on a WES-shaped batch of 16,384 pairs, holds
the byte-plane gather bit for bit against its plain version on that
path's upload, and checks the contract edges (reference corpus, fp64 underflow recompute,
host fallback).  Smith-Waterman: checks the fill and walk kernels bit for
bit against their plain versions at the SW benchmark shape (8192 pairs,
four overhang strategies) and on the edges of the fill's warp per pair
(reflen at the boundaries of its row chunks against altlen 1 and full,
batches that leave a block partly filled, a filled 1536-row bucket) and
of the walk's warp per pair (match runs of 31-64 cells before a gap,
gaps past 32 cells, gaps as the first and last step, walks ending on row
0 and column 0, lengths of 1, start-cell ties, 47-53 elements, 4096
gap-heavy pairs), drives SWEngine on it against the native host engine
and the oracle, times its call in pieces (pack, launches, the card,
the fetch, the decode), and checks its edges (ties, mixed buckets, host
fallback, element overflow).  HaplotypeCaller: drives
HaplotypeCallerCore on the port's two engines at 64 and 1024 regions.
BWA-MEM: checks the seed-extension kernel bit for bit against its plain
version at the extension benchmark's shape, on three edge batches and on
the edges of its one-warp-a-task design (query lengths at the boundaries
of 1, 2 and 8 columns a lane, band 8, max_ins below the band, h0 0, and
past 256 columns its shared-memory tiles: gaps at column 256, Q 1536 and
the Q 25,600 cap), drives ExtendEngine on 4096 seeds against the native
host engine and the oracle (with its host fallback, queries past 256
columns on the card, degenerate seeds and the BWA-SW record fixture);
builds a 100 Mbp FM-index, checks the SMEM kernel against its
plain version on 65,536 reads of 101 bp (with the distribution of its
extensions a read), drives SmemEngine on them against the native host
engine and the oracle (with its edges); then drives BwaMemSeeding on
GenomicsEngine over 2048 reads against the same composition over the
native host engines and the oracle chain; checks the SMEM kernel and the
fused seed-extension kernel bit for bit against their plain versions on
BwaMemDevicePipeline's own launches, and the fused kernel on the edges of
its warp per seed (left queries of 0-33, read widths 32, 33, 256 and 300,
seeds at both text ends, round 2), drives the pipeline on the same reads
against BwaMemSeeding, and checks its edges.  Mesh: on a (1, 4)
mesh of the one card, checks the band kernel against its plain version on
the first and the middle superstep of the DP x SP pipeline (byte planes
at C = 8, 16 and 32, fp32 planes at the engine's C) and times the
pipeline at each C, drives PairHMMEngine(mesh=...) on 2,048 pairs whose
haplotypes are all past 1024 columns against the native host engine and
the oracle, holds SP against the DP kernel on pairs that fit, and checks
the edges and GenomicsEngine(mesh=...).  The rest of PairHMMEngine:
upload="f32" on the engine batch against the byte-plane route, the
dispatch gate calibrated on the card and routing by it.  The service:
EngineServer around the 100 Mbp GenomicsEngine, one request at each
engine's main-path shape equal to the direct call and the native host,
round trips against direct calls, an index loaded by path, the CLI
daemon and concurrent clients.  Then each port driver at small sizes,
entry() and dryrun_multichip(4) on the one card.  Last, two processes on
the one card in a gloo group run the process-group forms (PairHMM DP and
DP x SP, SW, extension, SMEM) at the main paths' shapes against the
single-process forms, and the scaling driver runs on the card repeated.
Any failed check raises, so the exit code is non-zero.  The last line of
standard output is one JSON object naming the device; the line before it
lists each kernel of the main paths with its launches, error, times and
bound (the larger of its bytes over the memory rate and its operations
over the peak rate, computed from this run's inputs).

Needs a CUDA card and the native host library (built with a C++ compiler
at first use).  Imports only the port, never JAX or the JAX package.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CU_SOURCE = "acc_genomics_tpu_torch/ops/pairhmm/csrc/pairhmm_forward.cu"
TPU_KERNEL = "acc_genomics_tpu/ops/pairhmm/kernel.py:79"
# the byte-plane gather: on the TPU the planes are packed on the host
GATHER_SOURCE = "acc_genomics_tpu_torch/ops/pairhmm/csrc/pairhmm_gather.cu"
GATHER_TPU = "acc_genomics_tpu/ops/pairhmm/pack.py:220"
SW_FILL_SOURCE = "acc_genomics_tpu_torch/ops/sw/csrc/sw_fill.cu"
SW_FILL_TPU = "acc_genomics_tpu/ops/sw/kernel.py:57"
SW_WALK_SOURCE = "acc_genomics_tpu_torch/ops/sw/csrc/sw_walk.cu"
SW_WALK_TPU = "acc_genomics_tpu/ops/sw/walker.py:62"
EXTEND_SOURCE = "acc_genomics_tpu_torch/ops/extend/csrc/sw_extend.cu"
EXTEND_TPU = "acc_genomics_tpu/ops/extend/kernel.py:49"
SMEM_SOURCE = "acc_genomics_tpu_torch/ops/smem/csrc/smem_collect.cu"
SMEM_TPU = "acc_genomics_tpu/ops/smem/machine.py:267"
FUSED_TPU = "acc_genomics_tpu/models/bwa_mem.py:109"
BAND_SOURCE = "acc_genomics_tpu_torch/ops/pairhmm/csrc/pairhmm_band.cu"
BAND_TPU = "acc_genomics_tpu/ops/pairhmm/band_kernel.py:61"
# H100 SXM peaks (NVIDIA's data sheet, at 700 W): HBM3 bytes/s, fp32 outside
# the tensor cores, and int32 at half the fp32 rate (64 INT32 lanes an SM
# against 128 FP32)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 33.5e12
PAIRHMM_OPS_PER_CELL = 13  # fp32 (the JAX cost estimate, band_kernel.py:275)
SW_OPS_PER_CELL = 10  # int32: H, E, F maxima, the gap terms, the btrack code
EXTEND_OPS_PER_CELL = 12  # int32: M + sc, the h/e/f maxima, the row max, zero runs
SMEM_OPS_PER_PROBE = 32  # int32: two occ counts (masks, popcounts, sums) an extension
SMEM_PROBE_BYTES = 2 * 32  # two 32-byte probe-table rows an extension
SMEM_GENOME = 100_000_000  # bases: drivers/smem_driver.py's genome scale
SMEM_READS = 65536  # bench_smem's lane count, reads of 101
BWA_READS = 2048  # bench_bwamem's reads (max_occ 4, flank 100)
RETRY_GENOME = 64_444_167  # bases: the BWA cell's chr20, repeat-rich
RETRY_READS = 16384  # the BWA cell's reads of 150 a call
HC_SIZES = (64, 1024)  # regions: bench_hc's shape, and one full SW max_batch
HC_REPEATS = 5
# phase 15: 256 reads of up to 250 against 8 haplotypes of 2048-4096
MESH_READS, MESH_HAPS, MESH_READ_LEN, MESH_HAP_LEN = 256, 8, 250, 4096

# kernel vs plain on the card: every lane in raw fp32 within RAW_RTOL
# (denormal lanes within RAW_ATOL, 1/1024 of the smallest normal fp32),
# and the lanes the engine keeps (>= MIN_ACCEPTED) in log10 space within
# LOG_RTOL_PLAIN.  The kernel fuses multiply-adds and sums in another
# order than the plain version; nothing else differs.
RAW_RTOL = 1e-5
RAW_ATOL = float(np.finfo(np.float32).tiny) * 2.0**-10
LOG_RTOL_PLAIN = 1e-5
RTOL_HOST = 2e-4  # engine (arith expansion) vs native fp32 host engine
RTOL_HOST_GATHER = 1e-5  # engine (gather: the host's own tables) vs host
RTOL_ORACLE = 5e-3  # vs the fp64 oracle and the corpus golden file
MIN_ACCEPTED = 1e-28  # below this the engine recomputes in fp64
E2E_REPEATS = 10


def say(*a):
    print(*a, flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_time_ms(fn, repeats: int = 7, warm: bool = True) -> float:
    """Median of ``repeats`` CUDA-event timings of fn() (after one
    warm-up call unless ``warm`` is False)."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def bound(bytes_moved: float, ops: float, ops_per_s: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate."""
    b_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    o_ms = ops / ops_per_s * 1e3
    return {"bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "library_ms": None}


def spans_now() -> dict:
    """The program's span registry (``utils/timer.timers``) now."""
    from acc_genomics_tpu_torch.utils.timer import timers

    return timers()


def spans_ms(before: dict, calls: int) -> dict:
    """ms a call of each of the program's spans opened since the
    ``spans_now()`` reading ``before``."""
    return {k: round(1e3 * (v["total_s"] - before.get(k, {}).get("total_s", 0.0)) / calls, 4)
            for k, v in spans_now().items() if v["count"] != before.get(k, {}).get("count", 0)}


def nbytes(*tensors) -> int:
    import torch

    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def loglik(raw: np.ndarray, log10_ic) -> np.ndarray:
    with np.errstate(divide="ignore"):
        return np.log10(raw.astype(np.float64)) - np.float64(log10_ic)


def kernel_vs_plain(name: str, got: np.ndarray, want: np.ndarray, log10_ic) -> float:
    """Hold the kernel's raw results against the plain version's on every
    lane; returns the largest log10 error over the accepted lanes."""
    check(got.shape == want.shape, f"{name}: shape {got.shape} vs {want.shape}")
    check(np.isfinite(got).all() and np.isfinite(want).all(), f"{name}: non-finite")
    g64, w64 = got.astype(np.float64), want.astype(np.float64)
    err = np.abs(g64 - w64)
    off = err > RAW_RTOL * np.abs(w64) + RAW_ATOL
    if off.any():
        k = int(np.argmax(np.where(off, err, -1.0)))
        raise AssertionError(f"chip_smoke check failed: {name}: {int(off.sum())} "
                             f"lanes off in raw fp32, e.g. lane {k} kernel "
                             f"{got[k]!r} plain {want[k]!r}")
    ok = want >= MIN_ACCEPTED
    gl, wl = loglik(got[ok], log10_ic), loglik(want[ok], log10_ic)
    max_abs = float(np.max(np.abs(gl - wl))) if ok.any() else 0.0
    max_rel = float(np.max(np.abs(gl - wl) / np.abs(wl))) if ok.any() else 0.0
    check(max_rel <= LOG_RTOL_PLAIN, f"{name}: kernel vs plain log rel {max_rel}")
    low = w64[~ok]
    normal = low >= np.finfo(np.float32).tiny
    rel_low = err[~ok][normal] / low[normal]
    say(f"{name}: {len(want)} lanes; {int(ok.sum())} >= {MIN_ACCEPTED}: "
        f"max_abs_log10_err={max_abs:.3e} max_rel_log10={max_rel:.3e}; "
        f"{len(low)} below: {int(np.sum(low == 0))} zero, "
        f"{int(np.sum((low > 0) & ~normal))} denormal, {int(normal.sum())} "
        f"normal (max raw rel err {rel_low.max() if len(rel_low) else 0.0:.3e})")
    return max_abs


def matrix_pair_args(f):
    """compute_matrix_flat arguments -> compute_pairs_flat arguments."""
    rs, q, i, d, c, rl, hap, hl = f
    n_r, n_h = len(rl), len(hl)
    roffs = np.zeros(n_r, np.int64)
    np.cumsum(rl[:-1].astype(np.int64), out=roffs[1:])
    hoffs = np.zeros(n_h, np.int64)
    np.cumsum(hl[:-1].astype(np.int64), out=hoffs[1:])
    return (rs, q, i, d, c, np.repeat(rl, n_h), hap, np.tile(hl, n_r),
            np.repeat(roffs, n_h), np.tile(hoffs, n_r))


def oracle(tcs) -> np.ndarray:
    from acc_genomics_tpu_torch.ops.pairhmm.reference import pairhmm_loglik_oracle

    return np.array([pairhmm_loglik_oracle(t["rs"], t["q"], t["i"], t["d"],
                                           t["c"], t["hap"]) for t in tcs])


def host_loglik(tcs):
    """(log10-likelihoods, count recomputed) of the native host engine:
    fp32, and fp64 below MIN_ACCEPTED, as the engines' epilogue does."""
    from acc_genomics_tpu_torch import native
    from acc_genomics_tpu_torch.ops.pairhmm.context import PairHMMContext

    raw = native.pairhmm_forward(tcs, np.float32)
    out = loglik(raw, PairHMMContext(np.float32).log10_initial_constant)
    low = np.flatnonzero(raw < MIN_ACCEPTED)
    if len(low):
        out[low] = loglik(native.pairhmm_forward([tcs[k] for k in low], np.float64),
                          PairHMMContext(np.float64).log10_initial_constant)
    return out, len(low)


def masked_max_abs(a, b, region, step: int = 512) -> int:
    """Largest |a - b| where ``region`` holds, over slices of ``step``
    pairs (the whole int32 difference would take gigabytes)."""
    worst = 0
    for lo in range(0, a.shape[0], step):
        d = (a[lo:lo + step].int() - b[lo:lo + step].int()).abs()
        worst = max(worst, int(d.masked_fill_(~region[lo:lo + step], 0).max()))
    return worst


def sw_bench_batch(dev):
    """bench.py bench_sw's batch (seed 0, one ref of 286 vs 8192 alts) as
    the engine cuts it: one 320 x 320 bucket in chunks of chunk_pairs."""
    from acc_genomics_tpu_torch.tools.bench_shapes import sw_bench_chunks

    ref, alts, chunks = sw_bench_chunks(dev)
    rows, cols = chunks[0][0].shape[1], chunks[0][1].shape[1]
    check(rows == cols == 320 and all(c[1].shape[1] == 320 for c in chunks)
          and min(len(a) for a in alts) > 256, f"bench SW bucket {rows} x {cols}")
    return ref, alts, chunks


def sw_fill_walk_errors(ref, alt, rl, al, strategy: int):
    """(fill error, walk error, walk output bytes) of the fill and walk
    kernels against their plain versions on one batch: the fill inside
    each pair's region, its last row and column, the packed walk of each
    fill's own outputs."""
    import torch

    from acc_genomics_tpu_torch.ops.sw import kernel as SK

    rows, cols = ref.shape[1], alt.shape[1]
    got = SK.sw_fill(ref, alt, rl, al, strategy)
    want = SK.sw_fill_plain(ref, alt, rl, al, strategy)
    err = masked_max_abs(got[0], want[0], SK.btrack_region(rl, al, rows, cols))
    in_row = torch.arange(cols, device=ref.device)[None, :] < al[:, None]
    in_col = torch.arange(rows, device=ref.device)[None, :] < rl[:, None]
    err = max(err, int(torch.where(in_row, got[1] - want[1], 0).abs().max()),
              int(torch.where(in_col, got[2] - want[2], 0).abs().max()))
    packed = SK.sw_walk(*got, rl, al, strategy)
    packed_plain = SK.sw_walk_plain(*want, rl, al, strategy)
    return err, int((packed.int() - packed_plain.int()).abs().max()), nbytes(packed)


def sw_kernels_vs_plain(chunks, card: str):
    """Fill and walk kernels against their plain versions on every pair of
    the bench batch, inside each pair's region, in all four strategies;
    then their times (strategy 0).  Returns (fill_err, fill_ms,
    fill_plain_ms, walk_err, walk_ms, walk_plain_ms)."""
    import torch

    from acc_genomics_tpu_torch.ops.sw import kernel as SK
    from acc_genomics_tpu_torch.tools.bench_shapes import (
        WALK_GAP_PAIRS,
        sw_fill_batches,
        sw_walk_batches,
    )

    cells = sum(int((rl.long() * al.long()).sum()) for _, _, rl, al in chunks)
    # bytes each kernel must move: the fill reads the planes and lengths and
    # writes 2 B of backtrack a real cell plus the last row and column; the
    # walk reads those and at least one backtrack cell a step of a walk of
    # max(ref, alt) steps, and writes the packed elements
    edge = sum(nbytes(*c) + 4 * c[0].shape[0] * (c[0].shape[1] + c[1].shape[1] + 1)
               for c in chunks)
    fill_bound = bound(2 * cells + edge, SW_OPS_PER_CELL * cells, INT32_OPS_PER_S)
    steps = sum(int(torch.maximum(rl, al).long().sum()) for _, _, rl, al in chunks)
    fill_err = walk_err = 0

    def time_walk(name, ref, alt, rl, al):
        fill = SK.sw_fill(ref, alt, rl, al, 0)
        say(f"sw_walk on {name}: kernel_ms="
            f"{cuda_time_ms(lambda: SK.sw_walk(*fill, rl, al, 0)):.4f} [{card}]")

    for strategy in (0, 1, 2, 3):
        for ref, alt, rl, al in chunks:
            f_err, w_err, walk_out = sw_fill_walk_errors(ref, alt, rl, al, strategy)
            fill_err, walk_err = max(fill_err, f_err), max(walk_err, w_err)
        say(f"sw bench strategy {strategy}: {len(chunks)} chunks of "
            f"{[c[0].shape[0] for c in chunks]} pairs; fill max_abs_err={fill_err} "
            f"walk max_abs_err={walk_err}")
        check(fill_err == 0 and walk_err == 0,
              f"SW kernels vs plain, strategy {strategy}: not bit-exact")
    # the edges of the warp-per-pair fill: chunk boundaries, altlen 1,
    # batches that leave a block partly filled, a 1536-row bucket
    for name, ref, alt, rl, al in sw_fill_batches(chunks[0][0].device):
        errs = [sw_fill_walk_errors(ref, alt, rl, al, s)[:2] for s in (0, 1, 2, 3)]
        say(f"sw edges {name}: {ref.shape[0]} pairs, {ref.shape[1]} x {alt.shape[1]}; "
            f"fill and walk max_abs_err over 4 strategies {max(max(e) for e in errs)}")
        check(all(e == (0, 0) for e in errs), f"SW kernels vs plain, {name}: not bit-exact")
        if ref.shape[1] == 1536:
            time_walk(name, ref, alt, rl, al)
    # the edges of the warp-per-pair walk: match runs of 31-64 cells, gaps
    # past a round's reach, gaps first and last, ends on row 0 and column 0,
    # lengths of 1, start-cell ties, 47-53 elements, 4096 gap-heavy pairs
    for name, ref, alt, rl, al in sw_walk_batches(chunks[0][0].device):
        errs = [sw_fill_walk_errors(ref, alt, rl, al, s)[:2] for s in (0, 1, 2, 3)]
        say(f"sw walk edges {name}: {ref.shape[0]} pairs, {ref.shape[1]} x {alt.shape[1]}; "
            f"fill and walk max_abs_err over 4 strategies {max(max(e) for e in errs)}")
        check(all(e == (0, 0) for e in errs), f"SW kernels vs plain, {name}: not bit-exact")
        if ref.shape[0] == WALK_GAP_PAIRS:
            time_walk(name, ref, alt, rl, al)

    fills = [SK.sw_fill(*c, 0) for c in chunks]
    fill_ms = cuda_time_ms(lambda: [SK.sw_fill(*c, 0) for c in chunks])
    fill_plain_ms = cuda_time_ms(lambda: [SK.sw_fill_plain(*c, 0) for c in chunks],
                                 repeats=1, warm=False)
    walk = lambda fn: [fn(*f, c[2], c[3], 0) for f, c in zip(fills, chunks)]
    walk_ms = cuda_time_ms(lambda: walk(SK.sw_walk))
    walk_plain_ms = cuda_time_ms(lambda: walk(SK.sw_walk_plain), repeats=1, warm=False)
    walk_bound = bound(edge + 2 * steps + len(chunks) * walk_out, 0, INT32_OPS_PER_S)
    say(f"sw bench kernels, {cells} cells: sw_fill kernel_ms={fill_ms:.4f} "
        f"plain_ms={fill_plain_ms:.4f} kernel_gcups={cells / (fill_ms * 1e-3) / 1e9:.3f} "
        f"bound {fill_bound}; sw_walk kernel_ms={walk_ms:.4f} plain_ms={walk_plain_ms:.4f} "
        f"bound {walk_bound} [{card}]")
    return (fill_err, fill_ms, fill_plain_ms, fill_bound, walk_err, walk_ms, walk_plain_ms,
            walk_bound)


def sw_engine_main_path(ref, alts, n_chunks: int, card: str) -> dict:
    """SWEngine(device="cuda") on the bench batch, strategy 0: exact
    against the native host engine on every pair and the oracle on 64;
    median of 10 calls.  Returns the kernel launches of the timed calls."""
    import torch

    from acc_genomics_tpu_torch.engine.sw_engine import SWEngine
    from acc_genomics_tpu_torch.ops.sw import kernel as SK
    from acc_genomics_tpu_torch import native
    from acc_genomics_tpu_torch.ops.sw.reference import sw_align_oracle

    refs = [ref] * len(alts)
    eng = SWEngine(device="cuda")
    first = eng.align(refs, alts, 0)  # warm-up (allocator, pinned pool)
    torch.cuda.synchronize()
    SK.LAUNCHES.clear()
    times, results = [], []
    for _ in range(E2E_REPEATS):
        t0 = time.perf_counter()
        results.append(eng.align(refs, alts, 0))
        times.append(time.perf_counter() - t0)
    launches = dict(SK.LAUNCHES)
    cells = sum(len(ref) * len(a) for a in alts)
    med = statistics.median(times)
    say(f"SWEngine main path: {len(alts)} pairs, {cells} cells, {n_chunks} chunks a "
        f"call; launches {launches} over {E2E_REPEATS} calls; e2e_s median={med:.5f} "
        f"min={min(times):.5f} max={max(times):.5f}; e2e_gcups median="
        f"{cells / med / 1e9:.3f} min={cells / max(times) / 1e9:.3f} "
        f"max={cells / min(times) / 1e9:.3f} [{card}]")
    check(launches.get("sw_fill") == launches.get("sw_walk") == E2E_REPEATS * n_chunks
          and len(launches) == 2, f"SWEngine launches {launches}")
    check(all(r == first for r in results), "repeated SWEngine calls differ")
    check(first == native.sw_align_host(refs, alts, 0), "SWEngine vs native host")
    sample = np.random.default_rng(4).choice(len(alts), 64, replace=False)
    check(all(first[k] == sw_align_oracle(ref, alts[k], 0) for k in sample),
          "SWEngine vs oracle")
    say(f"SWEngine == native host on {len(alts)} pairs, == oracle on 64: ok "
        f"(stats {eng.stats})")
    split = sw_host_split(refs, alts, first)
    say("SWEngine call in pieces (host clocks, median of "
        f"{E2E_REPEATS}; a synchronize after the launches): "
        + " ".join(f"{k}_ms={v:.3f}" for k, v in split.items())
        + f"; whole-call e2e_ms median={med * 1e3:.3f} [{card}]")
    return launches


def sw_host_split(refs, alts, want) -> dict:
    """The pieces of SWEngine.align (engine/sw_engine.py) on one call,
    strategy 0, timed apart with host clocks by running its steps here as
    the engine strings them together: grouping by bucket and the planes
    pack into the pinned staging buffer (sw_align_batch_launch up to the
    upload); the upload and the fill and walk launches (host time to
    enqueue); the wait for the card; the one D2H fetch; and
    sw_align_batch_decode.  Medians of E2E_REPEATS calls; the CIGARs must
    equal the engine's (``want``)."""
    import torch

    from acc_genomics_tpu_torch.config import SWConfig
    from acc_genomics_tpu_torch.engine.sw_engine import chunk_pairs
    from acc_genomics_tpu_torch.ops.sw.batch import pack_planes, sw_align_batch_decode
    from acc_genomics_tpu_torch.ops.sw.kernel import sw_fill, sw_walk

    cfg, dev = SWConfig(), torch.device("cuda", 0)
    bucket = lambda n: next(b for b in cfg.seq_buckets if b >= n)
    times = {k: [] for k in ("group_pack", "launch", "device_wait", "fetch", "decode")}
    for _ in range(E2E_REPEATS):
        t0 = time.perf_counter()
        groups = {}
        for k, (r, a) in enumerate(zip(refs, alts)):
            groups.setdefault((bucket(len(r)), bucket(len(a))), []).append(k)
        staged = []
        for (rows, cols), idxs in groups.items():
            seg = chunk_pairs(rows, cols, cfg.max_batch)
            for lo in range(0, len(idxs), seg):
                part = idxs[lo:lo + seg]
                n = len(part)
                meta_at = -(-n * (rows + cols) // 16) * 16
                buf = torch.empty(meta_at + 8 * n, dtype=torch.uint8, pin_memory=True)
                hv = buf.numpy()
                meta = hv[meta_at:].view(np.int32).reshape(2, n)
                meta[0] = pack_planes([refs[k] for k in part], rows,
                                      hv[: n * rows].reshape(n, rows))
                meta[1] = pack_planes([alts[k] for k in part], cols,
                                      hv[n * rows: n * (rows + cols)].reshape(n, cols))
                staged.append((part, rows, cols, meta_at, buf))
        t1 = time.perf_counter()
        packed = []
        for part, rows, cols, meta_at, buf in staged:
            n = len(part)
            up = buf.to(dev, non_blocking=True)
            lens = up[meta_at:].view(torch.int32).view(2, n)
            fill = sw_fill(up[: n * rows].view(n, rows),
                           up[n * rows: n * (rows + cols)].view(n, cols), lens[0], lens[1], 0)
            packed.append(sw_walk(*fill, lens[0], lens[1], 0))
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        allpacked = torch.cat(packed, 1).cpu().numpy()
        t4 = time.perf_counter()
        out, col = [None] * len(refs), 0
        for part, *_ in staged:
            walked = sw_align_batch_decode(allpacked[:, col: col + len(part)],
                                           [refs[k] for k in part], [alts[k] for k in part], 0)
            col += len(part)
            for j, k in enumerate(part):
                out[k] = walked[j]
        t5 = time.perf_counter()
        for key, a, b in zip(times, (t0, t1, t2, t3, t4), (t1, t2, t3, t4, t5)):
            times[key].append((b - a) * 1e3)
        check(out == want, "SWEngine's pieces vs the engine")
    return {k: statistics.median(v) for k, v in times.items()}


def sw_edges():
    """Ties in all four strategies, mixed buckets with one pair past the
    largest, and an element-overflow pair, on the card."""
    from acc_genomics_tpu_torch.engine.sw_engine import SWEngine
    from acc_genomics_tpu_torch.ops.sw import kernel as SK
    from acc_genomics_tpu_torch.ops.sw.batch import sw_align_batch_launch
    from acc_genomics_tpu_torch import native
    from acc_genomics_tpu_torch.config import SWConfig
    from acc_genomics_tpu_torch.io.synth import gen_sw_batch
    from acc_genomics_tpu_torch.ops.sw.reference import sw_align_oracle
    import torch

    rng = np.random.default_rng(5)
    per = np.tile(np.array([0, 1], np.uint8), 11)
    ref1 = rng.integers(0, 4, 22).astype(np.uint8)
    ref2 = rng.integers(0, 4, 12).astype(np.uint8)
    ties = [(ref1, ref1.copy()), (np.zeros(18, np.uint8), np.zeros(22, np.uint8)),
            (np.zeros(22, np.uint8), np.zeros(13, np.uint8)),
            (per, np.tile(np.array([0, 1], np.uint8), 9)), (per, np.roll(per, 1)),
            (ref2, np.concatenate([ref2, ref2])), (np.concatenate([ref2, ref2]), ref2)]
    eng = SWEngine(device="cuda")
    for strategy in (0, 1, 2, 3):
        got = eng.align([r for r, _ in ties], [a for _, a in ties], strategy)
        check(got == [sw_align_oracle(r, a, strategy) for r, a in ties],
              f"tie-stress cases, strategy {strategy}")
    say(f"SW ties: {len(ties)} cases x 4 strategies == oracle")

    refs, alts = [], []
    for ln in (30, 100, 150, 200, 300, 500, 700, 1000, 1400, 1600):
        r, (a,) = gen_sw_batch(rng, 1, ref_len=ln)
        refs.append(r)
        alts.append(a)
    eng = SWEngine(device="cuda")
    buckets = {(eng._bucket(len(r)), eng._bucket(len(a))) for r, a in zip(refs, alts)}
    n_dev = len({b for b in buckets if None not in b})
    before = SK.LAUNCHES["sw_fill"]
    got = eng.align(refs, alts, 0)
    launched = SK.LAUNCHES["sw_fill"] - before
    say(f"SW mixed buckets {sorted(buckets, key=str)}: launches={launched} "
        f"host_fallback={eng.stats['host_fallback']}")
    check(got == native.sw_align_host(refs, alts, 0), "mixed buckets vs native host")
    check(eng.stats["host_fallback"] == 1 and launched == n_dev,
          "one pair past 1536 on the host, one launch per device bucket")

    ref = rng.integers(0, 4, 96).astype(np.uint8)
    alt = []
    for j, b in enumerate(ref):
        alt += [b, (b + 1) % 4, (b + 2) % 4] if j % 2 == 0 else [b]
    alt = np.asarray(alt, np.uint8)[:160]
    want = sw_align_oracle(ref, alt, 0)
    en = int(sw_align_batch_launch([ref], [alt], 0, 96, 192, torch.device("cuda")
                                   ).packed[SK.SHIP_ELEMS, 0])
    got = SWEngine(SWConfig(seq_buckets=(96, 192)), device="cuda").align([ref], [alt], 0)
    say(f"SW element overflow: {len(want[0])} elements, walk count {en}")
    check(en > SK.SHIP_ELEMS and got[0] == want, "element overflow rerun on the oracle")


def hc_phases(card: str):
    """HaplotypeCallerCore on the port's engines at bench_hc's shape (64
    regions of gen_region(n_reads=24), seed 0) and at 1024 regions (4096
    SW pairs, 98,304 PairHMM pairs): exact haplotype CIGARs against the
    native host, sampled likelihoods against the fp64 oracle, best
    haplotype recovery >= 0.55; regions/s as the median of 5 calls."""
    import torch

    from acc_genomics_tpu_torch.engine.pairhmm_engine import PairHMMEngine
    from acc_genomics_tpu_torch.engine.sw_engine import SWEngine
    from acc_genomics_tpu_torch.io.synth import gen_region
    from acc_genomics_tpu_torch.models import HaplotypeCallerCore, HCEngines
    from acc_genomics_tpu_torch.ops.pairhmm import kernel as K
    from acc_genomics_tpu_torch.ops.sw import kernel as SK
    from acc_genomics_tpu_torch import native
    from acc_genomics_tpu_torch.ops.pairhmm.reference import pairhmm_loglik_oracle

    for n_regions in HC_SIZES:
        rng = np.random.default_rng(0)
        made = [gen_region(rng, n_reads=24) for _ in range(n_regions)]
        regions = [m[:3] for m in made]
        n_sw = sum(len(h) for _, h, _ in regions)
        n_ph = sum(len(h) * len(r) for _, h, r in regions)
        hc = HaplotypeCallerCore(HCEngines(SWEngine(device="cuda"),
                                           PairHMMEngine(device="cuda")))
        hc.process_regions(regions)  # warm-up
        torch.cuda.synchronize()
        hc.reset_anatomy()
        K.LAUNCHES.clear()
        SK.LAUNCHES.clear()
        times = []
        for _ in range(HC_REPEATS):
            t0 = time.perf_counter()
            results = hc.process_regions(regions)
            times.append(time.perf_counter() - t0)
        launches = {**K.LAUNCHES, **SK.LAUNCHES}
        med = statistics.median(times)
        anatomy = {k: round(v / HC_REPEATS, 6) for k, v in hc.anatomy.items()}
        say(f"HC {n_regions} regions ({n_sw} SW pairs, {n_ph} PairHMM pairs): "
            f"regions_per_s median={n_regions / med:.3f} min={n_regions / max(times):.3f} "
            f"max={n_regions / min(times):.3f} (n={HC_REPEATS}); anatomy s per call "
            f"{anatomy}; launches {launches} [{card}]")
        check(launches.get("sw_fill", 0) > 0 and launches.get("sw_walk", 0) > 0
              and launches.get("pairhmm_forward_from_quals", 0) > 0,
              f"HC main path launches {launches}")

        refs = [ref for ref, haps, _ in regions for _ in haps]
        haps = [h for _, hs, _ in regions for h in hs]
        got = [c for res in results for c in res.hap_cigars]
        check(got == native.sw_align_host(refs, haps, hc.overhang_strategy),
              f"HC {n_regions}: haplotype CIGARs vs native host")
        worst = 0.0
        pick = np.random.default_rng(6)
        for k in pick.choice(n_regions, 4, replace=False):
            _, hs, reads = regions[k]
            for r_i in pick.choice(len(reads), 2, replace=False):
                r = reads[r_i]
                for h_i, h in enumerate(hs):
                    want = pairhmm_loglik_oracle(r["rs"], r["q"], r["i"], r["d"], r["c"], h)
                    worst = max(worst, abs(results[k].likelihoods[r_i, h_i] - want) / abs(want))
        hits = sum(int((res.best_hap == np.asarray(m[3])).sum())
                   for res, m in zip(results, made))
        recovery = hits / sum(len(m[3]) for m in made)
        say(f"HC {n_regions}: CIGARs == native host on {n_sw} haplotypes; 32 sampled "
            f"likelihoods max_rel={worst:.3e}; best-hap recovery {recovery:.3f}")
        check(worst < RTOL_ORACLE, f"HC {n_regions}: likelihoods vs oracle")
        check(recovery >= 0.55, f"HC {n_regions}: recovery {recovery}")


def sw_phases(card: str) -> list:
    """Phases 6-8; returns the kernels-line entries of sw_fill and sw_walk."""
    import torch

    ref, alts, chunks = sw_bench_batch(torch.device("cuda", 0))
    (fill_err, fill_ms, fill_plain_ms, fill_bound, walk_err, walk_ms, walk_plain_ms,
     walk_bound) = sw_kernels_vs_plain(chunks, card)
    launches = sw_engine_main_path(ref, alts, len(chunks), card)
    del chunks
    sw_edges()
    return [
        {"name": "sw_fill", "route": "cuda", "source": SW_FILL_SOURCE,
         "replaces": SW_FILL_TPU, "launches": launches.get("sw_fill", 0),
         "max_abs_err": fill_err, "ms": fill_ms, "plain_ms": fill_plain_ms, **fill_bound},
        {"name": "sw_walk", "route": "cuda", "source": SW_WALK_SOURCE,
         "replaces": SW_WALK_TPU, "launches": launches.get("sw_walk", 0),
         "max_abs_err": walk_err, "ms": walk_ms, "plain_ms": walk_plain_ms, **walk_bound},
    ]


def host_extend_seeds(seeds, params):
    """ExtendEngine's records computed over the native host engine."""
    from acc_genomics_tpu_torch.engine.extend_engine import resolve_seeds, seed_tasks
    from acc_genomics_tpu_torch import native

    lq, lt, rq, rt = seed_tasks(seeds)
    lres = native.sw_extend_host(lq, lt, [s["len"] for s in seeds], params)
    rres = native.sw_extend_host(rq, rt, [int(v) for v in lres["score"]], params)
    return resolve_seeds(seeds, lres, rres, params.pen_clip)


def oracle_record(s, params):
    from acc_genomics_tpu_torch.ops.extend.reference import extend_seed_oracle

    return extend_seed_oracle(s["read"], s["rseq"], s["qbeg"], s["rbeg_off"], s["len"], params)


def extend_phases(card: str, dev) -> dict:
    """Phases 10-11: the extension kernel against its plain version, then
    ExtendEngine on the card and its edges.  Returns the kernels-line
    entry (its launches: the engine phase's; phase 13 adds its own)."""
    import torch

    from acc_genomics_tpu_torch.config import ExtendConfig
    from acc_genomics_tpu_torch.engine.extend_engine import ExtendEngine
    from acc_genomics_tpu_torch.ops.extend import kernel as EK
    import acc_genomics_tpu_torch.engine.extend_engine as engine_module
    from acc_genomics_tpu_torch.tools.bench_shapes import (
        capture_calls,
        extend_batches,
        extend_bench_seeds,
    )
    from acc_genomics_tpu_torch.io.bwasw_records import (
        read_results,
        read_task_file,
        run_tasks,
    )

    # -- 10. kernel vs plain --------------------------------------------------
    err = 0
    bench = None
    for bt in extend_batches(dev):
        name, q, t, ql, tl, h0, mi, p = (bt[k] for k in ("name", "q", "t", "qlen", "tlen",
                                                         "h0", "max_ins", "params"))
        got = EK.sw_extend_rows(q, t, ql, tl, h0, mi, mi, p)
        want, cells = EK.sw_extend_plain(q, t, ql, tl, h0, mi, mi, p, count_cells=True)
        torch.cuda.synchronize()
        e = int((got.long() - want.long()).abs().max())
        err = max(err, e)
        rounds2 = int((got[6] == 2 * p.w).sum())
        say(f"extend {name}: {q.shape[1]} tasks, Q {q.shape[0]} T {t.shape[0]} w {p.w}; "
            f"max_abs_err={e} over 7 outputs; round 2 on {rounds2} lanes; "
            f"mean score {float(got[0].float().mean()):.3f}")
        check(e == 0, f"extend kernel vs plain, {name} batch: not bit-exact")
        if name in ("round2", "band 8", "gaps at column 256, Q 520, band 16"):
            check(rounds2 > 0, f"the {name} batch ran round 2 on no lane")
        if name.startswith("gaps at column 256"):
            check(bool((got[1] > 256).any()), f"{name}: no alignment past column 256")
        if name == "round2":
            check(rounds2 > q.shape[1] // 2, "the round-2 batch ran round 2 on few lanes")
        if name == "bench":
            bench = (q, t, ql, tl, h0)
            ext_bound = bound(nbytes(q, t, ql, tl, h0, got), EXTEND_OPS_PER_CELL * int(cells),
                              INT32_OPS_PER_S)
    q, t, ql, tl, h0 = bench
    k_ms = cuda_time_ms(lambda: EK.sw_extend_rows(q, t, ql, tl, h0, ql, ql))
    p_ms = cuda_time_ms(lambda: EK.sw_extend_plain(q, t, ql, tl, h0, ql, ql),
                        repeats=1, warm=False)
    say(f"extend bench batch: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
        f"kernel_seeds_per_s={q.shape[1] / (k_ms * 1e-3):.1f} bound {ext_bound} [{card}]")

    # -- 11. ExtendEngine main path --------------------------------------------
    _, seeds = extend_bench_seeds()
    eng = ExtendEngine(device=dev)
    first = eng.extend_seeds(seeds)  # warm-up
    torch.cuda.synchronize()
    eng.reset_anatomy()
    EK.LAUNCHES.clear()
    before = spans_now()
    times, results = [], []
    for _ in range(E2E_REPEATS):
        t0 = time.perf_counter()
        results.append(eng.extend_seeds(seeds))
        times.append(time.perf_counter() - t0)
    launches = EK.LAUNCHES["sw_extend"]
    med = statistics.median(times)
    anatomy = {k: round(v / E2E_REPEATS, 6) for k, v in eng.anatomy.items()}
    say(f"ExtendEngine main path: {len(seeds)} seeds, {launches} launches over "
        f"{E2E_REPEATS} calls; seeds_per_s median={len(seeds) / med:.1f} "
        f"min={len(seeds) / max(times):.1f} max={len(seeds) / min(times):.1f}; "
        f"anatomy per call {anatomy}; spans ms a call {spans_ms(before, E2E_REPEATS)} "
        f"[{card}]")
    check(launches > 0 and launches == E2E_REPEATS * eng.stats["device_calls"]
          // (E2E_REPEATS + 1), f"ExtendEngine launches {launches}")
    check(all(r == first for r in results), "repeated ExtendEngine calls differ")
    check(first == host_extend_seeds(seeds, eng.params), "ExtendEngine vs native host")
    sample = np.random.default_rng(8).choice(len(seeds), 64, replace=False)
    check(all(first[k] == oracle_record(seeds[k], eng.params) for k in sample),
          "ExtendEngine vs oracle")
    say(f"ExtendEngine == native host on {len(seeds)} seeds, == oracle on 64: ok "
        f"(stats {eng.stats})")

    # edges: a seed past the caps, degenerate seeds, the BWA-SW records
    genome, _ = extend_bench_seeds(0)
    edge = [dict(s) for s in seeds[:8]]
    pos = 5000
    edge.append(dict(read=genome[pos: pos + 101].copy(), rseq=genome[pos - 1100: pos + 201],
                     qbeg=40, rbeg_off=1140, len=21))  # left target 1140 > 1024
    read = genome[300:360].copy()
    rseq = genome[260:400]
    edge += [dict(read=read, rseq=rseq, qbeg=0, rbeg_off=40, len=20),
             dict(read=read, rseq=rseq, qbeg=40, rbeg_off=80, len=20),
             dict(read=read, rseq=rseq, qbeg=0, rbeg_off=40, len=60)]
    eng = ExtendEngine(device=dev)
    got = eng.extend_seeds(edge)
    check(eng.stats["host_fallback"] == 1, "one seed past the caps on the host")
    check(got == host_extend_seeds(edge, eng.params)
          and all(g == oracle_record(s, eng.params) for g, s in zip(got, edge)),
          "extend edges vs native host and oracle")
    fix = os.path.join(HERE, "tests/fixtures")
    want = read_results(os.path.join(fix, "bwasw_results0.bin"))
    recs = run_tasks(ExtendEngine(device=dev), np.load(os.path.join(fix, "bwasw_genome.npy")),
                     read_task_file(os.path.join(fix, "bwasw_tasks0.bin")))
    by_idx = {r["seed_index"]: r for r in recs}
    check(len(recs) == len(want) and all(by_idx[w["seed_index"]] == w for w in want),
          "BWA-SW record fixture vs golden results, on the card")
    long_q = [dict(read=genome[p0: p0 + 400].copy(), rseq=genome[p0 - 150: p0 + 550],
                   qbeg=qb, rbeg_off=150 + qb, len=21)
              for p0, qb in ((2000, 300), (6000, 30), (9000, 100))]
    eng = ExtendEngine(ExtendConfig(max_qlen=512), device=dev)
    calls = []
    with capture_calls(engine_module, "sw_extend_rows", calls):
        got = eng.extend_seeds(seeds[:8] + long_q)
    tiled = [args for args, _ in calls if args[0].shape[0] > EK.REGISTER_QUERY]
    check(eng.q_buckets[-1] == 512 and eng.stats["host_fallback"] == 0 and len(tiled) > 0
          and got == host_extend_seeds(seeds[:8] + long_q, eng.params),
          "ExtendEngine(max_qlen=512): queries past 256 on the card, all exact")
    check(all(torch.equal(EK.sw_extend_rows(*a), EK.sw_extend_plain(*a)) for a in tiled),
          "ExtendEngine(max_qlen=512): launches past 256 columns vs plain")
    say(f"extend edges: 1 seed past the caps on the host, 3 degenerate seeds, "
        f"{len(want)} BWA-SW fixture records, max_qlen 512 (3 seeds with a query past "
        f"{EK.REGISTER_QUERY} on the card, {len(tiled)} launches of a 512-column bucket "
        f"equal to the plain version): all exact")
    return {"name": "sw_extend", "route": "cuda", "source": EXTEND_SOURCE,
            "replaces": EXTEND_TPU, "launches": launches, "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms, **ext_bound}


def pack_reads(reads, rows: int):
    seq = np.full((rows, len(reads)), 4, np.uint8)
    lens = np.array([len(r) for r in reads], np.int32)
    for k, r in enumerate(reads):
        seq[: len(r), k] = r
    return seq, lens


class HostSmem:
    """SmemEngine's interface over the native host engine."""

    def __init__(self, fm, params):
        self.fm, self.params = fm, params

    def collect(self, reads):
        from acc_genomics_tpu_torch import native

        return native.smem_collect_host(self.fm, reads, self.params)


class HostExtend:
    """ExtendEngine's interface over the native host engine."""

    def __init__(self, params):
        self.params = params

    def extend_seeds(self, seeds):
        return host_extend_seeds(seeds, self.params)


def oracle_hits(fm, read, max_occ, flank, smem_params, ext_params):
    """drivers/bwamem_driver.py's oracle chain for one read: SMEM oracle,
    suffix-array positions in row order (at most max_occ), seed
    extension oracle; (qbeg, qend, rbeg, rend, score, trueScore, width,
    occ) per seed."""
    from acc_genomics_tpu_torch.ops.extend.reference import extend_seed_oracle
    from acc_genomics_tpu_torch.ops.smem.reference import mem_collect_intv_oracle

    out = []
    for iv in mem_collect_intv_oracle(fm, read, smem_params):
        slen = iv["end"] - iv["start"]
        for pos in fm.sa[iv["x0"]: iv["x0"] + min(iv["s"], max_occ)]:
            pos = int(pos)
            span_lo = max(0, pos - iv["start"] - flank)
            span_hi = min(fm.seq_len, pos + slen + (len(read) - iv["end"]) + flank)
            res = extend_seed_oracle(read, fm.text[span_lo:span_hi], iv["start"],
                                     pos - span_lo, slen, ext_params)
            out.append((res["qBeg"], iv["end"] + res["qEnd"], pos + res["rBeg"],
                        pos + slen + res["rEnd"], res["score"], res["trueScore"],
                        res["width"], iv["s"]))
    return out


def probe_spread(name: str, probes) -> None:
    """The distribution of FM-index extensions a read, and for warps of 32
    consecutive reads (one thread a read) the ratio of their mean to their
    longest read's: what a warp that runs as long as its longest read
    does of useful work."""
    pr = probes.long().cpu().numpy()
    q = np.percentile(pr, [50, 90, 99])
    w = pr[: len(pr) // 32 * 32].reshape(-1, 32)
    ratio = w.mean(1) / np.maximum(w.max(1), 1) if len(w) else np.zeros(1)
    say(f"{name}: probes a read min {pr.min()} p50 {q[0]:.0f} p90 {q[1]:.0f} p99 {q[2]:.0f} "
        f"max {pr.max()} mean {pr.mean():.1f}; warps of 32 consecutive reads, mean/max: "
        f"median {np.median(ratio):.3f} min {ratio.min():.3f} mean {ratio.mean():.3f}")


def smem_bwa_phases(card: str, dev, extend_entry: dict) -> dict:
    """Phases 12-14 over one 100 Mbp index: the SMEM kernel against its
    plain version, SmemEngine on the card and its edges, BwaMemSeeding on
    GenomicsEngine, then BwaMemDevicePipeline (``pipeline_phase``).  Adds
    phase 13's extension launches to ``extend_entry`` and returns the
    kernels-line entries of the SMEM and the fused extension kernels, and
    (phase 13's GenomicsEngine, the index, the 65,536 reads) for the
    service phase."""
    import torch

    from acc_genomics_tpu_torch.engine.genomics_engine import GenomicsEngine
    from acc_genomics_tpu_torch.engine.smem_engine import SmemEngine
    from acc_genomics_tpu_torch.models import BwaEngines, BwaMemSeeding
    from acc_genomics_tpu_torch.ops.extend import kernel as EK
    from acc_genomics_tpu_torch.ops.smem import kernel as MK
    from acc_genomics_tpu_torch.ops.smem.table import DeviceIndex
    from acc_genomics_tpu_torch import native
    from acc_genomics_tpu_torch.config import SmemConfig
    from acc_genomics_tpu_torch.io.synth import (
        gen_reference_with_repeats,
        gen_smem_reads,
    )
    from acc_genomics_tpu_torch.ops.smem.index import FMIndex
    from acc_genomics_tpu_torch.ops.smem.reference import mem_collect_intv_oracle

    # -- 12. index, kernel vs plain ---------------------------------------------
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    genome = gen_reference_with_repeats(rng, SMEM_GENOME)
    t1 = time.perf_counter()
    fm = FMIndex.build(genome)
    t2 = time.perf_counter()
    reads = gen_smem_reads(rng, genome, SMEM_READS, read_len=101)
    say(f"SMEM index: {SMEM_GENOME} bases (text {fm.seq_len}), genome_s={t1 - t0:.2f} "
        f"FMIndex.build_s={t2 - t1:.2f}; {len(reads)} reads of 101")
    params = SmemConfig().params()
    idx = DeviceIndex.build(fm, dev)
    seq, lens = pack_reads(reads, 128)
    seq_d, lens_d = torch.from_numpy(seq).to(dev), torch.from_numpy(lens).to(dev)
    got = MK.smem_collect(idx, seq_d, lens_d, params)
    t0 = time.perf_counter()
    want = MK.smem_collect_plain(idx, seq_d, lens_d, params)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
    probes = int(got[3].long().sum())
    smem_bound = bound(SMEM_PROBE_BYTES * probes + nbytes(seq_d, lens_d, *got),
                       SMEM_OPS_PER_PROBE * probes, INT32_OPS_PER_S)
    n_flag = int(got[2].sum())
    n_iv = int(got[1].sum())
    say(f"smem kernel vs plain, {len(reads)} reads: max_abs_err={err} over mem, counts, "
        f"flags, probes; {n_iv} intervals, {n_flag} flagged, "
        f"{int(got[3].long().sum())} probes (max {int(got[3].max())} a read)")
    check(err == 0, "SMEM kernel vs plain: not exact")
    probe_spread("smem bench batch", got[3])
    k_ms = cuda_time_ms(lambda: MK.smem_collect(idx, seq_d, lens_d, params))
    say(f"smem bench batch: kernel_ms={k_ms:.4f} plain_ms={plain_ms:.4f} (one call, "
        f"host clock) kernel_reads_per_s={len(reads) / (k_ms * 1e-3):.1f} bound "
        f"{smem_bound} [{card}]")
    del got, want

    # -- 12. SmemEngine main path -----------------------------------------------
    eng = SmemEngine(fm, device=dev)
    first = eng.collect(reads)  # warm-up
    torch.cuda.synchronize()
    eng.reset_anatomy()
    MK.LAUNCHES.clear()
    before = spans_now()
    times, results = [], []
    for _ in range(HC_REPEATS):
        t0 = time.perf_counter()
        results.append(eng.collect(reads))
        times.append(time.perf_counter() - t0)
    smem_launches = MK.LAUNCHES["smem_collect"]
    med = statistics.median(times)
    anatomy = {k: round(v / HC_REPEATS, 6) for k, v in eng.anatomy.items()}
    say(f"SmemEngine main path: {len(reads)} reads, {smem_launches} launches over "
        f"{HC_REPEATS} calls; reads_per_s median={len(reads) / med:.1f} "
        f"min={len(reads) / max(times):.1f} max={len(reads) / min(times):.1f}; "
        f"anatomy per call {anatomy}; spans ms a call {spans_ms(before, HC_REPEATS)}; "
        f"stats {eng.stats} [{card}]")
    check(smem_launches == HC_REPEATS, f"SmemEngine launches {smem_launches}")
    check(all(r == first for r in results), "repeated SmemEngine calls differ")
    check(first == native.smem_collect_host(fm, reads, params), "SmemEngine vs native host")
    sample = np.random.default_rng(9).choice(len(reads), 64, replace=False)
    check(all(first[k] == mem_collect_intv_oracle(fm, reads[k], params) for k in sample),
          "SmemEngine vs oracle")
    say(f"SmemEngine == native host on {len(reads)} reads in order, == oracle on 64: ok")
    del results

    # edges: past seq_length, all-N, shorter than min_seed_len, and a tandem
    # repeat read among 200 bench reads through caps of 6 chain rows and 4
    # output rows (no read of this genome busts the default caps)
    erng = np.random.default_rng(10)
    p = int(erng.integers(0, SMEM_GENOME - 400))
    edge = [genome[p: p + 300].copy(), np.full(101, 4, np.uint8), genome[p: p + 12].copy(),
            np.tile(genome[p: p + 8], 13)[:101].copy()] + reads[:200]
    tight = SmemEngine(fm, SmemConfig(curr_cap=6, mem_cap=4), device=dev)
    got = tight.collect(edge)
    check(got == native.smem_collect_host(fm, edge, params)
          and got[:3] == [mem_collect_intv_oracle(fm, r, params) for r in edge[:3]],
          "SMEM edges vs native host")
    check(got[1] == [] and got[2] == [] and tight.stats["overflow_reruns"] > 0,
          "all-N and short reads give no interval; tight caps flag reads")
    say(f"SMEM edges: 300 bp read on the host, all-N and 12 bp reads empty, caps 6/4 "
        f"flag {tight.stats['overflow_reruns']} of {len(edge) - 1} device reads, all "
        f"rerun exact")

    # -- 13. BwaMemSeeding on GenomicsEngine --------------------------------------
    bwa_reads = gen_smem_reads(rng, genome, BWA_READS, read_len=101)
    del eng
    engines = GenomicsEngine(device=dev)
    engines.set_index(fm)
    seeding = BwaMemSeeding(engines, max_occ=4, flank=100)
    first = seeding.map_reads(bwa_reads)  # warm-up
    torch.cuda.synchronize()
    MK.LAUNCHES.clear()
    EK.LAUNCHES.clear()
    times, results = [], []
    for _ in range(HC_REPEATS):
        t0 = time.perf_counter()
        results.append(seeding.map_reads(bwa_reads))
        times.append(time.perf_counter() - t0)
    bwa_launches = {**MK.LAUNCHES, **EK.LAUNCHES}
    med = statistics.median(times)
    n_hits = sum(len(h) for h in first)
    say(f"BwaMemSeeding: {len(bwa_reads)} reads, {n_hits} seed hits a call; "
        f"reads_per_s median={len(bwa_reads) / med:.1f} min={len(bwa_reads) / max(times):.1f} "
        f"max={len(bwa_reads) / min(times):.1f} (n={HC_REPEATS}); launches {bwa_launches} "
        f"[{card}]")
    check(bwa_launches.get("smem_collect", 0) > 0 and bwa_launches.get("sw_extend", 0) > 0,
          f"BwaMemSeeding launches {bwa_launches}")
    check(all(r == first for r in results), "repeated BwaMemSeeding calls differ")
    host = BwaMemSeeding(BwaEngines(HostSmem(fm, params), HostExtend(engines.extend.params)),
                         max_occ=4, flank=100).map_reads(bwa_reads)
    check(first == host, "BwaMemSeeding vs the native host composition")
    for k in range(16):
        got_k = [(h.qbeg, h.qend, h.rbeg, h.rend, h.score, h.true_score, h.width, h.occ)
                 for h in first[k]]
        check(got_k == oracle_hits(fm, bwa_reads[k], 4, 100, params, engines.extend.params),
              f"BwaMemSeeding vs oracle chain, read {k}")
    say(f"BwaMemSeeding == native host composition on {len(bwa_reads)} reads, == oracle "
        f"chain on 16: ok")
    extend_entry["launches"] += bwa_launches.get("sw_extend", 0)
    smem_entry = {"name": "smem_collect", "route": "cuda", "source": SMEM_SOURCE,
                  "replaces": SMEM_TPU,
                  "launches": smem_launches + bwa_launches.get("smem_collect", 0),
                  "max_abs_err": err, "ms": k_ms, "plain_ms": plain_ms, **smem_bound}

    fused_entry = pipeline_phase(card, engines, fm, genome, bwa_reads, first, smem_entry)
    return smem_entry, fused_entry, (engines, fm, reads)


def pipeline_phase(card: str, engines, fm, genome, bwa_reads, seeding_hits,
                   smem_entry: dict) -> dict:
    """Phase 14 on phase 13's index and reads (max_occ 4, flank 100): the
    fused seed-extension kernel against its plain version on the
    pipeline's own seed arrays, BwaMemDevicePipeline against phase 13's
    BwaMemSeeding result, its reads/s and its edges.  Adds the pipeline's
    SMEM launches to ``smem_entry``; returns the fused kernel's entry."""
    import torch

    import acc_genomics_tpu_torch.engine.smem_engine as smem_module
    import acc_genomics_tpu_torch.models.bwa_mem as bwa_module
    from acc_genomics_tpu_torch.config import SmemConfig
    from acc_genomics_tpu_torch.tools.bench_shapes import capture_calls, fused_batches
    from acc_genomics_tpu_torch.engine.smem_engine import SmemEngine
    from acc_genomics_tpu_torch.models import BwaEngines, BwaMemDevicePipeline, BwaMemSeeding
    from acc_genomics_tpu_torch.ops.extend import kernel as EK
    from acc_genomics_tpu_torch.ops.smem import kernel as MK

    t0 = time.perf_counter()
    pipe = BwaMemDevicePipeline(engines, max_occ=4, flank=100)
    torch.cuda.synchronize()
    say(f"BwaMemDevicePipeline: SA ({pipe.sa_dev.numel()} int32) and text "
        f"({pipe.text_dev.numel()} uint8) on the card in {time.perf_counter() - t0:.2f} s")

    # -- 14. fused kernel vs plain, on the pipeline's own seeds -------------------
    calls, smem_calls = [], []
    with capture_calls(bwa_module, "extend_seeds_fused", calls), \
            capture_calls(smem_module, "smem_collect", smem_calls):
        hits0 = pipe.map_reads_arrays(bwa_reads)[0]

    # -- 14. the SMEM kernel on the pipeline's own reads ------------------------
    check(len(smem_calls) == 1, f"pipeline SMEM launches {len(smem_calls)}")
    s_args, s_kw = smem_calls[0]
    got = MK.smem_collect(*s_args, **s_kw)
    t0 = time.perf_counter()
    want = MK.smem_collect_plain(*s_args, **s_kw)
    torch.cuda.synchronize()
    s_plain_ms = (time.perf_counter() - t0) * 1e3
    s_err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
    say(f"smem kernel vs plain, the pipeline's {got[1].numel()} reads: max_abs_err={s_err} "
        f"over mem, counts, flags, probes; {int(got[1].sum())} intervals, "
        f"{int(got[2].sum())} flagged")
    check(s_err == 0, "SMEM kernel vs plain on the pipeline's reads: not exact")
    probe_spread("smem pipeline batch", got[3])
    s_probes = int(got[3].long().sum())
    s_bound = bound(SMEM_PROBE_BYTES * s_probes + nbytes(*s_args, *got),
                    SMEM_OPS_PER_PROBE * s_probes, INT32_OPS_PER_S)
    s_ms = cuda_time_ms(lambda: MK.smem_collect(*s_args, **s_kw))
    say(f"smem pipeline batch: kernel_ms={s_ms:.4f} plain_ms={s_plain_ms:.4f} (one call, host "
        f"clock) bound {s_bound} [{card}]")
    del got, want, smem_calls

    args, kw = calls[0]
    got = EK.extend_seeds_fused(*args, **kw)
    want, cells = EK.extend_seeds_fused_plain(*args, **kw, count_cells=True)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    n_seeds = got.shape[1]
    say(f"sw_extend_fused vs plain: {n_seeds} seeds, {int(cells)} band cells; "
        f"max_abs_err={err} over 8 rows; pipeline's own launch equal: "
        f"{bool(np.array_equal(hits0, got.cpu().numpy()))}")
    check(n_seeds > 0 and err == 0, "fused kernel vs plain: not bit-exact")
    check(np.array_equal(hits0, got.cpu().numpy()), "fused kernel: repeated launch differs")
    # the edges of the warp-per-seed kernel: left queries of 0-33, read
    # widths 32, 33, 256 and 300 (tiles), both text ends, round 2
    for b in fused_batches(pipe.device):
        e_args = [b[k] for k in ("sa", "text", "reads", "rlens", "rows", "qbeg", "slen",
                                 "readid", "flank", "params")]
        e_got = EK.extend_seeds_fused(*e_args)
        e_want = EK.extend_seeds_fused_plain(*e_args)
        rounds2 = int((e_want[6] == 2 * b["params"].w).sum())
        e_err = int((e_got.long() - e_want.long()).abs().max())
        say(f"sw_extend_fused edges {b['name']}: {e_got.shape[1]} seeds, width "
            f"{b['reads'].shape[1]}; max_abs_err={e_err} over 8 rows; round 2 on {rounds2}")
        check(e_err == 0, f"fused kernel vs plain, {b['name']}: not bit-exact")
        if b["name"].startswith("round 2"):
            check(rounds2 > 0, "the round-2 fused batch ran round 2 on no seed")
    k_ms = cuda_time_ms(lambda: EK.extend_seeds_fused(*args, **kw))
    p_ms = cuda_time_ms(lambda: EK.extend_seeds_fused_plain(*args, **kw), repeats=1,
                        warm=False)
    sa, text, _, rlens, rows, qbeg, slen, readid, flank = args[:9]
    # bytes the step must move: each seed's SA entry, its query and target
    # spans (read once each), the seed arrays and read lengths, the output
    pos = sa[rows.long()].long()
    rq_len = (rlens[readid.long()] - qbeg - slen).long()
    lt_len = torch.minimum(pos, qbeg.long() + flank)
    rt_len = torch.minimum(text.numel() - pos - slen.long(), rq_len + flank)
    span_bytes = sum(int(x.clamp(min=0).sum()) for x in (qbeg.long(), rq_len, lt_len, rt_len))
    fused_bound = bound(4 * n_seeds + span_bytes
                        + nbytes(rlens, rows, qbeg, slen, readid, want),
                        EXTEND_OPS_PER_CELL * int(cells), INT32_OPS_PER_S)
    say(f"sw_extend_fused: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
        f"kernel_seeds_per_s={n_seeds / (k_ms * 1e-3):.1f} bound {fused_bound} [{card}]")
    del got, want

    # -- 14. BwaMemDevicePipeline main path ----------------------------------------
    first = pipe.map_reads(bwa_reads)
    check(first == seeding_hits, "BwaMemDevicePipeline vs BwaMemSeeding")
    say(f"BwaMemDevicePipeline == BwaMemSeeding on {len(bwa_reads)} reads "
        f"({sum(map(len, first))} seed hits): ok")
    torch.cuda.synchronize()
    pipe.reset_anatomy()
    MK.LAUNCHES.clear()
    EK.LAUNCHES.clear()
    times, results = [], []
    for _ in range(HC_REPEATS):
        t0 = time.perf_counter()
        results.append(pipe.map_reads_arrays(bwa_reads))
        times.append(time.perf_counter() - t0)
    launches = {**MK.LAUNCHES, **EK.LAUNCHES}
    med = statistics.median(times)
    anatomy = {k: round(v / HC_REPEATS, 6) if k.endswith("_s") else v // HC_REPEATS
               for k, v in pipe.anatomy.items()}
    say(f"BwaMemDevicePipeline.map_reads_arrays: {len(bwa_reads)} reads, {n_seeds} seeds a "
        f"call; reads_per_s median={len(bwa_reads) / med:.1f} "
        f"min={len(bwa_reads) / max(times):.1f} max={len(bwa_reads) / min(times):.1f} "
        f"(n={HC_REPEATS}); anatomy per call {anatomy}; launches {launches} [{card}]")
    check(launches.get("sw_extend_fused", 0) == HC_REPEATS
          and launches.get("smem_collect", 0) > 0, f"pipeline launches {launches}")
    say(f"smem kernel share of smem_s: {s_ms:.4f} ms of {anatomy['smem_s'] * 1e3:.4f} ms a "
        f"call ({s_ms / (anatomy['smem_s'] * 1e3):.3f}) [{card}]")
    smem_entry["pipeline_ms"] = s_ms
    smem_entry["pipeline_plain_ms"] = s_plain_ms
    smem_entry["pipeline_bound_ms"] = s_bound["bound_ms"]
    smem_entry["pipeline_bound_by"] = s_bound["bound_by"]
    check(all(np.array_equal(r[0], hits0) and r[3] == results[0][3] for r in results),
          "repeated pipeline calls differ")
    smem_entry["launches"] += launches.get("smem_collect", 0)

    # -- 14. edges ---------------------------------------------------------------
    edge = [genome[:70].copy(), genome[-70:].copy(), genome[5000:5300].copy(),
            np.full(101, 4, np.uint8)] + bwa_reads[:200]
    wide = BwaMemDevicePipeline(engines, max_occ=4, flank=300)
    got = wide.map_reads(edge)
    check(got == BwaMemSeeding(engines, max_occ=4, flank=300).map_reads(edge),
          "pipeline edges (text ends, flank 300, past seq_length, all-N) vs BwaMemSeeding")
    check(got[0] and got[1] and got[2] and got[3] == [], "edge reads' hits")
    del wide
    tight = BwaEngines(SmemEngine(fm, SmemConfig(curr_cap=6, mem_cap=4), device=pipe.device),
                       engines.extend)
    tpipe = BwaMemDevicePipeline(tight, max_occ=4, flank=100)
    _, _, _, host_idx = tpipe.map_reads_arrays(edge)
    rerun, rerun_host = tpipe.anatomy["rerun_reads"], tpipe.anatomy["rerun_host_reads"]
    got = tpipe.map_reads(edge)
    # only the read past seq_length is handed back; the capped reads take
    # the SMEM retry at wide caps and the card's extension
    check(host_idx == [2] and rerun > 1, f"caps 6/4: host_idx {host_idx}, {rerun} reruns")
    check(got == BwaMemSeeding(tight, max_occ=4, flank=100).map_reads(edge),
          "pipeline with SMEM caps 6/4 vs BwaMemSeeding")
    say(f"pipeline edges: reads at both text ends with flank 300, a 300 bp read, an "
        f"all-N read: == BwaMemSeeding; caps 6/4 retry {rerun} of {len(edge)} reads "
        f"({rerun_host} on the host) and hand back only the "
        f"300 bp read, == BwaMemSeeding")
    del tpipe, tight, pipe
    return {"name": "sw_extend_fused", "route": "cuda", "source": EXTEND_SOURCE,
            "replaces": FUSED_TPU, "launches": launches.get("sw_extend_fused", 0),
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, **fused_bound}


def retry_phase(card: str, dev, smem_entry: dict) -> None:
    """Phase 20: the SMEM retry at wide caps on a uniform-like batch.  A
    repeat-rich genome of chr20's length (``smem_repeat_genome``), 16,384
    reads of 150 at the pipeline's width 256 and the default caps; the
    reads that launch flags go through ``SmemEngine.retry_arrays``, whose
    one launch (width 160, chain cap 161, 256 output rows) is held bit for
    bit against the plain version and timed against its bound, and whose
    intervals equal ``host_arrays``'.  Adds the retry's figures to
    ``smem_entry``."""
    import torch

    import acc_genomics_tpu_torch.engine.smem_engine as smem_module
    from acc_genomics_tpu_torch.engine.packing import pack_tm
    from acc_genomics_tpu_torch.engine.smem_engine import SmemEngine
    from acc_genomics_tpu_torch.ops.smem import kernel as MK
    from acc_genomics_tpu_torch.ops.smem.index import FMIndex
    from acc_genomics_tpu_torch.tools.bench_shapes import (
        capture_calls,
        smem_repeat_genome,
        smem_retry_reads,
    )

    rng = np.random.default_rng(20)
    t0 = time.perf_counter()
    genome = smem_repeat_genome(rng, RETRY_GENOME)
    fm = FMIndex.build(genome)
    reads = smem_retry_reads(rng, genome, RETRY_READS)[:RETRY_READS]
    eng = SmemEngine(fm, device=dev)
    _, _, flags = eng.collect_arrays(*pack_tm(reads, 256, len(reads)))
    flagged = [reads[k] for k in np.flatnonzero(flags)]
    say(f"SMEM retry: repeat-rich index of {RETRY_GENOME} bases in "
        f"{time.perf_counter() - t0:.2f} s; {len(flagged)} of {len(reads)} reads of 150 "
        f"flagged at caps {MK.caps(eng.params, 256)}")
    check(len(flagged) > 0, "no read flagged at the default caps")
    # the main path's launches: the retry's one, none of the checks' and
    # timings' below
    calls = []
    MK.LAUNCHES.clear()
    with capture_calls(smem_module, "smem_collect", calls):
        flat, counts = eng.retry_arrays(flagged)
    retry_launches = MK.LAUNCHES["smem_collect"]
    want_flat, want_counts = eng.host_arrays(flagged)
    check(len(calls) == 1 and retry_launches == 1 and np.array_equal(counts, want_counts)
          and np.array_equal(flat, want_flat), "retry_arrays vs host_arrays")
    args, kw = calls[0]
    seq_d = args[1]
    chain_cap, mem_cap = MK.caps(args[3], seq_d.shape[0])
    got = MK.smem_collect(*args, **kw)
    t0 = time.perf_counter()
    want = MK.smem_collect_plain(*args, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
    check(err == 0, "SMEM kernel vs plain at the retry's caps: not exact")
    probes = int(got[3].long().sum())
    r_bound = bound(SMEM_PROBE_BYTES * probes + nbytes(*args[1:3], *got),
                    SMEM_OPS_PER_PROBE * probes, INT32_OPS_PER_S)
    probe_spread("smem retry batch", got[3])
    k_ms = cuda_time_ms(lambda: MK.smem_collect(*args, **kw))
    times = {}
    for name, fn in (("retry_arrays", eng.retry_arrays), ("host_arrays", eng.host_arrays)):
        fn(flagged)
        torch.cuda.synchronize()
        t = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn(flagged)
            t.append((time.perf_counter() - t0) * 1e3)
        times[name] = statistics.median(t)
    say(f"smem retry batch: {seq_d.shape[1]} reads at width {seq_d.shape[0]}, caps "
        f"({chain_cap}, {mem_cap}); max_abs_err={err}; {int(got[2].sum())} flagged again, "
        f"{int(got[1].sum())} intervals (max {int(got[1].max())} a read), {probes} probes; "
        f"kernel_ms={k_ms:.4f} plain_ms={plain_ms:.4f} (one call, host clock) bound "
        f"{r_bound}; retry_arrays {times['retry_arrays']:.3f} ms against host_arrays "
        f"{times['host_arrays']:.3f} ms a call (host clock, median of 5) [{card}]")
    smem_entry.update(retry_reads=int(seq_d.shape[1]), retry_ms=k_ms,
                      retry_plain_ms=plain_ms, retry_bound_ms=r_bound["bound_ms"],
                      retry_bound_by=r_bound["bound_by"])
    smem_entry["launches"] += retry_launches
    del eng, fm, genome


def band_vs_plain(args, name: str, ic: float):
    """One captured superstep through the band kernel and through its plain
    version, each on its own copy of the pipeline state; every value the
    superstep writes (the active slots' bottom rows, their right-edge rows,
    the last chunk's results) within RAW_RTOL.  Returns the largest
    absolute error in probability units (over the initial constant) and
    the plain version's time (ms, one call, CUDA events)."""
    import torch

    from acc_genomics_tpu_torch.ops.pairhmm import band_kernel as BK

    front, planes, tables, hap, slots, tops, edges, res, t, a, n, C, n_chunks = args
    states = [[x.clone() for x in (tops, edges, res)] for _ in range(2)]
    BK.pairhmm_band_superstep(front, planes, tables, hap, slots, *states[0], t, a, n, C,
                              n_chunks)
    plain_ms = cuda_time_ms(lambda: BK.pairhmm_band_superstep_plain(
        front, planes, tables, hap, slots, *states[1], t, a, n, C, n_chunks),
        repeats=1, warm=False)
    par, worst = t % 2, 0.0
    shard = slots[a:a + n, 0].tolist()
    regions = [("bottom rows", lambda s: s[0][1 - par, :, a:a + n])]
    for i, k in enumerate(shard):
        r0 = (t - k) * C
        regions.append((f"right edge, slot {a + i}",
                        lambda s, i=i, r0=r0: s[1][:, a + i, :, r0 + 1:r0 + C + 1]))
        if t - k == n_chunks - 1:
            regions.append((f"result, slot {a + i}", lambda s, i=i: s[2][a + i]))
    for what, cut in regions:
        g, w = cut(states[0]).double(), cut(states[1]).double()
        diff = (g - w).abs()
        off = int((diff > RAW_RTOL * w.abs() + RAW_ATOL).sum())
        check(off == 0 and bool(torch.isfinite(g).all()),
              f"band kernel vs plain, {name} superstep, {what}: {off} values off")
        worst = max(worst, float(diff.max()) / ic)
    if name.startswith("middle"):  # a chunk whose boundary streams carry mass
        check(bool(states[1][0][1 - par, :, a:a + n].any()),
              f"middle superstep ({name}): a bottom row all zero")
    say(f"pairhmm_band_superstep vs plain, {name} ({front}): {n} slots x {tops.shape[3]} lanes "
        f"x hc {tops.shape[4]}; every value within rtol {RAW_RTOL}; max_abs_err {worst:.3e} "
        f"(probability units)")
    return worst, plain_ms


def mesh_phase(card: str, dev) -> dict:
    """Phase 15 on a (1, 4) mesh of the card: the band kernel against its
    plain version on the first and a middle superstep of the main path's
    pipeline; PairHMMEngine(mesh=...) on 2,048 pairs whose haplotypes are
    all past 1024 columns (every pair on the band pipeline) against the
    native host engine and the oracle, and against the same batch on the
    native host engine (the route without a mesh); SP against the DP
    kernel on pairs that fit; the edges and GenomicsEngine(mesh=...).
    Returns the band kernel's kernels-line entry."""
    import torch

    import acc_genomics_tpu_torch.engine.pairhmm_engine as engine_module
    import acc_genomics_tpu_torch.parallel.sharded as sharded_module
    from acc_genomics_tpu_torch.engine.genomics_engine import GenomicsEngine
    from acc_genomics_tpu_torch.engine.pairhmm_engine import PairHMMEngine
    from acc_genomics_tpu_torch.io.synth import (
        gen_pairhmm_input,
        gen_reference_with_repeats,
        gen_smem_reads,
        gen_sw_batch,
    )
    from acc_genomics_tpu_torch.ops.pairhmm import band_kernel as BK
    from acc_genomics_tpu_torch.ops.pairhmm import kernel as K
    from acc_genomics_tpu_torch.ops.pairhmm.context import PairHMMContext
    from acc_genomics_tpu_torch.ops.pairhmm.convert import batch_to_torch
    from acc_genomics_tpu_torch.ops.pairhmm.pack import pack_pairhmm_batch
    from acc_genomics_tpu_torch.tools.bench_shapes import (
        capture_calls,
        extend_bench_seeds,
        flat_matrix_args,
    )
    from acc_genomics_tpu_torch.parallel import (
        make_mesh,
        pairhmm_forward_dpsp,
        pairhmm_forward_dpsp_from_quals,
    )

    ctx = PairHMMContext(np.float32)
    mesh = make_mesh((1, 4), devices=[dev] * 4)
    # seed 13: the first from 11 whose longest haplotype passes 3584, so
    # the SP pack has 4096 columns and each shard's slab is 1024
    rng = np.random.default_rng(13)
    reads, haps = gen_pairhmm_input(rng, MESH_READS, MESH_HAPS, max_read_len=MESH_READ_LEN,
                                    max_hap_len=MESH_HAP_LEN, derived=True)
    f = flat_matrix_args(reads, haps)
    tcs = [dict(hap=h, **r) for r in reads for h in haps]
    n_pairs = len(tcs)
    cells = int(sum(len(t["rs"]) * len(t["hap"]) for t in tcs))
    hl = [len(h) for h in haps]
    say(f"mesh batch: {n_pairs} pairs, reads {min(len(r['rs']) for r in reads)}-"
        f"{max(len(r['rs']) for r in reads)}, haps {min(hl)}-{max(hl)}, {cells} cells; "
        f"mesh {mesh}")
    check(min(hl) > 1024 and max(hl) <= 4 * 1024, "every haplotype past 1024, within 4096")

    # -- 15a. band kernel vs plain on two supersteps, at each C -----------------
    eng = PairHMMEngine(device=dev, mesh=mesh)
    rows = eng.config.read_buckets[-1]
    C = engine_module.sp_chunk_rows(rows)
    n_seq = mesh.shape["seq"]
    n_steps = rows // C + n_seq - 1
    sp_calls = []
    with capture_calls(engine_module, "pairhmm_forward_dpsp_from_quals", sp_calls):
        first = eng.compute_matrix_flat(*f)  # warm-up
    torch.cuda.synchronize()
    sp_args, sp_kw = sp_calls[0][0][1:], dict(sp_calls[0][1])  # after the mesh
    hc = (sp_args[5].shape[0] - rows) // n_seq
    check(hc == 1024 and sp_kw["C"] == C, f"SP slab {hc} columns, C {sp_kw['C']}")
    lanes = sp_args[0].shape[1]
    err, timed, spans, res_by_c = 0.0, {}, {}, {}
    for c in BK.CHUNK_ROWS:
        kw = dict(sp_kw, C=c)
        mid = (rows // c + n_seq - 1) // 2
        calls = []
        with capture_calls(sharded_module, "pairhmm_band_superstep", calls, keep=(0, mid)):
            res_by_c[c] = pairhmm_forward_dpsp_from_quals(mesh, *sp_args, **kw)
        for (args, _), name in zip(calls, (f"first, C {c}", f"middle, C {c}")):
            worst, p_ms = band_vs_plain(args, name, float(ctx.initial_constant))
            err = max(err, worst)
        args = calls[1][0]
        k_ms = cuda_time_ms(lambda: BK.pairhmm_band_superstep(*args))
        n_act = args[10]
        band_bound = bound(*BK.band_bound_terms(c, hc, n_act * lanes), FP32_OPS_PER_S)
        front_bound = bound(BK.band_quals_bytes(c, hc, n_act * lanes),
                            BK.band_bound_terms(c, hc, n_act * lanes)[1], FP32_OPS_PER_S)
        timed[c] = (k_ms, p_ms, band_bound, front_bound)
        say(f"pairhmm_band_superstep ({sp_kw['expand']}), middle superstep, C {c} ({n_act} "
            f"slots x {lanes} lanes, hc {hc}): kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound "
            f"(fp32 yardstick) {band_bound}; byte front end's own bytes {front_bound} [{card}]")
        spans[c] = cuda_time_ms(lambda: pairhmm_forward_dpsp_from_quals(mesh, *sp_args, **kw),
                                repeats=5)
        check(torch.equal(res_by_c[c], res_by_c[BK.CHUNK_ROWS[0]]),
              f"C {c} changed a bit of the SP result")
    say(f"pairhmm_forward_dpsp_from_quals on the main path's pack ({lanes} lanes, {rows} rows, "
        f"{sp_args[5].shape[0] - rows} cols): CUDA-event span ms by C {spans}; results equal "
        f"bit for bit; the engine runs C {C} [{card}]")
    k_ms, p_ms, band_bound, front_bound = timed[C]

    # the fp32 front end on the same pairs (pack.py's coefficient planes)
    t0 = time.perf_counter()
    fp32 = batch_to_torch(pack_pairhmm_batch(tcs, rows=rows, cols=sp_args[5].shape[0] - rows,
                                             dtype=np.float32), dev)
    pack_s = time.perf_counter() - t0
    calls = []
    with capture_calls(sharded_module, "pairhmm_band_superstep", calls,
                       keep=(0, n_steps // 2)):
        res32 = pairhmm_forward_dpsp(mesh, *fp32, C=C)
    for (args, _), name in zip(calls, (f"first, C {C}, fp32", f"middle, C {C}, fp32")):
        err = max(err, band_vs_plain(args, name, float(ctx.initial_constant))[0])
    got8, want32 = res_by_c[C][:n_pairs].double(), res32[:n_pairs].double()
    rel = float(((got8 - want32).abs() / want32.abs()).max())
    span32 = cuda_time_ms(lambda: pairhmm_forward_dpsp(mesh, *fp32, C=C), repeats=5)
    say(f"fp32 front end: pack {pack_s * 1e3:.1f} ms ({nbytes(*fp32)} bytes); pipeline span "
        f"{span32:.4f} ms at C {C}; byte planes vs fp32 pack max rel {rel:.3e} [{card}]")
    check(rel < RTOL_HOST, f"byte-plane SP vs fp32 SP {rel}")
    del fp32, calls, sp_calls, sp_args, res_by_c

    # -- 15b. PairHMMEngine(mesh=...) main path -----------------------------------
    before = spans_now()
    s0 = dict(eng.stats)
    h2d0 = eng.stats.get("h2d_bytes", 0)
    K.LAUNCHES.clear()
    BK.LAUNCHES.clear()
    times, liks = [], []
    for _ in range(HC_REPEATS):
        t0 = time.perf_counter()
        liks.append(eng.compute_matrix_flat(*f))
        times.append(time.perf_counter() - t0)
    launches = dict(BK.LAUNCHES)
    dp_launches = dict(K.LAUNCHES)
    h2d = (eng.stats.get("h2d_bytes", 0) - h2d0) // HC_REPEATS
    med = statistics.median(times)
    sp_pairs = eng.stats["sp_pairs"] - s0["sp_pairs"]
    say(f"PairHMMEngine(mesh=(1, 4)) compute_matrix_flat: {n_pairs} pairs, {cells} cells; "
        f"e2e_s median={med:.5f} min={min(times):.5f} max={max(times):.5f} (n={HC_REPEATS}); "
        f"gcups median={cells / med / 1e9:.3f} min={cells / max(times) / 1e9:.3f} "
        f"max={cells / min(times) / 1e9:.3f}; spans ms a call {spans_ms(before, HC_REPEATS)}; launches "
        f"{launches} {dp_launches}; sp_pairs {sp_pairs} host_fallback "
        f"{eng.stats.get('host_fallback', 0)}; C {eng.stats['sp_chunk_rows']}; h2d bytes a "
        f"call {h2d} [{card}]")
    check(sp_pairs == HC_REPEATS * n_pairs and eng.stats.get("host_fallback", 0) == 0,
          "every pair on the SP route, none on the host")
    check(launches == {"pairhmm_band_superstep": HC_REPEATS * n_steps} and not dp_launches,
          f"band launches {launches}, other launches {dp_launches}")
    lik = liks[0]
    check(lik.shape == (len(reads), len(haps)) and np.isfinite(lik).all()
          and all(np.array_equal(x, lik) for x in liks) and np.array_equal(first, lik),
          "mesh engine output shape, finite values, repeated calls equal")
    check(np.array_equal(eng.compute_matrix(reads, haps), lik),
          "compute_matrix vs compute_matrix_flat on the mesh")

    t0 = time.perf_counter()
    want, n_low = host_loglik(tcs)
    host_s = time.perf_counter() - t0
    rel = np.abs(lik.reshape(-1) - want) / np.abs(want)
    say(f"mesh engine vs native fp32 host on {n_pairs} pairs: max_rel={rel.max():.3e} "
        f"({n_low} below {MIN_ACCEPTED}, fp64 there); the native forward alone "
        f"{host_s:.3f} s")
    check(rel.max() < RTOL_HOST, f"mesh engine vs native host {rel.max()}")
    sample = np.random.default_rng(12).choice(n_pairs, min(16, n_pairs), replace=False)
    orc = oracle([tcs[k] for k in sample])
    rel_o = np.abs(lik.reshape(-1)[sample] - orc) / np.abs(orc)
    say(f"mesh engine vs fp64 oracle ({len(sample)} sampled pairs): max_rel={rel_o.max():.3e}")
    check(rel_o.max() < RTOL_ORACLE, f"mesh engine vs oracle {rel_o.max()}")

    host_eng = PairHMMEngine(device=dev)
    host_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        host_lik = host_eng.compute_matrix_flat(*f)
        host_times.append(time.perf_counter() - t0)
    hmed = statistics.median(host_times)
    say(f"same batch without a mesh (native host engine, host_fallback "
        f"{host_eng.stats['host_fallback']}): e2e_s median={hmed:.5f} min={min(host_times):.5f} "
        f"max={max(host_times):.5f} (n=3) gcups median={cells / hmed / 1e9:.3f}; mesh route "
        f"{hmed / med:.2f}x [{card}]")
    check(np.max(np.abs(host_lik - lik) / np.abs(host_lik)) < RTOL_HOST,
          "mesh route vs the route without a mesh")

    # -- 15c. SP against DP on pairs that fit --------------------------------------
    fit_r, fit_h = gen_pairhmm_input(np.random.default_rng(13), MESH_READS, MESH_HAPS,
                                     max_read_len=MESH_READ_LEN, max_hap_len=1024, derived=True)
    fit = [dict(hap=h, **r) for r in fit_r for h in fit_h]
    args = batch_to_torch(pack_pairhmm_batch(fit, rows=256, cols=1024), dev)
    sp = pairhmm_forward_dpsp(mesh, *args).cpu().numpy()
    dp = K.pairhmm_forward(*args).cpu().numpy()
    kernel_vs_plain("SP (seq 4) vs DP kernel, haps <= 1024", sp, dp, ctx.log10_initial_constant)

    # -- 15d. edges -----------------------------------------------------------------
    erng = np.random.default_rng(14)
    base = dict(reads[0])
    n_rich = erng.integers(0, 4, 2000).astype(np.uint8)
    n_rich[erng.random(2000) < 0.3] = 4
    mis_hap = erng.integers(0, 4, 2000).astype(np.uint8)
    mism = dict(rs=((mis_hap[:120] + 2) % 4).astype(np.uint8), q=np.full(120, 50, np.uint8),
                i=np.full(120, 45, np.uint8), d=np.full(120, 45, np.uint8),
                c=np.full(120, 10, np.uint8), hap=mis_hap)
    edge = [dict(base, hap=np.resize(haps[0], 1024)), dict(base, hap=np.resize(haps[0], 1025)),
            dict(base, hap=np.resize(haps[0], 4097)), dict(base, hap=n_rich), mism]
    eng_e = PairHMMEngine(device=dev, mesh=mesh)
    eng_e.min_device_cells = 0
    got = eng_e.compute_pairs(edge)
    orc = oracle(edge)
    rel = np.abs(got - orc) / np.abs(orc)
    st = eng_e.stats
    say(f"mesh edges (haps 1024, 1025, 4097, 30% N, all-mismatch): sp_pairs {st['sp_pairs']} "
        f"host_fallback {st['host_fallback']} device_calls {st['device_calls']} recomputed "
        f"{st['recomputed']}; max_rel vs oracle {rel.max():.3e}")
    check(st["sp_pairs"] == 3 and st["host_fallback"] == 1 and st["device_calls"] == 1
          and st["recomputed"] >= 1 and rel.max() < RTOL_ORACLE, "mesh edges")

    facades = [GenomicsEngine(device=dev, mesh=make_mesh((2, 2), devices=[dev] * 4)),
               GenomicsEngine(device=dev)]
    for e in facades:
        e.pairhmm.min_device_cells = 0
    r_s, h_s = gen_pairhmm_input(erng, 16, 4, max_read_len=100, max_hap_len=2048, derived=True)
    got = facades[0].pairhmm_matrix(r_s, h_s).reshape(-1)
    tcs_s = [dict(hap=h, **r) for r in r_s for h in h_s]
    want_s = host_loglik(tcs_s)[0]
    check(np.max(np.abs(got - want_s) / np.abs(want_s)) < RTOL_HOST
          and facades[0].pairhmm.stats.get("sp_pairs", 0) > 0,
          "GenomicsEngine(mesh=(2, 2)) PairHMM vs native host")
    ref, alts = gen_sw_batch(erng, 64, ref_len=200)
    sw = [e.sw_align(ref, alts, 0) for e in facades]
    _, seeds = extend_bench_seeds(256)
    ext = [e.extend_seeds(seeds) for e in facades]
    genome = gen_reference_with_repeats(erng, 20_000)
    sreads = gen_smem_reads(erng, genome, 256, read_len=101)
    fm = facades[0].load_reference(genome)
    facades[1].set_index(fm)
    sm = [e.smem_collect(sreads) for e in facades]
    check(sw[0] == sw[1] and ext[0] == ext[1] and sm[0] == sm[1],
          "GenomicsEngine(mesh=(2, 2)) SW, extension, SMEM vs the facade without a mesh")
    say(f"GenomicsEngine(mesh=(2, 2)): PairHMM ({len(tcs_s)} pairs, sp_pairs "
        f"{facades[0].pairhmm.stats.get('sp_pairs', 0)}) within {RTOL_HOST} of the native host; SW "
        f"{len(alts)} pairs, extension {len(seeds)} seeds, SMEM {len(sreads)} reads equal to "
        f"the facade without a mesh")
    return {"name": "pairhmm_band_superstep", "route": "cuda", "source": BAND_SOURCE,
            "replaces": BAND_TPU, "launches": launches.get("pairhmm_band_superstep", 0),
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, **band_bound,
            "front_bound_ms": front_bound["bound_ms"], "front_bound_by": front_bound["bound_by"]}


LAUNCH_MODULES = ("pairhmm.kernel", "pairhmm.band_kernel", "sw.kernel", "extend.kernel",
                  "smem.kernel")


def clear_launches():
    import importlib

    for m in LAUNCH_MODULES:
        importlib.import_module(f"acc_genomics_tpu_torch.ops.{m}").LAUNCHES.clear()


def read_launches() -> dict:
    """Every kernel wrapper's launch count since ``clear_launches``."""
    import importlib

    out = {}
    for m in LAUNCH_MODULES:
        out.update(importlib.import_module(f"acc_genomics_tpu_torch.ops.{m}").LAUNCHES)
    return {k: v for k, v in out.items() if v}


def add_launches(total: dict, run: dict):
    for k, v in run.items():
        total[k] = total.get(k, 0) + v


def host_median_s(fn, repeats: int = 5) -> float:
    """Median host-clock seconds of fn() (after one warm call)."""
    fn()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def crossover_cells(model) -> int:
    """The batch in cells from which the model prefers the card, by the
    bisection of benchmarks/pairhmm_e2e_bench.py:181-190."""
    lo, hi = 1_000, 10_000_000_000
    while hi / lo > 1.01:
        mid = int((lo * hi) ** 0.5)
        if model.device_worthwhile(mid, mid // 40):
            hi = mid
        else:
            lo = mid
    return hi


def dispatch_phase(card: str, f0, reads, haps, lik_arith, lik_gather, batch_cells: int,
                   k_ms: float) -> dict:
    """Phase 16, the rest of PairHMMEngine: upload="f32" on the engine batch
    against the byte-plane route (gather rtol 1e-6, arith 2e-4) and 16
    oracle pairs, timed in turns with it; calibrate_dispatch on the card
    (the kernel's rate on the engine's buckets, the fixed cost of a
    16-pair call, the host and link measured by the model) and its
    crossover; routing by the calibrated model on a small batch and on the
    engine batch.  Returns the launches of its paths."""
    import torch

    from acc_genomics_tpu_torch.config import PairHMMConfig
    from acc_genomics_tpu_torch.engine.pairhmm_engine import PairHMMEngine
    from acc_genomics_tpu_torch.io.synth import gen_pairhmm_pairs
    from acc_genomics_tpu_torch.utils.timer import device_trace, reset_timers, timers

    launches = {}
    # -- 16a. upload="f32" ---------------------------------------------------------
    f32 = PairHMMEngine(PairHMMConfig(upload="f32"), device="cuda")
    quals = PairHMMEngine(device="cuda")
    got = f32.compute_matrix_flat(*f0)  # warm-up
    quals.compute_matrix_flat(*f0)
    torch.cuda.synchronize()
    n_buckets, n_quals = f32.stats["device_calls"], quals.stats["device_calls"]
    h2d = {"f32": f32.stats["h2d_bytes"], "quals": quals.stats["h2d_bytes"]}
    clear_launches()
    times = {"f32": [], "quals": []}
    # the program's spans a call (host clocks): "pairhmm.call" the whole
    # call; "pairhmm.pack" the byte planes' native pack; "pairhmm.stage"
    # the pinned buffer and its fill (the f32 pack itself); "pairhmm.launch"
    # the H2D copy and the launches; "pairhmm.wait" the wait for the card
    sides = {"f32": [], "quals": []}
    for order in (("quals", "f32"), ("f32", "quals")) * 3:  # in turns
        for name in order:
            eng = f32 if name == "f32" else quals
            reset_timers()
            t0 = time.perf_counter()
            res = eng.compute_matrix_flat(*f0)
            times[name].append(time.perf_counter() - t0)
            sides[name].append({k: v["total_s"] for k, v in timers().items()})
            if name == "f32":
                check(res.tobytes() == got.tobytes(), "repeated f32 calls differ")
    run = read_launches()
    check(run.get("pairhmm_forward") == 6 * n_buckets
          and run.get("pairhmm_forward_from_quals") == 6 * n_quals,
          f"f32 / byte-plane launches {run} for {n_buckets} buckets")
    launches["pairhmm_forward"] = run["pairhmm_forward"]
    rel_g = float(np.max(np.abs(got - lik_gather) / np.abs(lik_gather)))
    rel_a = float(np.max(np.abs(got - lik_arith) / np.abs(lik_arith)))
    tcs = [dict(hap=h, **r) for r in reads for h in haps]
    sample = np.random.default_rng(6).choice(len(tcs), 16, replace=False)
    orc = oracle([tcs[k] for k in sample])
    rel_o = float(np.max(np.abs(got.reshape(-1)[sample] - orc) / np.abs(orc)))
    med = {k: statistics.median(v) for k, v in times.items()}
    say(f"upload=f32 on the engine batch: {n_buckets} launches of the coefficient front end "
        f"a call; vs byte planes (gather) max_rel={rel_g:.3e}, (arith) max_rel={rel_a:.3e}, "
        f"vs fp64 oracle (16 pairs) max_rel={rel_o:.3e}; e2e_s median f32={med['f32']:.5f} "
        f"(min {min(times['f32']):.5f} max {max(times['f32']):.5f}) byte planes="
        f"{med['quals']:.5f} (min {min(times['quals']):.5f} max {max(times['quals']):.5f}) "
        f"(n=6 each, in turns); gcups f32={batch_cells / med['f32'] / 1e9:.3f} byte planes="
        f"{batch_cells / med['quals'] / 1e9:.3f}; h2d_bytes a call f32={h2d['f32']} "
        f"byte planes={h2d['quals']} [{card}]")
    for name in ("f32", "quals"):
        keys = sorted({k for t in sides[name] for k in t})
        say(f"upload {name}: host timers a call, median of 6 (s): "
            + " ".join(f"{k}={statistics.median(t.get(k, 0.0) for t in sides[name]):.5f}"
                       for k in keys) + f" [{card}]")
    check(rel_g < 1e-6 and rel_a < 2e-4 and rel_o < RTOL_ORACLE, "f32 route tolerances")

    # does torch.profiler see the card on this host? (utils/timer.device_trace)
    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(tmp, "cuda") as prof:
            quals.compute_matrix_flat(*f0)
            torch.cuda.synchronize()
        traces = os.listdir(tmp)
    dev_rows = [(e.key, getattr(e, "device_time_total", 0.0)) for e in prof.key_averages()
                if getattr(e, "device_time_total", 0.0) > 0]
    dev_rows.sort(key=lambda r: -r[1])
    say(f"device_trace over one byte-plane call: {len(traces)} trace file(s), "
        f"{len(prof.key_averages())} event kinds, {len(dev_rows)} with device time; the "
        f"longest (us) {[(k[:48], round(t, 1)) for k, t in dev_rows[:4]]} [{card}]")

    # -- 16b. calibrate_dispatch on the card ---------------------------------------
    small = gen_pairhmm_pairs(np.random.default_rng(5), 16, max_read_len=100, max_hap_len=300)
    small_cells = sum(len(t["rs"]) * len(t["hap"]) for t in small)
    probe = PairHMMEngine(device="cuda")
    probe.min_device_cells = 0
    call_s = host_median_s(lambda: probe.compute_pairs(small), repeats=7)
    device_gcups = batch_cells / (k_ms * 1e-3) / 1e9
    fixed_s = max(call_s - small_cells / device_gcups / 1e9, 1e-6)
    model = probe.calibrate_dispatch(device_gcups=device_gcups, fixed_s=fixed_s)
    say(f"calibrate_dispatch: device_gcups={model.device_gcups:.3f} (the kernel on the "
        f"engine's buckets) fixed_s={model.fixed_s:.6f} (a 16-pair call, median of 7, "
        f"{small_cells} cells) host_gcups={model.host_gcups:.4f} (native, 64 pairs, all "
        f"threads) link_gb_s={model.link_gb_s:.3f} (4 MiB pinned H2D) cores={model.cores}; "
        f"crossover {crossover_cells(model)} cells [{card}]")

    # -- 16c. routing by the calibrated model --------------------------------------
    clear_launches()
    for label, batch in (("16 pairs", small), ("engine batch", tcs)):
        eng = PairHMMEngine(device="cuda")
        eng.set_cost_model(model)
        cells = sum(len(t["rs"]) * len(t["hap"]) for t in batch)
        est = 5 * sum(len(t["rs"]) for t in batch) + sum(len(t["hap"]) for t in batch) \
            + 12 * len(batch)
        to_card = model.device_worthwhile(cells, est)
        res = eng.compute_pairs(batch)
        on_card = eng.stats["device_calls"] > 0
        check(on_card == to_card
              and eng.stats.get("host_native_calls", 0) == int(not to_card),
              f"{label}: routed {'card' if on_card else 'host'}, model said "
              f"{'card' if to_card else 'host'}")
        want = lik_arith.reshape(-1) if batch is tcs else oracle(batch)
        rel = float(np.max(np.abs(res - want) / np.abs(want)))
        check(rel < (RAW_RTOL if batch is tcs else RTOL_ORACLE), f"{label}: routed result {rel}")
        say(f"calibrated routing, {label} ({cells} cells, {est} bytes): host_s="
            f"{model.host_s(cells):.6f} device_s={model.device_s(cells, est):.6f} -> "
            f"{'card' if on_card else 'host'}; max_rel vs "
            f"{'the flat route' if batch is tcs else 'oracle'} {rel:.3e}")
    run = read_launches()
    check(run.get("pairhmm_forward_from_quals", 0) > 0, f"routing launches {run}")
    launches["pairhmm_forward_from_quals"] = run["pairhmm_forward_from_quals"]
    return launches


def service_phase(card: str, engines, fm, smem_reads, pairhmm_batch) -> dict:
    """Phase 17, the engine service on the card: EngineServer around phase
    13's GenomicsEngine (the 100 Mbp index on the card); one request at
    each engine's main-path shape (PairHMM 1024 x 16, SW 8192 pairs,
    extension 4096 seeds, SMEM 65,536 reads), each equal to the engine's
    direct call and to the native host, the server's count and the
    launches showing the card answered; round trip against the direct
    call (host clocks, median of 5); a 1 Mbp index saved in BWA format and
    loaded by path; the CLI daemon as a subprocess; two concurrent
    clients.  Returns the launches of its paths."""
    import queue
    import threading

    from acc_genomics_tpu_torch import native
    from acc_genomics_tpu_torch.io.bwa_index import save_bwa_index
    from acc_genomics_tpu_torch.io.synth import (
        gen_reference_with_repeats,
        gen_smem_reads,
        gen_sw_batch,
    )
    from acc_genomics_tpu_torch.ops.smem.index import FMIndex
    from acc_genomics_tpu_torch.ops.smem.reference import mem_collect_intv_oracle
    from acc_genomics_tpu_torch.parallel.service import (
        OP_EXTEND,
        OP_PAIRHMM,
        OP_SMEM,
        OP_SW,
        EngineClient,
        EngineServer,
    )
    from acc_genomics_tpu_torch.tools.bench_shapes import SW_BENCH_PAIRS, extend_bench_seeds

    reads, haps, f0 = pairhmm_batch
    ref, alts = gen_sw_batch(np.random.default_rng(0), SW_BENCH_PAIRS, ref_len=286)
    refs = [ref] * len(alts)
    _, seeds = extend_bench_seeds()
    params = engines.smem.params
    ext_params = engines.extend.params
    host_lik = host_loglik([dict(hap=h, **r) for r in reads for h in haps])[0]
    ops = {
        "pairhmm": (OP_PAIRHMM, "pairhmm_forward_from_quals",
                    lambda c: c.pairhmm(reads, haps),
                    lambda: engines.pairhmm.compute_matrix_flat(*f0)),
        "sw": (OP_SW, "sw_fill", lambda c: c.sw(refs, alts, 0),
               lambda: engines.sw.align(refs, alts, 0)),
        "extend": (OP_EXTEND, "sw_extend", lambda c: c.extend(seeds),
                   lambda: engines.extend_seeds(seeds)),
        "smem": (OP_SMEM, "smem_collect", lambda c: c.smem(smem_reads),
                 lambda: engines.smem_collect(smem_reads)),
    }
    host = {
        "pairhmm": lambda got: float(np.max(np.abs(got.reshape(-1) - host_lik)
                                            / np.abs(host_lik))) < RTOL_HOST,
        "sw": lambda got: got == native.sw_align_host(refs, alts, 0),
        "extend": lambda got: got == host_extend_seeds(seeds, ext_params),
        "smem": lambda got: got == native.smem_collect_host(fm, smem_reads, params),
    }
    launches = {}
    server = EngineServer(engine=engines).start()
    try:
        client = EngineClient(*server.address, device="cuda", request_timeout=600)
        check(client.connected, "client did not reach the daemon")
        for name, (op, kernel, remote, direct) in ops.items():
            before = server.answered[op]
            clear_launches()
            got = remote(client)
            run = read_launches()
            check(server.answered[op] == before + 1 and not client.used_fallback
                  and run.get(kernel, 0) > 0,
                  f"{name}: answered {server.answered[op] - before}, launches {run}")
            add_launches(launches, run)
            want = direct()
            same = (got.tobytes() == want.tobytes() if name == "pairhmm" else got == want)
            check(same, f"{name}: served result differs from the direct call")
            check(host[name](got), f"{name}: served result vs the native host")
            rt, dt = [], []
            for _ in range(5):  # in turns
                t0 = time.perf_counter()
                remote(client)
                t1 = time.perf_counter()
                direct()
                rt.append(t1 - t0)
                dt.append(time.perf_counter() - t1)
            say(f"service {name}: served == direct call == native host; round trip "
                f"median={statistics.median(rt) * 1e3:.3f} ms (min {min(rt) * 1e3:.3f} max "
                f"{max(rt) * 1e3:.3f}) direct median={statistics.median(dt) * 1e3:.3f} ms "
                f"(min {min(dt) * 1e3:.3f} max {max(dt) * 1e3:.3f}); the wire "
                f"{(statistics.median(rt) - statistics.median(dt)) * 1e3:.3f} ms; launches "
                f"of the checked request {run} [{card}]")

        # a 1 Mbp index in BWA format, loaded by path; then the CLI daemon on it
        rng = np.random.default_rng(17)
        genome = gen_reference_with_repeats(rng, 1_000_000)
        fm1 = FMIndex.build(genome)
        reads1 = gen_smem_reads(rng, genome, 2048, read_len=101)
        with tempfile.TemporaryDirectory() as tmp:
            prefix = os.path.join(tmp, "idx1m")
            save_bwa_index(prefix, fm1)
            client.load_reference_path(prefix)
            clear_launches()
            got = client.smem(reads1)
            run = read_launches()
            check(run.get("smem_collect", 0) > 0 and not client.used_fallback,
                  f"index by path: launches {run}")
            launches["smem_collect"] += run["smem_collect"]
            check(got == native.smem_collect_host(fm1, reads1, params)
                  and all(got[k] == mem_collect_intv_oracle(fm1, reads1[k], params)
                          for k in range(0, 2048, 64)), "index by path: SMEM vs host, oracle")
            say(f"index by path: 1 Mbp saved in BWA format, OP_LOAD_REF by prefix, SMEM on "
                f"2048 reads == native host, == oracle on 32: ok")

            conf = os.path.join(tmp, "daemon.json")
            with open(conf, "w") as f:
                json.dump({"host": "127.0.0.1", "port": 0, "index_prefix": prefix}, f)
            env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
            t0 = time.perf_counter()
            proc = subprocess.Popen(
                [sys.executable, "-m", "acc_genomics_tpu_torch.parallel.service",
                 "--conf", conf, "--device", engines.device.type],
                cwd=HERE, env=env, stdout=subprocess.PIPE, text=True)
            try:
                lines = queue.Queue()
                threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                                 daemon=True).start()
                addr = None
                while addr is None:
                    m = re.search(r"listening on ([\d.]+):(\d+)", lines.get(timeout=180))
                    addr = m and (m.group(1), int(m.group(2)))
                up_s = time.perf_counter() - t0
                cli = EngineClient(*addr, device="cuda", request_timeout=300)
                check(cli.connected, "CLI daemon: no connection")
                sub = reads1[:256]
                check(cli.smem(sub) == got[:256] and not cli.used_fallback,
                      "CLI daemon: SMEM differs")
                cli.shutdown_server()
                check(proc.wait(timeout=60) == 0, "CLI daemon exit code")
                say(f"CLI daemon (--conf, --device {engines.device.type}): up in "
                    f"{up_s:.2f} s, SMEM on 256 reads == the in-process daemon, shut "
                    f"down: ok")
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=30)

        # two concurrent clients, interleaved SW and SMEM requests
        want_sw = engines.sw.align(refs[:2048], alts[:2048], 0)
        want_smem = got[:1024]
        errs, jobs = [], [
            lambda c: c.sw(refs[:2048], alts[:2048], 0) == want_sw,
            lambda c: c.smem(reads1[:1024]) == want_smem,
        ]
        before = dict(server.answered)

        def work(job):
            try:
                c = EngineClient(*server.address, device="cuda", request_timeout=300)
                for _ in range(3):
                    if not job(c):
                        errs.append("concurrent answer differs")
                c.close()
            except Exception as e:  # reported by the check below
                errs.append(repr(e))

        threads = [threading.Thread(target=work, args=(j,)) for j in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        check(not errs and not any(t.is_alive() for t in threads)
              and server.answered[OP_SW] - before.get(OP_SW, 0) == 3
              and server.answered[OP_SMEM] - before.get(OP_SMEM, 0) == 3,
              f"concurrent clients: {errs}")
        say(f"two concurrent clients (SW 2048 pairs, SMEM 1024 reads, 3 requests each): "
            f"exact; the daemon answered {dict(server.answered)}")
        client.close()
    finally:
        server.stop()
    return launches


def drivers_phase(card: str) -> dict:
    """Phase 18: each port driver's main(..., "--device", "cuda") at small
    sizes (exit code 0: every oracle and host check passed), then entry()
    against the plain forward and dryrun_multichip(4) on [cuda:0] * 4.
    Returns the launches of its paths."""
    from acc_genomics_tpu_torch import entry
    from acc_genomics_tpu_torch.drivers import (
        bwamem_driver,
        extend_driver,
        fuzz_driver,
        hc_driver,
        pairhmm_driver,
        smem_driver,
        sw_driver,
    )
    from acc_genomics_tpu_torch.ops.pairhmm import kernel as K

    corpus = tempfile.mkdtemp()  # the corpus under the driver's file names
    for kind in ("input", "output"):
        shutil.copy(os.path.join(HERE, "tests", "fixtures", f"pairhmm_{kind}0"),
                    os.path.join(corpus, f"{kind}0"))
    runs = [
        (pairhmm_driver, ["--syn", "2"]),
        (pairhmm_driver, ["--real", corpus]),
        (sw_driver, []),
        (extend_driver, []),
        (smem_driver, ["--genome", "1000000", "--reads", "2048", "--batches", "1"]),
        (bwamem_driver, ["--genome", "1000000", "--reads", "1024", "--batches", "1"]),
        (hc_driver, []),
        (fuzz_driver, ["--mesh"]),
    ]
    launches = {}
    for module, argv in runs:
        name = module.__name__.rsplit(".", 1)[1]
        clear_launches()
        t0 = time.perf_counter()
        rc = module.main(argv + ["--device", "cuda"])
        run = read_launches()
        say(f"driver {name} {' '.join(argv)}: exit {rc} in {time.perf_counter() - t0:.2f} s; "
            f"launches {run}")
        check(rc == 0, f"driver {name} {argv} exit code {rc}")
        add_launches(launches, run)
    shutil.rmtree(corpus)

    fn, args = entry.entry("cuda")
    clear_launches()
    got = fn(*args).cpu().numpy()
    run = read_launches()
    check(run == {"pairhmm_forward": 1}, f"entry() launches {run}")
    add_launches(launches, run)
    want = K.pairhmm_forward_plain(*args).cpu().numpy()
    check(np.allclose(got, want, rtol=1e-5, atol=0), "entry() vs the plain forward")
    clear_launches()
    entry.dryrun_multichip(4, "cuda")
    run = read_launches()
    check(all(run.get(k, 0) > 0 for k in ("pairhmm_band_superstep", "smem_collect",
                                           "sw_extend", "sw_fill", "sw_walk")),
          f"dryrun_multichip launches {run}")
    say(f"entry() == plain forward (rtol 1e-5); dryrun_multichip(4) on [cuda:0] * 4: ok; "
        f"launches {run} [{card}]")
    add_launches(launches, run)
    return launches


PG_KERNELS = ("pairhmm_forward", "pairhmm_band_superstep", "sw_fill", "sw_walk", "sw_extend",
              "smem_collect")
PG_TIMEOUT_S = 600


def distributed_phase(card: str) -> dict:
    """Phase 19: two processes on the one card in a gloo group over a file
    store (``tools/pg_run.py`` at the main paths' shapes: one bucket of the
    8192-pair PairHMM kernel batch, DP x SP on a (1, 2) grid over phase
    15's 2,048 long pairs, the SW batch's first 4096-pair chunk, the
    2048-task extension batch, 2048 reads over a 1 Mbp index), each rank
    holding its gathered result and local part against the single-process
    form; then the scaling driver on [cuda:0] * 4.  Returns the launches
    of the ranks' checked runs and the scaling driver's."""
    import torch

    from acc_genomics_tpu_torch.drivers import scaling_driver
    from acc_genomics_tpu_torch.tools.pg_run import run_ranks

    tmp = tempfile.mkdtemp()
    try:
        t0 = time.perf_counter()
        outs = run_ranks(tmp, "cuda", "main", timeout=PG_TIMEOUT_S)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {}
    for r, (rc, out) in enumerate(outs):
        if rc != 0:
            say(f"rank {r} output (last 4000 characters):\n{out[-4000:]}")
        check(rc == 0, f"phase 19 rank {r} exit code {rc}")
        rep = json.loads(out.strip().splitlines()[-1])
        check(rep["device"] == torch.cuda.get_device_name(0) and rep["checks"]
              and all(rep["checks"].values()), f"phase 19 rank {r}: {rep['checks']}")
        say(f"two processes on cuda:0, rank {r}: checks {rep['checks']}; launches "
            f"{rep['launches']}; times {json.dumps(rep['times'])} [{card}]")
        add_launches(launches, rep["launches"])
    check(all(launches.get(k, 0) > 0 for k in PG_KERNELS),
          f"phase 19: a kernel the ranks did not launch: {launches}")
    say(f"phase 19: both ranks exit 0 in {wall:.2f} s (wall, the ranks' set-up included) "
        f"[{card}]")
    clear_launches()
    t0 = time.perf_counter()
    rc = scaling_driver.main(["--device", "cuda", "--devices", "4", "--reps", "3"])
    run = read_launches()
    say(f"scaling_driver --devices 4: exit {rc} in {time.perf_counter() - t0:.2f} s; "
        f"launches {run} [{card}]")
    check(rc == 0 and run.get("pairhmm_forward", 0) > 0, "scaling_driver on [cuda:0] * 4")
    add_launches(launches, run)
    return launches


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "acc_genomics_tpu_torch")):
        # run alone, outside a checkout: there is no port to drive
        print(f"chip_smoke: no acc_genomics_tpu_torch package beside {__file__}; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import acc_genomics_tpu_torch.engine.pairhmm_engine as engine_module
    from acc_genomics_tpu_torch.build import ensure_native, find_nvcc
    from acc_genomics_tpu_torch.engine.pairhmm_engine import PairHMMEngine
    from acc_genomics_tpu_torch.ops.pairhmm import band_kernel as BK
    from acc_genomics_tpu_torch.ops.pairhmm import gather as G
    from acc_genomics_tpu_torch.ops.pairhmm import kernel as K
    from acc_genomics_tpu_torch.ops.extend import kernel as EK
    from acc_genomics_tpu_torch.ops.smem import kernel as MK
    from acc_genomics_tpu_torch.ops.sw import kernel as SK
    from acc_genomics_tpu_torch.ops.pairhmm.convert import (
        batch_to_torch,
        context_tables,
        quals_to_torch,
    )
    from acc_genomics_tpu_torch import native
    from acc_genomics_tpu_torch.config import PairHMMConfig
    from acc_genomics_tpu_torch.io.pairhmm_text import (
        read_pairhmm_input,
        read_pairhmm_output,
    )
    from acc_genomics_tpu_torch.io.synth import gen_pairhmm_input, gen_pairhmm_pairs
    from acc_genomics_tpu_torch.ops.pairhmm.context import PairHMMContext
    from acc_genomics_tpu_torch.ops.pairhmm.pack import (
        pack_pairhmm_batch,
        pack_pairhmm_quals,
    )
    from acc_genomics_tpu_torch.tools.bench_shapes import (
        capture_calls,
        flat_matrix_args,
        pairhmm_bench_groups,
        pairhmm_edge_packs,
        pairhmm_engine_batches,
    )

    check(not [m for m in sys.modules if m == "jax" or m.startswith("jax.")],
          "the port imported jax")
    check(not [m for m in sys.modules
               if m == "acc_genomics_tpu" or m.startswith("acc_genomics_tpu.")],
          "the port imported the JAX package")

    # -- 1. environment ----------------------------------------------------
    card = card_line()
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    nvcc_ver = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                              text=True, check=True).stdout.strip().splitlines()
    say(f"nvcc: {nvcc_ver[-1]}")
    native_ok = ensure_native()
    say(f"native host library available: {native_ok}")
    check(native_ok, "native host library unavailable: the engine needs it")

    # -- 2. build: one nvcc per source, all started together ------------------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(6) as pool:
        futures = [pool.submit(K.build_kernels), pool.submit(BK.build_kernels),
                   pool.submit(G.build_kernels), pool.submit(SK.build_kernels),
                   pool.submit(EK.build_kernels), pool.submit(MK.build_kernels)]
        libs = [f.result() for f in futures[:3]] + [b for f in futures[3:]
                                                    for b in f.result().values()]
    wall = time.perf_counter() - t0
    for built in libs:
        say(f"build: {built.path} built={built.built} nvcc_s={built.seconds:.2f}")
        for line in built.log.splitlines():
            if any(k in line for k in ("entry function", "registers", "spill", "stack")):
                say(f"  ptxas: {line.strip()}")
    say(f"build wall_s={wall:.2f}")

    dev = torch.device("cuda", 0)
    ctx = PairHMMContext(np.float32)
    ph2pr, m2m, _ = context_tables(ctx, dev)
    ic = float(ctx.initial_constant)
    log10_ic = ctx.log10_initial_constant

    # -- 3. kernel vs plain at the benchmark shapes -------------------------
    cols, row_buckets = 384, (64, 96, 128, 152)
    coef_packs, qual_packs = [], []
    for rows, group in pairhmm_bench_groups(cols, row_buckets).items():
        coef_packs.append(batch_to_torch(pack_pairhmm_batch(
            group, rows=rows, cols=cols, sort_by_haplen=True), dev))
        qp = pack_pairhmm_quals(group, rows=rows, cols=cols, sort_by_haplen=True)
        qual_packs.append((qp.cells, quals_to_torch(qp, dev)))
    cells = sum(c for c, _ in qual_packs)
    inert = torch.cat([a[7] == 0 for _, a in qual_packs]).cpu().numpy()
    say(f"bench shapes: 8192 pairs, {len(qual_packs)} row buckets "
        f"{row_buckets}, {cols} cols, {cells} cells, {int(inert.sum())} inert lanes")

    front_ends = {
        "coef": (K.pairhmm_forward, K.pairhmm_forward_plain, coef_packs),
        "quals_arith": (
            lambda *a: K.pairhmm_forward_from_quals(*a, ph2pr, m2m, ic, "arith"),
            lambda *a: K.pairhmm_forward_from_quals_plain(*a, ph2pr, m2m, ic, "arith"),
            [a for _, a in qual_packs]),
        "quals_gather": (
            lambda *a: K.pairhmm_forward_from_quals(*a, ph2pr, m2m, ic, "gather"),
            lambda *a: K.pairhmm_forward_from_quals_plain(*a, ph2pr, m2m, ic, "gather"),
            [a for _, a in qual_packs]),
    }
    for name, (kern, plain, packs) in front_ends.items():
        got = torch.cat([kern(*a) for a in packs]).cpu().numpy()
        want = torch.cat([plain(*a) for a in packs]).cpu().numpy()
        kernel_vs_plain(f"bench {name}", got, want, log10_ic)
        check(np.all(got[inert] == 0.0), f"bench {name}: inert lanes not exactly 0")
        k_ms = cuda_time_ms(lambda: [kern(*a) for a in packs])
        p_ms = cuda_time_ms(lambda: [plain(*a) for a in packs], repeats=1, warm=False)
        say(f"bench {name}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
            f"kernel_gcups={cells / (k_ms * 1e-3) / 1e9:.3f} [{card}]")

    # -- 3. the edges of the segment design: C = 8, 16, 32, the chunks and
    # partly filled warps ---------------------------------------------------
    for label, cp, qp in pairhmm_edge_packs(dev):
        for name, (kern, plain, _) in front_ends.items():
            a = cp if name == "coef" else qp
            got = kern(*a).cpu().numpy()
            want = plain(*a).cpu().numpy()
            kernel_vs_plain(f"edge {label} {name}", got, want, log10_ic)
            zero = (a[10] == 0) if name == "coef" else (a[6] == 0) | (a[7] == 0)
            check(np.all(got[zero.cpu().numpy()] == 0.0),
                  f"edge {label} {name}: inert lanes not exactly 0")

    # -- 4. engine main path --------------------------------------------------
    batches = [(reads, haps, flat_matrix_args(reads, haps))
               for reads, haps in pairhmm_engine_batches(3)]
    reads, haps, f0 = batches[0]
    n_pairs = len(reads) * len(haps)
    batch_cells = int(sum(len(r["rs"]) * len(h) for r in reads for h in haps))
    eng = PairHMMEngine(device="cuda")
    # warm-up (allocator, pinned pool, stream); keeps copies of the byte
    # planes of every bucket the engine launches, and of the upload and
    # layout of its gather, for the checks below
    launched, gathered = [], []
    with capture_calls(engine_module, "pairhmm_forward_from_quals", launched), \
            capture_calls(engine_module, "pairhmm_gather", gathered):
        eng.compute_matrix_flat(*f0)
    torch.cuda.synchronize()
    stats0 = dict(eng.stats)

    K.LAUNCHES.clear()
    e2e, liks = [], []
    for _ in range(E2E_REPEATS):
        t0 = time.perf_counter()
        liks.append(eng.compute_matrix_flat(*f0))
        e2e.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    streamed = eng.compute_pairs_flat_stream([matrix_pair_args(b[2]) for b in batches])
    stream_s = time.perf_counter() - t0
    launches = K.LAUNCHES["pairhmm_forward_from_quals"]
    coef_launches = K.LAUNCHES["pairhmm_forward"]
    gather_launches = K.LAUNCHES["pairhmm_gather"]

    device_calls = eng.stats["device_calls"] - stats0["device_calls"]
    e2e_s = statistics.median(e2e)
    say(f"engine main path: {n_pairs} pairs, {batch_cells} cells, "
        f"{len(launched)} buckets per batch; launches {launches} "
        f"(device buckets {device_calls}) over {E2E_REPEATS} batches + a "
        f"stream of 3; e2e_s median={e2e_s:.5f} min={min(e2e):.5f} "
        f"max={max(e2e):.5f} (n={E2E_REPEATS}) e2e_gcups median="
        f"{batch_cells / e2e_s / 1e9:.3f} min={batch_cells / max(e2e) / 1e9:.3f} "
        f"max={batch_cells / min(e2e) / 1e9:.3f}; stream of 3 batches "
        f"s={stream_s:.5f} gcups={3 * batch_cells / stream_s / 1e9:.3f} [{card}]")
    say(f"engine stats: {json.dumps(eng.stats, sort_keys=True)}")
    check(launches == device_calls >= E2E_REPEATS * len(launched) > 0
          and coef_launches == 0 and gather_launches == E2E_REPEATS + len(batches)
          and len(gathered) == 1,
          f"main path launches {dict(K.LAUNCHES)} for {device_calls} buckets")
    lik = liks[0]
    check(lik.shape == (len(reads), len(haps)) and np.isfinite(lik).all(),
          "engine output shape or non-finite values")
    check(all(np.array_equal(x, lik) for x in liks), "repeated batches differ")

    # the kernel against its plain version on the buckets the engine launched
    got = torch.cat([K.pairhmm_forward_from_quals(*a, **kw) for a, kw in launched])
    want = torch.cat([K.pairhmm_forward_from_quals_plain(*a, **kw)
                      for a, kw in launched])
    eng_err = kernel_vs_plain("engine buckets", got.cpu().numpy(),
                              want.cpu().numpy(), log10_ic)
    k_ms = cuda_time_ms(lambda: [K.pairhmm_forward_from_quals(*a, **kw)
                                 for a, kw in launched])
    p_ms = cuda_time_ms(lambda: [K.pairhmm_forward_from_quals_plain(*a, **kw)
                                 for a, kw in launched], repeats=1, warm=False)
    shapes = sorted({(a[4].shape[0], a[5].shape[0] - a[4].shape[0], a[4].shape[1])
                     for a, _ in launched})
    # the byte planes and tables read once, one fp32 result a pair written
    pairhmm_bound = bound(sum(nbytes(*a, *kw.values()) for a, kw in launched) + 4 * n_pairs,
                          PAIRHMM_OPS_PER_CELL * batch_cells, FP32_OPS_PER_S)
    say(f"engine buckets (rows, cols, pairs) {shapes}: kernel_ms={k_ms:.4f} "
        f"plain_ms={p_ms:.4f} kernel_gcups={batch_cells / (k_ms * 1e-3) / 1e9:.3f} "
        f"bound {pairhmm_bound} [{card}]")

    # the gather against its plain version on the warm-up's upload, bit
    # for bit, and against the planes the forward kernel was given
    (upload, layout), _ = gathered[0]
    planes = G.pairhmm_gather(upload, layout)
    check(torch.equal(planes, G.pairhmm_gather_plain(upload, layout)),
          "engine gather: kernel and plain planes differ")
    check(all(all(torch.equal(v, w) for v, w in zip(layout.bucket(b, planes, upload), a[:8]))
              for b, (a, _) in enumerate(launched)),
          "engine gather: planes differ from those the forward kernel was given")
    g_ms = cuda_time_ms(lambda: G.pairhmm_gather(upload, layout))
    gp_ms = cuda_time_ms(lambda: G.pairhmm_gather_plain(upload, layout), repeats=1,
                         warm=False)
    # the upload read once, the planes written once
    gather_bound = bound(layout.nbytes + layout.planes_bytes, 0, INT32_OPS_PER_S)
    say(f"engine gather: {layout.lanes} lanes, {len(layout.table)} buckets, upload "
        f"{layout.nbytes} B, planes {layout.planes_bytes} B; bit for bit vs plain; "
        f"kernel_ms={g_ms:.4f} plain_ms={gp_ms:.4f} bound {gather_bound} [{card}]")

    tcs = [dict(hap=h, **r) for r in reads for h in haps]
    raw_host = native.pairhmm_forward(tcs, np.float32)
    raw64 = native.pairhmm_forward(tcs, np.float64)
    ctx64 = PairHMMContext(np.float64)
    want = np.where(raw_host >= MIN_ACCEPTED, loglik(raw_host, log10_ic),
                    loglik(raw64, ctx64.log10_initial_constant))
    rel = np.abs(lik.reshape(-1) - want) / np.abs(want)
    say(f"engine (arith) vs native fp32 host: max_rel={rel.max():.3e}")
    check(rel.max() < RTOL_HOST, f"engine vs host {rel.max()}")
    lik_g = PairHMMEngine(PairHMMConfig(quals_expand="gather"),
                          device="cuda").compute_matrix_flat(*f0)
    rel = np.abs(lik_g.reshape(-1) - want) / np.abs(want)
    say(f"engine (gather) vs native fp32 host: max_rel={rel.max():.3e}")
    check(rel.max() < RTOL_HOST_GATHER, f"gather engine vs host {rel.max()}")
    sample = np.random.default_rng(2).choice(n_pairs, 64, replace=False)
    orc = oracle([tcs[k] for k in sample])
    rel_o = np.abs(lik.reshape(-1)[sample] - orc) / np.abs(orc)
    say(f"engine vs fp64 oracle (64 sampled pairs): max_rel={rel_o.max():.3e}")
    check(rel_o.max() < RTOL_ORACLE, f"engine vs oracle {rel_o.max()}")
    for (_, _, f), got in zip(batches, streamed):
        single = PairHMMEngine(device="cuda").compute_matrix_flat(*f).reshape(-1)
        np.testing.assert_allclose(got, single, rtol=1e-12)
    say("engine stream == single calls: ok")

    # -- 5. contract edges ------------------------------------------------------
    reads_c, haps_c = read_pairhmm_input(os.path.join(HERE, "tests/fixtures/pairhmm_input0"))
    golden = read_pairhmm_output(os.path.join(HERE, "tests/fixtures/pairhmm_output0"))
    eng = PairHMMEngine(device="cuda")
    eng.min_device_cells = 0
    before = K.LAUNCHES["pairhmm_forward_from_quals"]
    got = eng.compute_matrix(reads_c, haps_c).reshape(-1)
    corpus_launches = K.LAUNCHES["pairhmm_forward_from_quals"] - before
    rel = np.abs(got - golden) / np.maximum(np.abs(golden), 1e-12)
    say(f"corpus pairhmm_input0: {len(golden)} pairs max_rel={rel.max():.3e} "
        f"launches={corpus_launches}")
    check(rel.max() < RTOL_ORACLE and corpus_launches > 0, "corpus vs golden, on the card")

    rng = np.random.default_rng(3)
    reads_u, haps_u = gen_pairhmm_input(rng, 32, 4, max_read_len=150,
                                        max_hap_len=300, derived=False)
    eng = PairHMMEngine(device="cuda")
    eng.min_device_cells = 0
    got = eng.compute_matrix_flat(*flat_matrix_args(reads_u, haps_u)).reshape(-1)
    orc = oracle([dict(hap=h, **r) for r in reads_u for h in haps_u])
    rel = np.abs(got - orc) / np.abs(orc)
    say(f"underflow batch: recomputed={eng.stats['recomputed']}/{len(orc)} "
        f"max_rel={rel.max():.3e}")
    check(eng.stats["recomputed"] > 0 and rel.max() < RTOL_ORACLE, "underflow recompute")

    hap = rng.integers(0, 4, 120).astype(np.uint8)
    mism = dict(rs=((hap + 2) % 4).astype(np.uint8), q=np.full(120, 50, np.uint8),
                i=np.full(120, 45, np.uint8), d=np.full(120, 45, np.uint8),
                c=np.full(120, 10, np.uint8), hap=hap)
    eng = PairHMMEngine(PairHMMConfig(read_buckets=(128,), hap_buckets=(128,)),
                        device="cuda")
    eng.min_device_cells = 0
    got = eng.compute_pairs([mism])
    want1 = oracle([mism])[0]
    say(f"all-mismatch pair: recomputed={eng.stats['recomputed']} "
        f"got={got[0]:.6f} oracle={want1:.6f}")
    check(eng.stats["recomputed"] == 1 and abs(got[0] - want1) / abs(want1) < RTOL_ORACLE,
          "all-mismatch pair")

    eng = PairHMMEngine(device="cuda")
    eng.min_device_cells = 0
    pairs = gen_pairhmm_pairs(rng, 6, max_read_len=40, max_hap_len=80)
    big = dict(pairs[0])
    nr = eng.config.max_read_len + 5
    for k in ("rs", "q", "i", "d", "c"):
        big[k] = np.resize(np.asarray(pairs[0][k], np.uint8), nr)
    pairs.insert(3, big)
    got = eng.compute_pairs(pairs)
    orc = oracle(pairs)
    rel = np.abs(got - orc) / np.abs(orc)
    say(f"oversize read: host_fallback={eng.stats.get('host_fallback', 0)} "
        f"max_rel={rel.max():.3e}")
    check(eng.stats.get("host_fallback", 0) == 1, "one oversize pair on the host")
    check(rel.max() < RTOL_ORACLE, "oversize batch vs oracle")

    # -- 16. the rest of PairHMMEngine: upload="f32", the calibrated gate --------
    phase_launches = [dispatch_phase(card, f0, reads, haps, lik, lik_g, batch_cells, k_ms)]

    pairhmm_entry = {
        "name": "pairhmm_forward_from_quals", "route": "cuda", "source": CU_SOURCE,
        "replaces": TPU_KERNEL, "launches": launches, "max_abs_err": eng_err,
        "ms": k_ms, "plain_ms": p_ms, **pairhmm_bound,
    }
    gather_entry = {
        "name": "pairhmm_gather", "route": "cuda", "source": GATHER_SOURCE,
        "replaces": GATHER_TPU, "launches": gather_launches, "max_abs_err": 0,
        "ms": g_ms, "plain_ms": gp_ms, **gather_bound,
    }

    # -- 6-9. Smith-Waterman and HaplotypeCaller ---------------------------------
    sw_entries = sw_phases(card)
    hc_phases(card)

    # -- 10-14. BWA-MEM: extension, SMEM, BwaMemSeeding, BwaMemDevicePipeline ------
    extend_entry = extend_phases(card, dev)
    smem_entry, fused_entry, (engines, fm, smem_reads) = smem_bwa_phases(
        card, dev, extend_entry)

    # -- 20. the SMEM retry at wide caps on a uniform-like batch -------------------
    retry_phase(card, dev, smem_entry)

    # -- 17. the engine service on phase 13's GenomicsEngine ------------------------
    phase_launches.append(service_phase(card, engines, fm, smem_reads, (reads, haps, f0)))
    del engines, fm, smem_reads

    # -- 15. the mesh path: band kernel, DP x SP, GenomicsEngine(mesh=...) ------
    band_entry = mesh_phase(card, dev)

    # -- 18. the drivers and the entry check -----------------------------------------
    phase_launches.append(drivers_phase(card))

    # -- 19. two processes on the card: the process-group forms, the scaling driver --
    phase_launches.append(distributed_phase(card))

    check(not [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "acc_genomics_tpu" or m.startswith("acc_genomics_tpu.")],
          "a phase imported jax or the JAX package")
    entries = [pairhmm_entry, gather_entry, *sw_entries, extend_entry, smem_entry, fused_entry, band_entry]
    for run in phase_launches:  # phases 16-19 drive their paths through these kernels
        for e in entries:
            e["launches"] += run.get(e["name"], 0)
        pairhmm_entry["coef_front_end_launches"] = (
            pairhmm_entry.get("coef_front_end_launches", 0) + run.get("pairhmm_forward", 0))
    check(all(e["launches"] > 0 for e in entries),
          f"a kernel no main path launched: {[(e['name'], e['launches']) for e in entries]}")
    say(json.dumps({"kernels": entries}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
