"""Old against new: an earlier commit's kernels and this checkout's, timed
in turns on one card at the same inputs.

    python -m acc_genomics_tpu_torch.tools.kernel_ab OLD_DIR [KERNEL ...]

KERNEL is ``extend``, ``pairhmm``, ``band_superstep``, ``sw_fill``,
``sw_walk``, ``fused``, ``smem`` or ``pairhmm_gather`` (the default: all
eight).  OLD_DIR holds the
earlier commit's sources of the kernels named (``git show <commit>:<path>``
of ``acc_genomics_tpu_torch/ops/.../csrc/``), built with the package's
nvcc flags into its build directory:

  extend   ``sw_extend.cu`` (C entry point ``sw_extend``; the old
           interface takes an eh scratch, which the new one dropped): the
           bench batch of ``tools/bench_shapes.py``, ExtendEngine's own
           launches on its 4096 bench seeds, and the batch of gaps at
           column 256 in a 520-column bucket (the shared-memory tiles);
  pairhmm  ``pairhmm_forward.cu`` and the ``pairhmm_common.cuh`` it
           includes (the same C interface ``pairhmm_forward_quals``,
           arith): bench.py's 8192 pairs in their four row buckets and the
           buckets PairHMMEngine launches on chip_smoke.py's engine batch;
  band_superstep  ``pairhmm_band.cu`` and its ``pairhmm_common.cuh`` with
           the same C interface ``pairhmm_band_superstep``: the middle
           superstep of chip_smoke.py phase 15's SP pipeline at C = 8, 16
           and 32, every output bit for bit;
  sw_fill  ``sw_fill.cu`` (the same C interface ``sw_fill``): the SW bench
           batch's two 4,096-pair chunks (320 x 320) without and with the
           indel ramps, every output bit for bit;
  sw_walk  ``sw_walk.cu`` (the same C interface ``sw_walk``): the same fill
           outputs (strategy 0) walked by both builds, on the SW bench
           batch's two chunks, the 1536-row bucket of ``sw_fill_batches``
           and the 4,096 gap-heavy pairs of ``sw_walk_batches``, the packed
           outputs bit for bit;
  fused    ``sw_extend.cu`` (C entry point ``sw_extend_fused``; the old
           interface takes an eh scratch): chip_smoke.py phase 14's seeds
           on its 100 Mbp index (built first, about a minute), every output
           bit for bit;
  smem     ``smem_collect.cu`` (the same C interface ``smem_collect``) at
           the default caps (24/24): chip_smoke.py phase 12's 65,536
           reads and phase 14's 2,048 (both of 101, bucket 128) on the
           same index, every output bit for bit;
  pairhmm_gather  no old sources (OLD_DIR is not read): the card's
           byte-plane gather (``pairhmm_gather.cu``) against the native
           host pack it replaced (``native.pairhmm_pack_quals_flat``, every
           bucket into a buffer of its own, host clock; the engine packed
           into its pinned stage), on the PairHMM batch of 32 regions of each
           HC configuration's generator (``port_bench``, so run from the
           checkout's root), the planes bit for bit.

Every mode but ``band_superstep`` calls both builds through their C entry
points with the same prepared arguments, so no wrapper's host work is
timed on one side only (``band_superstep`` runs both through the
wrapper).  Each pair runs old, new, new, old (CUDA events, median of 7
each); the outputs must agree bit for bit (and PairHMM's wrapper within
rtol 1e-5 of the old build).  Registers and spills of both builds
(ptxas) are printed.  The last line of standard output is one JSON
object with every time.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

from acc_genomics_tpu_torch import build, native
from acc_genomics_tpu_torch.utils.convert import HAP_PAD

_P, _I = ctypes.c_void_p, ctypes.c_int


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def cuda_ms(fn, repeats: int = 7) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def in_turns(old, new) -> dict:
    """old, new, new, old: the two medians of each."""
    o1, n1, n2, o2 = cuda_ms(old), cuda_ms(new), cuda_ms(new), cuda_ms(old)
    return {"old_ms": [o1, o2], "new_ms": [n1, n2]}


def old_library(old_dir: str, name: str, headers=()):
    rel = lambda f: os.path.relpath(os.path.join(old_dir, f), build.PACKAGE_DIR)
    return build.load_library(f"{name}_old", [rel(f"{name}.cu")], [rel(h) for h in headers])


def ptxas(built) -> dict:
    """{kernel entry: "N registers, S bytes spill stores"} from nvcc's log."""
    out, entry = {}, None
    for line in built.log.splitlines():
        if "entry function" in line:
            entry = line.split("'")[1]
        elif entry and "spill stores" in line:
            out[entry] = line.strip().split(",")[1].strip()
        elif entry and "registers" in line:
            regs = line.split("Used", 1)[1].split(",")[0].strip()
            out[entry] = f"{regs}, {out.get(entry, '0 bytes spill stores')}"
            entry = None
    return out


def print_ptxas(name: str, old, new) -> dict:
    regs = {"old": ptxas(old), "new": ptxas(new)}
    for which, kernels in regs.items():
        for entry, line in kernels.items():
            print(f"  ptxas {name} {which}: {entry}: {line}", flush=True)
    return regs


def extend_ab(old_dir: str, dev) -> dict:
    """The bench batch and ExtendEngine's own launches."""
    import acc_genomics_tpu_torch.engine.extend_engine as engine_module
    from acc_genomics_tpu_torch.engine.extend_engine import ExtendEngine
    from acc_genomics_tpu_torch.ops.extend import kernel as EK
    from acc_genomics_tpu_torch.tools.bench_shapes import (
        capture_calls,
        extend_batches,
        extend_bench_seeds,
    )

    built = old_library(old_dir, "sw_extend")
    fn = built.lib.sw_extend
    fn.argtypes = [_P] * 7 + [_I] * 11 + [_P] * 3  # the old interface's eh scratch
    fn.restype = ctypes.c_int
    new_built = EK.build_kernels()["sw_extend"]
    new_fn = new_built.lib.sw_extend
    regs = print_ptxas("sw_extend", built, new_built)
    batches = {b["name"]: b for b in extend_batches(dev)}
    as_call = lambda b: [b[k] for k in ("q", "t", "qlen", "tlen", "h0", "max_ins", "max_ins",
                                        "params")]
    eng = ExtendEngine(device=dev)
    calls = []
    with capture_calls(engine_module, "sw_extend_rows", calls):
        eng.extend_seeds(extend_bench_seeds()[1])
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    out = {"ptxas": regs}
    for name, launches in (("bench", [(as_call(batches["bench"]), {})]), ("engine", calls),
                           ("tiles", [(as_call(batches["gaps at column 256, Q 520"]), {})])):
        prepared = []
        for args, kw in launches:
            q, t, ql, tl, h0, mi, md, p = [*args, *kw.values()]
            Q, B = q.shape
            eh = torch.empty((2, Q + 2, B), dtype=torch.int32, device=dev)
            res = torch.empty((7, B), dtype=torch.int32, device=dev)
            prepared.append((q.to(torch.uint8).contiguous(), t.to(torch.uint8).contiguous(),
                             ql, tl, h0, mi, md, p, eh, res))

        def with_lib(f, eh: bool):
            def go():
                for q, t, ql, tl, h0, mi, md, p, scratch, res in prepared:
                    err = f(*(_ptr(x) for x in (q, t, ql, tl, h0, mi, md)), q.shape[0],
                            t.shape[0], q.shape[1], p.o_del, p.e_del, p.o_ins, p.e_ins, p.w,
                            p.sc_match, p.sc_mismatch, p.sc_ambig,
                            *([_ptr(scratch)] if eh else []), _ptr(res), stream)
                    if err:
                        raise RuntimeError(f"extension kernel: error {err}")
            return go

        with_lib(fn, True)()
        got = [EK.sw_extend_rows(*x[:8]) for x in prepared]  # the wrapper's result
        torch.cuda.synchronize()
        if not all(torch.equal(g, x[9]) for g, x in zip(got, prepared)):
            raise AssertionError(f"extend, {name}: old and new kernels differ")
        tasks = sum(x[0].shape[1] for x in prepared)
        out[name] = {"launches": len(prepared), "tasks": tasks,
                     **in_turns(with_lib(fn, True), with_lib(new_fn, False))}
        print(f"extend, {name} ({len(prepared)} launches, {tasks} tasks): {out[name]}",
              flush=True)
    return out


def sw_fill_ab(old_dir: str, dev) -> dict:
    """The SW bench batch's two 4,096-pair chunks (320 x 320), strategy 0
    and 1 (the ramps): every output bit for bit (both builds write only
    each pair's region of zeroed outputs)."""
    from acc_genomics_tpu_torch.ops.sw import kernel as SK
    from acc_genomics_tpu_torch.tools.bench_shapes import sw_bench_chunks

    built = old_library(old_dir, "sw_fill")
    new_built = SK.build_kernels()["sw_fill"]
    fn, new_fn = built.lib.sw_fill, new_built.lib.sw_fill
    fn.argtypes = new_fn.argtypes
    fn.restype = ctypes.c_int
    regs = print_ptxas("sw_fill", built, new_built)
    _, _, chunks = sw_bench_chunks(dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    p = [int(x) for x in SK.DEFAULT_SW_PARAMS]

    def outputs():
        return [(torch.zeros((r.shape[0], r.shape[1] + a.shape[1] - 1, r.shape[1]),
                             dtype=torch.int16, device=dev),
                 torch.zeros(a.shape, dtype=torch.int32, device=dev),
                 torch.zeros(r.shape, dtype=torch.int32, device=dev)) for r, a, _, _ in chunks]

    def with_lib(f, outs, indel: int):
        def go():
            for (r, a, rl, al), o in zip(chunks, outs):
                err = f(*(_ptr(x) for x in (r, a, rl, al)), r.shape[1], a.shape[1], r.shape[0],
                        indel, *p, *(_ptr(x) for x in o), stream)
                if err:
                    raise RuntimeError(f"SW fill kernel: error {err}")
        return go

    out = {"ptxas": regs, "pairs": [c[0].shape[0] for c in chunks],
           "cells": sum(int((c[2].long() * c[3].long()).sum()) for c in chunks)}
    for indel in (0, 1):
        old_out, new_out = outputs(), outputs()
        with_lib(fn, old_out, indel)()
        with_lib(new_fn, new_out, indel)()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for o, n in zip(old_out, new_out) for x, y in zip(o, n)):
            raise AssertionError(f"sw_fill, indel {indel}: old and new kernels differ")
        del old_out
        out[f"indel{indel}"] = in_turns(with_lib(fn, new_out, indel),
                                        with_lib(new_fn, new_out, indel))
        print(f"sw_fill, bench batch, indel {indel}: outputs equal bit for bit; "
              f"{out[f'indel{indel}']}", flush=True)
        del new_out
    return out


def sw_walk_ab(old_dir: str, dev) -> dict:
    """The same fill outputs (strategy 0) walked by both builds: the SW
    bench batch's two 4,096-pair chunks, the 1536-row bucket of
    ``sw_fill_batches`` and the gap-heavy batch of ``sw_walk_batches``;
    the packed outputs bit for bit."""
    from acc_genomics_tpu_torch.ops.sw import kernel as SK
    from acc_genomics_tpu_torch.tools.bench_shapes import (
        WALK_GAP_PAIRS,
        sw_bench_chunks,
        sw_fill_batches,
        sw_walk_batches,
    )

    built = old_library(old_dir, "sw_walk")
    new_built = SK.build_kernels()["sw_walk"]
    fn, new_fn = built.lib.sw_walk, new_built.lib.sw_walk
    fn.argtypes = new_fn.argtypes
    fn.restype = ctypes.c_int
    regs = print_ptxas("sw_walk", built, new_built)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    cases = (("bench", lambda: sw_bench_chunks(dev)[2]),
             ("1536 bucket", lambda: [b[1:] for b in sw_fill_batches(dev)
                                      if b[1].shape[1] == 1536]),
             ("gap-heavy", lambda: [b[1:] for b in sw_walk_batches(dev)
                                    if b[1].shape[0] == WALK_GAP_PAIRS]))
    out = {"ptxas": regs}
    for name, batch in cases:
        fills = [(SK.sw_fill(r, a, rl, al, 0), rl, al) for r, a, rl, al in batch()]

        def with_lib(f, outs):
            def go():
                for ((bt, lr, ac), rl, al), o in zip(fills, outs):
                    rows = bt.shape[2]
                    err = f(*(_ptr(x) for x in (bt, lr, ac, rl, al)), rows,
                            bt.shape[1] - rows + 1, bt.shape[0], 0, _ptr(o), stream)
                    if err:
                        raise RuntimeError(f"SW walk kernel: error {err}")
            return go

        old_out, new_out = ([torch.zeros((SK.SHIP_ELEMS + 2, f[0][0].shape[0]),
                                         dtype=torch.int16, device=dev) for f in fills]
                            for _ in range(2))
        with_lib(fn, old_out)()
        with_lib(new_fn, new_out)()
        torch.cuda.synchronize()
        if not all(torch.equal(o, n) for o, n in zip(old_out, new_out)):
            raise AssertionError(f"sw_walk, {name}: old and new kernels differ")
        out[name] = {"launches": len(fills), "pairs": [f[0][0].shape[0] for f in fills],
                     "bucket": list(fills[0][0][0].shape),
                     **in_turns(with_lib(fn, old_out), with_lib(new_fn, new_out))}
        print(f"sw_walk, {name}: outputs equal bit for bit; {out[name]}", flush=True)
        del fills, old_out, new_out
    return out


def fused_ab(old_dir: str, dev) -> dict:
    """chip_smoke.py phase 14's 11,411 seeds (the 100 Mbp index is built
    first, about a minute): every output bit for bit.  The old build's C
    interface takes the eh scratch, the new one does not."""
    from acc_genomics_tpu_torch.ops.extend import kernel as EK
    from acc_genomics_tpu_torch.tools.bench_shapes import pipeline_fused_args

    built = old_library(old_dir, "sw_extend")
    new_built = EK.build_kernels()["sw_extend"]
    fn, new_fn = built.lib.sw_extend_fused, new_built.lib.sw_extend_fused
    fn.argtypes = [_P, _P, _I, _P, _I] + [_P] * 5 + [_I] * 11 + [_P] * 3
    fn.restype = ctypes.c_int
    regs = print_ptxas("sw_extend", built, new_built)
    (sa, text, reads, rlens, rows, qbeg, slen, readid, flank, p), _ = pipeline_fused_args(dev)
    n, width = rows.shape[0], reads.shape[1]
    eh = torch.empty((2, width + 2, n), dtype=torch.int32, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    def with_lib(f, res, scratch):
        def go():
            err = f(_ptr(sa), _ptr(text), text.shape[0], _ptr(reads), width,
                    *(_ptr(x) for x in (rlens, rows, qbeg, slen, readid)), n, flank,
                    p.o_del, p.e_del, p.o_ins, p.e_ins, p.w, p.sc_match, p.sc_mismatch,
                    p.sc_ambig, p.pen_clip, *([_ptr(scratch)] if scratch is not None else []),
                    _ptr(res), stream)
            if err:
                raise RuntimeError(f"fused extension kernel: error {err}")
        return go

    old_res, new_res = (torch.zeros((8, n), dtype=torch.int32, device=dev) for _ in range(2))
    with_lib(fn, old_res, eh)()
    with_lib(new_fn, new_res, None)()
    torch.cuda.synchronize()
    if not torch.equal(old_res, new_res):
        raise AssertionError("fused: old and new kernels differ")
    out = {"ptxas": regs, "seeds": n, "width": width,
           **in_turns(with_lib(fn, old_res, eh), with_lib(new_fn, new_res, None))}
    print(f"fused, phase 14's {n} seeds (width {width}): outputs equal bit for bit; "
          f"{ {k: v for k, v in out.items() if k != 'ptxas'} }", flush=True)
    return out


def smem_ab(old_dir: str, dev) -> dict:
    """chip_smoke.py phases 12 and 14's reads at the default caps: the
    counts, flags, probes and every interval row bit for bit."""
    from acc_genomics_tpu_torch.config import SmemConfig
    from acc_genomics_tpu_torch.engine.packing import pack_rows
    from acc_genomics_tpu_torch.ops.smem import kernel as MK
    from acc_genomics_tpu_torch.ops.smem.table import DeviceIndex
    from acc_genomics_tpu_torch.tools.bench_shapes import smem_index_and_reads

    built = old_library(old_dir, "smem_collect")
    new_built = MK.build_kernels()["smem_collect"]
    fn, new_fn = built.lib.smem_collect, new_built.lib.smem_collect
    fn.argtypes, fn.restype = new_fn.argtypes, ctypes.c_int
    regs = print_ptxas("smem_collect", built, new_built)
    _, fm, smem_reads, bwa_reads = smem_index_and_reads()
    idx = DeviceIndex.build(fm, dev)
    params = SmemConfig().params()
    chain_cap, mem_cap = MK.caps(params, 128)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    out = {"ptxas": regs, "caps": [chain_cap, mem_cap]}
    for key, reads in (("reads_65536", smem_reads), ("reads_2048", bwa_reads)):
        n, L = len(reads), 128
        rows, lens = pack_rows(reads, L, n)
        rows_d, lens_d = torch.from_numpy(rows).to(dev), torch.from_numpy(lens).to(dev)
        n_mem = 5 * mem_cap * n

        def with_lib(f, buf):
            def go():
                buf.zero_()  # the intervals past each count, the counts, the queue
                err = f(_ptr(idx.tbl), idx.primary, *idx.l2_values, _ptr(rows_d),
                        _ptr(lens_d), L, L, n, params.min_seed_len, params.split_len,
                        params.split_width, params.max_mem_intv, chain_cap, mem_cap,
                        _ptr(buf), *(_ptr(buf[n_mem + k * n:]) for k in range(3)),
                        _ptr(buf[-1:]), stream)
                if err:
                    raise RuntimeError(f"smem_collect: error {err}")
            return go

        old_buf, new_buf = (torch.zeros(n_mem + 3 * n + 1, dtype=torch.int32, device=dev)
                            for _ in range(2))
        with_lib(fn, old_buf)()
        with_lib(new_fn, new_buf)()
        torch.cuda.synchronize()
        if not torch.equal(old_buf, new_buf):
            raise AssertionError(f"smem {key}: old and new kernels differ")
        out[key] = in_turns(with_lib(fn, old_buf), with_lib(new_fn, new_buf))
        print(f"smem, {n} reads of 101 at caps {chain_cap}/{mem_cap}: outputs equal bit "
              f"for bit; {out[key]}", flush=True)
    return out


def pairhmm_ab(old_dir: str, dev) -> dict:
    """bench.py's pairs in their row buckets and the engine's own buckets."""
    import inspect

    import acc_genomics_tpu_torch.engine.pairhmm_engine as engine_module
    from acc_genomics_tpu_torch.engine.pairhmm_engine import PairHMMEngine
    from acc_genomics_tpu_torch.ops.pairhmm import kernel as K
    from acc_genomics_tpu_torch.ops.pairhmm.context import PairHMMContext
    from acc_genomics_tpu_torch.ops.pairhmm.convert import context_tables, quals_to_torch
    from acc_genomics_tpu_torch.ops.pairhmm.pack import pack_pairhmm_quals
    from acc_genomics_tpu_torch.tools.bench_shapes import (
        capture_calls,
        flat_matrix_args,
        pairhmm_bench_groups,
        pairhmm_engine_batches,
    )

    built = old_library(old_dir, "pairhmm_forward", ["pairhmm_common.cuh"])
    fn = built.lib.pairhmm_forward_quals
    fn.argtypes = [_P] * 10 + [ctypes.c_float, _I, _I, _I, _I, _P, _P]
    fn.restype = ctypes.c_int
    new_built = K.build_kernels()
    new_fn = new_built.lib.pairhmm_forward_quals
    regs = print_ptxas("pairhmm_forward", built, new_built)
    ctx = PairHMMContext(np.float32)
    ph2pr, m2m, _ = context_tables(ctx, dev)
    ic = float(ctx.initial_constant)
    bench = [(list(quals_to_torch(pack_pairhmm_quals(g, rows=rows, cols=384,
                                                     sort_by_haplen=True), dev))
              + [ph2pr, m2m, ic], {"expand": "arith"})
             for rows, g in pairhmm_bench_groups().items()]
    calls = []
    with capture_calls(engine_module, "pairhmm_forward_from_quals", calls):
        PairHMMEngine(device=dev).compute_matrix_flat(
            *flat_matrix_args(*pairhmm_engine_batches(1)[0]))
    sig = inspect.signature(K.pairhmm_forward_from_quals)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    tiny = float(np.finfo(np.float32).tiny) * 2.0**-10
    out = {"ptxas": regs}
    for name, launches in (("bench", bench), ("engine", calls)):
        prepared = []
        for args, kw in launches:
            a = sig.bind(*args, **kw)
            a.apply_defaults()
            v = a.arguments
            res = torch.empty(v["rs"].shape[1], dtype=torch.float32, device=dev)
            prepared.append((args, kw, v, res))

        def with_lib(f):
            def go():
                for _, _, v, res in prepared:
                    rows, bsz = v["rs"].shape
                    gather = v["expand"] == "gather"
                    err = f(*(_ptr(v[k]) for k in ("q", "i", "d", "c", "rs", "hap_ext",
                                                   "rslen", "haplen")),
                            _ptr(v["ph2pr"]) if gather else None,
                            _ptr(v["m2m"]) if gather else None,
                            ctypes.c_float(float(v["initial_constant"])), int(gather), rows,
                            v["hap_ext"].shape[0] - rows, bsz, _ptr(res), stream)
                    if err:
                        raise RuntimeError(f"PairHMM kernel: error {err}")
            return go

        with_lib(fn)()
        old_res = [res.clone() for _, _, _, res in prepared]
        with_lib(new_fn)()
        # the wrapper's result against the old library's
        got = [K.pairhmm_forward_from_quals(*args, **kw) for args, kw, _, _ in prepared]
        torch.cuda.synchronize()
        for o, (_, _, _, res) in zip(old_res, prepared):
            if not torch.equal(o.view(torch.int32), res.view(torch.int32)):
                raise AssertionError(f"pairhmm, {name}: old and new builds differ")
        for g, o in zip(got, old_res):
            torch.testing.assert_close(g, o, rtol=1e-5, atol=tiny)
        shapes = sorted({(tuple(v["rs"].shape), v["hap_ext"].shape[0] - v["rs"].shape[0])
                         for _, _, v, _ in prepared})
        out[name] = {"launches": len(prepared), "shapes": shapes,
                     **in_turns(with_lib(fn), with_lib(new_fn))}
        print(f"pairhmm, {name}: {out[name]}", flush=True)
    return out


def middle_supersteps(dev, Cs):
    """(C, the recorded arguments of ``pairhmm_band_superstep``) of the
    middle superstep of chip_smoke.py phase 15's SP pipeline at each C."""
    import acc_genomics_tpu_torch.engine.pairhmm_engine as engine_module
    import acc_genomics_tpu_torch.parallel.sharded as sharded_module
    from acc_genomics_tpu_torch.engine.pairhmm_engine import PairHMMEngine
    from acc_genomics_tpu_torch.io.synth import gen_pairhmm_input
    from acc_genomics_tpu_torch.parallel import make_mesh, pairhmm_forward_dpsp_from_quals
    from acc_genomics_tpu_torch.tools.bench_shapes import capture_calls, flat_matrix_args

    mesh = make_mesh((1, 4), devices=[dev] * 4)
    reads, haps = gen_pairhmm_input(np.random.default_rng(13), 256, 8, max_read_len=250,
                                    max_hap_len=4096, derived=True)
    sp_calls = []
    with capture_calls(engine_module, "pairhmm_forward_dpsp_from_quals", sp_calls):
        PairHMMEngine(device=dev, mesh=mesh).compute_matrix_flat(*flat_matrix_args(reads, haps))
    (_, *sp_args), sp_kw = sp_calls[0]
    for C in Cs:
        mid = (sp_args[0].shape[0] // C + 3) // 2
        calls = []
        with capture_calls(sharded_module, "pairhmm_band_superstep", calls, keep=(mid,)):
            pairhmm_forward_dpsp_from_quals(mesh, *sp_args, **dict(sp_kw, C=C))
        yield C, calls[0][0]


def band_superstep_ab(old_dir: str, dev) -> dict:
    """The middle superstep of phase 15's SP pipeline at C = 8, 16 and 32
    through the same wrapper on both builds of ``pairhmm_band_superstep``:
    every output (the next top row, the edge columns, the results) bit for
    bit."""
    from acc_genomics_tpu_torch.ops.pairhmm import band_kernel as BK

    built = old_library(old_dir, "pairhmm_band", ["pairhmm_common.cuh"])
    new_built = BK.build_kernels()
    fn = built.lib.pairhmm_band_superstep
    fn.argtypes = new_built.lib.pairhmm_band_superstep.argtypes
    fn.restype = ctypes.c_int
    regs = print_ptxas("pairhmm_band", built, new_built)
    real = BK.build_kernels
    out = {"ptxas": regs}
    try:
        for C, args in middle_supersteps(dev, (8, 16, 32)):
            state = {}
            for which, lib in (("old", built), ("new", new_built)):
                run = [x.clone() if isinstance(x, torch.Tensor) else x for x in args]
                BK.build_kernels = lambda lib=lib: lib
                BK.pairhmm_band_superstep(*run)
                state[which] = run[5:8]
            torch.cuda.synchronize()
            # bits, not values: unwritten scratch may hold NaN patterns
            if not all(torch.equal(o.view(torch.int32), n.view(torch.int32))
                       for o, n in zip(state["old"], state["new"])):
                raise AssertionError(f"band superstep, C {C}: old and new builds differ")

            def with_lib(lib):
                def go():
                    BK.build_kernels = lambda: lib
                    BK.pairhmm_band_superstep(*args)
                return go

            out[f"C{C}"] = in_turns(with_lib(built), with_lib(new_built))
            print(f"band superstep, C {C}: outputs equal bit for bit; {out[f'C{C}']}",
                  flush=True)
    finally:
        BK.build_kernels = real
    return out


def pairhmm_gather_ab(old_dir: str, dev) -> dict:
    """The gather's card time (CUDA events) beside the native host pack's
    (host clock), median of 7 each, at each HC cell's batch shape."""
    import time

    from acc_genomics_tpu_torch.config import engine_config_from_dict
    from acc_genomics_tpu_torch.engine.pairhmm_engine import PairHMMEngine
    from acc_genomics_tpu_torch.ops.pairhmm import gather as G
    from acc_genomics_tpu_torch.tools.bench_shapes import hc_flat_batch, native_planes
    # the HC cells' configurations and region generator, from the
    # benchmark harness beside the package (run from the checkout's root)
    from port_bench.gen.regions import make_regions
    from port_bench.manifest import Manifest

    regs = {"new": ptxas(G.build_kernels())}
    for entry, line in regs["new"].items():
        print(f"  ptxas pairhmm_gather: {entry}: {line}", flush=True)
    out = {"ptxas": regs}
    for name in ("gatk_hc_wgs30x", "gatk_hc_hifi28x"):
        conf = Manifest().config(name)
        args, kw = hc_flat_batch(make_regions(np.random.default_rng(0), conf, 32))
        eng = PairHMMEngine(engine_config_from_dict(conf["engine"]).pairhmm, device=dev)
        seen = []
        real = eng._launch_gathered
        eng._launch_gathered = lambda s, g: seen.append((s, g)) or real(s, g)
        eng.compute_pairs_flat(*args, **kw)
        (streams, groups), = seen
        rs, q, i, d, c, offs, lens, hap, hoffs, hlens = streams
        planes = (q, i, d, c, rs, hap)
        sels = [sel for sel, _, _ in groups]
        layout = G.GatherLayout.plan([(rows, cols, len(sel)) for sel, rows, cols in groups],
                                     [len(p) for p in planes])
        staged = torch.empty(layout.nbytes, dtype=torch.uint8, pin_memory=True)
        layout.fill(staged.numpy(), planes, offs, lens, hoffs, hlens, sels)
        up = staged.to(dev)
        got = G.pairhmm_gather(up, layout)
        batch = (planes, offs, lens, hoffs, hlens, groups)
        if not np.array_equal(got.cpu().numpy(), native_planes(*batch)):
            raise AssertionError(f"pairhmm_gather, {name}: card and host planes differ")

        def host_pack():
            for sel, rows, cols in groups:
                native.pairhmm_pack_quals_flat(
                    rs, q, i, d, c, offs[sel], lens[sel], hap, hoffs[sel], hlens[sel],
                    rows, cols, HAP_PAD)

        host = []
        for _ in range(8):
            t0 = time.perf_counter()
            host_pack()
            host.append(1e3 * (time.perf_counter() - t0))
        out[name] = {"pairs": int(layout.lanes), "buckets": len(groups),
                     "shapes": sorted({(rows, cols) for _, rows, cols in groups}),
                     "card_ms": cuda_ms(lambda: G.pairhmm_gather(up, layout)),
                     "host_pack_ms": statistics.median(host[1:]),
                     "upload_bytes": layout.nbytes, "planes_bytes": layout.planes_bytes}
        print(f"pairhmm_gather, {name}: {out[name]}", flush=True)
    return out


ABS = {"extend": extend_ab, "pairhmm": pairhmm_ab, "band_superstep": band_superstep_ab,
       "sw_fill": sw_fill_ab, "sw_walk": sw_walk_ab, "fused": fused_ab, "smem": smem_ab,
       "pairhmm_gather": pairhmm_gather_ab}


def main(argv) -> int:
    names = argv[1:] or list(ABS)
    if not argv or not set(names) <= set(ABS) or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    result = {"card": card, **{name: ABS[name](argv[0], dev) for name in names}}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
