"""Old against new: an earlier commit's band and SMEM kernels and this
checkout's, timed in turns on one card at the same inputs.

    python -m acc_genomics_tpu_torch.tools.kernel_ab OLD_DIR

OLD_DIR holds the earlier commit's ``pairhmm_band.cu`` and
``smem_collect.cu`` (``git show <commit>:<path>`` of
``acc_genomics_tpu_torch/ops/{pairhmm,smem}/csrc/``), with the C
interfaces of the kernels before their redesign (``pairhmm_band_chunk``
on one chunk in the JAX layout; ``smem_collect`` without a read queue).
They are built with the package's nvcc flags into its build directory.  The inputs are
chip_smoke.py's: the band kernel on the middle superstep of phase 15's SP
pipeline at C = 8 and 32 (the old kernel on the same chunks, cut by
``superstep_chunks``), the SMEM kernel on phase 12's 65,536 reads and
phase 14's 2,048 over the 100 Mbp index.  Each pair runs old, new, new,
old (CUDA events, median of 7 each); the outputs must agree (SMEM bit for
bit, band within rtol 1e-5).  The last line of standard output is one
JSON object with every time.
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

from acc_genomics_tpu_torch import build

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


def old_library(old_dir: str, name: str):
    path = os.path.relpath(os.path.join(old_dir, f"{name}.cu"), build.PACKAGE_DIR)
    return build.load_library(f"{name}_old", [path])


def band_ab(old_dir: str, dev) -> dict:
    """The middle superstep of phase 15's SP pipeline, at C = 8 and 32."""
    import acc_genomics_tpu_torch.engine.pairhmm_engine as engine_module
    import acc_genomics_tpu_torch.parallel.sharded as sharded_module
    from acc_genomics_tpu_torch.engine.pairhmm_engine import PairHMMEngine
    from acc_genomics_tpu_torch.io.synth import gen_pairhmm_input
    from acc_genomics_tpu_torch.ops.pairhmm import band_kernel as BK
    from acc_genomics_tpu_torch.parallel import make_mesh, pairhmm_forward_dpsp_from_quals

    built = old_library(old_dir, "pairhmm_band")
    fn = built.lib.pairhmm_band_chunk
    fn.argtypes = [_P] * 15 + [_I] * 4 + [_P]
    fn.restype = ctypes.c_int
    mesh = make_mesh((1, 4), devices=[dev] * 4)
    reads, haps = gen_pairhmm_input(np.random.default_rng(13), 256, 8, max_read_len=250,
                                    max_hap_len=4096, derived=True)
    cat = lambda key: np.concatenate([np.asarray(r[key], np.uint8) for r in reads])
    flat = (cat("rs"), cat("q"), cat("i"), cat("d"), cat("c"),
            np.array([len(r["rs"]) for r in reads], np.int32),
            np.concatenate([np.asarray(h, np.uint8) for h in haps]),
            np.array([len(h) for h in haps], np.int32))
    sp_calls, out = [], {}
    real = engine_module.pairhmm_forward_dpsp_from_quals
    engine_module.pairhmm_forward_dpsp_from_quals = (
        lambda *a, **kw: (sp_calls.append((a, kw)), real(*a, **kw))[1])
    try:
        PairHMMEngine(device=dev, mesh=mesh).compute_matrix_flat(*flat)
    finally:
        engine_module.pairhmm_forward_dpsp_from_quals = real
    (_, *sp_args), sp_kw = sp_calls[0]
    for C in (8, 32):
        rows = sp_args[0].shape[0]
        mid = (rows // C + 3) // 2
        calls = []
        real_step = sharded_module.pairhmm_band_superstep

        def record(*a):
            if len(calls) == 0 and a[8] == mid:
                calls.append([x.clone() if isinstance(x, torch.Tensor) else x for x in a])
            return real_step(*a)

        sharded_module.pairhmm_band_superstep = record
        try:
            pairhmm_forward_dpsp_from_quals(mesh, *sp_args, **dict(sp_kw, C=C))
        finally:
            sharded_module.pairhmm_band_superstep = real_step
        args = calls[0]
        front, planes, tables, hap, slots, tops, edges, res, t, a, n, _, _ = args
        chunks = [x.contiguous() for x in BK.superstep_chunks(
            front, planes, tables, hap, slots, tops, edges, t, a, n, C)]
        S, _, _, lanes = chunks[0].shape
        hc = chunks[2].shape[1]
        bot = torch.empty((3, S, hc, lanes), dtype=torch.float32, device=dev)
        redge = torch.empty((3, S, C, lanes), dtype=torch.float32, device=dev)
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

        def old():
            err = fn(*(_ptr(x) for x in chunks), *(_ptr(o) for o in (*bot, *redge)),
                     S, C, hc, lanes, stream)
            if err:
                raise RuntimeError(f"old band kernel: error {err}")

        def new():
            BK.pairhmm_band_superstep(*args)

        old()
        new()
        torch.cuda.synchronize()
        got = args[5][1 - t % 2, :, a:a + n].transpose(-1, -2)
        scale = float(bot.abs().max())
        torch.testing.assert_close(got, bot, rtol=1e-5, atol=1e-5 * scale)
        out[f"C{C}"] = {"slots": S, "lanes": lanes, "hc": hc, **in_turns(old, new)}
        print(f"band, middle superstep, C {C} ({S} slots x {lanes} lanes, hc {hc}): "
              f"{out[f'C{C}']}", flush=True)
    return out


def smem_ab(old_dir: str, dev) -> dict:
    """Phase 12's 65,536 reads and phase 14's 2,048 over the 100 Mbp index."""
    from acc_genomics_tpu_torch.build import ensure_native
    from acc_genomics_tpu_torch.config import SmemConfig
    from acc_genomics_tpu_torch.io.synth import gen_reference_with_repeats, gen_smem_reads
    from acc_genomics_tpu_torch.ops.smem import kernel as MK
    from acc_genomics_tpu_torch.ops.smem.index import FMIndex
    from acc_genomics_tpu_torch.ops.smem.table import DeviceIndex

    built = old_library(old_dir, "smem_collect")
    fn = built.lib.smem_collect
    fn.argtypes = [_P] + [_I] * 6 + [_P] * 2 + [_I] * 8 + [_P] * 5
    fn.restype = ctypes.c_int
    ensure_native()
    rng = np.random.default_rng(0)
    genome = gen_reference_with_repeats(rng, 100_000_000)
    fm = FMIndex.build(genome)
    batches = {"65536": gen_smem_reads(rng, genome, 65536, read_len=101)}
    batches["2048"] = gen_smem_reads(rng, genome, 2048, read_len=101)
    idx = DeviceIndex.build(fm, dev)
    params = SmemConfig().params()
    chain_cap, mem_cap = MK.caps(params)
    out = {}
    for name, reads in batches.items():
        seq = np.full((128, len(reads)), 4, np.uint8)
        for k, r in enumerate(reads):
            seq[: len(r), k] = r
        lens = torch.tensor([len(r) for r in reads], dtype=torch.int32, device=dev)
        seq = torch.from_numpy(seq).to(dev)
        B = len(reads)
        mem = torch.zeros((5, mem_cap, B), dtype=torch.int32, device=dev)
        counts = torch.zeros((3, B), dtype=torch.int32, device=dev)
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

        def old():
            mem.zero_()
            err = fn(_ptr(idx.tbl), idx.primary, *idx.l2_values, _ptr(seq), _ptr(lens), 128, B,
                     params.min_seed_len, params.split_len, params.split_width,
                     params.max_mem_intv, chain_cap, mem_cap, _ptr(mem), _ptr(counts[0]),
                     _ptr(counts[1]), _ptr(counts[2]), stream)
            if err:
                raise RuntimeError(f"old smem kernel: error {err}")

        def new():
            return MK.smem_collect(idx, seq, lens, params)

        old()
        got = new()
        torch.cuda.synchronize()
        if not (torch.equal(got[0], mem) and torch.equal(torch.stack(got[1:]), counts)):
            raise AssertionError(f"smem, {name} reads: old and new kernels differ")
        out[name] = in_turns(old, new)
        print(f"smem, {name} reads: {out[name]}", flush=True)
    return out


def main(argv) -> int:
    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    result = {"card": card, "band": band_ab(argv[0], dev), "smem": smem_ab(argv[0], dev)}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
