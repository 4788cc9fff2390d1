"""Ablation of the band kernel: which of a step's operations its time
rests on, on one card.

    python -m acc_genomics_tpu_torch.tools.band_ablation

Builds variants of ``ops/pairhmm/csrc/pairhmm_band.cu`` into the build
directory, each with one operation of the step taken out or changed (the
results of most are wrong: they are timed, not checked), and times each
with CUDA events (median of 7) on one superstep of the main path's shape:
4 slots x 2,048 lanes, hc 1024, 256 rows, byte planes ("arith"), every
shard active, at C = 8, 16 and 32.  Prints one line a variant with its
times and its registers and shared memory (ptxas).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import shutil
import statistics
import subprocess
import sys

import torch

from acc_genomics_tpu_torch import build

CSRC = os.path.join(build.PACKAGE_DIR, "ops", "pairhmm", "csrc")
# name -> (old text, new text) substitutions in the kernel's source
VARIANTS = {
    "as is": [],
    "mask rows padded by C words (banks)": [
        ("__shared__ uint32_t hmask[P][kRing];", "__shared__ uint32_t hmask[P][kRing + C];")],
    "no match-mask load": [
        ("const uint32_t hd = my_mask[j & (kRing - 1)];", "const uint32_t hd = 1u;")],
    "no top-row load (row 0)": [
        ("const float4 e = my_ring[t & (kRing - 1)];",
         "const float4 e = make_float4(0.5f, 0.25f, 0.75f, 0.0f);")],
    "no bottom-row staging store": [
        ("if (bottom_lane && (!EDGE || jb >= 0)) my_stage[jb & (2 * C - 1)] = "
         "make_float4(m, x, sxy, 0.0f);", "")],
    "no shuffles": [
        ("float up_m = __shfl_up_sync(kFull, m1, 1, C);\n"
         "    float up_x = __shfl_up_sync(kFull, x1, 1, C);\n"
         "    float up_s = __shfl_up_sync(kFull, s1, 1, C);",
         "float up_m = m1 * 0.5f;\n    float up_x = x1 * 0.5f;\n    float up_s = s1 * 0.5f;")],
}


def build_variant(k: int, name: str):
    src = open(os.path.join(CSRC, "pairhmm_band.cu")).read()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"variant {name!r}: the kernel no longer has {old!r}")
        src = src.replace(old, new)
    work = os.path.join(build.BUILD_DIR, "band_ablation")
    os.makedirs(work, exist_ok=True)
    shutil.copy(os.path.join(CSRC, "pairhmm_common.cuh"), work)
    path = os.path.join(work, f"band_{k}.cu")
    with open(path, "w") as f:
        f.write(src)
    built = build.load_library(f"band_ablation_{k}", [os.path.relpath(path, build.PACKAGE_DIR)],
                               [os.path.relpath(os.path.join(work, "pairhmm_common.cuh"),
                                                build.PACKAGE_DIR)])
    fn = built.lib.pairhmm_band_superstep
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [I, I, P] + [P] * 6 + [ctypes.c_float] + [P] * 5 + [I] * 11 + [P]
    fn.restype = I
    regs = sorted({line.split(":", 1)[1].strip() for line in built.log.splitlines()
                   if "registers" in line})
    return fn, regs


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    S, bd, hc, rows = 4, 2048, 1024, 256
    cols = 4 * hc
    g = torch.Generator().manual_seed(0)
    u8 = lambda lo, hi: torch.randint(lo, hi, (rows, bd), generator=g, dtype=torch.uint8).to(dev)
    q, i, d, rs = u8(10, 40), u8(30, 45), u8(30, 45), u8(0, 4)
    c = torch.full((rows, bd), 10, dtype=torch.uint8, device=dev)
    rslen = torch.full((bd,), rows - 6, dtype=torch.int32, device=dev)
    haplen = torch.full((bd,), cols - 200, dtype=torch.int32, device=dev)
    hap = torch.randint(0, 4, (bd, cols), generator=g, dtype=torch.uint8).to(dev)
    slots = torch.tensor([[k, 0, k - 1] for k in range(S)], dtype=torch.int32, device=dev)
    tops = torch.rand((2, 3, S, bd, hc), generator=g).to(dev) * 1e-3
    edges = torch.rand((3, S, bd, rows + 1), generator=g).to(dev) * 1e-3
    res = torch.zeros((S, bd), device=dev)
    planes = ctypes.cast((ctypes.c_void_p * 8)(q.data_ptr(), i.data_ptr(), d.data_ptr(),
                                               c.data_ptr(), None, None, None, None),
                         ctypes.c_void_p)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else None)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    def superstep(fn, C):
        t = S - 1 + (rows // C) // 2  # every shard active, a middle chunk
        err = fn(1, C, planes, ptr(rs), ptr(None), ptr(rslen), ptr(haplen), ptr(None),
                 ptr(None), ctypes.c_float(1e30), ptr(hap), ptr(slots), ptr(tops), ptr(edges),
                 ptr(res), S, S, 0, S, t, rows, cols, hc, bd, bd, rows // C, stream)
        if err:
            raise RuntimeError(f"launch failed with error {err}")

    def cuda_ms(f, repeats=7):
        f()
        torch.cuda.synchronize()
        times = []
        for _ in range(repeats):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            f()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(lambda kv: build_variant(*kv), enumerate(VARIANTS)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.splitlines()[0],
          flush=True)
    for name, (fn, regs) in zip(VARIANTS, built):
        times = {C: cuda_ms(lambda: superstep(fn, C)) for C in (8, 16, 32)}
        print(f"{name}: " + " ".join(f"C {C} {ms:.4f} ms" for C, ms in times.items())
              + f"; {regs}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
