"""Ablation of the SW walk kernel: what its time rests on, on one card.

    python -m acc_genomics_tpu_torch.tools.sw_walk_ablation

Builds variants of ``ops/sw/csrc/sw_walk.cu`` into the build directory,
each with one part taken out or changed, and times each through its C
entry point with CUDA events (median of 7) on the same fill outputs
(strategy 0): the SW bench batch's two 4,096-pair chunks (320 x 320),
the 4,096 gap-heavy pairs of ``sw_walk_batches`` and the 3 pairs of the
1536-row bucket of ``sw_fill_batches`` (three warps: latency alone).
The "no ..." and "... only" variants compute wrong walks: they are
timed, not checked.
The others compute the same walk another way and are held to the
kernel's outputs bit for bit.  Prints the card, then one line a variant
with its times and its registers (ptxas).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import subprocess
import sys

import torch

from acc_genomics_tpu_torch import build

CSRC = os.path.join(build.PACKAGE_DIR, "ops", "sw", "csrc")
# the lane count a round reads, cut to n: lanes past it count as the stop,
# and a stop with no gap code is no step
_ROUND = lambda n: [
    ("    const bool inside = i > 0 && j > 0;",
     f"    const bool inside = lane < {n} && i > 0 && j > 0;"),
    ("    if (run < 32 && p1 > 0 && p2 > 0) {", "    if (run < 32 && gap != 0 && p1 > 0 && p2 > 0) {")]
# name -> (old text, new text) substitutions in the kernel's source
VARIANTS = {
    "as is (32 cells a round, 2 warps a block)": [],
    "4 warps a block": [("constexpr int kWarpsPerBlock = 2;", "constexpr int kWarpsPerBlock = 4;")],
    "8 warps a block": [("constexpr int kWarpsPerBlock = 2;", "constexpr int kWarpsPerBlock = 8;")],
    "16 cells a round": _ROUND(16),
    "8 cells a round": _ROUND(8),
    "one cell a round": _ROUND(1),
    # the walk from the corner, as INDEL starts
    "no start-cell scans": [("  if (strategy != kIndel) {", "  if (false) {")],
    "start cell only (no walk)": [
        ("  bool active = p1 > 0 && p2 > 0 && rl > 0 && al > 0;", "  bool active = false;")],
    # 8 cells a round after a gap, twice as many after each full run
    "8 cells a round, doubling to 32 over a run": [
        ("  int state = kMatch;\n", "  int state = kMatch, width = 8;\n"),
        ("    const bool inside = i > 0 && j > 0;",
         "    const bool inside = lane < width && i > 0 && j > 0;"),
        ("    if (run < 32 && p1 > 0 && p2 > 0) {", "    if (run < width && p1 > 0 && p2 > 0) {"),
        ("    active = p1 > 0 && p2 > 0;\n  }",
         "    width = run == width ? min(2 * width, 32) : 8;\n    active = p1 > 0 && p2 > 0;\n  }")],
    # last: the limit holds for the rest of the process
    "L2 fetch granularity 32 B": [
        ("  if (batch == 0) return 0;",
         "  if (batch == 0) return 0;\n  cudaDeviceSetLimit(cudaLimitMaxL2FetchGranularity, 32);")],
}
EXACT = ("4 warps a block", "8 warps a block", "16 cells a round", "8 cells a round",
         "one cell a round", "8 cells a round, doubling to 32 over a run",
         "L2 fetch granularity 32 B")


def build_variant(k: int, name: str):
    src = open(os.path.join(CSRC, "sw_walk.cu")).read()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"variant {name!r}: the kernel no longer has {old!r}")
        src = src.replace(old, new)
    work = os.path.join(build.BUILD_DIR, "sw_walk_ablation")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, f"sw_walk_{k}.cu")
    with open(path, "w") as f:
        f.write(src)
    built = build.load_library(f"sw_walk_ablation_{k}", [os.path.relpath(path, build.PACKAGE_DIR)])
    fn = built.lib.sw_walk
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    regs = sorted({line.split(":", 1)[1].strip() for line in built.log.splitlines()
                   if "registers" in line})
    return fn, regs


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    from acc_genomics_tpu_torch.ops.sw import kernel as SK
    from acc_genomics_tpu_torch.tools.bench_shapes import (
        WALK_GAP_PAIRS,
        sw_bench_chunks,
        sw_fill_batches,
        sw_walk_batches,
    )
    from acc_genomics_tpu_torch.tools.kernel_ab import cuda_ms

    dev = torch.device("cuda", 0)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    cases = {"bench": sw_bench_chunks(dev)[2],
             "gap-heavy": [b[1:] for b in sw_walk_batches(dev)
                           if b[1].shape[0] == WALK_GAP_PAIRS],
             "1536 bucket": [b[1:] for b in sw_fill_batches(dev) if b[1].shape[1] == 1536]}
    fills = {name: [(SK.sw_fill(r, a, rl, al, 0), rl, al) for r, a, rl, al in batch]
             for name, batch in cases.items()}
    outs = {name: [torch.zeros((SK.SHIP_ELEMS + 2, f[0][0].shape[0]), dtype=torch.int16,
                               device=dev) for f in fs] for name, fs in fills.items()}

    def walk(fn, name):
        for ((bt, lr, ac), rl, al), o in zip(fills[name], outs[name]):
            rows = bt.shape[2]
            err = fn(ptr(bt), ptr(lr), ptr(ac), ptr(rl), ptr(al), rows, bt.shape[1] - rows + 1,
                     bt.shape[0], 0, ptr(o), stream)
            if err:
                raise RuntimeError(f"launch failed with error {err}")

    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(lambda kv: build_variant(*kv), enumerate(VARIANTS)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.splitlines()[0],
          flush=True)
    want = None
    for name, (fn, regs) in zip(VARIANTS, built):
        times = {case: cuda_ms(lambda: walk(fn, case)) for case in fills}
        check = ""
        if want is None or name in EXACT:
            got = []
            for case in fills:
                for o in outs[case]:
                    o.zero_()
                walk(fn, case)
                got += [o.clone() for o in outs[case]]
            if want is None:  # the kernel as it is
                want = got
            elif not all(torch.equal(a, b) for a, b in zip(want, got)):
                raise AssertionError(f"variant {name!r}: the walk differs from the kernel's")
            else:
                check = "; outputs equal bit for bit"
        print(f"{name}: " + " ".join(f"{case} {ms:.4f} ms" for case, ms in times.items())
              + f"; {regs}{check}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
