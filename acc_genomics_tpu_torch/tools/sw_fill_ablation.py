"""Ablation of the SW fill kernel: what its time rests on, on one card.

    python -m acc_genomics_tpu_torch.tools.sw_fill_ablation

Builds variants of ``ops/sw/csrc/sw_fill.cu`` into the build directory,
each with one part of a step taken out or changed, and times each through
its C entry point with CUDA events (median of 7) on the first 528, 1,056,
2,112 and 4,096 pairs of the SW bench batch's first chunk (320 x 320):
one to 7.8 warps a scheduler of the 132 SMs.  The "no ..." and "every
step unchecked" variants compute wrong fills: they are timed, not
checked.  The others compute the same fill another way and are held to
the kernel's outputs bit for bit on the 4,096 pairs.  Prints the card,
then one line a variant with its times and its registers (ptxas).
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
PAIRS = (528, 1056, 2112, 4096)
# the variants that compute the same fill: their outputs are held to the
# kernel's bit for bit on the 4,096 pairs
EXACT = ("one row a lane", "four rows a lane", "alt codes from a shared copy")
# name -> (old text, new text) substitutions in the kernel's source
VARIANTS = {
    "as is (two rows a lane)": [],
    "one row a lane": [("constexpr int R = 2;", "constexpr int R = 1;")],
    "four rows a lane": [("constexpr int R = 2;", "constexpr int R = 4;")],
    # the other way to hand the alt codes out: each lane reads its
    # column's code from a shared copy, and gsv travels alone
    "alt codes from a shared copy": [
        ("  return (cols + kChunk) * (int)(sizeof(int2) + sizeof(uint32_t));",
         "  return (cols + kChunk) * (int)(sizeof(int2) + sizeof(uint32_t)) + cols + 2 * kChunk;"),
        ("  uint32_t* const above_ga = (uint32_t*)(above + cols + kChunk);",
         "  uint32_t* const above_ga = (uint32_t*)(above + cols + kChunk);\n"
         "  uint8_t* const s_alt = (uint8_t*)(above_ga + cols + kChunk) + kChunk;"),
        ("    above_ga[j] = (uint32_t)alt[(int64_t)b * cols + j] << 16;",
         "    above_ga[j] = 0;\n    s_alt[j] = alt[(int64_t)b * cols + j];"),
        ("        const int alt_j = (int)(ga >> 16);", "        const int alt_j = s_alt[j];"),
        ("        const int32_t gsv = ext_v ? (int32_t)(ga & 0xffffu) + 1 : 1;",
         "        const int32_t gsv = ext_v ? (int32_t)ga + 1 : 1;"),
        ("        ga1[r] = ((uint32_t)alt_j << 16) | ((uint32_t)gsv & 0xffffu);",
         "        ga1[r] = (uint32_t)gsv;")],
    "no btrack store (interior)": [
        ("      if (INTERIOR) {  // both rows' codes in one store where aligned",
         "      if (INTERIOR && code[0] == 12345) {")],
    "no shuffles (interior)": [
        ("      int32_t up0 = __shfl_up_sync(kFull, sw1[R - 1], 1);\n"
         "      int32_t bgv0 = __shfl_up_sync(kFull, bgv1[R - 1], 1);\n"
         "      uint32_t ga0 = __shfl_up_sync(kFull, ga1[R - 1], 1);",
         "      int32_t up0 = INTERIOR ? sw1[R - 1] + 1 : __shfl_up_sync(kFull, sw1[R - 1], 1);\n"
         "      int32_t bgv0 = INTERIOR ? bgv1[R - 1] - 1 : __shfl_up_sync(kFull, bgv1[R - 1], 1);\n"
         "      uint32_t ga0 = INTERIOR ? ga1[R - 1] ^ 1 : __shfl_up_sync(kFull, ga1[R - 1], 1);")],
    "no shared-buffer traffic (interior)": [
        ("      if (li == 0) {\n        up0 = top.x;", "      if (!INTERIOR && li == 0) {\n        up0 = top.x;"),
        ("      if (is_bottom) {", "      if (!INTERIOR && is_bottom) {")],
    # the last-row and buffer stores keep their tests, so no store leaves
    # the pair's rows
    "every step unchecked": [
        ("    for (; s < min(kChunk, steps); ++s) step(std::false_type{}, s);",
         "    for (; s < min(kChunk, steps); ++s) step(std::true_type{}, s);"),
        ("    for (; s < steps; ++s) step(std::false_type{}, s);",
         "    for (; s < steps; ++s) step(std::true_type{}, s);"),
        ("if (INTERIOR || (j >= 0 && j < al)) last_row[j]", "if (j >= 0 && j < al) last_row[j]"),
        ("        if (INTERIOR || (j >= 0 && j < al)) {\n          above[j]",
         "        if (j >= 0 && j < al) {\n          above[j]")],
}


def build_variant(k: int, name: str):
    src = open(os.path.join(CSRC, "sw_fill.cu")).read()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"variant {name!r}: the kernel no longer has {old!r}")
        src = src.replace(old, new)
    work = os.path.join(build.BUILD_DIR, "sw_fill_ablation")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, f"sw_fill_{k}.cu")
    with open(path, "w") as f:
        f.write(src)
    built = build.load_library(f"sw_fill_ablation_{k}", [os.path.relpath(path, build.PACKAGE_DIR)])
    fn = built.lib.sw_fill
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    regs = sorted({line.split(":", 1)[1].strip() for line in built.log.splitlines()
                   if "registers" in line})
    return fn, regs


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    from acc_genomics_tpu_torch.ops.sw.reference import DEFAULT_SW_PARAMS
    from acc_genomics_tpu_torch.tools.bench_shapes import sw_bench_chunks
    from acc_genomics_tpu_torch.tools.kernel_ab import cuda_ms

    dev = torch.device("cuda", 0)
    ref, alt, rl, al = sw_bench_chunks(dev)[2][0]
    rows, cols = ref.shape[1], alt.shape[1]
    n = max(PAIRS)
    btrack = torch.zeros((n, rows + cols - 1, rows), dtype=torch.int16, device=dev)
    lastrow = torch.zeros((n, cols), dtype=torch.int32, device=dev)
    altcol = torch.zeros((n, rows), dtype=torch.int32, device=dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    weights = [int(x) for x in DEFAULT_SW_PARAMS]

    def fill(fn, pairs):
        err = fn(ptr(ref), ptr(alt), ptr(rl), ptr(al), rows, cols, pairs, 0, *weights,
                 ptr(btrack), ptr(lastrow), ptr(altcol), stream)
        if err:
            raise RuntimeError(f"launch failed with error {err}")

    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(lambda kv: build_variant(*kv), enumerate(VARIANTS)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.splitlines()[0],
          flush=True)
    want = None
    for name, (fn, regs) in zip(VARIANTS, built):
        times = {p: cuda_ms(lambda: fill(fn, p)) for p in PAIRS}
        check = ""
        if want is None or name in EXACT:
            for t in (btrack, lastrow, altcol):
                t.zero_()
            fill(fn, n)
            if want is None:  # the kernel as it is
                want = [t.clone() for t in (btrack, lastrow, altcol)]
            elif not all(torch.equal(a, b) for a, b in zip(want, (btrack, lastrow, altcol))):
                raise AssertionError(f"variant {name!r}: the fill differs from the kernel's")
            else:
                check = "; outputs equal bit for bit"
        print(f"{name}: " + " ".join(f"{p} pairs {ms:.4f} ms" for p, ms in times.items())
              + f"; {regs}{check}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
