"""acc_genomics_tpu_torch — the PyTorch/CUDA port of acc_genomics_tpu.

It runs on an NVIDIA Hopper card (H100, ``sm_90a``).  Every kernel that
the JAX package wrote in Pallas becomes a CUDA C++ kernel written by hand
(``ops/*/csrc``), built with nvcc at first use (``build.py``) and bound
with ctypes.  Beside each kernel sits a plain PyTorch version of the same
function: a CPU tensor runs it, a CUDA tensor launches the kernel.

The port imports the JAX package's framework-free modules (configs,
quality tables, packers, oracles, the native host runtime, synthetic
generators and corpus IO), all through ``shared.py``, and never imports
jax.

Layout:
  shared.py        the JAX package's framework-free modules the port uses
  device.py        explicit device resolution (cuda raises without a card)
  build.py         nvcc build of csrc/*.cu into _build/, ctypes loading;
                   the locked build of the native host library
  ops/pairhmm/     forward kernel wrappers + plain twins, state conversion
  ops/sw/          SW fill and walk kernel wrappers + plain twins, decode,
                   one-bucket launch
  ops/extend/      banded seed-extension kernel wrapper + plain twin
  ops/smem/        SMEM kernel wrapper + plain twin, the FM-index probe
                   table (DeviceIndex)
  engine/          bucketing, PairHMMEngine (pack -> kernel -> epilogue),
                   SWEngine (bucket -> fill + walk -> one fetch -> decode),
                   ExtendEngine (left launches -> right launches with h0
                   from the left scores on the card -> one fetch ->
                   clip resolution), SmemEngine (resident probe table ->
                   batches -> counts fetch -> live-interval fetch), the
                   time-major packer
  models/          HaplotypeCallerCore on SW + PairHMM; BwaMemSeeding on
                   SMEM + extension
  io/synth.py      synthetic active regions (gen_region)
"""

__version__ = "0.1.0"

from acc_genomics_tpu_torch.shared import PairHMMConfig  # noqa: F401
