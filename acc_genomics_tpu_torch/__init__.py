"""acc_genomics_tpu_torch — the PyTorch/CUDA port of acc_genomics_tpu.

It runs on an NVIDIA Hopper card (H100, ``sm_90a``).  Every kernel that
the JAX package wrote in Pallas becomes a CUDA C++ kernel written by hand
(``ops/*/csrc``), built with nvcc at first use (``build.py``) and bound
with ctypes.  Beside each kernel sits a plain PyTorch version of the same
function: a CPU tensor runs it, a CUDA tensor launches the kernel.

The port imports nothing of the JAX package and never imports jax: the
framework-free modules it needs (configs, quality tables, packers, the
oracles, the FM-index, the native host runtime, synthetic generators and
corpus IO) are its own copies, at the same relative paths.

Layout:
  config.py        engine configs (copy)
  native/          ctypes bindings of the native host runtime (packers,
                   host engines, fp64 recompute, SA-IS); its C++ source
                   in native/csrc, built by build.py (copy)
  device.py        explicit device resolution (cuda raises without a card)
  build.py         nvcc build of csrc/*.cu into _build/, ctypes loading;
                   the locked build of the native host library
  ops/pairhmm/     forward kernel wrappers + plain twins, state conversion;
                   context, pack, reference (copies)
  ops/sw/          SW fill and walk kernel wrappers + plain twins, decode,
                   one-bucket launch; reference (copy)
  ops/extend/      banded seed-extension kernel wrapper + plain twin, the
                   fused seed-extension step; reference (copy)
  ops/smem/        SMEM kernel wrapper + plain twin, the FM-index probe
                   table (DeviceIndex); index, reference (copies)
  engine/          bucketing, PairHMMEngine (pack -> kernel -> epilogue),
                   SWEngine (bucket -> fill + walk -> one fetch -> decode),
                   ExtendEngine (left launches -> right launches with h0
                   from the left scores on the card -> one fetch ->
                   clip resolution), SmemEngine (resident probe table ->
                   batches -> counts fetch -> live-interval fetch), the
                   time-major packer, the GenomicsEngine facade
  models/          HaplotypeCallerCore on SW + PairHMM; BwaMemSeeding on
                   SMEM + extension; BwaMemDevicePipeline (SMEM arrays ->
                   seed enumeration -> one fused extension launch)
  parallel/        the (data, seq) mesh and the sharded forms; service.py,
                   the engine daemon and its client over TCP
  drivers/         the oracle-checked drivers, one module an engine or model
  entry.py         the entry check: entry() and dryrun_multichip(n)
  io/              synthetic generators (copy, plus gen_region), PairHMM
                   text, BWA-SW record and BWA index IO (copies)
  utils/           base codes, host timers (copies), device_trace
"""

__version__ = "0.1.0"

from acc_genomics_tpu_torch.config import PairHMMConfig  # noqa: F401
