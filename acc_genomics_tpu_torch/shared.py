"""The JAX package's framework-free modules that the port uses.

The port imports these instead of copying them: configs, quality tables,
packers, the fp64 and SW oracles, the native host runtime (C++ packers,
host forward, host SW, fp64 recompute), synthetic generators and corpus
IO.  Every module of the port, and ``chip_smoke.py``, reaches them
through here, so this file is the one list of what the port borrows.
None of them imports jax; ``acc_genomics_tpu.engine``, the Pallas
modules and ``ops/sw/{kernel,walker}.py`` do, and are not listed.
"""

from acc_genomics_tpu import native
from acc_genomics_tpu.config import PairHMMConfig, SWConfig
from acc_genomics_tpu.io.pairhmm_text import (
    read_pairhmm_input,
    read_pairhmm_output,
)
from acc_genomics_tpu.io.synth import (
    gen_pairhmm_input,
    gen_pairhmm_pairs,
    gen_sw_batch,
)
from acc_genomics_tpu.native import cat_u8
from acc_genomics_tpu.ops.pairhmm.context import PairHMMContext
from acc_genomics_tpu.ops.pairhmm.pack import (
    PackedPairHMMBatch,
    PackedPairHMMQuals,
    pack_pairhmm_batch,
    pack_pairhmm_quals,
)
from acc_genomics_tpu.ops.pairhmm.reference import pairhmm_loglik_oracle
from acc_genomics_tpu.ops.sw.reference import (
    DEFAULT_SW_PARAMS,
    LOW_INIT,
    MATRIX_MIN_CUTOFF,
    OVERHANG_IGNORE,
    OVERHANG_INDEL,
    OVERHANG_LEADING_INDEL,
    OVERHANG_SOFTCLIP,
    STATE_CLIP,
    STATE_DELETION,
    STATE_INSERTION,
    STATE_MATCH,
    SWParams,
    sw_align_oracle,
)
from acc_genomics_tpu.utils.convert import BASE_N, HAP_PAD
from acc_genomics_tpu.utils.timer import Timer

__all__ = [
    "BASE_N",
    "DEFAULT_SW_PARAMS",
    "HAP_PAD",
    "LOW_INIT",
    "MATRIX_MIN_CUTOFF",
    "OVERHANG_IGNORE",
    "OVERHANG_INDEL",
    "OVERHANG_LEADING_INDEL",
    "OVERHANG_SOFTCLIP",
    "PackedPairHMMBatch",
    "PackedPairHMMQuals",
    "PairHMMConfig",
    "PairHMMContext",
    "STATE_CLIP",
    "STATE_DELETION",
    "STATE_INSERTION",
    "STATE_MATCH",
    "SWConfig",
    "SWParams",
    "Timer",
    "cat_u8",
    "gen_pairhmm_input",
    "gen_pairhmm_pairs",
    "gen_sw_batch",
    "native",
    "pack_pairhmm_batch",
    "pack_pairhmm_quals",
    "pairhmm_loglik_oracle",
    "read_pairhmm_input",
    "read_pairhmm_output",
    "sw_align_oracle",
]
