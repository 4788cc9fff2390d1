"""The JAX package's framework-free modules that the port uses.

The port imports these instead of copying them: configs, quality tables,
packers, the fp64, SW, extension and SMEM oracles, the FM-index and the
``bwa index`` reader, the native host runtime (C++ packers, host
forward, host SW, host extension, host SMEM, fp64 recompute), synthetic
generators and corpus IO (PairHMM text, BWA-SW task and result
records).  Every module of the port, and ``chip_smoke.py``, reaches them
through here, so this file is the one list of what the port borrows.
None of them imports jax; ``acc_genomics_tpu.engine``, the Pallas
modules, ``ops/sw/{kernel,walker}.py``, ``ops/smem/machine.py`` and
``models/bwa_mem.py`` do, and are not listed.
"""

from acc_genomics_tpu import native
from acc_genomics_tpu.config import ExtendConfig, PairHMMConfig, SmemConfig, SWConfig
from acc_genomics_tpu.io.bwa_index import load_bwa_index
from acc_genomics_tpu.io.bwasw_records import read_results, read_task_file, run_tasks
from acc_genomics_tpu.io.pairhmm_text import (
    read_pairhmm_input,
    read_pairhmm_output,
)
from acc_genomics_tpu.io.synth import (
    gen_pairhmm_input,
    gen_pairhmm_pairs,
    gen_reference_with_repeats,
    gen_smem_reads,
    gen_sw_batch,
)
from acc_genomics_tpu.native import cat_u8
from acc_genomics_tpu.ops.extend.reference import (
    DEFAULT_EXTEND_PARAMS,
    ExtendParams,
    extend_seed_oracle,
    sw_extend_oracle,
)
from acc_genomics_tpu.ops.pairhmm.context import PairHMMContext
from acc_genomics_tpu.ops.pairhmm.pack import (
    PackedPairHMMBatch,
    PackedPairHMMQuals,
    pack_pairhmm_batch,
    pack_pairhmm_quals,
)
from acc_genomics_tpu.ops.pairhmm.reference import pairhmm_loglik_oracle
from acc_genomics_tpu.ops.smem.index import FMIndex
from acc_genomics_tpu.ops.smem.reference import (
    DEFAULT_SMEM_PARAMS,
    SmemParams,
    mem_collect_intv_oracle,
)
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
    "DEFAULT_EXTEND_PARAMS",
    "DEFAULT_SMEM_PARAMS",
    "DEFAULT_SW_PARAMS",
    "ExtendConfig",
    "ExtendParams",
    "FMIndex",
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
    "SmemConfig",
    "SmemParams",
    "Timer",
    "cat_u8",
    "extend_seed_oracle",
    "gen_pairhmm_input",
    "gen_pairhmm_pairs",
    "gen_reference_with_repeats",
    "gen_smem_reads",
    "gen_sw_batch",
    "load_bwa_index",
    "mem_collect_intv_oracle",
    "native",
    "pack_pairhmm_batch",
    "pack_pairhmm_quals",
    "pairhmm_loglik_oracle",
    "read_pairhmm_input",
    "read_pairhmm_output",
    "read_results",
    "read_task_file",
    "run_tasks",
    "sw_align_oracle",
    "sw_extend_oracle",
]
