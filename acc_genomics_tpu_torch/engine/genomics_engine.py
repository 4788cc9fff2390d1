"""Unified single-card engine over all four kernels.

The port of ``acc_genomics_tpu/engine/genomics_engine.py``: the top-level
API a user lands on, with device-resident state and one stats
scoreboard.  An optional ``mesh`` (``parallel/mesh.py``) goes to all four
engines.
``HaplotypeCallerCore`` (``.sw``, ``.pairhmm``), ``BwaMemSeeding`` and
``BwaMemDevicePipeline`` (``.smem``, ``.extend``) run on it as they are.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from acc_genomics_tpu_torch.config import EngineConfig
from acc_genomics_tpu_torch.device import resolve_device
from acc_genomics_tpu_torch.engine.extend_engine import ExtendEngine
from acc_genomics_tpu_torch.engine.pairhmm_engine import PairHMMEngine
from acc_genomics_tpu_torch.engine.smem_engine import SmemEngine
from acc_genomics_tpu_torch.engine.sw_engine import SWEngine
from acc_genomics_tpu_torch.ops.smem.index import FMIndex


class GenomicsEngine:
    def __init__(self, config: EngineConfig = EngineConfig(), device="cuda", mesh=None):
        self.config = config
        self.device = resolve_device(device)
        self.mesh = mesh
        self.pairhmm = PairHMMEngine(config.pairhmm, device=self.device, mesh=mesh)
        self.sw = SWEngine(config.sw, device=self.device, mesh=mesh)
        self.extend = ExtendEngine(config.extend, device=self.device, mesh=mesh)
        self._smem = None

    # -- index management ---------------------------------------------------

    def load_reference(self, genome: np.ndarray) -> FMIndex:
        fm = FMIndex.build(genome)
        self.set_index(fm)
        return fm

    def set_index(self, fm: FMIndex):
        """Put ``fm``'s probe table on the card (replacing any earlier
        index)."""
        self._smem = SmemEngine(fm, self.config.smem, device=self.device, mesh=self.mesh)

    @property
    def smem(self) -> SmemEngine:
        if self._smem is None:
            raise RuntimeError("no reference loaded; call load_reference()")
        return self._smem

    # -- kernel entry points --------------------------------------------------

    def pairhmm_matrix(self, reads: Sequence[dict], haps: Sequence[np.ndarray]):
        return self.pairhmm.compute_matrix(reads, haps)

    def pairhmm_matrix_flat(self, rs, q, i, d, c, read_lens, hap, hap_lens):
        """Flat wire-format matrix entry (``PairHMMEngine.compute_matrix_flat``)."""
        return self.pairhmm.compute_matrix_flat(rs, q, i, d, c, read_lens, hap, hap_lens)

    def sw_align(self, ref, alts, strategy: int = 0):
        """ONE reference vs many alts (the HC realignment form).  For
        independent (ref, alt) pairs use ``self.sw.align(refs, alts)``."""
        ref = np.asarray(ref)
        if ref.ndim != 1:
            raise ValueError(
                "sw_align takes ONE 1-D reference (vs many alts); for a "
                "list of per-pair references use engine.sw.align(refs, alts)"
            )
        return self.sw.align_one_ref(ref, alts, strategy)

    def extend_seeds(self, seeds: Sequence[dict]):
        return self.extend.extend_seeds(seeds)

    def smem_collect(self, reads: List[np.ndarray]):
        return self.smem.collect(reads)

    def stats(self):
        out = dict(self.pairhmm.stats)
        out.update({f"sw_{k}": v for k, v in self.sw.stats.items()})
        out.update({f"extend_{k}": v for k, v in self.extend.stats.items()})
        if self._smem is not None:
            out.update({f"smem_{k}": v for k, v in self._smem.stats.items()})
        return out
