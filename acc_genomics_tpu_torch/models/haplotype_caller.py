"""HaplotypeCaller compute core on the port's engines.

The port of ``acc_genomics_tpu/models/haplotype_caller.py``: per active
region, the candidate haplotypes are realigned to the reference window
with full Smith-Waterman + CIGAR, and every read is scored against every
haplotype with the PairHMM forward likelihood.  ``process_regions``
coalesces all regions into one SW call and one flat PairHMM call.

The engine argument is any object with an ``sw`` (``SWEngine``) and a
``pairhmm`` (``PairHMMEngine``) attribute, such as ``HCEngines`` or the
``GenomicsEngine`` facade (``engine/genomics_engine.py``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Sequence

import numpy as np

from acc_genomics_tpu_torch.engine.pairhmm_engine import PairHMMEngine
from acc_genomics_tpu_torch.engine.sw_engine import SWEngine
from acc_genomics_tpu_torch.native import cat_u8
from acc_genomics_tpu_torch.ops.sw.reference import OVERHANG_SOFTCLIP


@dataclasses.dataclass
class HCEngines:
    """The two engines HaplotypeCallerCore runs on."""

    sw: SWEngine
    pairhmm: PairHMMEngine


@dataclasses.dataclass
class RegionResult:
    likelihoods: np.ndarray  # (n_reads, n_haps) log10
    hap_cigars: List[tuple]  # [(cigar, offset)] per haplotype vs reference
    best_hap: np.ndarray  # (n_reads,) argmax hap per read


class HaplotypeCallerCore:
    def __init__(self, engine, overhang_strategy: int = OVERHANG_SOFTCLIP):
        self.engine = engine
        self.overhang_strategy = overhang_strategy
        # phase split: sw = realignment batch, pairhmm = likelihood batch,
        # host = cross-product set-up
        self.anatomy = dict(sw_s=0.0, pairhmm_s=0.0, host_s=0.0)

    def reset_anatomy(self):
        for k in self.anatomy:
            self.anatomy[k] = 0.0

    def process_region(
        self,
        reference_window: np.ndarray,
        haplotypes: Sequence[np.ndarray],
        reads: Sequence[dict],
    ) -> RegionResult:
        return self.process_regions([(reference_window, haplotypes, reads)])[0]

    def process_regions(self, regions: Sequence[tuple]) -> List[RegionResult]:
        """Batch many active regions into single engine calls.

        regions: [(reference_window, haplotypes, reads)].  All regions' SW
        pairs go to one ``sw.align`` and all (read, hap) pairs to one flat
        ``pairhmm.compute_pairs_flat``: reads and haplotypes are
        concatenated once, and each region's cross product is offsets into
        those streams."""
        t0 = time.perf_counter()
        sw_refs, sw_alts = [], []
        for ref_win, haps, reads in regions:
            sw_refs.extend([ref_win] * len(haps))
            sw_alts.extend(haps)

        all_reads = [r for _, _, reads in regions for r in reads]
        all_haps = [h for _, haps, _ in regions for h in haps]
        cat = lambda key: cat_u8([r[key] for r in all_reads])[0]
        _, roffs, rlens = cat_u8([r["rs"] for r in all_reads])
        hapc, hoffs, hlens = cat_u8(list(all_haps))
        p_offs, p_lens, p_hoffs, p_hlens = [], [], [], []
        ri = hi = 0
        for _, haps, reads in regions:
            nr, nh = len(reads), len(haps)
            p_offs.append(np.repeat(roffs[ri : ri + nr], nh))
            p_lens.append(np.repeat(rlens[ri : ri + nr], nh))
            p_hoffs.append(np.tile(hoffs[hi : hi + nh], nr))
            p_hlens.append(np.tile(hlens[hi : hi + nh], nr))
            ri += nr
            hi += nh

        t1 = time.perf_counter()
        cigars_flat = self.engine.sw.align(sw_refs, sw_alts, self.overhang_strategy)
        t2 = time.perf_counter()
        liks_flat = self.engine.pairhmm.compute_pairs_flat(
            cat("rs"), cat("q"), cat("i"), cat("d"), cat("c"),
            np.concatenate(p_lens) if p_lens else np.zeros(0, np.int32),
            hapc,
            np.concatenate(p_hlens) if p_hlens else np.zeros(0, np.int32),
            offs=np.concatenate(p_offs) if p_offs else np.zeros(0, np.int64),
            hoffs=np.concatenate(p_hoffs) if p_hoffs else np.zeros(0, np.int64),
        )
        t3 = time.perf_counter()
        self.anatomy["host_s"] += t1 - t0
        self.anatomy["sw_s"] += t2 - t1
        self.anatomy["pairhmm_s"] += t3 - t2

        out: List[RegionResult] = []
        c_off = l_off = 0
        for _, haps, reads in regions:
            nh, nr = len(haps), len(reads)
            hap_cigars = cigars_flat[c_off : c_off + nh]
            c_off += nh
            lik = liks_flat[l_off : l_off + nr * nh].reshape(nr, nh)
            l_off += nr * nh
            best = np.argmax(lik, axis=1) if nh else np.zeros(nr, int)
            out.append(RegionResult(lik, hap_cigars, best))
        return out
