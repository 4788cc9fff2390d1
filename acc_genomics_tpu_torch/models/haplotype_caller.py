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
from typing import List, Sequence

import numpy as np

from acc_genomics_tpu_torch.config import PairHMMConfig
from acc_genomics_tpu_torch.engine.pairhmm_engine import PairHMMEngine
from acc_genomics_tpu_torch.engine.sw_engine import SWEngine
from acc_genomics_tpu_torch.native import cat_u8
from acc_genomics_tpu_torch.ops.sw.reference import OVERHANG_SOFTCLIP
from acc_genomics_tpu_torch.utils.timer import Timer

# the longest read the default read buckets take; longer reads need
# configured buckets (long-read data) or go to the native host forward
LONG_READ = PairHMMConfig().max_read_len


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
        # phase split, the readings of the spans hc.realign (sw),
        # hc.likelihoods (pairhmm) and hc.prepare (host); where the pairs
        # were scored: long_pairs, reads past LONG_READ on the device
        # route, host_pairs, pairs on the native host forward, and
        # card_pack_pairs, pairs whose byte planes the device built
        self.anatomy = dict(sw_s=0.0, pairhmm_s=0.0, host_s=0.0, long_pairs=0, host_pairs=0,
                            card_pack_pairs=0)

    def reset_anatomy(self):
        for k in self.anatomy:
            self.anatomy[k] = 0

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
        with Timer("hc.prepare") as prepare:
            sw_refs, sw_alts = [], []
            for ref_win, haps, reads in regions:
                sw_refs.extend([ref_win] * len(haps))
                sw_alts.extend(haps)

            all_reads = [r for _, _, reads in regions for r in reads]
            all_haps = [h for _, haps, _ in regions for h in haps]
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

        with Timer("hc.realign") as realign:
            cigars_flat = self.engine.sw.align(sw_refs, sw_alts, self.overhang_strategy)
        with Timer("hc.likelihoods") as likelihoods:
            with Timer("hc.cat"):
                cat = lambda key: cat_u8([r[key] for r in all_reads])[0]
                rs, q, i, d, c = (cat(key) for key in ("rs", "q", "i", "d", "c"))
                flat = lambda parts, dtype: (
                    np.concatenate(parts) if parts else np.zeros(0, dtype))
                pair_lens, pair_hlens = flat(p_lens, np.int32), flat(p_hlens, np.int32)
                pair_offs, pair_hoffs = flat(p_offs, np.int64), flat(p_hoffs, np.int64)
            pairhmm = self.engine.pairhmm
            host0 = pairhmm.stats.get("host_fallback", 0)
            packed0 = pairhmm.stats.get("card_packed", 0)
            liks_flat = pairhmm.compute_pairs_flat(
                rs, q, i, d, c, pair_lens, hapc, pair_hlens,
                offs=pair_offs, hoffs=pair_hoffs)
        cfg = pairhmm.config
        on_device = (pair_lens <= cfg.max_read_len) & (pair_hlens <= cfg.max_hap_len)
        self.anatomy["long_pairs"] += int(np.count_nonzero(on_device & (pair_lens > LONG_READ)))
        self.anatomy["host_pairs"] += pairhmm.stats.get("host_fallback", 0) - host0
        self.anatomy["card_pack_pairs"] += pairhmm.stats.get("card_packed", 0) - packed0
        self.anatomy["host_s"] += prepare.elapsed
        self.anatomy["sw_s"] += realign.elapsed
        self.anatomy["pairhmm_s"] += likelihoods.elapsed

        with Timer("hc.results"):
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
