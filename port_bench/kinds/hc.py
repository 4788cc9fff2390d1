"""GATK HaplotypeCaller regions through the port's ``HaplotypeCallerCore``.

One call is ``process_regions`` on the mix's ``regions_per_call``
consecutive regions of a pool drawn from the run's seed, cycling through
the pool: SW realignment of every haplotype to its reference window,
then PairHMM likelihoods of every read against every haplotype.  The
check recomputes a sample of the window's regions (drawn from the seed,
with the region of most read-haplotype pairs among those done) with the
plain references: every haplotype's CIGAR and offset exactly, every
likelihood to within a gap in log10.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.gen.regions import make_regions
from port_bench.kinds import common
from port_bench.reference import pairhmm as ref_pairhmm
from port_bench.reference import sw as ref_sw


class Cell:
    items = "regions"

    def __init__(self, cfg: dict, mix: dict, seed: int, device: str, cache_dir: str):
        from acc_genomics_tpu_torch.config import engine_config_from_dict
        from acc_genomics_tpu_torch.engine.genomics_engine import GenomicsEngine
        from acc_genomics_tpu_torch.models.haplotype_caller import HaplotypeCallerCore

        self.cfg, self.mix, self.device, self.seed = cfg, mix, device, seed
        rng = np.random.default_rng(common.seed_words(seed))
        self.pool = make_regions(rng, cfg, int(cfg["assumed"]["pool_regions"]))
        self.per_call = int(mix["regions_per_call"])
        self.engine = GenomicsEngine(engine_config_from_dict(cfg.get("engine", {})), device)
        self.core = HaplotypeCallerCore(self.engine, int(cfg["overhang_strategy"]))
        self.outputs = {}  # call -> (regions returned, {position: RegionResult} kept)

    def regions_of(self, k: int):
        n = len(self.pool)
        return [(k * self.per_call + j) % n for j in range(self.per_call)]

    def call(self, k: int) -> int:
        idx = self.regions_of(k)
        out = self.core.process_regions([self.pool[j] for j in idx])
        self.outputs[k] = (len(out), {j: out[j] for j in self.candidates(k) if j < len(out)})
        return len(idx)

    def _pairs(self, k: int, j: int) -> int:
        _, haps, reads = self.pool[self.regions_of(k)[j]]
        return len(haps) * len(reads)

    def candidates(self, k: int):
        """Positions of call ``k`` whose answers are kept for the check:
        two drawn from the seed, and the call's region of most pairs."""
        rng = np.random.default_rng(common.seed_words(self.seed, 2, k))
        pick = set(rng.choice(self.per_call, min(2, self.per_call), replace=False).tolist())
        pick.add(max(range(self.per_call), key=lambda j: self._pairs(k, j)))
        return sorted(pick)

    def warm(self, calls: int) -> None:
        for k in range(calls):
            self.call(k)
        self.outputs.clear()
        self.core.reset_anatomy()

    def layer_spans(self):
        return [(self.engine.sw, "align", "hc.sw"),
                (self.engine.pairhmm, "compute_pairs_flat", "hc.pairhmm")]

    def snapshot(self) -> dict:
        return dict(common.program_counters(), anatomy=dict(self.core.anatomy))

    def window_inputs(self, calls) -> dict:
        """Every (read length, haplotype length) pair the calls scored."""
        lens, hlens = [], []
        for k in calls:
            for j in self.regions_of(k):
                _, haps, reads = self.pool[j]
                rl = np.array([len(r["rs"]) for r in reads], np.int64)
                hl = np.array([len(h) for h in haps], np.int64)
                lens.append(np.repeat(rl, len(hl)))
                hlens.append(np.tile(hl, len(rl)))
        return dict(pairhmm_lens=np.concatenate(lens), pairhmm_hlens=np.concatenate(hlens))

    def free_program(self) -> None:
        del self.engine, self.core
        common.free_device()

    # -- the check --------------------------------------------------------

    def sample(self, calls: int, seed: int):
        """[(call, position)] drawn from the seed among the kept
        candidates, with the done region of most read-haplotype pairs."""
        done = [(k, j) for k in range(calls) for j in self.candidates(k)]
        rng = np.random.default_rng(common.seed_words(seed, 1))
        n = min(int(self.mix["check_regions"]), len(done))
        pick = {done[i] for i in rng.choice(len(done), n, replace=False)}
        pick.add(max(done, key=lambda kj: self._pairs(*kj)))
        return sorted(pick)

    def check(self, calls: int, seed: int, ref_device: str, control: bool = False):
        """[(name, value, limit)] of the sample."""
        limits = self.cfg["limits"]
        picks = self.sample(calls, seed)
        missing = cigar_bad = 0
        regions, results = [], []
        for k, j in picks:
            region = self.pool[self.regions_of(k)[j]]
            if control:
                regions.append(region)
                continue
            res = self.outputs[k][1].get(j) if k in self.outputs else None
            nr, nh = len(region[2]), len(region[1])
            if res is None or np.shape(res.likelihoods) != (nr, nh) or len(res.hap_cigars) != nh:
                missing += 1
                continue
            regions.append(region)
            results.append(res)
        strategy = int(self.cfg["overhang_strategy"])
        sw_params = ref_sw.SWParams(**self.cfg["engine"]["sw"])
        if not control:
            for (ref, haps, _), res in zip(regions, results):
                for h, got in zip(haps, res.hap_cigars):
                    want = ref_sw.sw_align(ref, h, strategy, sw_params)
                    cigar_bad += int(_cigar(got) != _cigar(want))
        gap = pairhmm_gap(regions, results, ref_device, control)
        nums = [("regions_missing", missing, 0), ("sw_cigar_mismatches", cigar_bad, 0),
                ("lik_log10_gap", gap, limits["lik_log10_gap"])]
        return nums


def _cigar(res):
    cigar, offset = res
    return [(int(a), int(b)) for a, b in cigar], int(offset)


def _stack(regions):
    """Every (read, haplotype) pair of the regions as padded matrices."""
    reads = [r for _, haps, rs in regions for r in rs for _ in haps]
    haps = [h for _, hs, rs in regions for _ in rs for h in hs]
    R = max(len(r["rs"]) for r in reads)
    H = max(len(h) for h in haps)
    mats = {}
    for key in ("rs", "q", "i", "d", "c"):
        m = np.zeros((len(reads), R), np.uint8)
        for t, r in enumerate(reads):
            m[t, : len(r[key])] = r[key]
        mats[key] = m
    hap = np.zeros((len(haps), H), np.uint8)
    for t, h in enumerate(haps):
        hap[t, : len(h)] = h
    lens = np.array([len(r["rs"]) for r in reads])
    hlens = np.array([len(h) for h in haps])
    return mats, lens, hap, hlens


def pairhmm_gap(regions, results, device: str, control: bool) -> float:
    """The widest |log10 likelihood - reference| over the regions' pairs
    (the control: the reference in bfloat16 in the program's place)."""
    if not regions:
        return 0.0
    mats, lens, hap, hlens = _stack(regions)
    args = (mats["rs"], mats["q"], mats["i"], mats["d"], mats["c"], lens, hap, hlens)
    want = ref_pairhmm.forward_loglik(*args, dtype=torch.float64, device=device)
    if control:
        got = ref_pairhmm.forward_loglik(*args, dtype=torch.bfloat16, device=device)
    else:
        got = np.concatenate([np.asarray(res.likelihoods, np.float64).reshape(-1)
                              for res in results])
    with np.errstate(invalid="ignore"):
        gap = np.abs(got - want)
    return float(np.nanmax(np.where(np.isfinite(gap), gap, np.inf)))
