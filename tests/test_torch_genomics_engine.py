"""The port's GenomicsEngine facade on ``device="cpu"`` against the JAX
GenomicsEngine on the cases of tests/test_engines.py.  SW CIGARs, seed
records, SMEM intervals and SeedHits are compared exactly; PairHMM
likelihoods (both engines on the gather expansion, the host's own tables)
to rtol 1e-5 / atol 1e-5, the tolerance of the port's PairHMM engine
tests: the two frameworks sum in another order.
"""

import dataclasses

import numpy as np
import pytest

from acc_genomics_tpu.config import EngineConfig as JaxEngineConfig
from acc_genomics_tpu.config import PairHMMConfig as JaxPairHMMConfig
from acc_genomics_tpu.config import SWConfig as JaxSWConfig
from acc_genomics_tpu.engine.genomics_engine import GenomicsEngine as JaxGenomicsEngine
from acc_genomics_tpu.io.synth import (
    gen_pairhmm_input,
    gen_reference_with_repeats,
    gen_smem_reads,
    gen_sw_batch,
)
from acc_genomics_tpu.models import BwaMemSeeding as JaxSeeding
from acc_genomics_tpu.models import HaplotypeCallerCore as JaxCore
from acc_genomics_tpu_torch.config import EngineConfig, PairHMMConfig, SWConfig
from acc_genomics_tpu_torch.engine.genomics_engine import GenomicsEngine
from acc_genomics_tpu_torch.models import BwaMemSeeding, HaplotypeCallerCore


def _engines(pairhmm=None, sw=None):
    cfg, jax_cfg = EngineConfig(), JaxEngineConfig()
    if pairhmm:
        cfg = dataclasses.replace(cfg, pairhmm=PairHMMConfig(**pairhmm))
        jax_cfg = dataclasses.replace(jax_cfg, pairhmm=JaxPairHMMConfig(**pairhmm))
    if sw:
        cfg = dataclasses.replace(cfg, sw=SWConfig(**sw))
        jax_cfg = dataclasses.replace(jax_cfg, sw=JaxSWConfig(**sw))
    return GenomicsEngine(cfg, device="cpu"), JaxGenomicsEngine(jax_cfg)


def test_sw_align_matches_jax_with_fallback(rng):
    eng, jax_eng = _engines(sw=dict(seq_buckets=(64, 128)))
    ref, alts = gen_sw_batch(rng, 6, ref_len=100)
    for strategy in (0, 1, 2, 3):
        assert eng.sw_align(ref, alts, strategy) == jax_eng.sw_align(ref, alts, strategy)
    big_ref, (big_alt,) = gen_sw_batch(rng, 1, ref_len=200)
    refs, pair_alts = [ref] * 6 + [big_ref], alts + [big_alt]
    assert eng.sw.align(refs, pair_alts, 0) == jax_eng.sw.align(refs, pair_alts, 0)
    assert eng.sw.stats["host_fallback"] == jax_eng.sw.stats["host_fallback"] == 1
    with pytest.raises(ValueError, match="ONE 1-D reference"):
        eng.sw_align(np.stack([ref, ref]), alts)


def test_extend_seeds_matches_jax(rng):
    eng, jax_eng = _engines()
    genome = rng.integers(0, 4, 600).astype(np.uint8)
    seeds = []
    for _ in range(9):
        pos = int(rng.integers(60, 400))
        read = genome[pos: pos + 100].copy()
        err = rng.random(100) < 0.05
        read[err] = (read[err] + rng.integers(1, 4, err.sum())) % 4
        qbeg = int(rng.integers(10, 40))
        read[qbeg: qbeg + 21] = genome[pos + qbeg: pos + qbeg + 21]
        seeds.append(dict(read=read, rseq=genome[pos - 50: pos + 160], qbeg=qbeg,
                          rbeg_off=50 + qbeg, len=21))
    assert eng.extend_seeds(seeds) == jax_eng.extend_seeds(seeds)


def test_smem_before_index_raises():
    eng, _ = _engines()
    with pytest.raises(RuntimeError, match="no reference loaded"):
        eng.smem
    with pytest.raises(RuntimeError, match="no reference loaded"):
        eng.smem_collect([np.zeros(30, np.uint8)])
    assert not [k for k in eng.stats() if k.startswith("smem_")]


def test_facade_and_pipelines_match_jax(rng):
    gather = dict(quals_expand="gather")
    eng, jax_eng = _engines(pairhmm=gather)
    genome = gen_reference_with_repeats(rng, 3000, repeat_len=25, n_repeats=3)
    fm = eng.load_reference(genome)
    jax_fm = jax_eng.load_reference(genome)
    np.testing.assert_array_equal(fm.sa, jax_fm.sa)

    reads = gen_smem_reads(rng, genome, 6, read_len=90, error_rate=0.01)
    assert eng.smem_collect(reads) == jax_eng.smem_collect(reads)

    ref_window = genome[500:800]
    alt = ref_window.copy()
    alt[150] = (alt[150] + 1) % 4
    haps = [ref_window.copy(), alt]
    hreads, _ = gen_pairhmm_input(rng, 5, 1, max_read_len=60, max_hap_len=64)
    hreads[0]["rs"] = alt[100:160].copy()
    for k, v in (("q", 40), ("i", 45), ("d", 45), ("c", 10)):
        hreads[0][k] = np.full(60, v, np.uint8)
    got = HaplotypeCallerCore(eng).process_region(ref_window, haps, hreads)
    want = JaxCore(jax_eng).process_region(ref_window, haps, hreads)
    assert got.hap_cigars == want.hap_cigars and got.hap_cigars[0][0] == [(300, 0)]
    np.testing.assert_allclose(got.likelihoods, want.likelihoods, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.best_hap, want.best_hap)
    assert got.best_hap[0] == 1

    clean = genome[1200:1280].copy()
    hits = BwaMemSeeding(eng).map_reads([clean])
    assert ([[dataclasses.astuple(h) for h in r] for r in hits]
            == [[dataclasses.astuple(h) for h in r] for r in JaxSeeding(jax_eng).map_reads([clean])])
    best = max(hits[0], key=lambda h: h.score)
    assert (best.score, best.rbeg, best.qbeg) == (80, 1200, 0)

    stats = eng.stats()
    assert {k for k in stats if k.startswith(("sw_", "extend_", "smem_"))}
    assert stats["smem_reads"] == jax_eng.stats()["smem_reads"] > 0
    assert stats["extend_seeds"] == jax_eng.stats()["extend_seeds"] > 0


def test_pairhmm_matrix_and_flat_match_jax(rng):
    eng, jax_eng = _engines(pairhmm=dict(read_buckets=(32, 64), hap_buckets=(64, 128),
                                         quals_expand="gather"))
    reads, haps = gen_pairhmm_input(rng, 4, 3, max_read_len=50, max_hap_len=100,
                                    derived=True)
    got = eng.pairhmm_matrix(reads, haps)
    assert got.shape == (4, 3)
    np.testing.assert_allclose(got, jax_eng.pairhmm_matrix(reads, haps), rtol=1e-5, atol=1e-5)
    cat = lambda key: np.concatenate([r[key] for r in reads]).astype(np.uint8)
    flat = (cat("rs"), cat("q"), cat("i"), cat("d"), cat("c"),
            np.array([len(r["rs"]) for r in reads], np.int32),
            np.concatenate(haps).astype(np.uint8), np.array([len(h) for h in haps], np.int32))
    np.testing.assert_allclose(eng.pairhmm_matrix_flat(*flat), got, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(jax_eng.pairhmm_matrix_flat(*flat), got, rtol=1e-5, atol=1e-5)
