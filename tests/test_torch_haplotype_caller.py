"""The port's HaplotypeCallerCore against the JAX HaplotypeCallerCore.

The port runs on its own engines on ``device="cpu"`` (SWEngine and
PairHMMEngine, the kernels' plain PyTorch versions); the JAX core runs
on ``GenomicsEngine()`` on the CPU.  Both PairHMM engines use the gather
expansion (the host's own tables), so likelihoods agree to rtol 1e-5 /
atol 1e-5; haplotype CIGARs are exact.
"""

import importlib.util
import pathlib

import numpy as np
import pytest

from acc_genomics_tpu.config import EngineConfig
from acc_genomics_tpu.config import PairHMMConfig as JaxPairHMMConfig
from acc_genomics_tpu.engine.genomics_engine import GenomicsEngine
from acc_genomics_tpu.io.synth import (
    gen_pairhmm_input,
    gen_reference_with_repeats,
    gen_sw_batch,
)
from acc_genomics_tpu.models.haplotype_caller import HaplotypeCallerCore as JaxCore
from acc_genomics_tpu.ops.pairhmm.reference import pairhmm_loglik_oracle
from acc_genomics_tpu.ops.sw.reference import sw_align_oracle
from acc_genomics_tpu_torch.config import PairHMMConfig
from acc_genomics_tpu_torch.engine.pairhmm_engine import PairHMMEngine
from acc_genomics_tpu_torch.engine.sw_engine import SWEngine
from acc_genomics_tpu_torch.io.synth import gen_region
from acc_genomics_tpu_torch.models import HaplotypeCallerCore, HCEngines

ROOT = pathlib.Path(__file__).resolve().parent.parent
GATHER = PairHMMConfig(quals_expand="gather")


def _cores():
    port = HaplotypeCallerCore(HCEngines(SWEngine(device="cpu"),
                                         PairHMMEngine(GATHER, device="cpu")))
    ref = JaxCore(GenomicsEngine(EngineConfig(pairhmm=JaxPairHMMConfig(quals_expand="gather"))))
    return port, ref


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.hap_cigars == w.hap_cigars
        np.testing.assert_allclose(g.likelihoods, w.likelihoods, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(g.best_hap, w.best_hap)


def test_region_matches_jax(rng):
    """test_engines.py's HaplotypeCaller case: a reference window, itself
    and one SNP variant as haplotypes, a read that is a slice of the
    variant."""
    genome = gen_reference_with_repeats(rng, 3000, repeat_len=25, n_repeats=3)
    ref_window = genome[500:800]
    alt = ref_window.copy()
    alt[150] = (alt[150] + 1) % 4
    haps = [ref_window.copy(), alt]
    reads, _ = gen_pairhmm_input(rng, 5, 1, max_read_len=60, max_hap_len=64)
    reads[0]["rs"] = alt[100:160].copy()
    for key, v in (("q", 40), ("i", 45), ("d", 45), ("c", 10)):
        reads[0][key] = np.full(60, v, np.uint8)
    port, ref = _cores()
    got = port.process_region(ref_window, haps, reads)
    _assert_same([got], [ref.process_region(ref_window, haps, reads)])
    assert got.likelihoods.shape == (5, 2)
    assert got.best_hap[0] == 1
    assert got.hap_cigars[0] == ([(300, 0)], 0)
    assert set(port.anatomy) == {"sw_s", "pairhmm_s", "host_s", "long_pairs", "host_pairs",
                                 "card_pack_pairs"}
    assert port.anatomy["long_pairs"] == port.anatomy["host_pairs"] == 0


def test_batched_regions_match_single_and_jax(rng):
    """test_engines.py's batched case: process_regions == region at a
    time, and == the JAX core."""
    regions = []
    for _ in range(3):
        ref_window, haps = gen_sw_batch(rng, 2, ref_len=50)
        reads, _ = gen_pairhmm_input(rng, 3, 1, max_read_len=25, max_hap_len=40)
        regions.append((ref_window, haps, reads))
    port, ref = _cores()
    batched = port.process_regions(regions)
    _assert_same(batched, ref.process_regions(regions))
    for reg_in, got in zip(regions, batched):
        one = port.process_region(*reg_in)
        np.testing.assert_allclose(got.likelihoods, one.likelihoods, rtol=1e-12)
        assert got.hap_cigars == one.hap_cigars


def test_gen_regions_match_jax(rng):
    """Four gen_region regions, as bench_hc runs off a TPU; above the
    PairHMM host gate, so the device route runs (its plain version)."""
    regions = [gen_region(rng, n_reads=24)[:3] for _ in range(4)]
    port, ref = _cores()
    got = port.process_regions(regions)
    _assert_same(got, ref.process_regions(regions))
    assert port.engine.pairhmm.stats["device_calls"] > 0
    ref_win, haps, reads = regions[0]
    for h, (cig, off) in zip(haps, got[0].hap_cigars):
        assert (cig, off) == sw_align_oracle(ref_win, h, 0)
    r = reads[0]
    want = [pairhmm_loglik_oracle(r["rs"], r["q"], r["i"], r["d"], r["c"], h) for h in haps]
    assert np.max(np.abs((got[0].likelihoods[0] - want) / want)) < 5e-3


@pytest.mark.parametrize("seed", [0, 7])
def test_gen_region_matches_hc_script(seed):
    spec = importlib.util.spec_from_file_location(
        "hc_driver", ROOT / "drivers" / "hc_driver.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    got = gen_region(np.random.default_rng(seed), n_reads=6)
    want = script.gen_region(np.random.default_rng(seed), n_reads=6)
    np.testing.assert_array_equal(got[0], want[0])
    assert len(got[1]) == len(want[1])
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got[2], want[2]):
        assert g.keys() == w.keys()
        for key in g:
            np.testing.assert_array_equal(g[key], w[key])
    assert got[3] == want[3]
