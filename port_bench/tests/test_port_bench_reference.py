"""The plain references against frozen oracles and brute force at tiny
sizes."""

import numpy as np
import pytest
import torch

from acc_genomics_tpu_torch.io.synth import gen_pairhmm_input, gen_reference_with_repeats
from acc_genomics_tpu_torch.ops.pairhmm.reference import pairhmm_loglik_oracle
from acc_genomics_tpu_torch.ops.smem.index import FMIndex
from acc_genomics_tpu_torch.ops.smem.reference import mem_collect_intv_oracle
from acc_genomics_tpu_torch.ops.sw.reference import sw_align_oracle
from port_bench.reference import fm as ref_fm
from port_bench.reference import pairhmm as ref_pairhmm
from port_bench.reference import sw as ref_sw


def _pad(arrs, width):
    out = np.zeros((len(arrs), width), np.uint8)
    for k, a in enumerate(arrs):
        out[k, : len(a)] = a
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pairhmm_matches_the_oracle_in_float64(seed):
    reads, haps = gen_pairhmm_input(np.random.default_rng(seed), 5, 3, max_read_len=30,
                                    max_hap_len=50, derived=True)
    pairs = [(r, h) for r in reads for h in haps]
    R = max(len(r["rs"]) for r, _ in pairs)
    H = max(len(h) for _, h in pairs)
    mats = {k: _pad([r[k] for r, _ in pairs], R) for k in ("rs", "q", "i", "d", "c")}
    got = ref_pairhmm.forward_loglik(mats["rs"], mats["q"], mats["i"], mats["d"], mats["c"],
                                     [len(r["rs"]) for r, _ in pairs], _pad([h for _, h in pairs], H),
                                     [len(h) for _, h in pairs], block=4)
    want = [pairhmm_loglik_oracle(r["rs"], r["q"], r["i"], r["d"], r["c"], h) for r, h in pairs]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_pairhmm_in_bfloat16_is_off_by_more_than_float32():
    reads, haps = gen_pairhmm_input(np.random.default_rng(7), 4, 2, max_read_len=60,
                                    max_hap_len=80, derived=True)
    pairs = [(r, h) for r in reads for h in haps]
    R = max(len(r["rs"]) for r, _ in pairs)
    H = max(len(h) for _, h in pairs)
    args = ([_pad([r[k] for r, _ in pairs], R) for k in ("rs", "q", "i", "d", "c")]
            + [[len(r["rs"]) for r, _ in pairs], _pad([h for _, h in pairs], H),
               [len(h) for _, h in pairs]])
    f64 = ref_pairhmm.forward_loglik(*args)
    f32 = ref_pairhmm.forward_loglik(*args, dtype=torch.float32)
    bf16 = ref_pairhmm.forward_loglik(*args, dtype=torch.bfloat16)
    assert np.abs(f32 - f64).max() < 1e-4 < 1e-3 < np.abs(bf16 - f64).max()


@pytest.mark.parametrize("strategy", [0, 1, 2, 3])
def test_sw_matches_the_oracle(strategy):
    rng = np.random.default_rng(strategy)
    for _ in range(6):
        ref = rng.integers(0, 4, int(rng.integers(5, 60))).astype(np.uint8)
        alt = ref.copy()
        mut = rng.random(len(alt)) < 0.1
        alt[mut] = (alt[mut] + 1) % 4
        if rng.random() < 0.5:
            alt = np.delete(alt, slice(3, 5))
        assert ref_sw.sw_align(ref, alt, strategy) == sw_align_oracle(ref, alt, strategy,
                                                                      fill="cellwise")


def test_suffix_array_against_sorted_suffixes():
    rng = np.random.default_rng(3)
    for n in (1, 2, 30, 200):
        t = rng.integers(0, 2, n).astype(np.uint8)  # two letters: long ties
        brute = sorted(range(n), key=lambda i: t[i:].tolist())
        assert ref_fm.suffix_array(t).tolist() == brute


def test_fm_index_and_smems_match_the_oracle():
    rng = np.random.default_rng(11)
    g = gen_reference_with_repeats(rng, 60_000, repeat_len=300, n_repeats=20)
    g[1000:1100] = np.tile(np.array([0, 1], np.uint8), 50)
    ours, port = ref_fm.RefIndex.build(g), FMIndex.build(g)
    assert np.array_equal(ours.sa, port.sa) and ours.primary == port.primary
    for s in rng.integers(0, len(g) - 150, 25):
        read = g[s:s + 150].copy()
        read[rng.random(150) < 0.02] = 4
        assert ref_fm.mem_collect_intv(ours, read) == mem_collect_intv_oracle(port, read)
