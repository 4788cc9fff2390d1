"""The port's PairHMMEngine against the JAX PairHMMEngine on the CPU.

The port runs on ``device="cpu"`` (the kernel's plain PyTorch version on
the byte-plane route); the JAX engine runs its XLA row scan
(``use_pallas=False``) or, for the flat path, its Pallas kernel in
interpret mode.  With ``quals_expand="gather"`` the port's coefficients
are bit-identical to the JAX host pack, so log-likelihoods agree to
rtol 1e-5 / atol 1e-5 and every stats counter is equal.
"""

import dataclasses
import os

import numpy as np
import pytest

from acc_genomics_tpu.config import PairHMMConfig as JaxPairHMMConfig
from acc_genomics_tpu.engine.pairhmm_engine import PairHMMEngine as JaxEngine
from acc_genomics_tpu.io.pairhmm_text import read_pairhmm_input, read_pairhmm_output
from acc_genomics_tpu.io.synth import gen_pairhmm_input, gen_pairhmm_pairs
from acc_genomics_tpu.ops.pairhmm.reference import pairhmm_loglik_oracle
from acc_genomics_tpu_torch.config import PairHMMConfig
from acc_genomics_tpu_torch.engine import plan_buckets
from acc_genomics_tpu_torch.engine.pairhmm_engine import PairHMMEngine
from acc_genomics_tpu_torch.utils.timer import timers

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
COUNTERS = ("pairs", "recomputed", "cells", "device_calls", "host_fallback",
            "host_native_calls")
GATHER = dict(quals_expand="gather")


def _jax(cfg):
    return JaxPairHMMConfig(**dataclasses.asdict(cfg))


def _engines(cfg=None, gate=0):
    cfg = cfg or PairHMMConfig(**GATHER)
    jax_eng = JaxEngine(_jax(cfg), use_pallas=False)
    port = PairHMMEngine(cfg, device="cpu")
    if gate is not None:
        jax_eng.min_device_cells = port.min_device_cells = gate
    return jax_eng, port


def _counters(stats):
    return {k: stats.get(k, 0) for k in COUNTERS}


def _flatten(tcs):
    cat = lambda key: (
        np.concatenate([np.asarray(t[key], np.uint8) for t in tcs])
        if tcs else np.zeros(0, np.uint8)
    )
    lens = np.array([len(t["rs"]) for t in tcs], np.int32)
    hlens = np.array([len(t["hap"]) for t in tcs], np.int32)
    return (cat("rs"), cat("q"), cat("i"), cat("d"), cat("c"), lens,
            cat("hap"), hlens)


def _oracle(tcs):
    return np.array([
        pairhmm_loglik_oracle(t["rs"], t["q"], t["i"], t["d"], t["c"], t["hap"])
        for t in tcs
    ])


def _mixed(rng):
    tcs = gen_pairhmm_pairs(rng, 40, max_read_len=50, max_hap_len=100)
    return tcs + gen_pairhmm_pairs(rng, 10, max_read_len=10, max_hap_len=20)


def _all_mismatch(rng):
    hap = rng.integers(0, 4, 120).astype(np.uint8)
    return [dict(
        rs=((hap + 2) % 4).astype(np.uint8), q=np.full(120, 50, np.uint8),
        i=np.full(120, 45, np.uint8), d=np.full(120, 45, np.uint8),
        c=np.full(120, 10, np.uint8), hap=hap,
    )]


def _oversize(rng):
    cfg = PairHMMConfig()
    tcs = gen_pairhmm_pairs(rng, 6, max_read_len=40, max_hap_len=80)
    big = gen_pairhmm_pairs(rng, 2, max_read_len=30, max_hap_len=60)
    nr = cfg.max_read_len + 5
    for k in ("rs", "q", "i", "d", "c"):
        big[0][k] = np.resize(np.asarray(big[0][k], np.uint8), nr)
    big[1]["hap"] = np.resize(big[1]["hap"], cfg.max_hap_len + 7)
    return tcs[:3] + [big[0]] + tcs[3:] + [big[1]]


# (pairs, config, static gate) of test_pairhmm_engine.py's cases
DICT_CASES = {
    "mixed_buckets": (_mixed, dict(read_buckets=(16, 32, 64), hap_buckets=(32, 64, 128)), 0),
    "host_gate": (_mixed, dict(read_buckets=(16, 32, 64), hap_buckets=(32, 64, 128)), None),
    "underflow_recompute": (_all_mismatch, dict(read_buckets=(128,), hap_buckets=(128,)), 0),
    "oversize_host_fallback": (_oversize, {}, 0),
}


@pytest.mark.parametrize("case", sorted(DICT_CASES))
def test_compute_pairs_matches_jax(case, rng):
    make, cfg_kw, gate = DICT_CASES[case]
    tcs = make(rng)
    jax_eng, port = _engines(PairHMMConfig(**cfg_kw, **GATHER), gate=gate)
    want = jax_eng.compute_pairs(tcs)
    got = port.compute_pairs(tcs)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert port.stats == jax_eng.stats
    orc = _oracle(tcs)
    assert np.max(np.abs((got - orc) / orc)) < 5e-3
    if case == "underflow_recompute":
        assert port.stats["recomputed"] == 1
    if case == "oversize_host_fallback":
        assert port.stats["host_fallback"] == 2
    if case == "host_gate":
        assert port.stats["host_native_calls"] == 1
        assert port.stats["device_calls"] == 0


def test_matrix_layout_and_empty(rng):
    jax_eng, port = _engines(PairHMMConfig(read_buckets=(32,), hap_buckets=(64,), **GATHER))
    reads, haps = gen_pairhmm_input(rng, 3, 4, max_read_len=30, max_hap_len=64)
    got = port.compute_matrix(reads, haps)
    assert got.shape == (3, 4)
    np.testing.assert_allclose(got, jax_eng.compute_matrix(reads, haps), rtol=1e-5, atol=1e-5)
    assert port.compute_pairs([]).shape == (0,)
    assert jax_eng.compute_pairs([]).shape == (0,)
    assert port.stats == jax_eng.stats
    assert plan_buckets([10, 60], [50, 300], (32, 64), (128, 512)).groups == {
        (32, 128): [0], (64, 512): [1]}


def test_flat_matches_dict_and_jax(rng):
    tcs = gen_pairhmm_pairs(rng, 96, max_read_len=40, max_hap_len=80)
    cfg = PairHMMConfig(read_buckets=(32, 64), hap_buckets=(64, 128), **GATHER)
    jax_eng, port = _engines(cfg)
    want = jax_eng.compute_pairs_flat(*_flatten(tcs))
    got = port.compute_pairs_flat(*_flatten(tcs))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert _counters(port.stats) == _counters(jax_eng.stats)
    dict_port = PairHMMEngine(cfg, device="cpu")
    dict_port.min_device_cells = 0
    np.testing.assert_allclose(dict_port.compute_pairs(tcs), got, rtol=1e-12)
    # one upload of the whole batch and one fetch of every lane
    assert port.stats["h2d_bytes"] > 0
    assert port.stats["d2h_bytes"] == 4 * len(tcs)


def test_flat_with_oversize_matches_jax_flat(rng):
    """Both engines' native flat routes (byte planes, arith expansion,
    concurrent host fallback, flat fp64 recompute); JAX runs its Pallas
    kernel in interpret mode."""
    tcs = gen_pairhmm_pairs(rng, 40, max_read_len=30, max_hap_len=60)
    big = dict(tcs[0])
    for k in ("rs", "q", "i", "d", "c"):
        big[k] = np.resize(np.asarray(tcs[0][k], np.uint8), 80)
    tcs.append(big)
    cfg = PairHMMConfig(read_buckets=(32, 64), hap_buckets=(64,))
    jax_eng = JaxEngine(_jax(cfg), use_pallas=True)
    jax_eng._interpret = True
    want = jax_eng.compute_pairs_flat(*_flatten(tcs))
    port = PairHMMEngine(cfg, device="cpu")
    got = port.compute_pairs_flat(*_flatten(tcs))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert _counters(port.stats) == _counters(jax_eng.stats)
    assert port.stats["host_fallback"] == 1


def test_flat_underflow_recompute(rng):
    # independent random reads and haps: most pairs underflow fp32
    reads, haps = gen_pairhmm_input(rng, 6, 3, max_read_len=120, max_hap_len=120)
    tcs = [dict(hap=h, **r) for r in reads for h in haps]
    jax_eng, port = _engines(PairHMMConfig(read_buckets=(128,), hap_buckets=(128,), **GATHER))
    want = jax_eng.compute_pairs_flat(*_flatten(tcs))
    got = port.compute_pairs_flat(*_flatten(tcs))
    assert 0 < port.stats["recomputed"] < len(tcs)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert _counters(port.stats) == _counters(jax_eng.stats)
    assert np.max(np.abs((got - _oracle(tcs)) / _oracle(tcs))) < 5e-3


def test_flat_stream_matches_single_calls(rng):
    batches = [
        _flatten(gen_pairhmm_pairs(rng, 40, max_read_len=30, max_hap_len=60))
        for _ in range(3)
    ]
    cfg = PairHMMConfig(read_buckets=(32, 64), hap_buckets=(64,))
    eng = PairHMMEngine(cfg, device="cpu")
    before = timers()
    got = eng.compute_pairs_flat_stream(batches)
    spans = {k: v["count"] - before.get(k, {"count": 0})["count"] for k, v in timers().items()}
    assert len(got) == 3
    assert spans["pairhmm.stream_launch"] == spans["pairhmm.stream_finalize"] == 3
    for b, g in zip(batches, got):
        single = PairHMMEngine(cfg, device="cpu").compute_pairs_flat(*b)
        np.testing.assert_allclose(g, single, rtol=1e-12)


def test_matrix_flat_matches_matrix(rng):
    reads, haps = gen_pairhmm_input(rng, 5, 3, max_read_len=40, max_hap_len=90, derived=True)
    eng = PairHMMEngine(PairHMMConfig(read_buckets=(64,), hap_buckets=(128,)), device="cpu")
    eng.min_device_cells = 0
    cat = lambda key: np.concatenate([r[key] for r in reads])
    got = eng.compute_matrix_flat(
        cat("rs"), cat("q"), cat("i"), cat("d"), cat("c"),
        [len(r["rs"]) for r in reads], np.concatenate(haps), [len(h) for h in haps],
    )
    np.testing.assert_allclose(got, eng.compute_matrix(reads, haps), rtol=1e-12)


def test_corpus_fixture(rng):
    reads, haps = read_pairhmm_input(os.path.join(FIX, "pairhmm_input0"))
    golden = read_pairhmm_output(os.path.join(FIX, "pairhmm_output0"))
    jax_eng, port = _engines()
    got = port.compute_matrix(reads, haps).reshape(-1)
    want = jax_eng.compute_matrix(reads, haps).reshape(-1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.max(np.abs(got - golden) / np.abs(golden)) < 5e-3
    assert port.stats == jax_eng.stats and port.stats["device_calls"] > 0
