"""The rest of the port's PairHMMEngine against the JAX package on the CPU:
the native fp32 coefficient pack (``native.pairhmm_pack_flat_f32``), the
calibrated dispatch gate (``DispatchCostModel``, ``set_cost_model``,
``calibrate_dispatch``) and the ``upload="f32"`` flat route.

The JAX wrappers run on the port's build of the native library (its
``accnative.cpp`` is the JAX package's source, one comment apart), so no
test here starts the JAX package's in-tree ``make``.  The JAX engine's f32
route runs its Pallas kernel in interpret mode.
"""

import dataclasses

import numpy as np
import pytest

import acc_genomics_tpu.native as jax_native
from acc_genomics_tpu.config import PairHMMConfig as JaxPairHMMConfig
from acc_genomics_tpu.engine import pairhmm_engine as jax_engine_module
from acc_genomics_tpu.ops.pairhmm import pack as jax_pack
from acc_genomics_tpu_torch import native
from acc_genomics_tpu_torch.config import PairHMMConfig
from acc_genomics_tpu_torch.engine.pairhmm_engine import DispatchCostModel, PairHMMEngine
from acc_genomics_tpu_torch.io.synth import gen_pairhmm_pairs
from acc_genomics_tpu_torch.ops.pairhmm.context import PairHMMContext
from acc_genomics_tpu_torch.ops.pairhmm.reference import pairhmm_loglik_oracle

MODEL_KEYS = ("host_gcups", "device_gcups", "link_gb_s", "fixed_s", "cores")


@pytest.fixture
def jax_native_on_port_lib(monkeypatch):
    monkeypatch.setattr(jax_native, "get_lib", native.get_lib)


def _flatten(tcs):
    cat = lambda key: np.concatenate([np.asarray(t[key], np.uint8) for t in tcs])
    lens = np.array([len(t["rs"]) for t in tcs], np.int32)
    hlens = np.array([len(t["hap"]) for t in tcs], np.int32)
    return (cat("rs"), cat("q"), cat("i"), cat("d"), cat("c"), lens, cat("hap"), hlens)


def _oracle(tcs):
    return np.array([pairhmm_loglik_oracle(t["rs"], t["q"], t["i"], t["d"], t["c"], t["hap"])
                     for t in tcs])


@pytest.mark.parametrize("rows,cols,n", [(32, 64, 50), (64, 128, 33), (16, 32, 1)])
def test_pack_flat_f32_matches_jax(rows, cols, n, monkeypatch):
    """Byte for byte: the port's wrapper, the JAX wrapper and the JAX
    package's NumPy coefficient pack (pack_pairhmm_batch, unsorted and
    unpadded lanes) give the same planes, codes and y0."""
    tcs = gen_pairhmm_pairs(np.random.default_rng(rows + n), n, max_read_len=rows - 1,
                            max_hap_len=cols)
    flat = native._flat_pairs(tcs, rows, cols, 0)[:10]
    ctx = PairHMMContext(np.float32)
    tables = (ctx.ph2pr, ctx.match_to_match, ctx.initial_constant)
    big_f, big_i = native.pairhmm_pack_flat_f32(*flat, rows, cols, *tables)
    assert big_f.shape == (8 * rows + 1, n) and big_f.dtype == np.float32
    assert big_i.shape == (2 * rows + cols, n) and big_i.dtype == np.int32
    monkeypatch.setattr(jax_native, "get_lib", native.get_lib)
    want_f, want_i = jax_native.pairhmm_pack_flat_f32(*flat, rows, cols, *tables)
    assert big_f.tobytes() == want_f.tobytes() and big_i.tobytes() == want_i.tobytes()
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    arrs = jax_pack.pack_pairhmm_batch(tcs, rows=rows, cols=cols, dtype=np.float32,
                                       lane_multiple=1).arrays()
    np.testing.assert_array_equal(big_f[: 8 * rows], np.concatenate(arrs[:8]))
    np.testing.assert_array_equal(big_i, np.concatenate(arrs[8:10]))
    np.testing.assert_array_equal(big_f[8 * rows], arrs[10])
    # into given buffers (views of a staging buffer), and refusing wrong ones
    out_f = np.zeros_like(big_f)
    out_i = np.zeros_like(big_i)
    native.pairhmm_pack_flat_f32(*flat, rows, cols, *tables, out_f=out_f, out_i=out_i)
    assert out_f.tobytes() == big_f.tobytes() and out_i.tobytes() == big_i.tobytes()
    with pytest.raises(ValueError, match="out buffers"):
        native.pairhmm_pack_flat_f32(*flat, rows, cols, *tables, out_f=out_f[:-1],
                                     out_i=out_i)


# the crossover cases of tests/test_hybrid_dispatch.py: (model, cells, bytes,
# device_worthwhile)
MODELS = dict(
    many_core_host=dict(host_gcups=0.35, device_gcups=55, link_gb_s=0.05, fixed_s=0.06,
                        cores=24),
    pcie_device=dict(host_gcups=0.35, device_gcups=55, link_gb_s=12.0, fixed_s=0.001,
                     cores=1),
    fixed=dict(host_gcups=0.35, device_gcups=55, link_gb_s=1.0, fixed_s=0.06, cores=1),
    fast_host=dict(host_gcups=35.0, device_gcups=55, link_gb_s=1.0, fixed_s=0.06, cores=1),
)


@pytest.mark.parametrize("model,cells,nbytes,worthwhile", [
    ("many_core_host", 5_000_000, 130_000, False),
    ("pcie_device", 5_000_000, 130_000, True),
    ("fixed", 1_000_000, 25_000, False),
    ("fixed", 400_000_000, 10_000_000, True),
    ("fast_host", 400_000_000, 10_000_000, False),
])
def test_cost_model_crossover_matches_jax(model, cells, nbytes, worthwhile):
    mine = DispatchCostModel(**MODELS[model])
    theirs = jax_engine_module.DispatchCostModel(**MODELS[model])
    assert mine.device_worthwhile(cells, nbytes) is worthwhile
    assert theirs.device_worthwhile(cells, nbytes) is worthwhile
    assert mine.host_s(cells) == theirs.host_s(cells)
    assert mine.device_s(cells, nbytes) == theirs.device_s(cells, nbytes)


def test_cost_model_crossover_bisection_matches_jax():
    """The crossover in cells by the bisection of
    benchmarks/pairhmm_e2e_bench.py:181-190 is the same on both models."""
    def crossover(m):
        lo, hi = 1_000, 10_000_000_000
        while hi / lo > 1.01:
            mid = int((lo * hi) ** 0.5)
            if m.device_worthwhile(mid, mid // 40):
                hi = mid
            else:
                lo = mid
        return hi

    for kw in MODELS.values():
        assert crossover(DispatchCostModel(**kw)) == crossover(
            jax_engine_module.DispatchCostModel(**kw))


def test_from_e2e_bench_matches_jax():
    res = dict(cells=3_400_000_000, n_batches=8, link_gcups=120.0, device_gcups=95.0,
               host_gcups=0.42, single_batch_latency_s=0.011)
    mine = DispatchCostModel.from_e2e_bench(res, cores=8)
    theirs = jax_engine_module.DispatchCostModel.from_e2e_bench(res, cores=8)
    assert dataclasses.asdict(mine) == {k: getattr(theirs, k) for k in MODEL_KEYS}
    # without the host keys: the port's own defaults, not JAX's tunnel figures
    part = DispatchCostModel.from_e2e_bench(
        {k: v for k, v in res.items() if k not in ("host_gcups", "single_batch_latency_s")},
        cores=8)
    assert part.host_gcups == DispatchCostModel.host_gcups
    assert part.fixed_s == pytest.approx(DispatchCostModel.fixed_s)


@pytest.mark.parametrize("route", ["host", "device"])
def test_calibrated_routing_matches_jax(route, rng, jax_native_on_port_lib):
    """Opposite cost models route the same batch to the host or the card,
    in both packages, every result within 5e-3 of the oracle."""
    tcs = gen_pairhmm_pairs(rng, 12, max_read_len=40, max_hap_len=90)
    kw = (dict(host_gcups=100.0, device_gcups=1e-3, fixed_s=10.0, link_gb_s=1e-4)
          if route == "host" else
          dict(host_gcups=1e-4, device_gcups=100.0, fixed_s=0.0, link_gb_s=100.0))
    port = PairHMMEngine(device="cpu")
    port.set_cost_model(DispatchCostModel(**kw))
    jax_eng = jax_engine_module.PairHMMEngine(use_pallas=False)
    jax_eng.set_cost_model(jax_engine_module.DispatchCostModel(**kw))
    got, want = port.compute_pairs(tcs), jax_eng.compute_pairs(tcs)
    host_calls = int(route == "host")
    assert port.stats.get("host_native_calls", 0) == host_calls
    assert jax_eng.stats.get("host_native_calls", 0) == host_calls
    assert (port.stats["device_calls"] >= 1) == (route == "device")
    np.testing.assert_allclose(got, _oracle(tcs), rtol=5e-3)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    port.set_cost_model(None)  # the static gate again: 12 small pairs on the host
    port.compute_pairs(tcs)
    assert port.stats.get("host_native_calls", 0) == host_calls + 1


def test_calibrate_dispatch_measures_host_and_link():
    eng = PairHMMEngine(device="cpu")
    default = eng.calibrate_dispatch()  # the card's constants measured on an H100
    assert (default.device_gcups, default.fixed_s) == (
        DispatchCostModel.device_gcups, DispatchCostModel.fixed_s)
    model = eng.calibrate_dispatch(device_gcups=50.0, fixed_s=2e-4)
    assert eng.cost_model is model
    assert model.device_gcups == 50.0 and model.fixed_s == 2e-4
    # the native forward's measured rate is already the whole host's
    assert model.host_gcups > 0 and model.link_gb_s > 0 and model.cores == 1
    # the gate now decides by the model: a huge fixed cost sends all home
    eng.set_cost_model(dataclasses.replace(model, fixed_s=1e9))
    eng.compute_pairs(gen_pairhmm_pairs(np.random.default_rng(1), 4))
    assert eng.stats.get("host_native_calls", 0) == 1 and eng.stats["device_calls"] == 0


def test_f32_upload_matches_jax_interpret(rng, jax_native_on_port_lib):
    """tests/test_pairhmm_flat.py:82-105's 50 pairs: the port's f32 route
    against its byte-plane route (gather within rtol 1e-6, arith 2e-4) and
    against the JAX engine's f32 route (Pallas, interpret mode)."""
    tcs = gen_pairhmm_pairs(rng, 50, max_read_len=30, max_hap_len=60)
    flat = _flatten(tcs)
    outs = {}
    for mode in ("quals", "quals_arith", "f32"):
        cfg = PairHMMConfig(
            read_buckets=(32,), hap_buckets=(64,),
            upload="f32" if mode == "f32" else "quals",
            quals_expand="arith" if mode == "quals_arith" else "gather",
        )
        eng = PairHMMEngine(cfg, device="cpu")
        outs[mode] = eng.compute_pairs_flat(*flat)
        assert eng.stats["device_calls"] == 1 and eng.stats["h2d_bytes"] > 0
        if mode == "f32":
            # planes, codes and y0 of one 50-lane bucket, staged once
            assert eng.stats["h2d_bytes"] == 4 * 50 * (8 * 32 + 1 + 2 * 32 + 64)
    np.testing.assert_allclose(outs["quals"], outs["f32"], rtol=1e-6)
    np.testing.assert_allclose(outs["quals_arith"], outs["f32"], rtol=2e-4)
    np.testing.assert_allclose(outs["f32"], _oracle(tcs), rtol=5e-3)
    jcfg = JaxPairHMMConfig(read_buckets=(32,), hap_buckets=(64,), upload="f32")
    jax_eng = jax_engine_module.PairHMMEngine(jcfg, use_pallas=True)
    jax_eng._interpret = True
    want = jax_eng.compute_pairs_flat(*flat)
    np.testing.assert_allclose(outs["f32"], want, rtol=1e-6)


def test_f32_upload_with_host_fallback_and_stream(rng):
    """The f32 route beside oversize pairs on the host, several buckets a
    batch, and the pipelined stream, against the byte-plane route."""
    tcs = gen_pairhmm_pairs(rng, 30, max_read_len=60, max_hap_len=120)
    tcs += gen_pairhmm_pairs(rng, 3, max_read_len=90, max_hap_len=120)
    batches = [_flatten(tcs), _flatten(tcs[:17])]
    outs = {}
    for upload in ("quals", "f32"):
        cfg = PairHMMConfig(read_buckets=(32, 64), hap_buckets=(64, 128), upload=upload,
                            quals_expand="gather")
        eng = PairHMMEngine(cfg, device="cpu")
        outs[upload] = eng.compute_pairs_flat_stream(batches)
        assert eng.stats["device_calls"] >= 4
    assert eng.stats["host_fallback"] > 0
    for a, b in zip(outs["quals"], outs["f32"]):
        np.testing.assert_allclose(b, a, rtol=1e-6)
    np.testing.assert_allclose(outs["f32"][0], _oracle(tcs), rtol=5e-3)


def test_f32_upload_raises_without_native_pack(rng, monkeypatch):
    eng = PairHMMEngine(PairHMMConfig(upload="f32"), device="cpu")
    monkeypatch.setattr(native, "pairhmm_pack_flat_f32", lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="f32"):
        eng.compute_pairs_flat(*_flatten(gen_pairhmm_pairs(rng, 4)))
    with pytest.raises(ValueError, match="upload"):
        PairHMMEngine(PairHMMConfig(upload="f16"), device="cpu")
