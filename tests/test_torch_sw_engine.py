"""The port's SWEngine against the JAX SWEngine on the CPU.

The port runs on ``device="cpu"`` (the kernels' plain PyTorch versions on
the engine's own route: buckets, chunks, one fetch, decode, oracle rerun
of element overflows, concurrent native host fallback); the JAX engine
runs its XLA fill and native walk (``use_pallas=False``).  CIGARs and
offsets are exact and the ``stats`` counters equal.
"""

import dataclasses
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from acc_genomics_tpu import native as jax_native
from acc_genomics_tpu.config import SWConfig as JaxSWConfig
from acc_genomics_tpu.engine.sw_engine import SWEngine as JaxEngine
from acc_genomics_tpu.io.synth import gen_sw_batch
from acc_genomics_tpu.ops.sw.reference import sw_align_oracle
from acc_genomics_tpu_torch.config import EngineConfig, SWConfig
from acc_genomics_tpu_torch.engine import sw_engine as engine_module
from acc_genomics_tpu_torch.engine.genomics_engine import GenomicsEngine
from acc_genomics_tpu_torch.engine.sw_engine import SWEngine, chunk_pairs
from acc_genomics_tpu_torch.ops.sw import kernel as K
from acc_genomics_tpu_torch.parallel import make_mesh


def _jax(cfg):
    return JaxSWConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def jax_native_lib(tmp_path_factory):
    """The JAX package's native library, which the JAX engine's host route
    and walk run on: without it that engine answers from the oracle, which
    aligns an empty side differently.  The package builds the library at
    first use with an unlocked ``make`` into its own directory, and a
    process that loads it while another process links it reads a
    half-written file and keeps None for good.  Such a process gets its own
    copy here, built by the package's Makefile into a private directory."""
    if jax_native.get_lib() is not None:
        yield
        return
    src = os.path.dirname(os.path.abspath(jax_native.__file__))
    out = tmp_path_factory.mktemp("jax_native")
    shutil.copy(os.path.join(src, "accnative.cpp"), out)
    try:
        subprocess.run(["make", "-s", "-C", str(out), "-f", os.path.join(src, "Makefile"),
                        "libaccnative.so"], check=True, capture_output=True, text=True)
    except (OSError, subprocess.CalledProcessError) as e:
        pytest.skip(f"the JAX package's native library does not build: "
                    f"{getattr(e, 'stderr', None) or e}")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB_PATH", str(out / "libaccnative.so"))
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_tried", False)
        assert jax_native.get_lib() is not None
        yield


def _fallback_case(rng):
    """test_engines.py's case: six pairs in the buckets, one past them."""
    ref, alts = gen_sw_batch(rng, 6, ref_len=100)
    big_ref, (big_alt,) = gen_sw_batch(rng, 1, ref_len=200)
    return [ref] * 6 + [big_ref], alts + [big_alt], SWConfig(seq_buckets=(64, 128))


def _mixed_buckets(rng):
    refs, alts = [], []
    for ln in (20, 50, 60, 90, 120, 40, 70):
        r, (a,) = gen_sw_batch(rng, 1, ref_len=ln)
        refs.append(r)
        alts.append(a)
    # small max_batch: one bucket splits into several chunks
    return refs, alts, SWConfig(seq_buckets=(64, 128), max_batch=2)


def _overflow(rng):
    ref = rng.integers(0, 4, 96).astype(np.uint8)
    alt = []
    for j, b in enumerate(ref):
        alt.append(b)
        if j % 2 == 0:
            alt.append((b + 1) % 4)
            alt.append((b + 2) % 4)
    r2, (a2,) = gen_sw_batch(rng, 1, ref_len=90)
    return [ref, r2], [np.asarray(alt, np.uint8)[:160], a2], SWConfig(seq_buckets=(96, 192))


CASES = {"host_fallback": _fallback_case, "mixed_buckets_chunked": _mixed_buckets,
         "element_overflow": _overflow}


@pytest.mark.parametrize("strategy", [0, 1, 2, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_align_matches_jax_engine(case, strategy, rng, jax_native_lib):
    refs, alts, cfg = CASES[case](rng)
    port = SWEngine(cfg, device="cpu")
    jax_eng = JaxEngine(_jax(cfg), use_pallas=False)
    got = port.align(refs, alts, strategy)
    assert got == jax_eng.align(refs, alts, strategy)
    assert port.stats == jax_eng.stats
    for r, a, res in zip(refs, alts, got):
        assert res == sw_align_oracle(r, a, strategy)
    if case == "host_fallback":
        assert port.stats["host_fallback"] == 1


def test_chunks_launch_before_one_fetch(monkeypatch, rng):
    refs, alts, cfg = _mixed_buckets(rng)
    launched, fetched = [], []
    real_launch = engine_module.sw_align_batch_launch
    real_decode = engine_module.sw_align_batch_decode

    def launch(*a, **kw):
        assert not fetched, "a launch after the fetch"
        launched.append(len(a[0]))
        return real_launch(*a, **kw)

    def decode(packed, *a, **kw):
        fetched.append(packed.shape[1])
        return real_decode(packed, *a, **kw)

    monkeypatch.setattr(engine_module, "sw_align_batch_launch", launch)
    monkeypatch.setattr(engine_module, "sw_align_batch_decode", decode)
    eng = SWEngine(cfg, device="cpu")
    got = eng.align(refs, alts, 0)
    assert launched == fetched and max(launched) == 2 and sum(launched) == len(refs)
    assert got == [sw_align_oracle(r, a, 0) for r, a in zip(refs, alts)]


def test_align_one_ref_and_empty(rng, jax_native_lib):
    ref, alts = gen_sw_batch(rng, 5, ref_len=60)
    port = SWEngine(SWConfig(seq_buckets=(64,)), device="cpu")
    jax_eng = JaxEngine(JaxSWConfig(seq_buckets=(64,)), use_pallas=False)
    assert port.align_one_ref(ref, alts, 2) == jax_eng.align_one_ref(ref, alts, 2)
    assert port.align([], [], 0) == []
    assert port.stats == jax_eng.stats


def test_chunk_budget():
    """A chunk's btrack stays under the byte budget; results do not depend
    on the split (test_align_matches_jax_engine[mixed_buckets_chunked])."""
    assert chunk_pairs(320, 320, 4096) == 4096
    assert chunk_pairs(1536, 1536, 4096) == engine_module.BTRACK_BUDGET_BYTES // (
        2 * 1536 * 3071) == 455
    assert chunk_pairs(64, 64, 4096) == 4096


def test_engine_raises_without_native_or_card(monkeypatch):
    monkeypatch.setattr(engine_module, "ensure_native", lambda: False)
    with pytest.raises(RuntimeError, match="native"):
        SWEngine(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        SWEngine(device="cuda")


def test_cpu_engine_never_launches(rng):
    ref, alts = gen_sw_batch(rng, 4, ref_len=50)
    before = dict(K.LAUNCHES)
    SWEngine(SWConfig(seq_buckets=(64,)), device="cpu").align_one_ref(ref, alts, 0)
    assert dict(K.LAUNCHES) == before


EMPTY = np.zeros(0, np.uint8)
EMPTY_SIDES = {"ref": lambda r, a: (EMPTY, a), "alt": lambda r, a: (r, EMPTY),
               "both": lambda r, a: (EMPTY, EMPTY)}


@pytest.mark.parametrize("strategy", [0, 1, 2, 3])
@pytest.mark.parametrize("side", sorted(EMPTY_SIDES))
def test_empty_side_aligns_on_the_host_as_the_jax_engine(side, strategy, rng, jax_native_lib):
    """A pair with an empty ref or alt, mixed into a batch of normal pairs,
    runs on the native host engine: ([], 0), the JAX engine's answer on
    its XLA route, counted in host_fallback."""
    ref, alts = gen_sw_batch(rng, 4, ref_len=50)
    refs, alts = [ref] * 4, list(alts)
    for k in (1, 3):
        refs[k], alts[k] = EMPTY_SIDES[side](refs[k], alts[k])
    cfg = SWConfig(seq_buckets=(64,))
    port = SWEngine(cfg, device="cpu")
    jax_eng = JaxEngine(_jax(cfg), use_pallas=False)
    got = port.align(refs, alts, strategy)
    assert got == jax_eng.align(refs, alts, strategy)
    assert got[1] == got[3] == ([], 0)
    assert [got[0], got[2]] == [sw_align_oracle(refs[k], alts[k], strategy) for k in (0, 2)]
    assert port.stats["host_fallback"] == jax_eng.stats["host_fallback"] + 2
    assert dict(port.stats, host_fallback=0) == dict(jax_eng.stats, host_fallback=0)


def test_empty_side_through_align_one_ref_genomics_engine_and_mesh(rng, jax_native_lib):
    ref, alts = gen_sw_batch(rng, 5, ref_len=60)
    alts[2] = EMPTY
    cfg = SWConfig(seq_buckets=(64,))
    jax_eng = JaxEngine(_jax(cfg), use_pallas=False)
    facade = GenomicsEngine(EngineConfig(sw=cfg), device="cpu")
    meshed = SWEngine(cfg, device="cpu", mesh=make_mesh((8, 1), devices=["cpu"] * 8))
    for strategy in (0, 1, 2, 3):
        want = jax_eng.align_one_ref(ref, alts, strategy)
        assert want[2] == ([], 0)
        assert facade.sw_align(ref, alts, strategy) == want
        assert meshed.align_one_ref(ref, alts, strategy) == want
    assert facade.sw.stats["host_fallback"] == meshed.stats["host_fallback"] == 4
    assert facade.sw_align(EMPTY, alts, 1) == jax_eng.align_one_ref(EMPTY, alts, 1) == \
        [([], 0)] * 5
