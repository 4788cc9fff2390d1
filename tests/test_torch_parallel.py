"""The port's mesh path against the JAX package's, on CPU meshes.

Port meshes repeat ``torch.device("cpu")`` (the counterpart of the JAX
tests' eight virtual CPU devices, tests/conftest.py); the JAX side runs on
those virtual devices.  Cases are tests/test_parallel.py's,
tests/test_hybrid_dispatch.py's SP cases and tests/test_sharded_kernels.py's.
Tolerances: the PairHMM forms rtol 1e-5 against the JAX forms and the
single-device forward (SP sums a partial per shard, DP sums in column
order); the byte-plane SP form against the JAX form on the fp32 pack of
the same pairs rtol 2e-4 with the arith expansion (the host packs its
coefficients from float64 tables) and 1e-5 with gather (the host's own
tables); the engines' likelihoods rtol 1e-5 against the JAX engine and
5e-3 against the fp64 oracle; the SMEM, extension and SW forms exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acc_genomics_tpu.config import PairHMMConfig as JaxPairHMMConfig
from acc_genomics_tpu.engine.bucketing import plan_buckets as jax_plan_buckets
from acc_genomics_tpu.engine.genomics_engine import GenomicsEngine as JaxGenomicsEngine
from acc_genomics_tpu.engine.pairhmm_engine import PairHMMEngine as JaxPairHMMEngine
from acc_genomics_tpu.io.synth import (
    gen_pairhmm_input,
    gen_pairhmm_pairs,
    gen_reference_with_repeats,
    gen_smem_reads,
)
from acc_genomics_tpu.ops.extend.jax_impl import sw_extend_batch
from acc_genomics_tpu.ops.pairhmm.context import PairHMMContext
from acc_genomics_tpu.ops.pairhmm.jax_impl import forward_from_pack
from acc_genomics_tpu.ops.pairhmm.pack import pack_pairhmm_batch
from acc_genomics_tpu.ops.pairhmm.reference import pairhmm_oracle
from acc_genomics_tpu.ops.smem.index import FMIndex as JaxFMIndex
from acc_genomics_tpu.ops.smem.machine import device_index_fused, intervals_to_dicts
from acc_genomics_tpu.ops.sw.jax_impl import sw_backtrack_slim
from acc_genomics_tpu.parallel import make_mesh as jax_make_mesh
from acc_genomics_tpu.parallel import pairhmm_forward_dp as jax_forward_dp
from acc_genomics_tpu.parallel.sharded import pairhmm_forward_dpsp_pallas
from acc_genomics_tpu.parallel.sharded_kernels import (
    smem_collect_dp as jax_smem_dp,
    sw_fill_dp as jax_sw_fill_dp,
)
from acc_genomics_tpu_torch.config import PairHMMConfig
from acc_genomics_tpu_torch.engine.bucketing import plan_buckets
from acc_genomics_tpu_torch.engine.genomics_engine import GenomicsEngine
from acc_genomics_tpu_torch.engine.pairhmm_engine import PairHMMEngine, sp_chunk_rows
from acc_genomics_tpu_torch.ops.extend.kernel import KEYS, sw_extend_rows
from acc_genomics_tpu_torch.ops.pairhmm import band_kernel as BK
from acc_genomics_tpu_torch.ops.pairhmm.context import PairHMMContext as PortContext
from acc_genomics_tpu_torch.ops.pairhmm.convert import context_tables, quals_to_torch
from acc_genomics_tpu_torch.ops.pairhmm.pack import pack_pairhmm_quals
from acc_genomics_tpu_torch.ops.smem.index import FMIndex
from acc_genomics_tpu_torch.ops.smem.kernel import smem_collect
from acc_genomics_tpu_torch.ops.smem.table import DeviceIndex
from acc_genomics_tpu_torch.ops.sw.batch import pack_planes, sw_align_batch_decode
from acc_genomics_tpu_torch.ops.sw.kernel import sw_fill, sw_walk
from acc_genomics_tpu_torch.parallel import (
    make_mesh,
    pairhmm_forward_dp,
    pairhmm_forward_dpsp,
    pairhmm_forward_dpsp_from_quals,
)
from acc_genomics_tpu_torch.parallel.mesh import lane_groups
from acc_genomics_tpu_torch.parallel.sharded_kernels import (
    replicate_index,
    smem_collect_dp,
    sw_device_dp,
    sw_extend_dp,
    sw_fill_dp,
)
from acc_genomics_tpu_torch.utils.timer import timers

CPU = torch.device("cpu")
LANES_JAX = 128  # the JAX Pallas forms take lanes in blocks of 128
FIELDS = ("x0", "x1", "s", "start", "end")


def _mesh(shape):
    return make_mesh(shape, devices=[CPU] * 8)


def _pack(rng, n, rows=16, cols=32):
    tcs = gen_pairhmm_pairs(rng, n, max_read_len=rows - 1, max_hap_len=cols)
    return pack_pairhmm_batch(tcs, rows=rows, cols=cols, dtype=np.float32)


def _torch(pack):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in pack.arrays()]


# -- mesh --------------------------------------------------------------------


def test_make_mesh_shape_and_repeats():
    mesh = _mesh((2, 4))
    assert mesh.shape == {"data": 2, "seq": 4}
    assert mesh.axis_names == ("data", "seq")
    assert mesh.devices.shape == (2, 4) and mesh.first_device == CPU
    assert mesh.distinct_devices() == [CPU]
    with pytest.raises(ValueError, match="need 8 devices, have 3"):
        make_mesh((2, 4), devices=[CPU] * 3)


def test_make_mesh_without_devices_takes_cuda_and_raises_without(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="need 4 devices, have 0"):
        make_mesh((1, 4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        make_mesh((1, 1), devices=["cuda"])


@pytest.mark.parametrize("n,parts", [(16, 8), (10, 4), (3, 8), (0, 2)])
def test_lane_groups_cover_in_order(n, parts):
    groups = lane_groups(n, parts)
    assert len(groups) == parts
    assert [lo for lo, _ in groups] == [0] + [hi for _, hi in groups[:-1]]
    assert groups[-1][1] == n
    sizes = [hi - lo for lo, hi in groups]
    assert max(sizes) - min(sizes) <= 1


# -- PairHMM forms -----------------------------------------------------------

# tests/test_parallel.py:31-80: (mesh, lanes, rows, cols)
SP_CASES = {
    "2x4_128": ((2, 4), 128, 16, 32),
    "2x4_256": ((2, 4), 256, 16, 32),
    "1x8_multichunk": ((1, 8), 128, 24, 64),
    "1x8_seq_only": ((1, 8), 128, 16, 64),
}


@pytest.mark.parametrize("case", sorted(SP_CASES))
def test_dpsp_matches_jax_band_pipeline_and_single(case):
    shape, lanes, rows, cols = SP_CASES[case]
    pack = _pack(np.random.default_rng(0), lanes, rows, cols)
    before = dict(BK.LAUNCHES)
    got = pairhmm_forward_dpsp(_mesh(shape), *_torch(pack)).numpy()
    assert dict(BK.LAUNCHES) == before  # the CPU runs the plain version
    args = [jnp.asarray(v) for v in pack.arrays()]
    want = np.asarray(pairhmm_forward_dpsp_pallas(jax_make_mesh(shape), *args,
                                                  interpret=True))
    single = np.asarray(forward_from_pack(pack))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, single, rtol=1e-5)


def test_dpsp_chunk_size_changes_no_bit():
    """C changes no bit of the result: every cell sees the same inputs."""
    pack = _pack(np.random.default_rng(1), 64, 32, 64)
    mesh = _mesh((2, 2))
    by_c = [pairhmm_forward_dpsp(mesh, *_torch(pack), C=c) for c in (8, 16, 32)]
    assert all(torch.equal(by_c[0], x) for x in by_c[1:])


def test_dpsp_rejects_bad_geometry():
    args = _torch(_pack(np.random.default_rng(2), 8, 16, 32))
    with pytest.raises(ValueError, match="chunk size"):
        pairhmm_forward_dpsp(_mesh((1, 2)), *args, C=12)
    with pytest.raises(ValueError, match="seq shards"):
        pairhmm_forward_dpsp(_mesh((1, 3)), *args)
    with pytest.raises(ValueError, match="data shards"):
        pairhmm_forward_dpsp(_mesh((3, 1)), *args)


@pytest.mark.parametrize("expand,rtol", [("arith", 2e-4), ("gather", 1e-5)])
@pytest.mark.parametrize("case", ["2x4_128", "1x8_multichunk"])
def test_dpsp_from_quals_matches_jax_band_pipeline(case, expand, rtol):
    """The byte-plane SP form against the JAX Pallas pipeline on the fp32
    pack of the same pairs (lanes padded alike)."""
    shape, lanes, rows, cols = SP_CASES[case]
    tcs = gen_pairhmm_pairs(np.random.default_rng(3), lanes, max_read_len=rows - 1,
                            max_hap_len=cols)
    qp = pack_pairhmm_quals(tcs, rows=rows, cols=cols, lane_multiple=LANES_JAX)
    ph2pr, m2m, _ = context_tables(PortContext(np.float32), CPU)
    ic = float(PortContext(np.float32).initial_constant)
    got = pairhmm_forward_dpsp_from_quals(_mesh(shape), *quals_to_torch(qp, CPU), ph2pr, m2m,
                                          ic, expand=expand).numpy()
    pack = pack_pairhmm_batch(tcs, rows=rows, cols=cols, dtype=np.float32)
    want = np.asarray(pairhmm_forward_dpsp_pallas(
        jax_make_mesh(shape), *[jnp.asarray(v) for v in pack.arrays()], interpret=True))
    assert got.shape == want.shape and (want[:lanes] > 0).all()
    np.testing.assert_allclose(got, want, rtol=rtol)


@pytest.mark.parametrize("rows", [16, 48])
def test_dpsp_chunk_rows_follow_the_read_bucket(rows):
    """A largest read bucket that 32 does not divide runs at the largest C
    of CHUNK_ROWS that does."""
    assert sp_chunk_rows(rows) == 16
    assert sp_chunk_rows(64) == 32 and sp_chunk_rows(24) == 8
    with pytest.raises(ValueError, match="chunk size"):
        sp_chunk_rows(20)


@pytest.mark.parametrize("rows", [16, 48])
def test_engine_sp_route_with_read_buckets_32_does_not_divide(rows):
    """The engine on a (1, 2) mesh with read_buckets=(16,) or (48,) (which
    raised while the SP route ran a fixed C = 32) against the JAX engine
    on the same 8 pairs, haplotypes of 100 past hap_buckets=(64,)."""
    rng = np.random.default_rng(rows)
    ln = rows - 3
    tcs = []
    for _ in range(8):
        hap = rng.integers(0, 4, 100).astype(np.uint8)
        tcs.append(dict(rs=hap[10:10 + ln].copy(),
                        q=rng.integers(20, 40, ln).astype(np.uint8),
                        i=np.full(ln, 40, np.uint8), d=np.full(ln, 40, np.uint8),
                        c=np.full(ln, 10, np.uint8), hap=hap))
    cfg = dict(read_buckets=(rows,), hap_buckets=(64,))
    port = PairHMMEngine(PairHMMConfig(**cfg), device="cpu", mesh=_mesh((1, 2)))
    port.min_device_cells = 0
    got = port.compute_pairs(tcs)
    assert port.stats["sp_pairs"] == 8 and port.stats["sp_chunk_rows"] == 16
    jax_eng = JaxPairHMMEngine(JaxPairHMMConfig(**cfg), use_pallas=True,
                               mesh=jax_make_mesh((1, 2)))
    jax_eng._interpret = True
    jax_eng.min_device_cells = 0
    np.testing.assert_allclose(got, jax_eng.compute_pairs(tcs), rtol=1e-5)
    np.testing.assert_allclose(got, _oracle(tcs), rtol=5e-3)


def test_dp_matches_jax_dp():
    pack = _pack(np.random.default_rng(0), 256)
    got = pairhmm_forward_dp(_mesh((8, 1)), *_torch(pack)).numpy()
    want = np.asarray(jax_forward_dp(jax_make_mesh((8, 1)),
                                     *[jnp.asarray(v) for v in pack.arrays()]))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(forward_from_pack(pack)), rtol=1e-5)


# -- PairHMMEngine(mesh=...) --------------------------------------------------


def _sp_pairs(seed):
    """tests/test_hybrid_dispatch.py:95-185: haps of 50, 100 and 120 with
    a 64-column bucket, reads of 30."""
    rng = np.random.default_rng(seed)
    tcs = []
    for hl in (50, 100, 120):
        ln = 30
        hap = rng.integers(0, 4, hl).astype(np.uint8)
        tcs.append(dict(
            rs=np.resize(hap, ln).copy(),
            q=np.clip(rng.normal(30, 5, ln), 6, 127).astype(np.uint8),
            i=np.clip(rng.normal(40, 1, ln), 1, 127).astype(np.uint8),
            d=np.clip(rng.normal(40, 1, ln), 1, 127).astype(np.uint8),
            c=np.full(ln, 10, np.uint8),
            hap=hap,
        ))
    return tcs


def _oracle(tcs):
    ctx64 = PairHMMContext(np.float64)
    return np.array([np.log10(pairhmm_oracle(t["rs"], t["q"], t["i"], t["d"], t["c"],
                                             t["hap"], np.float64))
                     - ctx64.log10_initial_constant for t in tcs])


def _flat(tcs):
    cat = lambda key: np.concatenate([np.asarray(t[key], np.uint8) for t in tcs])
    return (cat("rs"), cat("q"), cat("i"), cat("d"), cat("c"),
            np.array([len(t["rs"]) for t in tcs], np.int32), cat("hap"),
            np.array([len(t["hap"]) for t in tcs], np.int32))


@pytest.mark.parametrize("seed", [5, 6])
def test_engine_routes_long_haps_to_sp(seed):
    cfg = dict(read_buckets=(32,), hap_buckets=(64,))
    tcs = _sp_pairs(seed)
    port = PairHMMEngine(PairHMMConfig(**cfg), device="cpu", mesh=_mesh((4, 2)))
    port.min_device_cells = 0
    before = timers()
    got = port.compute_pairs(tcs)
    spans = {k: v["count"] - before.get(k, {"count": 0})["count"] for k, v in timers().items()}
    assert port.stats["sp_pairs"] == 2 and port.stats.get("host_fallback", 0) == 0
    assert spans["pairhmm.sp_pack"] == 1 and spans["pairhmm.fetch"] == 1
    jax_eng = JaxPairHMMEngine(JaxPairHMMConfig(**cfg), use_pallas=True,
                               mesh=jax_make_mesh((4, 2)))
    jax_eng._interpret = True
    jax_eng.min_device_cells = 0
    np.testing.assert_allclose(got, jax_eng.compute_pairs(tcs), rtol=1e-5)
    np.testing.assert_allclose(got, _oracle(tcs), rtol=5e-3)
    assert jax_eng.stats["sp_pairs"] == 2
    for key in ("pairs", "cells", "device_calls", "recomputed"):
        assert port.stats[key] == jax_eng.stats[key], key
    # the flat entry points take the dict path on a mesh
    flat = port.compute_pairs_flat(*_flat(tcs))
    np.testing.assert_array_equal(flat, got)
    assert port.stats["sp_pairs"] == 4


def test_engine_mesh_edges():
    """A hap past max_hap_len x seq and a read past max_read_len go to the
    host; fitting pairs run data-parallel; results within 5e-3 of the
    oracle, and the matrix entry points agree."""
    cfg = PairHMMConfig(read_buckets=(32,), hap_buckets=(64,))
    tcs = _sp_pairs(7)
    tcs.append(dict(tcs[1], hap=np.resize(tcs[1]["hap"], 129)))  # > 64 x 2
    long_read = {k: np.resize(v, 40) for k, v in tcs[0].items() if k != "hap"}
    tcs.append(dict(long_read, hap=tcs[0]["hap"]))  # read past 31
    eng = PairHMMEngine(cfg, device="cpu", mesh=_mesh((4, 2)))
    eng.min_device_cells = 0
    got = eng.compute_pairs(tcs)
    assert eng.stats["sp_pairs"] == 2 and eng.stats["host_fallback"] == 2
    assert eng.stats["device_calls"] == 1
    np.testing.assert_allclose(got, _oracle(tcs), rtol=5e-3)

    rng = np.random.default_rng(8)
    reads, haps = gen_pairhmm_input(rng, 4, 3, max_read_len=30, max_hap_len=120,
                                    derived=True)
    eng = PairHMMEngine(cfg, device="cpu", mesh=_mesh((2, 4)))
    eng.min_device_cells = 0
    mat = eng.compute_matrix(reads, haps)
    rl = np.array([len(r["rs"]) for r in reads], np.int32)
    hl = np.array([len(h) for h in haps], np.int32)
    cat = lambda key: np.concatenate([r[key] for r in reads])
    flat = eng.compute_matrix_flat(cat("rs"), cat("q"), cat("i"), cat("d"), cat("c"),
                                   rl, np.concatenate(haps), hl)
    np.testing.assert_array_equal(mat, flat)
    want = _oracle([dict(hap=h, **r) for r in reads for h in haps]).reshape(mat.shape)
    np.testing.assert_allclose(mat, want, rtol=5e-3)


# -- the data-parallel forms of SMEM, extension and SW ------------------------


def test_smem_dp_matches_single_and_jax_dp():
    """tests/test_sharded_kernels.py:18-38."""
    rng = np.random.default_rng(0)
    genome = gen_reference_with_repeats(rng, 1200)
    reads = gen_smem_reads(rng, genome, 16, read_len=60)
    seq = np.full((64, 16), 4, np.uint8)
    lens = np.zeros(16, np.int32)
    for k, r in enumerate(reads):
        seq[: len(r), k] = r
        lens[k] = len(r)
    fm = FMIndex.build(genome)
    mesh = _mesh((8, 1))
    got = smem_collect_dp(mesh, replicate_index(mesh, fm), torch.from_numpy(seq),
                          torch.from_numpy(lens))
    single = smem_collect(DeviceIndex.build(fm, CPU), torch.from_numpy(seq),
                          torch.from_numpy(lens))
    assert all(torch.equal(a, b) for a, b in zip(got, single))
    mem8, n8, _ = jax_smem_dp(jax_make_mesh((8, 1)), device_index_fused(JaxFMIndex.build(genome)),
                              jnp.asarray(seq.astype(np.int32)), jnp.asarray(lens))
    want = intervals_to_dicts(np.stack([np.asarray(m) for m in mem8]), np.asarray(n8), 16)
    mem, n, flag = (x.numpy() for x in got[:3])
    assert flag.sum() < 16
    for k in np.flatnonzero(flag == 0):  # a flagged read reruns on the host
        port = sorted(tuple(int(v) for v in mem[:, j, k]) for j in range(n[k]))
        assert port == sorted(tuple(iv[f] for f in FIELDS) for iv in want[k]), k


def test_extend_dp_matches_single_and_jax():
    """tests/test_sharded_kernels.py:111-124."""
    rng = np.random.default_rng(0)
    B, Q, T = 16, 32, 48
    q = rng.integers(0, 4, (Q, B)).astype(np.int32)
    t = rng.integers(0, 4, (T, B)).astype(np.int32)
    qlen, tlen, h0 = (np.full(B, v, np.int32) for v in (Q, T, 20))
    args = [torch.from_numpy(v) for v in (q.astype(np.uint8), t.astype(np.uint8),
                                          qlen, tlen, h0, qlen, qlen)]
    got = sw_extend_dp(_mesh((8, 1)), *args)
    assert torch.equal(got, sw_extend_rows(*args))
    want = sw_extend_batch(*[jnp.asarray(v) for v in (q, t, qlen, tlen, h0, qlen, qlen)])
    for r, key in enumerate(KEYS):
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(want[key]), err_msg=key)


def test_sw_device_dp_matches_single_and_jax_fill_dp():
    """tests/test_sharded_kernels.py:127-140: the fill of the JAX DP form,
    walked on the host by the JAX walker, against the port's DP device
    path (fill and walk), decoded."""
    rng = np.random.default_rng(0)
    B, R, C = 8, 24, 32
    refs = [rng.integers(0, 4, R).astype(np.uint8) for _ in range(B)]
    alts = [rng.integers(0, 4, C).astype(np.uint8) for _ in range(B)]
    ref, alt = np.empty((B, R), np.uint8), np.empty((B, C), np.uint8)
    rl, al = pack_planes(refs, R, ref), pack_planes(alts, C, alt)
    targs = [torch.from_numpy(x) for x in (ref, alt, rl, al)]
    for strategy in (0, 1, 2, 3):
        packed = sw_device_dp(_mesh((8, 1)), *targs, strategy)
        assert torch.equal(packed, sw_walk(*sw_fill(*targs, strategy), targs[2], targs[3],
                                           strategy))
        got = sw_align_batch_decode(packed.numpy(), refs, alts, strategy)
        bt, lr, ac = (np.asarray(x) for x in jax_sw_fill_dp(
            jax_make_mesh((8, 1)), *[jnp.asarray(v) for v in (ref.T.astype(np.int32),
                                                              alt.T.astype(np.int32), rl, al)],
            strategy))
        bt, lr, ac = bt.transpose(2, 0, 1), lr.T, ac.T
        want = [sw_backtrack_slim(bt[j], lr[j], ac[j], R, C, strategy) for j in range(B)]
        assert [(list(map(tuple, c)), o) for c, o in got] == \
            [(list(map(tuple, c)), o) for c, o in want], strategy


@pytest.mark.parametrize("strategy", [0, 1, 2, 3])
def test_sw_fill_dp_matches_single_and_jax_fill_dp(strategy):
    """tests/test_sharded_kernels.py:127-140's fill alone: the port's
    triple (pairs first, its own layout) against the single-device fill
    and, inside each pair's region, the JAX DP fill."""
    rng = np.random.default_rng(strategy)
    B, R, C = 8, 24, 32
    refs = [rng.integers(0, 4, n).astype(np.uint8) for n in rng.integers(1, R + 1, B)]
    alts = [rng.integers(0, 4, n).astype(np.uint8) for n in rng.integers(1, C + 1, B)]
    ref, alt = np.empty((B, R), np.uint8), np.empty((B, C), np.uint8)
    rl, al = pack_planes(refs, R, ref), pack_planes(alts, C, alt)
    targs = [torch.from_numpy(x) for x in (ref, alt, rl, al)]
    got = sw_fill_dp(_mesh((8, 1)), *targs, strategy)
    assert all(torch.equal(a, b) for a, b in zip(got, sw_fill(*targs, strategy)))
    btrack, lastrow, altcol = (x.numpy() for x in got)
    w_bt, w_last, w_col = (np.asarray(x) for x in jax_sw_fill_dp(
        jax_make_mesh((8, 1)), *[jnp.asarray(v) for v in (ref.T.astype(np.int32),
                                                          alt.T.astype(np.int32), rl, al)],
        strategy))
    for b in range(B):
        i, j = np.meshgrid(np.arange(rl[b]), np.arange(al[b]), indexing="ij")
        np.testing.assert_array_equal(btrack[b, i + j, i], w_bt[i, j, b])
        np.testing.assert_array_equal(lastrow[b, : al[b]], w_last[1 : al[b] + 1, b])
        np.testing.assert_array_equal(altcol[b, : rl[b]], w_col[: rl[b], b])


@pytest.mark.parametrize("lane_pad", [1, 8, 128])
def test_bucket_plan_shapes_and_padded_cells_match_jax(lane_pad):
    rng = np.random.default_rng(lane_pad)
    read_lens = rng.integers(1, 150, 300).tolist()
    hap_lens = rng.integers(1, 500, 300).tolist()
    buckets = ((32, 64, 96, 160), (128, 256, 512))
    got = plan_buckets(read_lens, hap_lens, *buckets)
    want = jax_plan_buckets(read_lens, hap_lens, *buckets)
    assert got.shapes == want.shapes and len(got.shapes) > 4
    assert got.padded_cells(lane_pad) == want.padded_cells(lane_pad)
    assert got.padded_cells() == want.padded_cells()


# -- GenomicsEngine(mesh=...) --------------------------------------------------


def test_genomics_engine_on_mesh_matches_jax():
    """tests/test_parallel.py:83-117, against the JAX facade on its mesh
    and the port's facade without one."""
    rng = np.random.default_rng(0)
    em = GenomicsEngine(device="cpu", mesh=_mesh((8, 1)))
    e1 = GenomicsEngine(device="cpu")
    jm = JaxGenomicsEngine(mesh=jax_make_mesh((8, 1)))
    for e in (em, e1, jm):
        e.pairhmm.min_device_cells = 0

    reads, haps = gen_pairhmm_input(rng, 5, 2, max_read_len=25, max_hap_len=40)
    got = em.pairhmm_matrix(reads, haps)
    np.testing.assert_allclose(got, jm.pairhmm_matrix(reads, haps), rtol=1e-5)
    np.testing.assert_allclose(got, e1.pairhmm_matrix(reads, haps), rtol=1e-5)

    genome = gen_reference_with_repeats(rng, 1200)
    em.load_reference(genome)
    e1.load_reference(genome)
    jm.load_reference(genome)
    sreads = gen_smem_reads(rng, genome, 5, read_len=60)
    got = em.smem_collect(sreads)
    assert got == e1.smem_collect(sreads)
    canon = lambda z: sorted(tuple(i[f] for f in FIELDS) for i in z)
    assert [canon(g) for g in got] == [canon(w) for w in jm.smem_collect(sreads)]

    pos = 400
    read = genome[pos: pos + 60].copy()
    seeds = [dict(read=read, rseq=genome[pos - 30: pos + 90], qbeg=20, rbeg_off=50, len=20)]
    got = em.extend_seeds(seeds)
    assert got == e1.extend_seeds(seeds) == jm.extend_seeds(seeds)

    ref = rng.integers(0, 4, 60).astype(np.uint8)
    alts = [np.concatenate([ref[:20], ref[25:]]), ref[:50].copy(), np.roll(ref, 3)]
    assert em.sw_align(ref, alts, 0) == e1.sw_align(ref, alts, 0) == jm.sw_align(ref, alts, 0)
    assert em.mesh is em.pairhmm.mesh is em.sw.mesh is em.extend.mesh is em.smem.mesh
