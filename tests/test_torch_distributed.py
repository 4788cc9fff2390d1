"""The port's process-group forms (``parallel/distributed.py``) in two
processes on the CPU: the counterpart of tests/test_distributed_multiprocess.py.

Two ``tools/pg_run.py`` workers (the port only, ``device="cpu"``) form a
gloo group over a file store in ``tmp_path``, run every form and write
their inputs, gathered results and local parts to ``rank<r>.npz``.  This
process holds them against the JAX package on the same inputs (PairHMM DP:
the JAX test's 16-pair pack, ``forward_from_pack`` rtol 1e-6, local halves
included; DP x SP: ``pairhmm_forward_dpsp_pallas`` in interpret mode on a
(1, 2) mesh, rtol 1e-5 on the fp32 pack and 2e-4 on the byte planes with
the arith expansion, as test_torch_parallel.py holds the single-process
forms; SW, extension and SMEM: the JAX ``*_dp`` forms on the eight-device
CPU mesh, exactly) and against the port's single-process forms (exactly,
DP x SP bit for bit).  A one-rank group in this process checks the forms'
argument errors.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from acc_genomics_tpu.io.synth import gen_pairhmm_pairs
from acc_genomics_tpu.ops.pairhmm.jax_impl import forward_from_pack
from acc_genomics_tpu.ops.pairhmm.pack import pack_pairhmm_batch
from acc_genomics_tpu.ops.smem.index import FMIndex as JaxFMIndex
from acc_genomics_tpu.ops.smem.machine import device_index_fused, intervals_to_dicts
from acc_genomics_tpu.ops.sw.jax_impl import sw_backtrack_slim
from acc_genomics_tpu.parallel import make_mesh as jax_make_mesh
from acc_genomics_tpu.parallel.sharded import pairhmm_forward_dpsp_pallas
from acc_genomics_tpu.parallel.sharded_kernels import (
    smem_collect_dp as jax_smem_dp,
    sw_extend_dp as jax_extend_dp,
    sw_fill_dp as jax_sw_fill_dp,
)
from acc_genomics_tpu_torch.ops.extend.kernel import KEYS
from acc_genomics_tpu_torch.ops.pairhmm.context import PairHMMContext
from acc_genomics_tpu_torch.ops.pairhmm.convert import context_tables
from acc_genomics_tpu_torch.ops.smem.index import FMIndex
from acc_genomics_tpu_torch.ops.sw.batch import sw_align_batch_decode
from acc_genomics_tpu_torch.parallel import distributed as D
from acc_genomics_tpu_torch.parallel import make_mesh
from acc_genomics_tpu_torch.parallel.sharded import (
    pairhmm_forward_dp,
    pairhmm_forward_dpsp,
    pairhmm_forward_dpsp_from_quals,
)
from acc_genomics_tpu_torch.parallel.sharded_kernels import (
    replicate_index,
    smem_collect_dp,
    sw_device_dp,
    sw_extend_dp,
)
from acc_genomics_tpu_torch.tools.pg_run import WORLD, local_lanes, run_ranks

CPU = torch.device("cpu")
FIELDS = ("x0", "x1", "s", "start", "end")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("pg"))
    outs = run_ranks(tmp, "cpu", "small", timeout=120, out=True)
    for r, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {r} failed:\n{out}"
    reports = [json.loads(out.strip().splitlines()[-1]) for _, out in outs]
    files = [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(WORLD)]
    return reports, files


def _inputs(files, name):
    f, out = files[0], []
    while f"in_{name}_{len(out)}" in f:
        out.append(f[f"in_{name}_{len(out)}"])
    return out


def _result(files, name, r=0, part="gathered", j=0):
    return files[r][f"{name}_{part}_{j}"]


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_workers_check_themselves_on_the_cpu(ranks):
    reports, files = ranks
    for r, rep in enumerate(reports):
        assert rep["rank"] == r and rep["device"] == "cpu"
        assert rep["checks"] and all(rep["checks"].values()), rep["checks"]
        assert rep["launches"] == {}  # the CPU runs the plain versions
    for name in reports[0]["checks"]:  # every rank gathers the same result
        assert np.array_equal(_result(files, name, 0), _result(files, name, 1)), name


def test_pairhmm_dp_pg_matches_jax_and_single(ranks):
    _, files = ranks
    tcs = gen_pairhmm_pairs(np.random.default_rng(0), 16, max_read_len=15, max_hap_len=24)
    pack = pack_pairhmm_batch(tcs, rows=16, cols=24, dtype=np.float32, pad_lanes=False)
    arrays = _inputs(files, "dp")
    for a, b in zip(arrays, pack.arrays()):
        np.testing.assert_array_equal(a, np.asarray(b))
    want = np.asarray(forward_from_pack(pack))
    got = _result(files, "pairhmm_dp")
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for r in range(WORLD):  # each process's half
        np.testing.assert_allclose(_result(files, "pairhmm_dp", r, "local"),
                                   want.reshape(WORLD, -1)[r], rtol=1e-6)
    single = pairhmm_forward_dp(make_mesh((WORLD, 1), devices=[CPU] * WORLD),
                                *_torch(arrays)).numpy()
    np.testing.assert_array_equal(got, single)


@pytest.mark.parametrize("form", ["pairhmm_dpsp", "pairhmm_dpsp_quals"])
def test_pairhmm_dpsp_pg_matches_jax_and_single_bit_for_bit(ranks, form):
    _, files = ranks
    tcs = gen_pairhmm_pairs(np.random.default_rng(1), 128, max_read_len=15, max_hap_len=32)
    pack = pack_pairhmm_batch(tcs, rows=16, cols=32, dtype=np.float32)
    for a, b in zip(_inputs(files, "dpsp"), pack.arrays()):
        np.testing.assert_array_equal(a, np.asarray(b))
    want = np.asarray(pairhmm_forward_dpsp_pallas(
        jax_make_mesh((1, WORLD)), *[jnp.asarray(v) for v in pack.arrays()], interpret=True))
    got = _result(files, form)
    assert (want[:len(tcs)] > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5 if form == "pairhmm_dpsp" else 2e-4)
    mesh = make_mesh((1, WORLD), devices=[CPU] * WORLD)
    if form == "pairhmm_dpsp":
        single = pairhmm_forward_dpsp(mesh, *_torch(_inputs(files, "dpsp")))
    else:
        ctx = PairHMMContext(np.float32)
        ph2pr, m2m, _ = context_tables(ctx, CPU)
        single = pairhmm_forward_dpsp_from_quals(mesh, *_torch(_inputs(files, "dpsp_quals")),
                                                 ph2pr, m2m, float(ctx.initial_constant))
    np.testing.assert_array_equal(got, single.numpy())
    for r in range(WORLD):  # a (1, 2) grid: both ranks hold the one data group
        lo, hi = local_lanes(form, len(got), r)
        np.testing.assert_array_equal(_result(files, form, r, "local"), got[lo:hi])


@pytest.mark.parametrize("strategy", [0, 1, 2, 3])
def test_sw_device_dp_pg_matches_jax_fill_dp_and_single(ranks, strategy):
    _, files = ranks
    ref, alt, rl, al = _inputs(files, "sw")
    name = f"sw_device_{strategy}"
    got = _result(files, name)
    single = sw_device_dp(make_mesh((WORLD, 1), devices=[CPU] * WORLD),
                          *_torch((ref, alt, rl, al)), strategy)
    np.testing.assert_array_equal(got, single.numpy())
    refs = [ref[b, :rl[b]] for b in range(len(rl))]
    alts = [alt[b, :al[b]] for b in range(len(al))]
    decoded = sw_align_batch_decode(got, refs, alts, strategy)
    bt, lr, ac = (np.asarray(x) for x in jax_sw_fill_dp(
        jax_make_mesh((8, 1)), *[jnp.asarray(v) for v in (ref.T.astype(np.int32),
                                                          alt.T.astype(np.int32), rl, al)],
        strategy))
    bt, lr, ac = bt.transpose(2, 0, 1), lr.T, ac.T
    want = [sw_backtrack_slim(bt[j], lr[j], ac[j], int(rl[j]), int(al[j]), strategy)
            for j in range(len(rl))]
    assert [(list(map(tuple, c)), o) for c, o in decoded] == \
        [(list(map(tuple, c)), o) for c, o in want]
    for r in range(WORLD):
        lo, hi = local_lanes(name, len(rl), r)
        np.testing.assert_array_equal(_result(files, name, r, "local"), got[:, lo:hi])


def test_sw_extend_dp_pg_matches_jax_dp_and_single(ranks):
    _, files = ranks
    arrays = _inputs(files, "extend")
    got = _result(files, "sw_extend")
    single = sw_extend_dp(make_mesh((WORLD, 1), devices=[CPU] * WORLD), *_torch(arrays))
    np.testing.assert_array_equal(got, single.numpy())
    want = jax_extend_dp(jax_make_mesh((8, 1)), *[jnp.asarray(a.astype(np.int32))
                                                  for a in arrays])
    for r, key in enumerate(KEYS):
        np.testing.assert_array_equal(got[r], np.asarray(want[key]), err_msg=key)
    for r in range(WORLD):
        lo, hi = local_lanes("sw_extend", got.shape[1], r)
        np.testing.assert_array_equal(_result(files, "sw_extend", r, "local"), got[:, lo:hi])


def test_smem_collect_dp_pg_matches_jax_dp_and_single(ranks):
    _, files = ranks
    seq, lens = _inputs(files, "smem")
    (genome,) = _inputs(files, "genome")
    assert seq.shape == (64, 16) and len(genome) == 1200
    got = [_result(files, "smem", j=j) for j in range(4)]
    mesh = make_mesh((WORLD, 1), devices=[CPU] * WORLD)
    single = smem_collect_dp(mesh, replicate_index(mesh, FMIndex.build(genome)),
                             *_torch((seq, lens)))
    for g, s in zip(got, single):
        np.testing.assert_array_equal(g, s.numpy())
    mem8, n8, _ = jax_smem_dp(jax_make_mesh((8, 1)), device_index_fused(JaxFMIndex.build(genome)),
                              jnp.asarray(seq.astype(np.int32)), jnp.asarray(lens))
    want = intervals_to_dicts(np.stack([np.asarray(m) for m in mem8]), np.asarray(n8),
                              seq.shape[1])
    mem, n, flag = got[:3]
    assert flag.sum() < seq.shape[1]
    for k in np.flatnonzero(flag == 0):  # a flagged read reruns on the host
        port = sorted(tuple(int(v) for v in mem[:, j, k]) for j in range(n[k]))
        assert port == sorted(tuple(iv[f] for f in FIELDS) for iv in want[k]), k
    for r in range(WORLD):
        lo, hi = local_lanes("smem", seq.shape[1], r)
        for j in range(4):
            np.testing.assert_array_equal(_result(files, "smem", r, "local", j),
                                          got[j][..., lo:hi])


@pytest.fixture
def one_rank_group(tmp_path):
    D.init_group(0, 1, f"file://{tmp_path}/store")
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_one_rank_group_forms_and_their_errors(one_rank_group):
    """A group of one rank is the single-device call; the forms reject
    geometry they cannot cut."""
    rng = np.random.default_rng(3)
    tcs = gen_pairhmm_pairs(rng, 8, max_read_len=15, max_hap_len=32)
    args = _torch([np.ascontiguousarray(a) for a in
                   pack_pairhmm_batch(tcs, rows=16, cols=32, dtype=np.float32).arrays()])
    mesh = make_mesh((1, 1), devices=[CPU])
    assert torch.equal(D.pairhmm_forward_dp_pg(*args), pairhmm_forward_dp(mesh, *args))
    assert torch.equal(D.pairhmm_forward_dpsp_pg(*args, seq=1),
                       pairhmm_forward_dpsp(mesh, *args))
    assert torch.equal(D.pairhmm_forward_dpsp_pg(*args, seq=1, gather=False),
                       pairhmm_forward_dpsp(mesh, *args))
    with pytest.raises(ValueError, match="grid of seq 2"):
        D.pairhmm_forward_dpsp_pg(*args, seq=2)
    with pytest.raises(ValueError, match="chunk size"):
        D.pairhmm_forward_dpsp_pg(*args, seq=1, C=12)
    with pytest.raises(ValueError, match="0 lanes cannot give each of 1 ranks"):
        D.pairhmm_forward_dp_pg(*[a[..., :0] for a in args])
