"""The port's banded extension against the JAX package, on the same inputs.

Inputs come from numpy seeds (``test_extend._rand_tasks``, the cases of
test_extend_pallas.py) and go to both packages.  The port runs its plain
PyTorch version (CPU tensors); the JAX side runs its XLA scan
``jax_impl.sw_extend_batch`` and its Pallas kernel ``sw_extend_pallas`` in
interpret mode, at the shapes test_extend_pallas.py compiles.  All seven
outputs are integers and compared exactly, and against the oracle
``sw_extend_oracle`` task by task.  The CUDA kernel is held against the
plain version in test_torch_gpu.py, which needs a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acc_genomics_tpu.ops.extend.jax_impl import sw_extend_batch
from acc_genomics_tpu.ops.extend.kernel import LANES, sw_extend_pallas
from acc_genomics_tpu.ops.extend.reference import ExtendParams, sw_extend_oracle
from acc_genomics_tpu_torch.ops.extend import kernel as K
from test_extend import KEYS, _rand_tasks


def _pack(tasks, qmax, tmax, lanes=LANES):
    """(Q, Bp) / (T, Bp) int32 codes (pad 4) and (Bp,) lengths and h0, Bp
    the task count rounded up to the Pallas kernel's 128 lanes."""
    bsz = -(-len(tasks) // lanes) * lanes
    q = np.full((qmax, bsz), 4, np.int32)
    t = np.full((tmax, bsz), 4, np.int32)
    ql, tl, h0 = (np.zeros(bsz, np.int32) for _ in range(3))
    for k, x in enumerate(tasks):
        q[: len(x["query"]), k] = x["query"]
        t[: len(x["target"]), k] = x["target"]
        ql[k], tl[k], h0[k] = len(x["query"]), len(x["target"]), x["h0"]
    return q, t, ql, tl, h0


def _seeded(seed):
    return _rand_tasks(np.random.default_rng(seed), 40, maxq=48, maxt=60), 64, 64


def _degenerate():
    rng = np.random.default_rng(0)
    tasks = [
        dict(query=np.zeros(0, np.uint8), target=np.zeros(0, np.uint8), h0=7),
        dict(query=np.zeros(0, np.uint8), target=rng.integers(0, 4, 9).astype(np.uint8), h0=3),
        dict(query=rng.integers(0, 4, 9).astype(np.uint8), target=np.zeros(0, np.uint8), h0=3),
        dict(query=np.full(12, 4, np.uint8), target=rng.integers(0, 4, 12).astype(np.uint8), h0=5),
        dict(query=rng.integers(0, 4, 16).astype(np.uint8),
             target=rng.integers(0, 4, 16).astype(np.uint8), h0=1),
    ]
    return tasks, 32, 32


def _block_rows():
    """Two 128-lane blocks with different target lengths."""
    rng = np.random.default_rng(0)
    tasks = []
    for _ in range(LANES):
        q = rng.integers(0, 4, 24).astype(np.uint8)
        tasks.append(dict(query=q, target=q[:20].copy(), h0=10))
    for _ in range(LANES):
        q = rng.integers(0, 4, 24).astype(np.uint8)
        tasks.append(dict(query=q, target=np.concatenate(
            [q, rng.integers(0, 4, 30).astype(np.uint8)]), h0=10))
    return tasks, 32, 64


CASES = {"seed0": lambda: _seeded(0), "seed1": lambda: _seeded(1),
         "degenerate": _degenerate, "block_rows": _block_rows}


def _port(q, t, ql, tl, h0, params=ExtendParams()):
    tt = torch.from_numpy
    got = K.sw_extend(tt(q), tt(t), tt(ql), tt(tl), tt(h0), tt(ql), tt(ql), params)
    assert set(got) == set(KEYS)
    return {k: v.numpy() for k, v in got.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_and_oracle(case):
    tasks, qmax, tmax = CASES[case]()
    q, t, ql, tl, h0 = _pack(tasks, qmax, tmax)
    got = _port(q, t, ql, tl, h0)
    args = [jnp.asarray(x) for x in (q, t, ql, tl, h0, ql, ql)]
    want_xla = sw_extend_batch(*args)
    want_pallas = sw_extend_pallas(*args, jnp.asarray(np.full(1, tmax, np.int32)),
                                   interpret=True)
    for key in KEYS:
        np.testing.assert_array_equal(got[key], np.asarray(want_xla[key]), err_msg=key)
        np.testing.assert_array_equal(got[key], np.asarray(want_pallas[key]), err_msg=key)
    for k, x in enumerate(tasks):
        want = sw_extend_oracle(x["query"], x["target"], h0=x["h0"])
        assert {key: int(got[key][k]) for key in KEYS} == want, k


def test_plain_query_window_params():
    """test_extend_pallas.py's sliding-window case (band 8, which narrows
    the Pallas kernel's query window below the bucket): the port against
    the Pallas kernel."""
    rng = np.random.default_rng(0)
    p = ExtendParams(w=8)
    bsz, qmax, tmax = LANES, 62, 96
    q = np.full((qmax, bsz), 4, np.int32)
    t = np.full((tmax, bsz), 4, np.int32)
    ql = rng.integers(5, qmax, bsz).astype(np.int32)
    tl = rng.integers(5, tmax, bsz).astype(np.int32)
    for b in range(bsz):
        qq = rng.integers(0, 4, ql[b])
        q[: ql[b], b] = qq
        tt = rng.integers(0, 4, tl[b])
        n = min(ql[b], tl[b])
        tt[:n] = np.where(rng.random(n) < 0.9, qq[:n], tt[:n])
        t[: tl[b], b] = tt
    h0 = rng.integers(3, 30, bsz).astype(np.int32)
    got = _port(q, t, ql, tl, h0, p)
    args = [jnp.asarray(x) for x in (q, t, ql, tl, h0, ql, ql)]
    want = sw_extend_pallas(*args, jnp.asarray(np.full(1, tmax, np.int32)),
                            interpret=True, params=p)
    for key in KEYS:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    for b in range(0, bsz, 16):
        want_b = sw_extend_oracle(q[: ql[b], b], t[: tl[b], b], int(h0[b]), params=p)
        assert {key: int(got[key][b]) for key in KEYS} == want_b


def test_plain_long_tasks_against_oracle():
    """Longer tasks than the Pallas cases, an ambiguous target base, and
    max_ins / max_del below qlen, against the oracle."""
    rng = np.random.default_rng(5)
    tasks = _rand_tasks(rng, 24, maxq=120, maxt=150)
    tasks[3]["target"] = tasks[3]["target"].copy()
    tasks[3]["target"][::7] = 4
    q, t, ql, tl, h0 = _pack(tasks, 128, 160, lanes=1)
    cap = np.minimum(ql, 50).astype(np.int32)
    tt = torch.from_numpy
    rows = K.sw_extend_rows(tt(q), tt(t), tt(ql), tt(tl), tt(h0), tt(cap), tt(cap)).numpy()
    assert rows.dtype == np.int32 and rows.shape == (7, len(tasks))
    for k, x in enumerate(tasks):
        want = sw_extend_oracle(x["query"], x["target"], x["h0"],
                                max_ins=int(cap[k]), max_del=int(cap[k]))
        assert dict(zip(KEYS, rows[:, k].tolist())) == want, k


def test_plain_round_two():
    """Targets with a 7-base insertion past a 20-base prefix: with band 8
    the first round's best cell lies 7 columns off the diagonal (at least
    3/4 of the band), so round 2 runs with band 16 on the un-reset eh rows."""
    rng = np.random.default_rng(6)
    p = ExtendParams(w=8)
    tasks = []
    for k in range(32):
        q = rng.integers(0, 4, 60).astype(np.uint8)
        t = np.concatenate([q[:20], rng.integers(0, 4, 7).astype(np.uint8), q[20:]])
        tasks.append(dict(query=q, target=t, h0=int(rng.integers(5, 30))))
    q, t, ql, tl, h0 = _pack(tasks, 64, 96, lanes=1)
    got = _port(q, t, ql, tl, h0, p)
    assert (got["w"] == 16).all()
    for k, x in enumerate(tasks):
        want = sw_extend_oracle(x["query"], x["target"], x["h0"], params=p)
        assert {key: int(got[key][k]) for key in KEYS} == want, k


def test_wrapper_dispatch():
    tasks, qmax, tmax = _degenerate()
    args = [torch.from_numpy(x) for x in _pack(tasks, qmax, tmax)]
    q, t, ql, tl, h0 = args
    before = dict(K.LAUNCHES)
    K.sw_extend(q, t, ql, tl, h0, ql, ql)
    assert dict(K.LAUNCHES) == before  # CPU tensors: the plain version
    meta = torch.empty(q.shape, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="mixed"):
        K.sw_extend(meta, t, ql, tl, h0, ql, ql)
    with pytest.raises(ValueError, match="unsupported"):
        K.sw_extend(*[torch.empty(a.shape, dtype=a.dtype, device="meta")
                      for a in (q, t, ql, tl, h0, ql, ql)])


def _warp_edge_tasks(qlens, tmax, seed, h0=None):
    """One Pallas block of tasks, qlen cycling through ``qlens``: targets
    90% identical to the query (every fourth with a 7-base insertion after
    20 query bases), tlen 1..tmax, h0 0-29 (or ``h0``)."""
    rng = np.random.default_rng(seed)
    tasks = []
    for k in range(LANES):
        ql = qlens[k % len(qlens)]
        q = rng.integers(0, 4, ql).astype(np.uint8)
        t = rng.integers(0, 4, int(rng.integers(1, tmax + 1))).astype(np.uint8)
        src = q if k % 4 else np.concatenate([q[:20], rng.integers(0, 4, 7), q[20:]])
        m = min(len(src), len(t))
        t[:m] = np.where(rng.random(m) < 0.9, src[:m], t[:m])
        tasks.append(dict(query=q, target=t,
                          h0=int(rng.integers(0, 30)) if h0 is None else h0))
    return tasks


# the CUDA kernel's edges (one warp a task, K = ceil(Q / 32) query columns a
# lane, tiles of 256 columns past 256): (tasks, Q, T, band, max_ins cap)
WARP_EDGES = {
    "qlen_0_1_31_32_k1": lambda: (_warp_edge_tasks([0, 1, 31, 32], 40, 10), 32, 40, 100, None),
    "qlen_31_32_33_k2": lambda: (_warp_edge_tasks([31, 32, 33], 40, 11), 33, 40, 100, None),
    "qlen_0_1_255_256_k8": lambda: (_warp_edge_tasks([0, 1, 255, 256], 24, 12), 256, 24,
                                    100, None),
    "band_8": lambda: (_warp_edge_tasks([60, 45, 30], 72, 13), 64, 72, 8, None),
    "max_ins_5_below_band_8": lambda: (_warp_edge_tasks([60, 45, 30], 72, 14), 64, 72, 8, 5),
    "h0_0": lambda: (_warp_edge_tasks([60, 45, 30], 72, 15, h0=0), 64, 72, 100, None),
    # past 256 columns the kernel runs the query in tiles of 256
    "tiles_qlen_255_256_257_300_band_300": lambda: (
        _warp_edge_tasks([255, 256, 257, 300], 40, 16), 300, 40, 300, None),
    "tiles_band_across_column_256": lambda: (
        _warp_edge_tasks([300, 280], 300, 17), 300, 300, 100, None),
}


@pytest.mark.parametrize("case", sorted(WARP_EDGES))
def test_plain_matches_pallas_at_warp_edges(case):
    """The plain version against the Pallas kernel (interpret mode) and the
    oracle at the edges of the CUDA kernel's design."""
    tasks, qmax, tmax, w, cap = WARP_EDGES[case]()
    p = ExtendParams(w=w)
    q, t, ql, tl, h0 = _pack(tasks, qmax, tmax)
    mi = ql if cap is None else np.minimum(ql, cap).astype(np.int32)
    tt = torch.from_numpy
    got = K.sw_extend_rows(tt(q), tt(t), tt(ql), tt(tl), tt(h0), tt(mi), tt(mi), p).numpy()
    want = sw_extend_pallas(*[jnp.asarray(x) for x in (q, t, ql, tl, h0, mi, mi)],
                            jnp.asarray(np.full(1, tmax, np.int32)), interpret=True, params=p)
    for k, key in enumerate(KEYS):
        np.testing.assert_array_equal(got[k], np.asarray(want[key]), err_msg=key)
    for b, x in enumerate(tasks):
        want_b = sw_extend_oracle(x["query"], x["target"], x["h0"], max_ins=int(mi[b]),
                                  max_del=int(mi[b]), params=p)
        assert dict(zip(KEYS, got[:, b].tolist())) == want_b, b
    if w == 8 and cap is None:
        assert (got[6] == 16).any()  # round 2 ran


def test_max_query_caps_extend_engine_buckets():
    """``MAX_QUERY`` caps the kernel's query buckets at 25,600 columns,
    far past ``max_qlen`` 512: queries past the 256 register columns stay
    in the engine's buckets (on the card they run in shared-memory tiles),
    with the native host's records."""
    from acc_genomics_tpu_torch.config import ExtendConfig
    from acc_genomics_tpu_torch.engine.extend_engine import ExtendEngine

    assert K.REGISTER_QUERY == 256 and K.MAX_QUERY == 100 * 256
    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, 4000).astype(np.uint8)
    seeds = []
    for pos, qbeg in ((500, 300), (1500, 30), (2500, 200)):
        read = genome[pos: pos + 400].copy()
        read[rng.random(400) < 0.03] = 2
        seeds.append(dict(read=read, rseq=genome[pos - 100: pos + 500], qbeg=qbeg,
                          rbeg_off=100 + qbeg, len=20))
    eng = ExtendEngine(ExtendConfig(max_qlen=512), device="cpu")
    assert eng.q_buckets[-1] == 512
    got = eng.extend_seeds(seeds)
    assert eng.stats["host_fallback"] == 0
    want = ExtendEngine(ExtendConfig(max_qlen=512, max_tlen=64), device="cpu")
    assert got == want.extend_seeds(seeds)  # every seed on the host there
    assert want.stats["host_fallback"] == 3
