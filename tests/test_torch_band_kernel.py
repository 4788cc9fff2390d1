"""The port's band kernel against the JAX band kernel, on the same inputs.

``pairhmm_band_chunk_plain`` (the chunk in the JAX layout, on which the
superstep's plain version runs) against the JAX ``pairhmm_band_chunk`` in
Pallas interpret mode, on seeded numpy inputs with random non-zero
streams: every output within rtol 1e-5 of the largest value of that
output (the two frameworks may contract products into fused multiply-adds
differently; nothing else differs).  The superstep's byte front end
against the fp32 chunk fed ``expand_quals_plain``'s planes: rtol 1e-6 (the
same arithmetic).  The CUDA kernel is held against the plain version in
test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

from acc_genomics_tpu.ops.pairhmm.band_kernel import pairhmm_band_chunk as jax_band_chunk
from acc_genomics_tpu_torch.ops.pairhmm import band_kernel as BK
from acc_genomics_tpu_torch.ops.pairhmm.context import PairHMMContext
from acc_genomics_tpu_torch.ops.pairhmm.convert import context_tables
from acc_genomics_tpu_torch.ops.pairhmm.kernel import expand_quals_plain, hap_to_mask

LANES = 128
NAMES = ("bot_m", "bot_x", "bot_s", "redge_m", "redge_y", "redge_s")


def _inputs(rng, C, hc, lanes=LANES):
    """coef_rows, rs_rows, hap_mask, three top and three edge streams;
    codes include N (4) and hap masks include N (15) and padding (16)."""
    coef = rng.uniform(0.05, 1.0, (8, C, lanes)).astype(np.float32)
    rs = rng.integers(0, 5, (C, lanes)).astype(np.int32)
    hap = (1 << rng.integers(0, 4, (hc, lanes))).astype(np.int32)
    hap[rng.random((hc, lanes)) < 0.05] = 15
    hap[hc - hc // 8:, : lanes // 4] = 16  # a padded slab tail on some lanes
    tops = [rng.uniform(0.1, 2.0, (hc + 1, lanes)).astype(np.float32) for _ in range(3)]
    edges = [rng.uniform(0.1, 2.0, (C + 1, lanes)).astype(np.float32) for _ in range(3)]
    return [coef, rs, hap, *tops, *edges]


def _close(got, want, name, rtol=1e-5):
    want = np.asarray(want)
    assert got.shape == want.shape, name
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale, err_msg=name)


@pytest.mark.parametrize("hc", [32, 64])
@pytest.mark.parametrize("C", [8, 16])
def test_plain_matches_jax_band_chunk(C, hc):
    args = _inputs(np.random.default_rng(C * 100 + hc), C, hc)
    want = jax_band_chunk(*args, interpret=True)
    got = BK.pairhmm_band_chunk_plain(*(torch.from_numpy(a) for a in args))
    for g, w, name in zip(got, want, NAMES):
        _close(g.numpy(), w, name)


def _byte_state(rng, C, hc, front="arith", n_chunks=3, lanes=40):
    """A byte-plane pack of two shards (one data group) and a pipeline
    state with random non-zero tops and edges: the superstep's arguments
    but t (planes, tables, hap, slots, tops, edges, res)."""
    rows, cols = n_chunks * C, 2 * hc
    q = rng.integers(6, 60, (rows, lanes)).astype(np.uint8)
    i, d = (rng.integers(10, 50, (rows, lanes)).astype(np.uint8) for _ in range(2))
    c = np.full((rows, lanes), 10, np.uint8)
    rs = rng.integers(0, 5, (rows, lanes)).astype(np.uint8)
    rslen = rng.integers(1, rows, lanes).astype(np.int32)
    haplen = rng.integers(hc // 2, cols + 1, lanes).astype(np.int32)
    rslen[:2], haplen[:2] = 0, 0  # inert lanes
    hap = rng.integers(0, 5, (lanes, cols)).astype(np.uint8)
    hap[np.arange(cols)[None, :] >= haplen[:, None]] = 5
    ph2pr, m2m, _ = context_tables(PairHMMContext(np.float32), "cpu")
    ic = float(PairHMMContext(np.float32).initial_constant)
    planes = tuple(torch.from_numpy(a) for a in (q, i, d, c, rs, rslen, haplen))
    slots = torch.tensor([[0, 0, -1], [1, 0, 0]], dtype=torch.int32)
    tops = torch.from_numpy(rng.uniform(0.1, 2.0, (2, 3, 2, lanes, hc)).astype(np.float32))
    edges = torch.from_numpy(rng.uniform(0.1, 2.0, (3, 2, lanes, rows + 1)).astype(np.float32))
    res = torch.zeros((2, lanes), dtype=torch.float32)
    return planes, (ph2pr, m2m, ic), torch.from_numpy(hap), slots, tops, edges, res


def test_wrapper_on_cpu_runs_plain_and_counts_nothing():
    planes, tables, hap, slots, tops, edges, res = _byte_state(np.random.default_rng(1), 8, 32)
    state = [tops.clone(), edges.clone(), res.clone()]
    before = dict(BK.LAUNCHES)
    BK.pairhmm_band_superstep("arith", planes, tables, hap, slots, tops, edges, res,
                              t=2, first=0, n_active=2, C=8, n_chunks=3)
    BK.pairhmm_band_superstep_plain("arith", planes, tables, hap, slots, *state,
                                    t=2, first=0, n_active=2, C=8, n_chunks=3)
    assert all(torch.equal(g, w) for g, w in zip((tops, edges, res), state))
    assert dict(BK.LAUNCHES) == before
    assert not torch.equal(tops[1], state[0][0])  # the bottom row went to buffer 1


@pytest.mark.parametrize("front", ["arith", "gather"])
@pytest.mark.parametrize("C", [8, 16, 32])
@pytest.mark.parametrize("chunk", [0, 1, 2])
def test_byte_front_end_matches_fp32_chunk(C, front, chunk):
    """Shard 1's chunk through the superstep's byte front end against the
    JAX-layout fp32 chunk fed ``expand_quals_plain``'s planes, the top and
    edge streams cut from the same state (row -1 and the corner at chunk
    0); the bottom row lands in buffer 1 - t % 2, the right edge in shard
    1's column, the result at the last chunk."""
    hc = 40
    planes, tables, hap, slots, tops, edges, res = _byte_state(
        np.random.default_rng(C + chunk), C, hc, front)
    t, r0 = chunk + 1, chunk * C
    par = t % 2
    *coef, codes, _, y0 = expand_quals_plain(*planes[:5], planes[4], *planes[5:], *tables,
                                             expand=front)
    corner = torch.zeros((1, planes[0].shape[1]))
    if chunk == 0:
        top = [torch.zeros((hc + 1, y0.numel()))] * 2 + [y0.expand(hc + 1, -1)]
    else:
        top = [torch.cat([corner, tops[par, q, 1].t()]) for q in range(3)]
    edge = [edges[q, 0, :, r0:r0 + C + 1].t().clone() for q in range(3)]
    if chunk == 0:
        edge[0][0], edge[2][0] = 0.0, y0
    want = BK.pairhmm_band_chunk_plain(
        torch.stack([x[r0:r0 + C] for x in coef]), codes[r0:r0 + C],
        hap_to_mask(hap[:, hc:].t()), *top, *edge)
    BK.pairhmm_band_superstep(front, planes, tables, hap, slots, tops, edges, res,
                              t=t, first=1, n_active=1, C=C, n_chunks=3)
    got = [tops[1 - par, q, 1].t() for q in range(3)]
    got += [edges[q, 1, :, r0 + 1:r0 + C + 1].t() for q in range(3)]
    for g, w, name in zip(got, want, NAMES):
        _close(g.numpy(), w.numpy(), name, rtol=1e-6)
    if chunk == 2:
        _close(res[1].numpy(), want[1].sum(0).numpy(), "res", rtol=1e-6)


def test_slot_axis_equals_slot_by_slot():
    """A leading slot axis (the shards of one device in one launch) runs
    each slot as its own chunk would."""
    rng = np.random.default_rng(2)
    per_slot = [[torch.from_numpy(a) for a in _inputs(rng, 16, 32, lanes=24)] for _ in range(3)]
    stacked = BK.pairhmm_band_chunk_plain(*(torch.stack(xs) for xs in zip(*per_slot)))
    for s, args in enumerate(per_slot):
        for g, w in zip(stacked, BK.pairhmm_band_chunk_plain(*args)):
            assert torch.equal(g[s], w)


def test_zero_streams_give_zero_chunk():
    """With no mass entering from the top or the left, every output is 0."""
    args = _inputs(np.random.default_rng(3), 8, 32)
    for k in range(3, 9):
        args[k] = np.zeros_like(args[k])
    for out in BK.pairhmm_band_chunk_plain(*(torch.from_numpy(a) for a in args)):
        assert not out.any()


def test_bound_terms_follow_the_jax_cost_estimate():
    """13 fp32 operations a cell of a step, (9C + 7 steps) x 4 bytes a lane."""
    C, hc, lanes = 8, 1024, 2048
    steps = hc + C - 1
    assert BK.band_bound_terms(C, hc, lanes) == ((9 * C + 7 * steps) * lanes * 4,
                                                  13 * steps * C * lanes)


def test_quals_bytes_count_each_stream_once():
    """Byte planes 5C + 8, codes hc, top in and bottom out 12 hc each,
    edges 12 (C + 1) in and 12 C out, a lane."""
    C, hc, lanes = 8, 1024, 2048
    per = 5 * C + 8 + hc + 12 * (C + 1) + 12 * C
    assert BK.band_quals_bytes(C, hc, lanes) == (per + 24 * hc) * lanes


def test_wrapper_rejects_unsupported_devices():
    planes, tables, hap, slots, tops, edges, res = _byte_state(np.random.default_rng(4), 8, 32)
    meta = lambda a: torch.empty(a.shape, dtype=a.dtype, device="meta")
    state = [meta(a) for a in (hap, slots, tops, edges, res)]
    with pytest.raises(ValueError, match="unsupported"):
        BK.pairhmm_band_superstep("arith", tuple(map(meta, planes)),
                                  (meta(tables[0]), meta(tables[1]), tables[2]), *state,
                                  t=0, first=0, n_active=1, C=8, n_chunks=3)
    with pytest.raises(ValueError, match="mixed"):
        BK.pairhmm_band_superstep("arith", planes, tables, *state,
                                  t=0, first=0, n_active=1, C=8, n_chunks=3)
    with pytest.raises(ValueError, match="front"):
        BK.pairhmm_band_superstep("f16", planes, tables, hap, slots, tops, edges, res,
                                  t=0, first=0, n_active=1, C=8, n_chunks=3)
