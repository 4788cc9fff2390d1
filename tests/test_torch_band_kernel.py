"""The port's band kernel against the JAX band kernel, on the same inputs.

``pairhmm_band_chunk_plain`` (the band kernel's plain PyTorch version,
what the wrapper runs on CPU tensors) against the JAX
``pairhmm_band_chunk`` in Pallas interpret mode, on seeded numpy inputs
with random non-zero streams: every output within rtol 1e-5 of the
largest value of that output (the two frameworks may contract products
into fused multiply-adds differently; nothing else differs).  The CUDA
kernel is held against the plain version in test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

from acc_genomics_tpu.ops.pairhmm.band_kernel import pairhmm_band_chunk as jax_band_chunk
from acc_genomics_tpu_torch.ops.pairhmm import band_kernel as BK

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


def _close(got, want, name):
    want = np.asarray(want)
    assert got.shape == want.shape, name
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale, err_msg=name)


@pytest.mark.parametrize("hc", [32, 64])
@pytest.mark.parametrize("C", [8, 16])
def test_plain_matches_jax_band_chunk(C, hc):
    args = _inputs(np.random.default_rng(C * 100 + hc), C, hc)
    want = jax_band_chunk(*args, interpret=True)
    got = BK.pairhmm_band_chunk_plain(*(torch.from_numpy(a) for a in args))
    for g, w, name in zip(got, want, NAMES):
        _close(g.numpy(), w, name)


def test_wrapper_on_cpu_runs_plain_and_counts_nothing():
    args = [torch.from_numpy(a) for a in _inputs(np.random.default_rng(1), 8, 32)]
    before = dict(BK.LAUNCHES)
    got = BK.pairhmm_band_chunk(*args)
    want = BK.pairhmm_band_chunk_plain(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert dict(BK.LAUNCHES) == before


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


def test_wrapper_rejects_unsupported_devices():
    args = [torch.from_numpy(a) for a in _inputs(np.random.default_rng(4), 8, 32)]
    meta = [torch.empty(a.shape, dtype=a.dtype, device="meta") for a in args]
    with pytest.raises(ValueError, match="unsupported"):
        BK.pairhmm_band_chunk(*meta)
    with pytest.raises(ValueError, match="mixed"):
        BK.pairhmm_band_chunk(*meta[:8], args[8])
