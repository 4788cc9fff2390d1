"""The port's SW fill and walk against the JAX package, on the same inputs.

Inputs come from numpy seeds and go to both packages.  The port runs its
plain PyTorch versions (CPU tensors); the JAX side runs its XLA fill
(``jax_impl.sw_fill``) and its device walker ``sw_walk_device``.  (Its
Pallas fill in interpret mode takes 25-40 s at 32 x 32 on a CPU, so the
fill is held to the XLA fill, which test_sw_jax.py holds to the oracle.)
SW results are integers, so every comparison
is exact: the fill inside each pair's real region, the packed walk buffer
bit for bit on every pair, and the decoded CIGARs against the oracle.
The CUDA kernels are held against the plain versions in
test_torch_gpu.py, which needs a card.
"""

import numpy as np
import pytest
import torch

from acc_genomics_tpu.io.synth import gen_sw_batch
from acc_genomics_tpu.ops.sw import jax_impl
from acc_genomics_tpu.ops.sw.reference import SWParams, sw_align_oracle
from acc_genomics_tpu.ops.sw.walker import SHIP_ELEMS as JAX_SHIP_ELEMS
from acc_genomics_tpu.ops.sw.walker import decode_elements as jax_decode
from acc_genomics_tpu.ops.sw.walker import sw_walk_device
from acc_genomics_tpu_torch.ops.sw import kernel as K
from acc_genomics_tpu_torch.ops.sw.batch import (
    pack_planes,
    sw_align_batch_decode,
    sw_align_batch_launch,
)
from acc_genomics_tpu_torch.ops.sw.walker import decode_elements
from acc_genomics_tpu_torch.tools.bench_shapes import sw_fill_batches, sw_walk_batches

STRATEGIES = [0, 1, 2, 3]
CPU = torch.device("cpu")


def _random(rng):
    ref, alts = gen_sw_batch(rng, 6, ref_len=40)
    return [ref] * 6, alts, 48, 48


def _mixed(rng):
    refs, alts = [], []
    for ln in (10, 30, 44, 20):
        r, (a,) = gen_sw_batch(rng, 1, ref_len=ln)
        refs.append(r)
        alts.append(a)
    refs.append(rng.integers(0, 4, 9).astype(np.uint8))  # ref shorter than alt
    alts.append(rng.integers(0, 4, 31).astype(np.uint8))
    return refs, alts, 48, 48


def _tie_stress(rng):
    """test_sw_pallas.py's degenerate inputs: identical sequences,
    homopolymers, periodic repeats, tandem duplicates."""
    cases = []
    ref1 = rng.integers(0, 4, 22).astype(np.uint8)
    cases.append((ref1, ref1.copy()))
    cases.append((np.zeros(18, np.uint8), np.zeros(22, np.uint8)))
    cases.append((np.zeros(22, np.uint8), np.zeros(13, np.uint8)))
    per = np.tile(np.array([0, 1], np.uint8), 11)
    cases.append((per, np.tile(np.array([0, 1], np.uint8), 9)))
    cases.append((per, np.roll(per, 1)))
    ref2 = rng.integers(0, 4, 12).astype(np.uint8)
    cases.append((ref2, np.concatenate([ref2, ref2])))
    cases.append((np.concatenate([ref2, ref2]), ref2))
    return [r for r, _ in cases], [a for _, a in cases], 32, 32


def _overflow(rng):
    """test_sw_pallas.py's long-CIGAR pair: more than 48 elements."""
    ref = rng.integers(0, 4, 96).astype(np.uint8)
    alt = []
    for j, b in enumerate(ref):
        alt.append(b)
        if j % 2 == 0:
            alt.append((b + 1) % 4)
            alt.append((b + 2) % 4)
    return [ref], [np.asarray(alt, np.uint8)[:160]], 96, 192


CASES = {"random": _random, "mixed_lengths": _mixed, "tie_stress": _tie_stress,
         "element_overflow": _overflow}


def _planes(refs, alts, rows, cols):
    n = len(refs)
    ref = np.empty((n, rows), np.uint8)
    alt = np.empty((n, cols), np.uint8)
    rl = pack_planes(refs, rows, ref)
    al = pack_planes(alts, cols, alt)
    return ref, alt, rl, al


def _plain_fill(refs, alts, rows, cols, strategy, params=None):
    ref, alt, rl, al = _planes(refs, alts, rows, cols)
    kw = {} if params is None else dict(params=params)
    out = K.sw_fill(*(torch.from_numpy(x) for x in (ref, alt, rl, al)), strategy, **kw)
    return [t.numpy() for t in out], rl, al


def _jax_walker_inputs(btrack, lastrow, altcol, rl, al):
    """The port's layout -> sw_walk_device's: btrack (B/128, D, R, 128)
    and the diagonal-indexed last row / last column (D, B), lanes padded
    to 128 with one-cell pairs."""
    bsz, n_diag, rows = btrack.shape
    bp = -(-bsz // 128) * 128
    bt = np.zeros((bp, n_diag, rows), np.int16)
    bt[:bsz] = btrack
    bt = bt.reshape(bp // 128, 128, n_diag, rows).transpose(0, 2, 3, 1)
    rlp = np.ones(bp, np.int32)
    alp = np.ones(bp, np.int32)
    rlp[:bsz], alp[:bsz] = rl, al
    lr = np.zeros((bp, lastrow.shape[1]), np.int32)
    ac = np.zeros((bp, rows), np.int32)
    lr[:bsz], ac[:bsz] = lastrow, altcol
    dd = np.arange(n_diag)[:, None]
    lanes = np.arange(bp)[None, :]
    j = dd - rlp[None, :] + 1  # lastrow_diag[d] = sw at (reflen - 1, d - reflen + 1)
    lr_d = np.where((j >= 0) & (j < alp), lr[lanes, np.clip(j, 0, lr.shape[1] - 1)], 0)
    i = dd - alp[None, :] + 1  # altcol_diag[d] = sw at (d - altlen + 1, altlen - 1)
    ac_d = np.where((i >= 0) & (i < rlp), ac[lanes, np.clip(i, 0, rows - 1)], 0)
    return np.ascontiguousarray(bt), lr_d.astype(np.int32), ac_d.astype(np.int32), rlp, alp


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_fill_matches_jax_xla(case, strategy, rng):
    refs, alts, rows, cols = CASES[case](rng)
    (btrack, lastrow, altcol), rl, al = _plain_fill(refs, alts, rows, cols, strategy)
    assert btrack.shape == (len(refs), rows + cols - 1, rows)
    assert btrack.dtype == np.int16 and lastrow.dtype == np.int32
    ref, alt, _, _ = _planes(refs, alts, rows, cols)
    w_bt, w_last, w_col = (np.asarray(x) for x in jax_impl.sw_fill(
        ref.T.astype(np.int32), alt.T.astype(np.int32), rl, al, strategy))
    for b in range(len(refs)):
        i, j = np.meshgrid(np.arange(rl[b]), np.arange(al[b]), indexing="ij")
        np.testing.assert_array_equal(btrack[b, i + j, i], w_bt[i, j, b])
        np.testing.assert_array_equal(lastrow[b, : al[b]], w_last[1 : al[b] + 1, b])
        np.testing.assert_array_equal(altcol[b, : rl[b]], w_col[: rl[b], b])


_EDGES = {name: (ref, alt, rl, al)
          for name, ref, alt, rl, al in sw_fill_batches(CPU, big=False)}


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("batch", sorted(_EDGES))
def test_fill_matches_jax_xla_at_chunk_edges(batch, strategy):
    """The edges of the CUDA fill's 32-row chunks (reflen 1-65 against
    altlen 1 and full) and batches of 1, 5 and 13 pairs: the plain fill
    against the XLA fill inside each pair's region."""
    ref, alt, rl, al = (x.numpy() for x in _EDGES[batch])
    btrack, lastrow, altcol = (x.numpy() for x in K.sw_fill(
        *(torch.from_numpy(x) for x in (ref, alt, rl, al)), strategy))
    w_bt, w_last, w_col = (np.asarray(x) for x in jax_impl.sw_fill(
        ref.T.astype(np.int32), alt.T.astype(np.int32), rl, al, strategy))
    for b in range(len(rl)):
        i, j = np.meshgrid(np.arange(rl[b]), np.arange(al[b]), indexing="ij")
        np.testing.assert_array_equal(btrack[b, i + j, i], w_bt[i, j, b])
        np.testing.assert_array_equal(lastrow[b, : al[b]], w_last[1 : al[b] + 1, b])
        np.testing.assert_array_equal(altcol[b, : rl[b]], w_col[: rl[b], b])


def test_fill_weights_are_arguments(rng):
    """Non-default SWConfig weights reach the fill as arguments."""
    refs, alts, rows, cols = _mixed(rng)
    params = SWParams(w_match=3, w_mismatch=-2, w_open=-5, w_extend=-1)
    (btrack, lastrow, altcol), rl, al = _plain_fill(refs, alts, rows, cols, 1, params)
    ref, alt, _, _ = _planes(refs, alts, rows, cols)
    w_bt, w_last, _ = (np.asarray(x) for x in jax_impl.sw_fill(
        ref.T.astype(np.int32), alt.T.astype(np.int32), rl, al, 1, params))
    for b in range(len(refs)):
        i, j = np.meshgrid(np.arange(rl[b]), np.arange(al[b]), indexing="ij")
        np.testing.assert_array_equal(btrack[b, i + j, i], w_bt[i, j, b])
        np.testing.assert_array_equal(lastrow[b, : al[b]], w_last[1 : al[b] + 1, b])


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_walk_matches_jax_walker(case, strategy, rng):
    refs, alts, rows, cols = CASES[case](rng)
    (btrack, lastrow, altcol), rl, al = _plain_fill(refs, alts, rows, cols, strategy)
    got = K.sw_walk(*(torch.from_numpy(x) for x in (btrack, lastrow, altcol, rl, al)),
                    strategy).numpy()
    assert got.shape == (K.SHIP_ELEMS + 2, len(refs)) and got.dtype == np.int16
    assert K.SHIP_ELEMS == JAX_SHIP_ELEMS
    want = np.asarray(sw_walk_device(
        *_jax_walker_inputs(btrack, lastrow, altcol, rl, al), strategy))[:, : len(refs)]
    np.testing.assert_array_equal(got, want)
    res, overflow = decode_elements(got, len(refs))
    w_res, w_overflow = jax_decode(want, len(refs))
    assert res == w_res
    np.testing.assert_array_equal(overflow, w_overflow)
    assert overflow.any() == (case == "element_overflow")


_WALK_EDGES = {name: (ref, alt, rl, al)
               for name, ref, alt, rl, al in sw_walk_batches(CPU, gap_pairs=8)}


def _plain_walk(batch, strategy):
    ref, alt, rl, al = _WALK_EDGES[batch]
    fill = [x.numpy() for x in K.sw_fill(ref, alt, rl, al, strategy)]
    packed = K.sw_walk(*(torch.from_numpy(x) for x in fill), rl, al, strategy).numpy()
    return fill, rl.numpy(), al.numpy(), packed


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("batch", sorted(_WALK_EDGES))
def test_walk_matches_jax_walker_at_warp_edges(batch, strategy):
    """The edges of the warp-a-pair walk (match runs of 31-64 cells, gaps
    past 32, gaps first and last, walks ending on row 0 or column 0,
    lengths of 1, start-cell ties, 47-53 elements, gap-heavy pairs): the
    plain walk against the JAX walker bit for bit on the plain fill."""
    (btrack, lastrow, altcol), rl, al, got = _plain_walk(batch, strategy)
    want = np.asarray(sw_walk_device(
        *_jax_walker_inputs(btrack, lastrow, altcol, rl, al), strategy))[:, : len(rl)]
    np.testing.assert_array_equal(got, want)
    res, overflow = decode_elements(got, len(rl))
    assert res == jax_decode(want, len(rl))[0]
    assert overflow.any() == batch.startswith("47/48/49/53")


def test_walk_batches_reach_their_edges():
    """The walk batches hold what their names say (SOFTCLIP): each run
    pair's first walk element is a match of exactly its run, the corner
    pairs walk one element, the 40-base gaps are single steps, and the
    element counts are 47, 48, 49 and 53."""
    runs = next(b for b in _WALK_EDGES if b.startswith("match runs"))
    packed = _plain_walk(runs, 0)[3]
    for k, run in enumerate(np.repeat([31, 32, 33, 64], 3)):
        assert packed[0, k] == run  # state 0: a match
        assert (packed[K.SHIP_ELEMS, k] == 1) == (k % 3 == 2)
    gaps = next(b for b in _WALK_EDGES if b.startswith("gaps of 40"))
    packed = _plain_walk(gaps, 0)[3]
    assert list(packed[1, :2]) == [40 | 2 << 12, 40 | 1 << 12]  # deletion, insertion
    counts = next(b for b in _WALK_EDGES if b.startswith("47/48/49/53"))
    assert list(_plain_walk(counts, 0)[3][K.SHIP_ELEMS]) == [47, 48, 49, 53]


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_batch_matches_oracle(case, strategy, rng):
    refs, alts, rows, cols = CASES[case](rng)
    before = dict(K.LAUNCHES)
    launched = sw_align_batch_launch(refs, alts, strategy, rows, cols, CPU)
    got = sw_align_batch_decode(launched.packed.numpy(), refs, alts, strategy)
    assert dict(K.LAUNCHES) == before  # CPU tensors never launch
    for r, a, res in zip(refs, alts, got):
        assert res == sw_align_oracle(r, a, strategy)


def test_decode_matches_jax_decode(rng):
    """Random packed buffers: counts 0..60 (past 48 overflows), negative
    offsets, and padding columns past n_real."""
    packed = rng.integers(0, 4096, (K.SHIP_ELEMS + 2, 300)).astype(np.int16)
    packed[: K.SHIP_ELEMS] |= (rng.choice([0, 1, 2, 4], (K.SHIP_ELEMS, 300)) << 12).astype(np.int16)
    packed[K.SHIP_ELEMS] = rng.integers(0, 61, 300)
    packed[K.SHIP_ELEMS + 1] = rng.integers(-500, 500, 300)
    got, overflow = decode_elements(packed, 260)
    want, w_overflow = jax_decode(packed, 260)
    assert got == want and overflow.any()
    np.testing.assert_array_equal(overflow, w_overflow)
    assert decode_elements(packed[:, :0], 0)[0] == []


def test_btrack_region(rng):
    refs, alts, rows, cols = _mixed(rng)
    (btrack, _, _), rl, al = _plain_fill(refs, alts, rows, cols, 0)
    region = K.btrack_region(torch.from_numpy(rl), torch.from_numpy(al), rows, cols).numpy()
    assert region.shape == btrack.shape
    assert region.sum() == int((rl.astype(np.int64) * al).sum())
    assert not btrack[~region].any() and btrack[region].any()


def test_pack_planes_and_bucket_check():
    seqs = [np.array([1, 2, 3], np.uint8), np.zeros(0, np.uint8), np.array([0], np.uint8)]
    out = np.empty((3, 4), np.uint8)
    lens = pack_planes(seqs, 4, out)
    np.testing.assert_array_equal(lens, [3, 0, 1])
    np.testing.assert_array_equal(out, [[1, 2, 3, 255], [255] * 4, [0, 255, 255, 255]])
    with pytest.raises(ValueError, match="exceeds bucket"):
        pack_planes(seqs, 2, np.empty((3, 2), np.uint8))


def test_wrappers_reject_bad_arguments():
    ref = torch.zeros((2, 8), dtype=torch.uint8)
    lens = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="strategy"):
        K.sw_fill(ref, ref, lens, lens, 7)
    with pytest.raises(ValueError, match="mixed"):
        K.sw_fill(ref, ref.to("meta"), lens, lens, 0)
    meta = [t.to("meta") for t in (ref, ref, lens, lens)]
    with pytest.raises(ValueError, match="unsupported"):
        K.sw_fill(*meta, 0)
