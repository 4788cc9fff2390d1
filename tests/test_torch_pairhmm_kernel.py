"""The port's PairHMM forward against the JAX package, on the same packs.

Inputs come from numpy seeds and one pack feeds both packages.  The JAX
side runs its Pallas kernel in interpret mode and its XLA row scan; the
port runs its plain PyTorch version (CPU tensors).  Raw fp32 forward
probabilities agree to rtol 1e-5: both are fp32 over the same cells and
only the order of the sums differs.  The CUDA kernel itself is checked
against the plain version in test_torch_gpu.py, which needs a card.
"""

import numpy as np
import pytest
import torch

from acc_genomics_tpu.io.synth import gen_pairhmm_pairs
from acc_genomics_tpu.ops.pairhmm import jax_impl
from acc_genomics_tpu.ops.pairhmm.context import PairHMMContext
from acc_genomics_tpu.ops.pairhmm.kernel import (
    block_diag_counts,
    forward_from_pack_pallas,
    hap_to_mask as jax_hap_to_mask,
    pairhmm_forward_pallas_from_quals,
)
from acc_genomics_tpu.ops.pairhmm.pack import pack_pairhmm_batch, pack_pairhmm_quals
from acc_genomics_tpu.ops.pairhmm.reference import pairhmm_loglik_oracle
from acc_genomics_tpu_torch.ops.pairhmm import kernel as K
from acc_genomics_tpu_torch.ops.pairhmm.convert import (
    batch_to_torch,
    context_tables,
    quals_to_torch,
)

RTOL_RAW = 1e-5


def _case_rows16(rng):
    tcs = gen_pairhmm_pairs(rng, 128, max_read_len=15, max_hap_len=24)
    return tcs, dict(rows=16, cols=24)


def _case_mixed_with_n(rng):
    tcs = gen_pairhmm_pairs(rng, 120, max_read_len=23, max_hap_len=30)
    tcs += gen_pairhmm_pairs(rng, 8, max_read_len=3, max_hap_len=5)
    for t in tcs[::9]:
        t["rs"][::6] = 4
        t["hap"][::5] = 4
    return tcs, dict(rows=24, cols=32)


def _case_inert_lanes(rng):
    tcs = gen_pairhmm_pairs(rng, 5, max_read_len=7, max_hap_len=9)
    return tcs, dict(rows=8, cols=16)


def _case_sorted(rng):
    tcs = gen_pairhmm_pairs(rng, 260, max_read_len=15, max_hap_len=30)
    return tcs, dict(rows=16, cols=32, sort_by_haplen=True)


CASES = {
    "rows16_cols24": _case_rows16,
    "mixed_lengths_with_n": _case_mixed_with_n,
    "inert_padded_lanes": _case_inert_lanes,
    "sorted_pack_unsort": _case_sorted,
}


def _oracle_logs(tcs):
    return np.array([
        pairhmm_loglik_oracle(t["rs"], t["q"], t["i"], t["d"], t["c"], t["hap"])
        for t in tcs
    ])


def _logs(raw):
    ctx = PairHMMContext(np.float32)
    return np.log10(raw.astype(np.float64)) - np.float64(ctx.log10_initial_constant)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case, rng):
    tcs, kw = CASES[case](rng)
    pack = pack_pairhmm_batch(tcs, dtype=np.float32, **kw)
    got = K.pairhmm_forward(*batch_to_torch(pack, "cpu")).numpy()
    assert got.shape == (pack.batch,) and got.dtype == np.float32
    want_pallas = np.asarray(forward_from_pack_pallas(pack, interpret=True))
    want_scan = np.asarray(jax_impl.forward_from_pack(pack))
    np.testing.assert_allclose(got, want_pallas, rtol=RTOL_RAW, atol=0)
    np.testing.assert_allclose(got, want_scan, rtol=RTOL_RAW, atol=0)
    # inert padded lanes are exactly 0, real lanes positive
    assert np.all(got[pack.n_real:] == 0.0)
    assert np.all(got[: pack.n_real] > 0.0)
    logs = _logs(pack.unsort(got))
    want = _oracle_logs(tcs)
    assert np.max(np.abs((logs - want) / want)) < 5e-3


@pytest.mark.parametrize("expand", ["arith", "gather"])
def test_from_quals_matches_jax(expand, rng):
    tcs = gen_pairhmm_pairs(rng, 24, max_read_len=46, max_hap_len=96)
    pack = pack_pairhmm_quals(tcs, rows=48, cols=96, sort_by_haplen=True)
    ctx = PairHMMContext(np.float32)
    ph2pr, m2m, ic = context_tables(ctx, "cpu")
    got = K.pairhmm_forward_from_quals(
        *quals_to_torch(pack, "cpu"), ph2pr, m2m, ic, expand=expand
    ).numpy()
    want = np.asarray(pairhmm_forward_pallas_from_quals(
        pack.q, pack.i, pack.d, pack.c, pack.rs, pack.hap_ext,
        pack.rslen, pack.haplen, ctx.ph2pr, ctx.match_to_match,
        np.float32(ctx.initial_constant),
        block_diags=block_diag_counts(pack), interpret=True, expand=expand,
    ))
    np.testing.assert_allclose(got, want, rtol=RTOL_RAW, atol=0)
    assert np.all(got[pack.n_real:] == 0.0)
    # gather reads the host tables, so it equals the host coefficient pack
    if expand == "gather":
        coef = pack_pairhmm_batch(tcs, rows=48, cols=96, sort_by_haplen=True)
        np.testing.assert_array_equal(
            got, K.pairhmm_forward(*batch_to_torch(coef, "cpu")).numpy()
        )


def test_arith_vs_gather_expansion(rng):
    tcs = gen_pairhmm_pairs(rng, 40, max_read_len=46, max_hap_len=96)
    pack = pack_pairhmm_quals(tcs, rows=48, cols=96)
    ph2pr, m2m, ic = context_tables(PairHMMContext(np.float32), "cpu")
    args = quals_to_torch(pack, "cpu")
    arith = K.pairhmm_forward_from_quals(*args, None, None, ic, expand="arith")
    gather = K.pairhmm_forward_from_quals(*args, ph2pr, m2m, ic, expand="gather")
    n = pack.n_real
    np.testing.assert_allclose(
        _logs(arith.numpy()[:n]), _logs(gather.numpy()[:n]), rtol=2e-4
    )


def test_hap_mask_matches_jax():
    codes = np.array([[0, 1, 2, 3, 4, 5, 6, 255]], np.int32).T
    got = K.hap_to_mask(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_hap_to_mask(codes)))


def test_state_carried_across(rng):
    tcs = gen_pairhmm_pairs(rng, 10, max_read_len=20, max_hap_len=40)
    pack = pack_pairhmm_batch(tcs, rows=24, cols=40, sort_by_haplen=True)
    got = batch_to_torch(pack, "cpu")
    assert len(got) == 11
    for t, a in zip(got, pack.arrays()):
        assert t.dtype == torch.from_numpy(a).dtype and t.is_contiguous()
        np.testing.assert_array_equal(t.numpy(), a)  # same (R, B) layout
    assert got[0].shape == (24, 128) and got[9].shape == (64, 128)
    qp = pack_pairhmm_quals(tcs, rows=24, cols=40)
    q = quals_to_torch(qp, "cpu")
    arrays = (qp.q, qp.i, qp.d, qp.c, qp.rs, qp.hap_ext, qp.rslen, qp.haplen)
    assert [t.dtype for t in q] == [torch.uint8] * 6 + [torch.int32] * 2
    for t, a in zip(q, arrays):
        np.testing.assert_array_equal(t.numpy(), a)
    ctx = PairHMMContext(np.float32)
    ph2pr, m2m, ic = context_tables(ctx, "cpu")
    assert ph2pr.shape == (128,) and ph2pr.dtype == torch.float32
    np.testing.assert_array_equal(m2m.numpy(), ctx.match_to_match)
    assert ic.dtype == torch.float32 and float(ic) == float(ctx.initial_constant)


def test_cpu_tensors_never_launch(rng):
    tcs = gen_pairhmm_pairs(rng, 6, max_read_len=10, max_hap_len=20)
    before = dict(K.LAUNCHES)
    K.pairhmm_forward(*batch_to_torch(pack_pairhmm_batch(tcs, rows=16, cols=24), "cpu"))
    qp = pack_pairhmm_quals(tcs, rows=16, cols=24)
    K.pairhmm_forward_from_quals(*quals_to_torch(qp, "cpu"), None, None, 2.0**120)
    assert dict(K.LAUNCHES) == before


def _edge_pairs(rng, rows, cols, n_reads=8, n_haps=2):
    """Derived pairs whose reads fill a ``rows`` bucket but its absorbing
    row, every haplotype exactly ``cols`` long."""
    from acc_genomics_tpu.io.synth import gen_pairhmm_input

    reads, haps = gen_pairhmm_input(rng, n_reads, n_haps, max_read_len=max(rows - 1, 1),
                                    max_hap_len=max(cols, 64), derived=True)
    haps = [np.concatenate([h, rng.integers(0, 4, cols)])[:cols].astype(np.uint8)
            for h in haps]
    return [dict(hap=h, **r) for r in reads for h in haps]


# the CUDA kernel's edges that the Pallas kernel takes (rows a multiple of
# 8): C = 8 (8 rows), 16 (16), 32 in one chunk (24, 32) and in two or eight
# (40, 256), haplotypes of 1 and 1024 columns
SEGMENT_EDGES = [(8, 24), (16, 24), (24, 40), (32, 40), (40, 40), (256, 320), (16, 1),
                 (40, 1024)]


@pytest.mark.parametrize("rows,cols", SEGMENT_EDGES)
def test_plain_matches_pallas_at_segment_edges(rows, cols):
    """Both plain versions against the Pallas kernel (interpret mode) at
    the edges of the CUDA kernel's segments and chunks; inert lanes 0."""
    tcs = _edge_pairs(np.random.default_rng(rows * 7 + cols), rows, cols)
    pack = pack_pairhmm_batch(tcs, rows=rows, cols=cols, dtype=np.float32)
    got = K.pairhmm_forward(*batch_to_torch(pack, "cpu")).numpy()
    want = np.asarray(forward_from_pack_pallas(pack, interpret=True))
    np.testing.assert_allclose(got, want, rtol=RTOL_RAW, atol=0)
    assert np.all(got[pack.n_real:] == 0.0)
    qp = pack_pairhmm_quals(tcs, rows=rows, cols=cols)
    ctx = PairHMMContext(np.float32)
    ph2pr, m2m, ic = context_tables(ctx, "cpu")
    got_q = K.pairhmm_forward_from_quals(*quals_to_torch(qp, "cpu"), ph2pr, m2m, ic).numpy()
    want_q = np.asarray(pairhmm_forward_pallas_from_quals(
        qp.q, qp.i, qp.d, qp.c, qp.rs, qp.hap_ext, qp.rslen, qp.haplen, ctx.ph2pr,
        ctx.match_to_match, np.float32(ctx.initial_constant),
        block_diags=block_diag_counts(qp), interpret=True))
    np.testing.assert_allclose(got_q, want_q, rtol=RTOL_RAW, atol=0)
    inert = (qp.rslen == 0) | (qp.haplen == 0)
    assert np.all(got_q[inert] == 0.0)
    assert np.all(got_q[: qp.n_real] > 0.0)
