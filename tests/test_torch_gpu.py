"""CUDA kernel and engine checks of the PyTorch port; they need a card.

This file imports nothing of JAX, so it also runs where JAX is not
installed (the repository's conftest imports it):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Without a card every test skips.  Tolerances: the PairHMM kernel against
its plain PyTorch version in log space rtol 1e-5 (the kernel contracts
multiply-adds into fmas and sums in another order); inert lanes exactly 0.
The SW kernels are integer: bit-exact against their plain versions, and
the SW engine exact against the native host engine.
"""

import numpy as np
import pytest
import torch

from acc_genomics_tpu import native
from acc_genomics_tpu.config import PairHMMConfig
from acc_genomics_tpu.io.synth import gen_pairhmm_input, gen_pairhmm_pairs, gen_sw_batch
from acc_genomics_tpu.ops.pairhmm.context import PairHMMContext
from acc_genomics_tpu.ops.pairhmm.pack import pack_pairhmm_batch, pack_pairhmm_quals
from acc_genomics_tpu_torch.engine.pairhmm_engine import PairHMMEngine
from acc_genomics_tpu_torch.engine.sw_engine import SWEngine
from acc_genomics_tpu_torch.ops.pairhmm import kernel as K
from acc_genomics_tpu_torch.ops.sw import kernel as SK
from acc_genomics_tpu_torch.ops.sw.batch import pack_planes
from acc_genomics_tpu_torch.ops.pairhmm.convert import (
    batch_to_torch,
    context_tables,
    quals_to_torch,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _logs(raw):
    ctx = PairHMMContext(np.float32)
    return np.log10(raw.astype(np.float64)) - np.float64(ctx.log10_initial_constant)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain(cuda):
    rng = np.random.default_rng(0)
    tcs = gen_pairhmm_pairs(rng, 300, max_read_len=60, max_hap_len=120)
    for t in tcs[::7]:
        t["rs"][::5] = 4
        t["hap"][::6] = 4
    ctx = PairHMMContext(np.float32)
    ph2pr, m2m, _ = context_tables(ctx, cuda)
    ic = float(ctx.initial_constant)
    pack = pack_pairhmm_batch(tcs, rows=64, cols=128, sort_by_haplen=True)
    qp = pack_pairhmm_quals(tcs, rows=64, cols=128, sort_by_haplen=True)
    before = dict(K.LAUNCHES)
    coef = batch_to_torch(pack, cuda)
    runs = [(K.pairhmm_forward(*coef), K.pairhmm_forward_plain(*coef))]
    for expand in ("arith", "gather"):
        args = quals_to_torch(qp, cuda)
        runs.append((
            K.pairhmm_forward_from_quals(*args, ph2pr, m2m, ic, expand=expand),
            K.pairhmm_forward_from_quals_plain(*args, ph2pr, m2m, ic, expand),
        ))
    torch.cuda.synchronize()
    assert K.LAUNCHES["pairhmm_forward"] == before.get("pairhmm_forward", 0) + 1
    assert K.LAUNCHES["pairhmm_forward_from_quals"] == (
        before.get("pairhmm_forward_from_quals", 0) + 2
    )
    n = len(tcs)
    for got, want in runs:
        got, want = got.cpu().numpy(), want.cpu().numpy()
        assert np.all(got[n:] == 0.0)
        ok = want[:n] >= 1e-28
        assert ok.sum() > n // 2
        np.testing.assert_allclose(_logs(got[:n][ok]), _logs(want[:n][ok]), rtol=1e-5)


@pytest.mark.gpu
def test_cuda_kernel_rejects_bad_arguments(cuda):
    planes = [torch.zeros((8, 4), device=cuda) for _ in range(8)]
    rs = torch.zeros((8, 4), dtype=torch.int32, device=cuda)
    hap = torch.full((24, 4), 5, dtype=torch.int32, device=cuda)
    y0 = torch.zeros(4, device=cuda)
    with pytest.raises(TypeError):
        K.pairhmm_forward(*planes, rs.to(torch.int64), hap, y0)
    with pytest.raises(ValueError, match="contiguous"):
        K.pairhmm_forward(*planes[:7], planes[7].t().contiguous().t(), rs, hap, y0)
    big = torch.zeros((264, 4), device=cuda)
    with pytest.raises(ValueError, match="rows"):
        K.pairhmm_forward(*[big] * 8, big.int(), torch.zeros((300, 4), dtype=torch.int32,
                                                             device=cuda), y0)
    assert torch.all(K.pairhmm_forward(*planes, rs, hap, y0) == 0)


@pytest.mark.gpu
def test_cuda_engine_matches_cpu_engine(cuda):
    rng = np.random.default_rng(1)
    reads, haps = gen_pairhmm_input(rng, 40, 4, max_read_len=100, max_hap_len=200,
                                    derived=True)
    cfg = PairHMMConfig(read_buckets=(64, 128), hap_buckets=(128, 256))
    got_eng = PairHMMEngine(cfg, device="cuda")
    want_eng = PairHMMEngine(cfg, device="cpu")
    for eng in (got_eng, want_eng):
        eng.min_device_cells = 0
    before = K.LAUNCHES["pairhmm_forward_from_quals"]
    got = got_eng.compute_matrix(reads, haps)
    want = want_eng.compute_matrix(reads, haps)
    assert K.LAUNCHES["pairhmm_forward_from_quals"] - before == got_eng.stats["device_calls"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert got_eng.stats == want_eng.stats


def _sw_planes(rng, n, ref_len, rows, cols, cuda):
    ref, alts = gen_sw_batch(rng, n, ref_len=ref_len)
    refs = [ref] * n
    refs[-1] = rng.integers(0, 4, ref_len // 3).astype(np.uint8)  # short ref
    ref_p = np.empty((n, rows), np.uint8)
    alt_p = np.empty((n, cols), np.uint8)
    rl = pack_planes(refs, rows, ref_p)
    al = pack_planes(alts, cols, alt_p)
    return [torch.from_numpy(x).to(cuda) for x in (ref_p, alt_p, rl, al)]


@pytest.mark.gpu
@pytest.mark.parametrize("bucket", [(64, 56), (1536, 1450)])
def test_cuda_sw_kernels_match_plain(cuda, bucket):
    """Bit-exact in each pair's region, all four strategies; 1536 rows
    run two rows per thread (a block has at most 1024 threads)."""
    rows, ref_len = bucket
    rng = np.random.default_rng(2)
    ref, alt, rl, al = _sw_planes(rng, 6, ref_len, rows, rows, cuda)
    region = SK.btrack_region(rl, al, rows, rows)
    for strategy in (0, 1, 2, 3):
        before = dict(SK.LAUNCHES)
        got = SK.sw_fill(ref, alt, rl, al, strategy)
        want = SK.sw_fill_plain(ref, alt, rl, al, strategy)
        packed = SK.sw_walk(*got, rl, al, strategy)
        torch.cuda.synchronize()
        assert SK.LAUNCHES["sw_fill"] == before.get("sw_fill", 0) + 1
        assert SK.LAUNCHES["sw_walk"] == before.get("sw_walk", 0) + 1
        assert not ((got[0] != want[0]) & region).any()
        for b in range(len(rl)):
            assert torch.equal(got[1][b, : al[b]], want[1][b, : al[b]])
            assert torch.equal(got[2][b, : rl[b]], want[2][b, : rl[b]])
        assert torch.equal(packed, SK.sw_walk_plain(*want, rl, al, strategy))


@pytest.mark.gpu
def test_cuda_sw_engine_matches_native_host(cuda):
    rng = np.random.default_rng(3)
    refs, alts = [], []
    for ln in (40, 100, 200, 300, 90, 250):
        r, a = gen_sw_batch(rng, 3, ref_len=ln)
        refs += [r] * 3
        alts += a
    big, (big_alt,) = gen_sw_batch(rng, 1, ref_len=1600)  # past 1536: host
    refs.append(big)
    alts.append(big_alt)
    eng = SWEngine(device="cuda")
    n_buckets = len({(eng._bucket(len(r)), eng._bucket(len(a)))
                     for r, a in zip(refs[:-1], alts[:-1])})
    before = SK.LAUNCHES["sw_walk"]
    for strategy in (0, 1, 2, 3):
        got = eng.align(refs, alts, strategy)
        assert got == native.sw_align_host(refs, alts, strategy)
    assert eng.stats["host_fallback"] == 4
    assert SK.LAUNCHES["sw_walk"] - before == 4 * n_buckets  # one chunk each
