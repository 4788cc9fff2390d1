"""CUDA kernel and engine checks of the PyTorch port; they need a card.

This file imports nothing of JAX or the JAX package, so it also runs
where JAX is not installed (the repository's conftest imports it):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Without a card every test skips.  Tolerances: the PairHMM kernel against
its plain PyTorch version in log space rtol 1e-5 (the kernel contracts
multiply-adds into fmas and sums in another order); inert lanes exactly 0.
The SW, extension and SMEM kernels are integer: bit-exact against their
plain versions, and their engines exact against the native host engines.
The band kernel against its plain version (both front ends): every value
written within rtol 1e-5 of its largest value; the SP route within 2e-4
of the native fp32 host engine and within 1e-5 of the DP kernel (another
summation order).
"""

import json
import os

import numpy as np
import pytest
import torch

from acc_genomics_tpu_torch import native
from acc_genomics_tpu_torch.config import PairHMMConfig, SmemConfig
from acc_genomics_tpu_torch.io import bwasw_records as br
from acc_genomics_tpu_torch.io.synth import (
    gen_pairhmm_input,
    gen_pairhmm_pairs,
    gen_reference_with_repeats,
    gen_smem_reads,
    gen_sw_batch,
)
from acc_genomics_tpu_torch.ops.smem.index import FMIndex
from acc_genomics_tpu_torch.build import ensure_native
from acc_genomics_tpu_torch.engine.genomics_engine import GenomicsEngine
from acc_genomics_tpu_torch.engine.extend_engine import (
    ExtendEngine,
    resolve_seeds,
    seed_tasks,
)
from acc_genomics_tpu_torch.ops.pairhmm.context import PairHMMContext
from acc_genomics_tpu_torch.ops.pairhmm.pack import pack_pairhmm_batch, pack_pairhmm_quals
from acc_genomics_tpu_torch.engine.pairhmm_engine import PairHMMEngine, sp_chunk_rows
from acc_genomics_tpu_torch.engine.smem_engine import SmemEngine
from acc_genomics_tpu_torch.engine.sw_engine import SWEngine
from acc_genomics_tpu_torch.models import BwaEngines, BwaMemDevicePipeline, BwaMemSeeding
from acc_genomics_tpu_torch.ops.extend import kernel as EK
from acc_genomics_tpu_torch.ops.pairhmm import kernel as K
from acc_genomics_tpu_torch.ops.smem import kernel as MK
from acc_genomics_tpu_torch.ops.smem.table import DeviceIndex
from acc_genomics_tpu_torch.ops.sw import kernel as SK
from acc_genomics_tpu_torch.ops.sw.batch import pack_planes
from acc_genomics_tpu_torch.ops.pairhmm import band_kernel as BK
from acc_genomics_tpu_torch.parallel import make_mesh, pairhmm_forward_dp, pairhmm_forward_dpsp
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
    big = torch.zeros((1032, 4), device=cuda)
    with pytest.raises(ValueError, match="rows"):
        K.pairhmm_forward(*[big] * 8, big.int(), torch.zeros((1068, 4), dtype=torch.int32,
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
    run 48 chunks of 32 rows in turn on a pair's warp."""
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
def test_cuda_sw_fill_warp_edges(cuda):
    """The warp-per-pair fill at its edges (reflen 1-65 at the 32-row chunk
    boundaries against altlen 1 and full, batches of 1, 5 and 13 pairs that
    leave a four-warp block partly filled, a 1536-row bucket filled) in all
    four strategies: bit-exact in each pair's region, the walk of its
    outputs bit-exact too."""
    from acc_genomics_tpu_torch.tools.bench_shapes import sw_fill_batches

    batches = sw_fill_batches(cuda)
    assert len(batches) == 5
    for name, ref, alt, rl, al in batches:
        rows, cols = ref.shape[1], alt.shape[1]
        region = SK.btrack_region(rl, al, rows, cols)
        for strategy in (0, 1, 2, 3):
            got = SK.sw_fill(ref, alt, rl, al, strategy)
            want = SK.sw_fill_plain(ref, alt, rl, al, strategy)
            assert not ((got[0] != want[0]) & region).any(), (name, strategy)
            for b in range(len(rl)):
                assert torch.equal(got[1][b, : al[b]], want[1][b, : al[b]]), (name, b)
                assert torch.equal(got[2][b, : rl[b]], want[2][b, : rl[b]]), (name, b)
            assert torch.equal(SK.sw_walk(*got, rl, al, strategy),
                               SK.sw_walk_plain(*want, rl, al, strategy)), (name, strategy)


@pytest.mark.gpu
def test_cuda_sw_walk_warp_edges(cuda):
    """The warp-a-pair walk at its edges (``sw_walk_batches``: match runs
    of 31-64 cells, gaps past 32, gaps first and last, walks ending on row
    0 or column 0, lengths of 1, start-cell ties, 47-53 elements, 4096
    gap-heavy pairs) in all four strategies, on the plain fill's outputs
    with every cell outside the pairs' regions poisoned: bit-exact against
    the plain walk, one launch a call."""
    from acc_genomics_tpu_torch.tools.bench_shapes import sw_walk_batches

    batches = sw_walk_batches(cuda)
    assert len(batches) == 6
    for name, ref, alt, rl, al in batches:
        region = SK.btrack_region(rl, al, ref.shape[1], alt.shape[1])
        for strategy in (0, 1, 2, 3):
            btrack, lastrow, altcol = SK.sw_fill_plain(ref, alt, rl, al, strategy)
            btrack.masked_fill_(~region, 0x7777)
            before = SK.LAUNCHES["sw_walk"]
            got = SK.sw_walk(btrack, lastrow, altcol, rl, al, strategy)
            assert SK.LAUNCHES["sw_walk"] == before + 1
            want = SK.sw_walk_plain(btrack, lastrow, altcol, rl, al, strategy)
            assert torch.equal(got, want), (name, strategy)


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


@pytest.mark.gpu
@pytest.mark.parametrize("strategy", [0, 1, 2, 3])
def test_cuda_sw_engine_empty_side_on_the_host(cuda, strategy):
    """Pairs with an empty ref or alt among card pairs: ([], 0) from the
    native host engine, counted in host_fallback; the rest on the card."""
    rng = np.random.default_rng(4)
    ref, alts = gen_sw_batch(rng, 6, ref_len=80)
    empty = np.zeros(0, np.uint8)
    refs = [ref, empty, ref, empty, ref, ref]
    alts = [alts[0], alts[1], empty, empty, alts[4], alts[5]]
    eng = SWEngine(device="cuda")
    before = SK.LAUNCHES["sw_fill"]
    got = eng.align(refs, alts, strategy)
    assert got == native.sw_align_host(refs, alts, strategy)
    assert got[1] == got[2] == got[3] == ([], 0)
    assert eng.stats["host_fallback"] == 3 and SK.LAUNCHES["sw_fill"] == before + 1


@pytest.fixture(scope="module")
def two_ranks_on_the_card(tmp_path_factory):
    """tools/pg_run.py's two ranks on cuda:0 (small shapes): their reports
    and rank 0's npz."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from acc_genomics_tpu_torch.tools.pg_run import run_ranks

    tmp = str(tmp_path_factory.mktemp("pg"))
    outs = run_ranks(tmp, "cuda", "small", timeout=600, out=True)
    for r, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {r} failed:\n{out}"
    reports = [json.loads(out.strip().splitlines()[-1]) for _, out in outs]
    return reports, dict(np.load(os.path.join(tmp, "rank0.npz")))


@pytest.mark.gpu
def test_cuda_two_process_dp(two_ranks_on_the_card):
    """pairhmm_forward_dp_pg in two processes on one card: each rank's
    checks (gathered equal to the single-process form within 1e-6, local
    halves exact) and the kernel launched; the gathered result within
    rtol 1e-5 of the plain forward."""
    reports, f = two_ranks_on_the_card
    for rep in reports:
        assert rep["checks"]["pairhmm_dp"] and rep["launches"]["pairhmm_forward"] >= 2
        assert all(rep["checks"].values()), rep["checks"]
    args = [torch.from_numpy(f[f"in_dp_{j}"]) for j in range(11)]
    want = K.pairhmm_forward_plain(*args).numpy()
    np.testing.assert_allclose(f["pairhmm_dp_gathered_0"], want, rtol=1e-5)


@pytest.mark.gpu
def test_cuda_two_process_dpsp(two_ranks_on_the_card):
    """pairhmm_forward_dpsp_pg (both front ends) on a (1, 2) grid of two
    processes on one card: bit for bit the single-process pipeline (each
    rank's check), the band kernel launched, and within rtol 1e-5 of the
    DP forward's plain version (another summation order)."""
    reports, f = two_ranks_on_the_card
    for rep in reports:
        assert rep["checks"]["pairhmm_dpsp"] and rep["checks"]["pairhmm_dpsp_quals"]
        assert rep["launches"]["pairhmm_band_superstep"] > 0
    args = [torch.from_numpy(f[f"in_dpsp_{j}"]) for j in range(11)]
    want = K.pairhmm_forward_plain(*args).numpy()
    np.testing.assert_allclose(f["pairhmm_dpsp_gathered_0"], want, rtol=1e-5)
    np.testing.assert_allclose(f["pairhmm_dpsp_quals_gathered_0"], want, rtol=2e-4)


FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _extend_batch(rng, n, qmax, tmax):
    """Query-like targets with errors, a 7-base insertion in every fourth
    (round 2 at band 8), ambiguous bases in every fifth; time-major."""
    q = np.full((qmax, n), 4, np.uint8)
    t = np.full((tmax, n), 4, np.uint8)
    ql = rng.integers(0, qmax + 1, n).astype(np.int32)
    tl = rng.integers(0, tmax + 1, n).astype(np.int32)
    for b in range(n):
        qq = rng.integers(0, 4, ql[b]).astype(np.uint8)
        tt = rng.integers(0, 4, tl[b]).astype(np.uint8)
        src = qq if b % 4 else np.concatenate([qq[:20], rng.integers(0, 4, 7), qq[20:]])
        m = min(len(src), tl[b])
        tt[:m] = np.where(rng.random(m) < 0.95, src[:m], tt[:m])
        if b % 5 == 0:
            tt[::9] = 4
        q[: ql[b], b] = qq
        t[: tl[b], b] = tt
    h0 = rng.integers(1, 40, n).astype(np.int32)
    return q, t, ql, tl, h0


@pytest.mark.gpu
@pytest.mark.parametrize("w", [100, 8])
def test_cuda_extend_kernel_matches_plain(cuda, w):
    from acc_genomics_tpu_torch.ops.extend.reference import ExtendParams

    rng = np.random.default_rng(4)
    p = ExtendParams(w=w)
    q, t, ql, tl, h0 = (torch.from_numpy(x).to(cuda) for x in _extend_batch(rng, 700, 128, 256))
    before = EK.LAUNCHES["sw_extend"]
    got = EK.sw_extend_rows(q, t, ql, tl, h0, ql, ql, p)
    torch.cuda.synchronize()
    assert EK.LAUNCHES["sw_extend"] == before + 1
    want = EK.sw_extend_plain(q, t, ql, tl, h0, ql, ql, p)
    assert torch.equal(got, want)
    if w == 8:
        assert (got[6] == 16).any()


@pytest.mark.gpu
def test_cuda_extend_engine_matches_native_host(cuda):
    genome = np.load(os.path.join(FIX, "bwasw_genome.npy"))
    tasks = br.read_task_file(os.path.join(FIX, "bwasw_tasks0.bin"))
    want = br.read_results(os.path.join(FIX, "bwasw_results0.bin"))
    eng = ExtendEngine(device=cuda)
    got = {r["seed_index"]: r for r in br.run_tasks(eng, genome, tasks)}
    assert all(got[w["seed_index"]] == w for w in want)
    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, 6000).astype(np.uint8)
    seeds = []
    for k in range(300):
        pos = int(rng.integers(1200, 4700))
        read = genome[pos: pos + 101].copy()
        read[rng.random(101) < 0.03] = 1
        qb = int(rng.integers(0, 80))
        flank = 100 if k % 50 else 1100  # past max_tlen: the host
        lo = max(0, pos - flank)
        seeds.append(dict(read=read, rseq=genome[lo: pos + 101 + flank], qbeg=qb,
                          rbeg_off=pos + qb - lo, len=19))
    eng = ExtendEngine(device=cuda)
    before = EK.LAUNCHES["sw_extend"]
    got = eng.extend_seeds(seeds)
    lq, lt, rq, rt = seed_tasks(seeds)
    lres = native.sw_extend_host(lq, lt, [19] * len(seeds), eng.params)
    rres = native.sw_extend_host(rq, rt, [int(v) for v in lres["score"]], eng.params)
    assert got == resolve_seeds(seeds, lres, rres, eng.params.pen_clip)
    assert eng.stats["host_fallback"] == 6
    assert EK.LAUNCHES["sw_extend"] - before == eng.stats["device_calls"]


def _smem_case(rng):
    ensure_native()  # FMIndex.build's suffix array comes from it
    genome = gen_reference_with_repeats(rng, 50_000)
    reads = gen_smem_reads(rng, genome, 500, read_len=101)
    reads[0][30:33] = 4
    reads += [np.full(40, 4, np.uint8), reads[1][:10].copy(), np.zeros(0, np.uint8)]
    return FMIndex.build(genome), reads


@pytest.mark.gpu
@pytest.mark.parametrize("n_reads", [1, 33, 2048])
def test_cuda_smem_kernel_matches_plain(cuda, n_reads):
    """The persistent lockstep kernel bit for bit against its plain
    version: 1, 33 and 2,048 reads (the last with a 30% N share on a
    quarter of them), at the default caps, at caps that 24-row chains and
    most reads bust (flag set, the same rows up to the stop), and at
    32-row chains (wider ones: test_cuda_smem_wide_caps_match_plain)."""
    from acc_genomics_tpu_torch.ops.smem.reference import SmemParams

    rng = np.random.default_rng(6)
    fm, reads = _smem_case(rng)
    reads = (reads * (n_reads // len(reads) + 1))[:n_reads]
    if n_reads == 2048:
        reads[:512] = [np.where(rng.random(len(r)) < 0.3, 4, r).astype(np.uint8)
                       for r in reads[:512]]
    seq = np.full((128, len(reads)), 4, np.uint8)
    lens = np.array([len(r) for r in reads], np.int32)
    for k, r in enumerate(reads):
        seq[: len(r), k] = r
    idx = DeviceIndex.build(fm, cuda)
    seq_d, lens_d = torch.from_numpy(seq).to(cuda), torch.from_numpy(lens).to(cuda)
    flagged = 0
    for params in (SmemParams(), SmemParams(curr_cap=3, mem_cap=4),
                   SmemParams(curr_cap=32, mem_cap=64)):
        before = MK.LAUNCHES["smem_collect"]
        got = MK.smem_collect(idx, seq_d, lens_d, params)
        torch.cuda.synchronize()
        assert MK.LAUNCHES["smem_collect"] == before + 1
        want = MK.smem_collect_plain(idx, seq_d, lens_d, params)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        flagged += int(got[2].sum())
    assert flagged > 0  # the tight caps flag reads


@pytest.mark.gpu
def test_cuda_smem_engine_and_bwa_mem_match_host(cuda):
    fm, reads = _smem_case(np.random.default_rng(7))
    reads.append(np.tile(reads[2], 3))  # past seq_length: the host
    eng = SmemEngine(fm, SmemConfig(batch_size=128), device=cuda)
    before = MK.LAUNCHES["smem_collect"]
    got = eng.collect(reads)
    assert got == native.smem_collect_host(fm, reads, eng.params)
    # 500 reads of 101 in batches of 128 (bucket 128), 3 short ones (bucket 64)
    assert MK.LAUNCHES["smem_collect"] - before == 5
    engines = BwaEngines(eng, ExtendEngine(device=cuda))
    cpu = BwaEngines(SmemEngine(fm, device="cpu"), ExtendEngine(device="cpu"))
    sub = reads[:16]
    assert (BwaMemSeeding(engines, max_occ=4).map_reads(sub)
            == BwaMemSeeding(cpu, max_occ=4).map_reads(sub))


def _retry_case(rng):
    """A repeat-rich 200 kbp index and 403 reads of 150 over it: reads
    that the default caps flag, three whose chains outgrow 32 rows."""
    from acc_genomics_tpu_torch.tools.bench_shapes import smem_repeat_genome, smem_retry_reads

    ensure_native()
    genome = smem_repeat_genome(rng, 200_000)
    return FMIndex.build(genome), smem_retry_reads(rng, genome, 400)


@pytest.mark.gpu
@pytest.mark.parametrize("chain_cap,width", [(24, 160), (64, 160), (161, 160),
                                             (MK.CHAIN_MAX, 256), (MK.chain_room(512), 512)])
def test_cuda_smem_wide_caps_match_plain(cuda, chain_cap, width):
    """The kernel at the retry's caps (256 output rows) bit for bit
    against its plain version on reads the default caps flag.  At the
    largest chain cap a 32-lane block takes 224,000 bytes of chains and
    8,192 of reads: the launch is taken both for the reads and for a
    batch past 64 reads an SM, whose 64-lane blocks would not fit.  At
    width 512 the largest chain cap is 241, and 250 is refused before the
    launch."""
    from acc_genomics_tpu_torch.engine.packing import pack_tm

    fm, reads = _retry_case(np.random.default_rng(12))
    idx = DeviceIndex.build(fm, cuda)
    params = SmemConfig().params()._replace(curr_cap=chain_cap, mem_cap=256)

    def launch(batch):
        seq, lens = pack_tm(batch, width, len(batch))
        seq_d, lens_d = torch.from_numpy(seq).to(cuda), torch.from_numpy(lens).to(cuda)
        before = MK.LAUNCHES["smem_collect"]
        got = MK.smem_collect(idx, seq_d, lens_d, params)
        torch.cuda.synchronize()
        assert MK.LAUNCHES["smem_collect"] == before + 1
        return seq_d, lens_d, got

    seq_d, lens_d, got = launch(reads)
    if width > 256:
        with pytest.raises(ValueError, match="CHAIN_MAX"):
            MK.smem_collect(idx, seq_d, lens_d, params._replace(curr_cap=MK.CHAIN_MAX))
    want = MK.smem_collect_plain(idx, seq_d, lens_d, params)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    flagged = int(got[2].sum())
    assert flagged > 0 if chain_cap < 161 else flagged == 0
    if chain_cap == MK.chain_room(width):
        # each read's answer does not depend on its batch
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        copies = 64 * sms // len(reads) + 1
        _, _, big = launch(reads * copies)
        assert torch.equal(big[0], got[0].repeat(1, 1, copies))
        for a, b in zip(big[1:], got[1:]):
            assert torch.equal(a, b.repeat(copies))


@pytest.mark.gpu
def test_cuda_smem_retry_matches_host(cuda):
    """``retry_arrays`` on the reads the first launch flags, a
    trinucleotide repeat of 150 among them: one more
    launch, nothing on the host, ``host_arrays``' intervals in order."""
    from acc_genomics_tpu_torch.engine.packing import pack_tm

    fm, reads = _retry_case(np.random.default_rng(13))
    reads.append(np.resize(np.array([1, 0, 2], np.uint8), 150))
    eng = SmemEngine(fm, device=cuda)
    _, _, flags = eng.collect_arrays(*pack_tm(reads, 160, len(reads)))
    flagged = [reads[k] for k in np.flatnonzero(flags)]
    assert len(flagged) > 10 and flags[-1]
    before, host = MK.LAUNCHES["smem_collect"], eng.stats["retry_host"]
    flat, counts = eng.retry_arrays(flagged)
    assert MK.LAUNCHES["smem_collect"] == before + 1 and eng.stats["retry_host"] == host
    want_flat, want_counts = eng.host_arrays(flagged)
    np.testing.assert_array_equal(counts, want_counts)
    np.testing.assert_array_equal(flat, want_flat)


@pytest.mark.gpu
def test_cuda_pipeline_retries_flagged_reads_on_the_card(cuda):
    fm, reads = _retry_case(np.random.default_rng(14))
    eng = GenomicsEngine(device=cuda)
    eng.set_index(fm)
    pipe = BwaMemDevicePipeline(eng, max_occ=4, flank=100)
    before = MK.LAUNCHES["smem_collect"]
    got = pipe.map_reads(reads)
    assert MK.LAUNCHES["smem_collect"] - before == 2
    assert pipe.anatomy["rerun_reads"] > 10 and pipe.anatomy["rerun_host_reads"] == 0
    assert got == BwaMemSeeding(eng, max_occ=4, flank=100).map_reads(reads)


def _pipeline_case(cuda, flank):
    """A GenomicsEngine on the card over a 50 kbp index, its pipeline, and
    reads: 500 of 101, both text ends, one past seq_length, one all-N."""
    fm, reads = _smem_case(np.random.default_rng(8))
    reads += [fm.text[:70].copy(), fm.text[-70:].copy(), np.tile(reads[2], 3)]
    eng = GenomicsEngine(device=cuda)
    eng.set_index(fm)
    return eng, BwaMemDevicePipeline(eng, max_occ=4, flank=flank), reads


@pytest.mark.gpu
@pytest.mark.parametrize("flank", [100, 300])
def test_cuda_fused_extension_matches_plain(cuda, flank):
    import acc_genomics_tpu_torch.models.bwa_mem as bwa_module

    _, pipe, reads = _pipeline_case(cuda, flank)
    calls = []
    real = bwa_module.extend_seeds_fused
    bwa_module.extend_seeds_fused = lambda *a: (calls.append(a), real(*a))[1]
    try:
        before = EK.LAUNCHES["sw_extend_fused"]
        hits = pipe.map_reads_arrays(reads)[0]
    finally:
        bwa_module.extend_seeds_fused = real
    assert EK.LAUNCHES["sw_extend_fused"] == before + 1 and hits.shape[1] > 0
    want = EK.extend_seeds_fused_plain(*calls[0])
    assert torch.equal(torch.from_numpy(hits), want.cpu())


@pytest.mark.gpu
def test_cuda_fused_extension_warp_edges(cuda):
    """The warp-per-seed fused kernel at its edges (left queries of 0, 1,
    31, 32 and 33 at width 256, widths 32, 33 and 300 (tiles), seeds at
    both text ends with flank 100 and 300, round 2 at band 8) bit for bit
    against the plain version; a read width past the tiles raises."""
    from acc_genomics_tpu_torch.tools.bench_shapes import fused_batches

    batches = fused_batches(cuda)
    assert len(batches) == 7
    for b in batches:
        args = [b[k] for k in ("sa", "text", "reads", "rlens", "rows", "qbeg", "slen",
                               "readid", "flank", "params")]
        before = EK.LAUNCHES["sw_extend_fused"]
        got = EK.extend_seeds_fused(*args)
        want = EK.extend_seeds_fused_plain(*args)
        assert EK.LAUNCHES["sw_extend_fused"] == before + 1
        assert torch.equal(got, want), b["name"]
        if b["name"].startswith("round 2"):
            assert bool((want[6] == 2 * b["params"].w).any())
    b = batches[0]
    wide = torch.zeros((1, EK.MAX_QUERY + 1), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="read width"):
        EK.extend_seeds_fused(b["sa"], b["text"], wide, b["rlens"][:1], b["rows"],
                              b["qbeg"], b["slen"], b["readid"] * 0, 100)


@pytest.mark.gpu
def test_cuda_pipeline_matches_bwa_mem_seeding(cuda):
    eng, pipe, reads = _pipeline_case(cuda, 100)
    got = pipe.map_reads(reads)
    assert got == BwaMemSeeding(eng, max_occ=4, flank=100).map_reads(reads)
    assert got[-1] and got[500] == []  # the host route; the all-N read


def _band_state(cuda, rng, C, front, bd, n_chunks=3, hc=96):
    """A three-shard pipeline state of one data group, random non-zero
    tops and edges, and its pack (byte planes or fp32 planes) on the card:
    the superstep's arguments but t, first and n_active."""
    rows, cols, lanes = n_chunks * C, 3 * hc, bd + 7  # the group sits at lane 7
    tcs = gen_pairhmm_pairs(rng, lanes, max_read_len=rows - 1, max_hap_len=cols)
    ctx = PairHMMContext(np.float32)
    if front == "coef":
        pack = pack_pairhmm_batch(tcs, rows=rows, cols=cols, pad_lanes=False)
        planes = tuple(batch_to_torch(pack, cuda))
        hap_ext, planes, tables = planes[9], planes[:9] + planes[10:], ()
    else:
        qp = pack_pairhmm_quals(tcs, rows=rows, cols=cols, pad_lanes=False)
        q, i, d, c, rs, hap_ext, rslen, haplen = quals_to_torch(qp, cuda)
        planes = (q, i, d, c, rs, rslen, haplen)
        ph2pr, m2m, _ = context_tables(ctx, cuda)
        tables = (ph2pr, m2m, float(ctx.initial_constant))
    hap = hap_ext[:cols].t().contiguous().to(torch.uint8)
    slots = torch.tensor([[0, 7, -1], [1, 7, 0], [2, 7, 1]], dtype=torch.int32, device=cuda)
    state = [rng.uniform(0.1, 2.0, (2, 3, 3, bd, hc)), rng.uniform(0.1, 2.0, (3, 3, bd, rows + 1)),
             np.zeros((3, bd))]
    state = [torch.from_numpy(x.astype(np.float32)).to(cuda) for x in state]
    return (front, planes, tables, hap, slots, *state)


@pytest.mark.gpu
@pytest.mark.parametrize("front", ["arith", "gather", "coef"])
@pytest.mark.parametrize("C", [8, 16, 32])
def test_cuda_band_kernel_matches_plain(cuda, C, front):
    """The superstep kernel against its plain version: three shards of
    300 lanes (not a multiple of a block's problems) and of 5 lanes (one
    block, not filled), the first, a middle and the last superstep; every
    value written within rtol 1e-5 of the largest value of its output."""
    rng = np.random.default_rng(C)
    for bd in (300, 5):
        base = _band_state(cuda, rng, C, front, bd)
        for t, first, n in ((0, 0, 1), (2, 0, 3), (4, 2, 1)):
            got = [x.clone() for x in base[5:]]
            want = [x.clone() for x in base[5:]]
            before = BK.LAUNCHES["pairhmm_band_superstep"]
            BK.pairhmm_band_superstep(*base[:5], *got, t, first, n, C, 3)
            torch.cuda.synchronize()
            assert BK.LAUNCHES["pairhmm_band_superstep"] == before + 1
            BK.pairhmm_band_superstep_plain(*base[:5], *want, t, first, n, C, 3)
            for g, w in zip(got, want):
                scale = float(w.abs().max())
                torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * scale)
    with pytest.raises(ValueError, match="chunk rows"):
        BK.pairhmm_band_superstep(*base[:5], *base[5:], 0, 0, 1, 12, 3)


@pytest.mark.gpu
def test_cuda_sp_engine_matches_native_host(cuda):
    """Haps past 1024 on PairHMMEngine(mesh=(1, 4) of one card): every
    pair on the band pipeline, none on the host; SP against DP on a pack
    that fits."""
    rng = np.random.default_rng(3)
    reads, haps = gen_pairhmm_input(rng, 24, 3, max_read_len=150, max_hap_len=2400,
                                    derived=True)
    mesh = make_mesh((1, 4), devices=[cuda] * 4)
    eng = PairHMMEngine(device="cuda", mesh=mesh)
    eng.min_device_cells = 0
    before = BK.LAUNCHES["pairhmm_band_superstep"]
    got = eng.compute_matrix(reads, haps).reshape(-1)
    assert eng.stats["sp_chunk_rows"] == sp_chunk_rows(256)
    assert BK.LAUNCHES["pairhmm_band_superstep"] - before == 256 // sp_chunk_rows(256) + 4 - 1
    assert eng.stats["sp_pairs"] == 72 and eng.stats.get("host_fallback", 0) == 0
    tcs = [dict(hap=h, **r) for r in reads for h in haps]
    ctx = PairHMMContext(np.float32)
    raw = native.pairhmm_forward(tcs, np.float32)
    assert (raw >= 1e-28).all()
    want = np.log10(raw.astype(np.float64)) - np.float64(ctx.log10_initial_constant)
    np.testing.assert_allclose(got, want, rtol=2e-4)

    pack = pack_pairhmm_batch(gen_pairhmm_pairs(rng, 200, max_read_len=100, max_hap_len=512),
                              rows=128, cols=512)
    args = batch_to_torch(pack, cuda)
    sp = pairhmm_forward_dpsp(mesh, *args).cpu().numpy()
    dp = pairhmm_forward_dp(make_mesh((2, 1), devices=[cuda] * 2), *args).cpu().numpy()
    np.testing.assert_allclose(sp, dp, rtol=1e-5, atol=float(np.finfo(np.float32).tiny))


@pytest.mark.gpu
def test_cuda_mesh_engine_read_bucket_48_matches_native_host(cuda):
    """read_buckets=(48,) on a (1, 2) mesh of the card: the SP route at
    C = 16, within 2e-4 of the native fp32 host engine."""
    rng = np.random.default_rng(4)
    reads, haps = gen_pairhmm_input(rng, 16, 4, max_read_len=47, max_hap_len=250, derived=True)
    cfg = PairHMMConfig(read_buckets=(48,), hap_buckets=(128,))
    eng = PairHMMEngine(cfg, device="cuda", mesh=make_mesh((1, 2), devices=[cuda] * 2))
    eng.min_device_cells = 0
    before = BK.LAUNCHES["pairhmm_band_superstep"]
    got = eng.compute_matrix(reads, haps).reshape(-1)
    tcs = [dict(hap=h, **r) for r in reads for h in haps]
    n_sp = sum(len(t["hap"]) > 128 for t in tcs)
    assert n_sp > 0 and eng.stats["sp_pairs"] == n_sp and eng.stats["sp_chunk_rows"] == 16
    assert BK.LAUNCHES["pairhmm_band_superstep"] - before == 48 // 16 + 2 - 1
    ctx = PairHMMContext(np.float32)
    raw = native.pairhmm_forward(tcs, np.float32)
    assert (raw >= 1e-28).all()
    want = np.log10(raw.astype(np.float64)) - np.float64(ctx.log10_initial_constant)
    np.testing.assert_allclose(got, want, rtol=2e-4)


@pytest.mark.gpu
def test_cuda_extend_kernel_warp_edges(cuda):
    """The one-warp-a-task kernel at its edges (qlen at the boundaries of
    K = 1, 2 and 8 columns a lane, band 8, max_ins below the band, h0 0,
    and past 256 columns the shared-memory tiles: qlen 255-300, gaps at
    column 256, Q 1536 and the Q 25,600 cap) bit for bit against the plain
    version; a bucket past the cap raises."""
    from acc_genomics_tpu_torch.tools.bench_shapes import extend_batches

    edges = [b for b in extend_batches(cuda)
             if b["name"] not in ("bench", "round2", "ambiguous", "caps")]
    assert len(edges) == 11
    for b in edges:
        args = [b[k] for k in ("q", "t", "qlen", "tlen", "h0", "max_ins", "max_ins", "params")]
        got = EK.sw_extend_rows(*args)
        want = EK.sw_extend_plain(*args)
        assert torch.equal(got, want), b["name"]
    q = torch.zeros((EK.MAX_QUERY + 1, 4), dtype=torch.uint8, device=cuda)
    t = torch.zeros((8, 4), dtype=torch.uint8, device=cuda)
    n = torch.ones(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="query bucket"):
        EK.sw_extend_rows(q, t, n, n, n, n, n)


@pytest.mark.gpu
@pytest.mark.parametrize("front", ["coef", "arith", "gather"])
def test_cuda_pairhmm_kernel_segment_edges(cuda, front):
    """The segment kernel at C = 8, 16 and 32, one and two chunks, 255
    rows, 257 to 1024 rows (9 to 32 chunks) and haplotypes of 1 and 1024
    columns, and unpadded packs of 1, 5, 13 and 3 pairs whose last warp is
    partly filled: within rtol 1e-5 of the plain version, inert lanes
    exactly 0."""
    from acc_genomics_tpu_torch.tools.bench_shapes import pairhmm_edge_packs

    ctx = PairHMMContext(np.float32)
    ph2pr, m2m, _ = context_tables(ctx, cuda)
    ic = float(ctx.initial_constant)
    tiny = float(np.finfo(np.float32).tiny) * 2.0**-10
    for label, cp, qp in pairhmm_edge_packs(cuda):
        if front == "coef":
            got, want = K.pairhmm_forward(*cp), K.pairhmm_forward_plain(*cp)
            inert = cp[10] == 0
        else:
            got = K.pairhmm_forward_from_quals(*qp, ph2pr, m2m, ic, expand=front)
            want = K.pairhmm_forward_from_quals_plain(*qp, ph2pr, m2m, ic, front)
            inert = (qp[6] == 0) | (qp[7] == 0)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=tiny, msg=label)
        assert torch.all(got[inert] == 0), label


def _flat_pairs_args(tcs):
    cat = lambda key: np.concatenate([np.asarray(t[key], np.uint8) for t in tcs])
    return (cat("rs"), cat("q"), cat("i"), cat("d"), cat("c"),
            np.array([len(t["rs"]) for t in tcs], np.int32), cat("hap"),
            np.array([len(t["hap"]) for t in tcs], np.int32))


@pytest.mark.gpu
def test_cuda_f32_upload_matches_byte_planes(cuda):
    """upload="f32" on the card: the native coefficient pack through the
    kernel's coefficient front end, against the byte-plane route (gather
    rtol 1e-6, arith 2e-4) and the oracle (5e-3)."""
    from acc_genomics_tpu_torch.ops.pairhmm.reference import pairhmm_loglik_oracle

    tcs = gen_pairhmm_pairs(np.random.default_rng(21), 300, max_read_len=120,
                            max_hap_len=300)
    flat = _flat_pairs_args(tcs)
    outs = {}
    for mode in ("gather", "arith", "f32"):
        cfg = PairHMMConfig(upload="f32" if mode == "f32" else "quals",
                            quals_expand="arith" if mode == "arith" else "gather")
        K.LAUNCHES.clear()
        eng = PairHMMEngine(cfg, device="cuda")
        outs[mode] = eng.compute_pairs_flat(*flat)
        kernel = "pairhmm_forward" if mode == "f32" else "pairhmm_forward_from_quals"
        assert K.LAUNCHES[kernel] == eng.stats["device_calls"] > 0
    np.testing.assert_allclose(outs["f32"], outs["gather"], rtol=1e-6)
    np.testing.assert_allclose(outs["f32"], outs["arith"], rtol=2e-4)
    want = [pairhmm_loglik_oracle(t["rs"], t["q"], t["i"], t["d"], t["c"], t["hap"])
            for t in tcs[::10]]
    np.testing.assert_allclose(outs["f32"][::10], want, rtol=5e-3)


@pytest.mark.gpu
def test_cuda_calibrated_dispatch_routes(cuda):
    eng = PairHMMEngine(device="cuda")
    model = eng.calibrate_dispatch(device_gcups=100.0, fixed_s=1e-3)
    assert model.host_gcups > 0 and model.link_gb_s > 0.1 and model.cores == 1
    tcs = gen_pairhmm_pairs(np.random.default_rng(22), 8)
    eng.compute_pairs(tcs)  # 8 small pairs: the host is quicker
    assert eng.stats.get("host_native_calls", 0) == 1 and eng.stats["device_calls"] == 0


@pytest.mark.gpu
def test_cuda_service_loopback(cuda):
    """A daemon on the card answers PairHMM, SW and SMEM requests equal to
    the engine's direct calls, and counts them."""
    from acc_genomics_tpu_torch.parallel.service import EngineClient, EngineServer

    rng = np.random.default_rng(23)
    server = EngineServer(device="cuda").start()
    try:
        client = EngineClient(*server.address, device="cuda", request_timeout=300)
        assert client.connected
        reads, haps = gen_pairhmm_input(rng, 32, 4, max_read_len=100, max_hap_len=200)
        K.LAUNCHES.clear()
        lik = client.pairhmm(reads, haps)
        assert K.LAUNCHES["pairhmm_forward_from_quals"] > 0
        from acc_genomics_tpu_torch.tools.bench_shapes import flat_matrix_args

        direct = server.engine.pairhmm.compute_matrix_flat(*flat_matrix_args(reads, haps))
        assert lik.tobytes() == direct.tobytes()
        ref, alts = gen_sw_batch(rng, 64, ref_len=200)
        assert client.sw([ref] * 64, alts) == native.sw_align_host([ref] * 64, alts, 0)
        genome = gen_reference_with_repeats(rng, 50_000)
        client.load_reference(genome)
        smem_reads = gen_smem_reads(rng, genome, 256)
        fm = FMIndex.build(genome)
        assert client.smem(smem_reads) == native.smem_collect_host(fm, smem_reads)
        assert sum(server.answered.values()) == 4 and not client.used_fallback
        client.shutdown_server()
    finally:
        server.stop()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["empty", "hifi", "illumina"])
def test_cuda_gather_equals_the_native_pack(cuda, case):
    """The byte-plane gather on the card: every byte of every bucket's
    region the native host pack's, one launch."""
    from acc_genomics_tpu_torch.ops.pairhmm.gather import GatherLayout, pairhmm_gather
    from acc_genomics_tpu_torch.tools.bench_shapes import (
        GATHER_CASES,
        gather_case,
        native_planes,
    )

    ensure_native()
    batch = gather_case(np.random.default_rng(3), *GATHER_CASES[case])
    streams, offs, lens, hoffs, hlens, groups = batch
    layout = GatherLayout.plan([(rows, cols, len(sel)) for sel, rows, cols in groups],
                               [len(s) for s in streams])
    hv = np.empty(layout.nbytes, np.uint8)
    layout.fill(hv, streams, offs, lens, hoffs, hlens, [sel for sel, _, _ in groups])
    dev = torch.from_numpy(hv).to(cuda)
    before = K.LAUNCHES["pairhmm_gather"]
    planes = pairhmm_gather(dev, layout)
    torch.cuda.synchronize()
    assert K.LAUNCHES["pairhmm_gather"] == before + 1
    assert planes.device == dev.device
    assert np.array_equal(planes.cpu().numpy(), native_planes(*batch))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["gatk_hc_wgs30x", "gatk_hc_hifi28x"])
def test_cuda_flat_route_equals_the_native_pack_route(cuda, name):
    """compute_pairs_flat on a seeded HC batch: the float64 likelihoods
    of the planes gathered on the card equal, bit for bit, those of the
    same buckets' planes packed by the native host pack and run through
    the same forward kernel and epilogue; one gather launch a call."""
    from acc_genomics_tpu_torch.config import engine_config_from_dict
    from acc_genomics_tpu_torch.tools.bench_shapes import hc_flat_batch
    from acc_genomics_tpu_torch.utils.convert import HAP_PAD
    from port_bench.gen.regions import make_regions
    from port_bench.manifest import Manifest

    ensure_native()
    conf = Manifest().config(name)
    args, kw = hc_flat_batch(make_regions(np.random.default_rng(21), conf, 6))
    cfg = engine_config_from_dict(conf["engine"]).pairhmm
    eng = PairHMMEngine(cfg, device="cuda")
    seen = []
    real = eng._launch_gathered

    def spy(streams, groups):
        seen.append((streams, groups))
        return real(streams, groups)

    eng._launch_gathered = spy
    before = dict(K.LAUNCHES)
    got = eng.compute_pairs_flat(*args, **kw)
    torch.cuda.synchronize()
    (streams, groups), = seen
    assert K.LAUNCHES["pairhmm_gather"] - before.get("pairhmm_gather", 0) == 1
    assert (K.LAUNCHES["pairhmm_forward_from_quals"]
            - before.get("pairhmm_forward_from_quals", 0) == len(groups) > 0)
    assert eng.stats["card_packed"] == len(args[5]) - eng.stats.get("host_fallback", 0)

    rs, q, i, d, c, offs, lens, hap, hoffs, hlens = streams
    ctx = PairHMMContext(np.float32)
    ph2pr, m2m, _ = context_tables(ctx, cuda)
    raw = np.zeros(len(lens), np.float32)
    for sel, rows, cols in groups:
        planes = native.pairhmm_pack_quals_flat(rs, q, i, d, c, offs[sel], lens[sel], hap,
                                                hoffs[sel], hlens[sel], rows, cols, HAP_PAD)
        dev = [torch.from_numpy(np.ascontiguousarray(p)).to(cuda) for p in planes]
        meta = [torch.from_numpy(np.ascontiguousarray(x[sel])).to(cuda) for x in (lens, hlens)]
        raw[sel] = K.pairhmm_forward_from_quals(
            *dev, *meta, ph2pr, m2m, float(ctx.initial_constant),
            expand=cfg.quals_expand).cpu().numpy()
    want = eng._epilogue_flat(*streams, raw)
    assert got.dtype == np.float64 and np.all(np.isfinite(got))
    assert got.tobytes() == want.tobytes()
