"""The port's BwaMemDevicePipeline on the CPU (the fused step's plain
version) against the JAX BwaMemDevicePipeline on ``GenomicsEngine()``
(its XLA extension on the CPU), on the cases of tests/test_bwamem_device.py
and on zero seeds, reads without an interval, the capped reads' native
rerun and the host route.  SeedHits and the fused step's (8, N) rows are
compared exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from acc_genomics_tpu.config import EngineConfig as JaxEngineConfig
from acc_genomics_tpu.config import SmemConfig as JaxSmemConfig
from acc_genomics_tpu.engine.genomics_engine import GenomicsEngine as JaxGenomicsEngine
from acc_genomics_tpu.io.synth import gen_reference_with_repeats, gen_smem_reads
from acc_genomics_tpu.models.bwa_mem import BwaMemDevicePipeline as JaxPipeline
from acc_genomics_tpu.models.bwa_mem import TEXT_PAD, _extend_seeds_fused
from acc_genomics_tpu.ops.extend.reference import ExtendParams as JaxExtendParams
from acc_genomics_tpu_torch.config import EngineConfig, SmemConfig
from acc_genomics_tpu_torch.engine.genomics_engine import GenomicsEngine
from acc_genomics_tpu_torch.models import BwaMemDevicePipeline, BwaMemSeeding, SeedHit
from acc_genomics_tpu_torch.ops.extend import kernel as EK
from acc_genomics_tpu_torch.tools.bench_shapes import fused_batches


def _engines(genome, smem=None):
    jax_cfg = JaxEngineConfig() if smem is None else dataclasses.replace(
        JaxEngineConfig(), smem=JaxSmemConfig(**smem))
    cfg = EngineConfig() if smem is None else dataclasses.replace(
        EngineConfig(), smem=SmemConfig(**smem))
    jax_eng = JaxGenomicsEngine(jax_cfg)
    jax_eng.load_reference(genome)
    eng = GenomicsEngine(cfg, device="cpu")
    eng.load_reference(genome)
    return jax_eng, eng


def _tuples(per_read):
    return [[dataclasses.astuple(h) for h in hits] for hits in per_read]


def _case_reads(rng):
    genome = gen_reference_with_repeats(rng, 8000, repeat_len=60, n_repeats=6)
    reads = gen_smem_reads(rng, genome, 12, read_len=75)
    reads[3][10] = 4  # an N
    reads[7] = reads[7][:30].copy()  # a short read
    return genome, reads


def test_device_pipeline_matches_jax(rng):
    genome, reads = _case_reads(rng)
    jax_eng, eng = _engines(genome)
    want = JaxPipeline(jax_eng, max_occ=4, flank=40).map_reads(reads)
    pipe = BwaMemDevicePipeline(eng, max_occ=4, flank=40)
    got = pipe.map_reads(reads)
    assert _tuples(got) == _tuples(want)
    assert all(isinstance(h, SeedHit) for hs in got for h in hs)
    assert sum(map(len, got)) > len(reads)
    # and the port's host composition on the same engine
    assert got == BwaMemSeeding(eng, max_occ=4, flank=40).map_reads(reads)
    assert pipe.stats["device_calls"] == 1 and pipe.stats["seeds"] == sum(map(len, got))
    assert pipe.anatomy["h2d_bytes"] > 0 and pipe.anatomy["d2h_bytes"] == 8 * 4 * pipe.stats["seeds"]


def test_device_pipeline_array_form_matches_jax(rng):
    genome = gen_reference_with_repeats(rng, 5000)
    jax_eng, eng = _engines(genome, smem=dict(curr_cap=64, mem_cap=64))
    reads = gen_smem_reads(rng, genome, 6, read_len=60)
    want = JaxPipeline(jax_eng, max_occ=2, flank=30).map_reads_arrays(reads)
    got = BwaMemDevicePipeline(eng, max_occ=2, flank=30).map_reads_arrays(reads)
    hits, rid, meta, host_idx = got
    assert hits.shape == (8, len(rid)) and hits.dtype == np.int32
    np.testing.assert_array_equal(hits, want[0])
    np.testing.assert_array_equal(rid, want[1])
    for a, b in zip(meta, want[2]):
        np.testing.assert_array_equal(a, b)
    assert host_idx == want[3] == []
    assert (hits[4] >= meta[1]).all()


def test_device_pipeline_large_flank_near_boundaries(rng):
    genome = gen_reference_with_repeats(rng, 3000)
    jax_eng, eng = _engines(genome)
    reads = [genome[:70].copy(), genome[-70:].copy(), genome[1000:1070].copy()]
    want = JaxPipeline(jax_eng, max_occ=4, flank=300).map_reads(reads)
    got = BwaMemDevicePipeline(eng, max_occ=4, flank=300).map_reads(reads)
    assert _tuples(got) == _tuples(want)
    assert got == BwaMemSeeding(eng, max_occ=4, flank=300).map_reads(reads)


def test_device_pipeline_edges_match_jax(rng):
    """A read past seq_length goes to the host route; reads past SMEM caps
    of 6/4 rerun natively and stay on the card route; an all-N and a
    12-base read have no interval."""
    genome = gen_reference_with_repeats(rng, 6000)
    jax_eng, eng = _engines(genome, smem=dict(curr_cap=6, mem_cap=4))
    reads = gen_smem_reads(rng, genome, 8, read_len=101)
    reads += [genome[2000:2300].copy(), np.full(101, 4, np.uint8),
              genome[500:512].copy(), np.tile(genome[40:48], 13)[:101].copy()]
    jax_pipe = JaxPipeline(jax_eng, max_occ=4, flank=100)
    pipe = BwaMemDevicePipeline(eng, max_occ=4, flank=100)
    hits, rid, _, host_idx = pipe.map_reads_arrays(reads)
    want_hits, want_rid, _, want_host = jax_pipe.map_reads_arrays(reads)
    # JAX hands the capped reads back (its arrays also carry their partial
    # seeds, which its map_reads drops); the port maps them itself.  The
    # reads JAX keeps agree in the arrays.
    assert host_idx == [8] and want_host[0] == 8 and len(want_host) > 1
    capped = [k for k in want_host if k != 8]
    assert np.isin(capped, rid).all() and 8 not in rid
    keep, want_keep = ~np.isin(rid, want_host), ~np.isin(want_rid, want_host)
    np.testing.assert_array_equal(hits[:, keep], want_hits[:, want_keep])
    np.testing.assert_array_equal(rid[keep], want_rid[want_keep])
    got, want = pipe.map_reads(reads), jax_pipe.map_reads(reads)
    assert _tuples([got[k] for k in capped]) == _tuples([want[k] for k in capped])
    assert _tuples(got) == _tuples(want)
    assert got[9] == [] and got[10] == [] and got[8] != []


def test_device_pipeline_zero_seeds(rng):
    genome = gen_reference_with_repeats(rng, 3000)
    jax_eng, eng = _engines(genome)
    reads = [np.full(60, 4, np.uint8), genome[100:110].copy()]
    pipe = BwaMemDevicePipeline(eng)
    hits, rid, meta, host_idx = pipe.map_reads_arrays(reads)
    assert hits.shape == (8, 0) and len(rid) == 0 and all(len(m) == 0 for m in meta)
    assert host_idx == []
    assert pipe.map_reads(reads) == [[], []]
    assert _tuples(JaxPipeline(jax_eng).map_reads(reads)) == [[], []]
    assert pipe.map_reads([]) == []


def _jax_fused(sa, text, reads, rlens, rows, qbeg, slen, readid, flank, params):
    """The JAX ``_extend_seeds_fused`` (use_pallas=False) on the port's
    arguments, with the guard flanks its slices need."""
    wq = reads.shape[1]
    wt = -(-(wq + flank) // 64) * 64
    guard = max(TEXT_PAD, wt)
    text_pad = np.full(len(text) + 2 * guard, 4, np.uint8)
    text_pad[guard: guard + len(text)] = text
    seq_pad = np.full((reads.shape[0], 3 * wq), 4, np.uint8)
    seq_pad[:, wq: 2 * wq] = reads
    n = rows.shape[0]
    return np.asarray(_extend_seeds_fused(
        sa, text_pad, np.int32(len(text)), seq_pad, rlens, rows, qbeg, slen, readid,
        np.ones(max(n // 128, 1), np.int32), wq=wq, wt=wt, flank=flank, use_pallas=False,
        params=JaxExtendParams(**params._asdict()), text_guard=guard))


@pytest.mark.parametrize("flank", [40, 300])
def test_fused_plain_matches_jax_fused(flank, rng):
    """extend_seeds_fused_plain against the JAX ``_extend_seeds_fused``
    (use_pallas=False) on the pipeline's own seed arrays, all 8 rows."""
    genome, reads = _case_reads(rng)
    reads += [genome[:70].copy(), genome[-70:].copy()]
    jax_eng, eng = _engines(genome)
    pipe = BwaMemDevicePipeline(eng, max_occ=4, flank=flank)
    captured = []
    real = EK.extend_seeds_fused

    def capture(*args, **kw):
        captured.append(args)
        return real(*args, **kw)

    import acc_genomics_tpu_torch.models.bwa_mem as bwa_module

    bwa_module.extend_seeds_fused = capture
    try:
        hits, _, _, _ = pipe.map_reads_arrays(reads)
    finally:
        bwa_module.extend_seeds_fused = real
    (sa, text, rd, rlens, rows, qbeg, slen, readid, fl, params), = captured
    assert fl == flank and hits.shape[1] == rows.shape[0] > 0
    got = EK.extend_seeds_fused_plain(sa, text, rd, rlens, rows, qbeg, slen, readid,
                                      flank, params).numpy()
    np.testing.assert_array_equal(got, hits)
    np.testing.assert_array_equal(
        EK.extend_seeds_fused(sa, text, rd, rlens, rows, qbeg, slen, readid, flank,
                              params).numpy(), got)

    fm = jax_eng.smem.fm
    want = _jax_fused(fm.sa.astype(np.int32), fm.text, rd.numpy(), rlens.numpy(),
                      rows.numpy(), qbeg.numpy(), slen.numpy(), readid.numpy(), flank,
                      params)
    np.testing.assert_array_equal(got, want)


_FUSED_EDGES = {b["name"]: b for b in fused_batches(torch.device("cpu"), n=24)}


@pytest.mark.parametrize("batch", sorted(_FUSED_EDGES))
def test_fused_plain_matches_jax_fused_at_warp_edges(batch):
    """The edges of the CUDA kernel's warp per seed (left queries of 0-33,
    read widths 32, 33, 256 and 300, seeds at both text ends, round 2):
    extend_seeds_fused_plain against the JAX ``_extend_seeds_fused``, all
    8 rows exactly."""
    b = _FUSED_EDGES[batch]
    keys = ("sa", "text", "reads", "rlens", "rows", "qbeg", "slen", "readid")
    got = EK.extend_seeds_fused(*(b[k] for k in keys), b["flank"], b["params"]).numpy()
    want = _jax_fused(*(b[k].numpy() for k in keys), b["flank"], b["params"])
    np.testing.assert_array_equal(got, want)
    if batch.startswith("round 2"):
        assert (got[6] == 2 * b["params"].w).any()
    if batch.startswith("text ends"):
        assert {0, len(b["text"]) - int(b["slen"][1])} <= set(got[7].tolist())


def test_fused_wrapper_rejects_mixed_devices():
    cpu = torch.zeros(4, dtype=torch.int32)
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    text = torch.zeros(3, dtype=torch.uint8)
    reads = torch.zeros((1, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="mixed"):
        EK.extend_seeds_fused(cpu, text, reads, cpu[:1], cpu, cpu, cpu, meta, 10)
