"""``SmemEngine.retry_arrays``: the reads the SMEM kernel flags at its
caps (24 chain rows, 24 output rows) get a second launch at caps taken
from their batch (chains of the width + 1 rows, ``max_intv_alloc``
output rows), and only what that launch flags too takes the native host
engine.  On the CPU the launch is the kernel's plain version.  Intervals
are compared exactly and in order: with the JAX oracle, with
``host_arrays``, through ``collect_flat`` (whose flagged reads take the
same retry) and through ``BwaMemDevicePipeline`` with ``BwaMemSeeding``
and the oracle chain."""

import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

from acc_genomics_tpu.ops.smem.index import FMIndex as JaxFMIndex
from acc_genomics_tpu.ops.smem.reference import mem_collect_intv_oracle as jax_oracle
from acc_genomics_tpu_torch.config import EngineConfig, SmemConfig
from acc_genomics_tpu_torch.engine.genomics_engine import GenomicsEngine
from acc_genomics_tpu_torch.engine.packing import pack_tm
from acc_genomics_tpu_torch.engine.smem_engine import SmemEngine, split_dicts
from acc_genomics_tpu_torch.io.synth import gen_smem_reads
from acc_genomics_tpu_torch.models import BwaMemDevicePipeline, BwaMemSeeding
from acc_genomics_tpu_torch.ops.extend.reference import extend_seed_oracle
from acc_genomics_tpu_torch.ops.smem import kernel as K
from acc_genomics_tpu_torch.ops.smem.index import FMIndex
from acc_genomics_tpu_torch.ops.smem.reference import mem_collect_intv_oracle
from acc_genomics_tpu_torch.tools.bench_shapes import smem_repeat_genome, smem_retry_reads
from acc_genomics_tpu_torch.utils.timer import timers

FIELDS = ("x0", "x1", "s", "start", "end")
MAX_OCC, FLANK = 4, 60


def _plain(idx, reads, width, params):
    seq, lens = pack_tm(reads, width, len(reads))
    mem, n, flag, _ = K.smem_collect(idx, torch.from_numpy(seq), torch.from_numpy(lens),
                                     params)
    got = [[tuple(int(v) for v in mem[:, j, k]) for j in range(int(n[k]))]
           for k in range(len(reads))]
    return got, flag.numpy().astype(bool)


WIDTH = 112  # reads of 100, rounded up to 16


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(11)
    genome = smem_repeat_genome(rng, 200_000)
    fm = FMIndex.build(genome)
    reads = smem_retry_reads(rng, genome, 150, read_len=100)
    eng = SmemEngine(fm, device="cpu")
    _, flags = _plain(eng.index, reads, WIDTH, eng.params)
    flagged = np.flatnonzero(flags).tolist()
    # the three reads of long chains, and some drawn from the genome
    assert flagged[-3:] == [150, 151, 152] and len(flagged) >= 6
    return dict(genome=genome, fm=fm, reads=reads, eng=eng, flagged=flagged)


def _spans(before):
    return {k: v["count"] - before.get(k, {"count": 0})["count"]
            for k, v in timers().items() if v["count"] != before.get(k, {"count": 0})["count"]}


def test_plain_at_wide_caps_matches_the_jax_oracle(case):
    """Reads that bust the 24-row caps, some of them 32-row chains too,
    finish at the retry's caps (113 chain rows at width 112, 256 output
    rows) with the oracle's intervals in its order."""
    eng, reads = case["eng"], [case["reads"][k] for k in case["flagged"]]
    _, at32 = _plain(eng.index, reads, WIDTH, eng.params._replace(curr_cap=32, mem_cap=256))
    assert at32[-3:].all() and at32.sum() >= 4  # chains past 32 rows
    wide = eng.params._replace(curr_cap=WIDTH + 1, mem_cap=eng.params.max_intv_alloc)
    got, flags = _plain(eng.index, reads, WIDTH, wide)
    assert not flags.any()
    jax_fm = JaxFMIndex.build(case["genome"])
    for k, r in enumerate(reads):
        assert got[k] == [tuple(iv[f] for f in FIELDS) for iv in jax_oracle(jax_fm, r)], k


def test_retry_arrays_equal_host_arrays(case):
    """Flagged reads of mixed lengths, a read past seq_length, an all-N
    and an empty read: one retry launch, and only the long read on the
    host."""
    eng, fm, reads = case["eng"], case["fm"], case["reads"]
    batch = [reads[k] for k in case["flagged"]]
    batch += [r[:40].copy() for r in batch[1::3]]
    batch += [case["genome"][1000:1300].copy(), np.full(90, 4, np.uint8),
              np.zeros(0, np.uint8)]
    stats = dict(eng.stats)
    before = timers()
    flat, counts = eng.retry_arrays(batch)
    spans = _spans(before)
    want_flat, want_counts = eng.host_arrays(batch)
    np.testing.assert_array_equal(counts, want_counts)
    np.testing.assert_array_equal(flat, want_flat)
    assert flat.dtype == np.int64 and counts.dtype == np.int64
    assert eng.stats["retry_host"] - stats["retry_host"] == 1
    assert spans["smem.launch"] == 1 and spans["smem.retry_host"] == 1
    assert spans["smem.pack"] == 1  # the staging; the packing is the caller's span
    assert counts[-2:].tolist() == [0, 0] and counts[-3] > 0
    assert counts.tolist()[:3] == [len(mem_collect_intv_oracle(fm, r, eng.params))
                                   for r in batch[:3]]


def test_a_read_past_the_wide_caps_takes_the_native_engine(case):
    """At ``max_intv_alloc`` = 4 the retry's output cap flags the reads of
    more than 4 intervals again: they take the native host engine, stay
    exact and are counted in ``rerun_host_reads``."""
    eng4 = GenomicsEngine(dataclasses.replace(
        EngineConfig(), smem=SmemConfig(max_intv_alloc=4)), device="cpu")
    eng4.set_index(case["fm"])
    sub = [case["reads"][k] for k in case["flagged"]] + case["reads"][:2]
    busy = int((eng4.smem.host_arrays(sub)[1] > 4).sum())
    pipe = BwaMemDevicePipeline(eng4, max_occ=MAX_OCC, flank=FLANK)
    before = timers()
    got = pipe.map_reads(sub)
    spans = _spans(before)
    assert 0 < busy <= pipe.anatomy["rerun_host_reads"] <= pipe.anatomy["rerun_reads"]
    assert spans["bwa.pipe.rerun"] == 1 and spans["smem.retry_host"] == 1
    assert got == BwaMemSeeding(eng4, max_occ=MAX_OCC, flank=FLANK).map_reads(sub)
    pipe.reset_anatomy()
    assert pipe.anatomy["rerun_host_reads"] == 0 and pipe.anatomy["rerun_reads"] == 0


def _oracle_hits(fm, read, params, ext_params):
    """The oracle chain of one read: SMEM oracle, the first MAX_OCC
    suffix-array rows of each interval, the seed extension oracle."""
    out = []
    for iv in mem_collect_intv_oracle(fm, read, params):
        slen = iv["end"] - iv["start"]
        for pos in fm.sa[iv["x0"]: iv["x0"] + min(iv["s"], MAX_OCC)].tolist():
            lo = max(0, pos - iv["start"] - FLANK)
            hi = min(fm.seq_len, pos + slen + (len(read) - iv["end"]) + FLANK)
            e = extend_seed_oracle(read, fm.text[lo:hi], iv["start"], pos - lo, slen,
                                   ext_params)
            out.append((e["qBeg"], iv["end"] + e["qEnd"], pos + e["rBeg"],
                        pos + slen + e["rEnd"], e["score"], e["trueScore"], e["width"],
                        iv["s"]))
    return out


def test_the_pipeline_retries_on_the_card_route(case):
    """Flagged reads among clean ones at the default caps: the pipeline
    equals BwaMemSeeding and the oracle chain, counts every flagged read
    in ``rerun_reads`` and none in ``rerun_host_reads``, and launches the
    SMEM kernel twice (the first pass, the retry)."""
    eng = GenomicsEngine(device="cpu")
    eng.set_index(case["fm"])
    flagged = case["flagged"][-4:]
    sub = case["reads"][:4] + [case["reads"][k] for k in flagged]
    pipe = BwaMemDevicePipeline(eng, max_occ=MAX_OCC, flank=FLANK)
    before = timers()
    got = pipe.map_reads(sub)
    spans = _spans(before)
    assert pipe.anatomy["rerun_reads"] == len(flagged) + sum(
        k in case["flagged"] for k in range(4))
    assert pipe.anatomy["rerun_host_reads"] == 0 and pipe.anatomy["rerun_s"] > 0
    assert spans["bwa.pipe.rerun"] == 1 and spans["smem.launch"] == 2
    assert "smem.retry_host" not in spans
    assert got == BwaMemSeeding(eng, max_occ=MAX_OCC, flank=FLANK).map_reads(sub)
    ext = eng.extend.params
    for k in range(4, len(sub)):
        want = _oracle_hits(case["fm"], sub[k], eng.smem.params, ext)
        assert [(h.qbeg, h.qend, h.rbeg, h.rend, h.score, h.true_score, h.width, h.occ)
                for h in got[k]] == want, k


def _rows(flat, counts):
    """Each read's interval tuples from read-major ``flat`` and ``counts``."""
    return [[tuple(iv[f] for f in FIELDS) for iv in ivs] for ivs in split_dicts(flat, counts)]


def _oracle_rows(fm, reads, params):
    return [[tuple(iv[f] for f in FIELDS) for iv in mem_collect_intv_oracle(fm, r, params)]
            for r in reads]


def test_collect_flat_retries_the_busts_on_the_card(monkeypatch):
    """The tight-cap tandem-repeat genome (caps 4/8, every read of it
    flags) with two reads past ``seq_length``: one ``retry_arrays`` call
    takes the flagged reads and the long ones, with one more launch, and
    the answers equal ``host_arrays`` and the oracle.  At
    ``max_intv_alloc`` 8 the wide launch flags the reads of more than 8
    intervals again: ``retry_host`` counts them and the long reads,
    nothing else."""
    rng = np.random.default_rng(7)
    motif = rng.integers(0, 4, 8).astype(np.uint8)
    genome = np.tile(motif, 1500)
    mut = rng.random(len(genome)) < 0.02
    genome[mut] = (genome[mut] + rng.integers(1, 4, mut.sum())) % 4
    reads = gen_smem_reads(rng, genome, 18, read_len=90, error_rate=0.01)
    reads[3:3] = [genome[100:220].copy(), genome[4000:4150].copy()]
    cfg = SmemConfig(batch_size=32, read_buckets=(96,), seq_length=96, curr_cap=4,
                     mem_cap=8, max_intv_alloc=8)
    fm = FMIndex.build(genome)
    eng = SmemEngine(fm, cfg, device="cpu")
    retried = []
    real_retry = eng.retry_arrays
    monkeypatch.setattr(eng, "retry_arrays", lambda rs: retried.append(rs) or real_retry(rs))
    before = timers()
    flat, counts = eng.collect_flat(reads)
    spans = _spans(before)
    short = [k for k, r in enumerate(reads) if len(r) <= 96]
    _, first = _plain(eng.index, [reads[k] for k in short], 96, eng.params)
    flagged = [short[k] for k in np.flatnonzero(first)]
    assert eng.stats["overflow_reruns"] == len(flagged) == len(short)
    assert len(retried) == 1 and [len(r) for r in retried[0]] == [len(r) for r in reads]
    assert spans["smem.launch"] == 2 and spans["smem.retry_host"] == 1
    want_flat, want_counts = eng.host_arrays(reads)
    np.testing.assert_array_equal(counts, want_counts)
    np.testing.assert_array_equal(flat, want_flat)
    assert flat.dtype == np.int64
    past_cap = int((counts[flagged] > 8).sum())
    assert 0 < past_cap < len(flagged) and eng.stats["retry_host"] == 2 + past_cap
    assert _rows(flat, counts) == _oracle_rows(fm, reads, eng.params)


def test_collect_flat_mixes_long_flagged_and_clean_reads_in_read_order(case):
    """Clean, flagged and long reads, a short one, an all-N and an empty
    read, shuffled: the rows come read-major in read order, each read's as
    ``collect`` gives it in the unshuffled call and as the oracle gives
    it."""
    eng = SmemEngine(case["fm"], SmemConfig(read_buckets=(64, 128), seq_length=128),
                     device="cpu")
    clean = [case["reads"][k] for k in range(8) if k not in case["flagged"]][:4]
    flagged = [case["reads"][k] for k in case["flagged"][:3]]
    long = [case["genome"][2000:2300].copy(), case["genome"][7000:7140].copy()]
    odd = [flagged[0][:40].copy(), np.full(60, 4, np.uint8), np.zeros(0, np.uint8)]
    batch = clean + flagged + long + odd
    perm = np.random.default_rng(3).permutation(len(batch))
    flat, counts = eng.collect_flat([batch[k] for k in perm])
    assert eng.stats["overflow_reruns"] >= len(flagged)
    assert eng.stats["retry_host"] >= len(long)
    got = _rows(flat, counts)
    want = eng.collect(batch)
    assert got == [[tuple(iv[f] for f in FIELDS) for iv in want[k]] for k in perm]
    assert got == _oracle_rows(case["fm"], [batch[k] for k in perm], eng.params)


def test_the_wrapper_raises_past_chain_max(case):
    idx = case["eng"].index
    seq = torch.full((32, 1), 4, dtype=torch.uint8)
    lens = torch.tensor([20], dtype=torch.int32)
    with pytest.raises(ValueError, match="CHAIN_MAX"):
        K.smem_collect(idx, seq, lens, case["eng"].params._replace(curr_cap=K.CHAIN_MAX + 1))
    fits = lambda cap, L: (7 * 4 * cap + L) * 32 <= K.BLOCK_SMEM
    assert fits(K.CHAIN_MAX, 256) and not fits(K.CHAIN_MAX + 1, 256)
    assert K.chain_room(160) == K.chain_room(256) == K.CHAIN_MAX
    for L in (272, 1024, 4096):
        room = K.chain_room(L)
        assert room < K.CHAIN_MAX and fits(room, L) and not fits(room + 1, L)
    assert K.chain_room(8192) == 0


def test_a_chain_cap_past_its_width_is_refused(case):
    """At a read width past 256 the caps that fit a block shrink: the
    wrapper (here its plain version) refuses curr_cap 250 at width 512, as
    the CUDA entry point would, and takes the most that fits."""
    idx = case["eng"].index
    reads = [case["reads"][k] for k in case["flagged"][-3:]]
    seq, lens = (torch.from_numpy(a) for a in pack_tm(reads, 512, len(reads)))
    params = case["eng"].params._replace(mem_cap=256)
    with pytest.raises(ValueError, match="CHAIN_MAX"):
        K.smem_collect(idx, seq, lens, params._replace(curr_cap=K.CHAIN_MAX))
    with pytest.raises(ValueError, match="CHAIN_MAX"):
        K.caps(params._replace(curr_cap=K.chain_room(512) + 1), 512)
    room = K.chain_room(512)
    assert room == 241
    got, flag = _plain(idx, reads, 512, params._replace(curr_cap=room))
    assert not flag.any()
    for k, r in enumerate(reads):
        want = mem_collect_intv_oracle(case["fm"], r, params)
        assert got[k] == [tuple(iv[f] for f in FIELDS) for iv in want], k


@pytest.mark.parametrize("py,cu", [("CHAIN_MAX", "kChainMax"), ("BLOCK_SMEM", "kBlockSmem")])
def test_the_entry_points_limits_are_the_wrappers(py, cu):
    """The CUDA entry point refuses what ``caps`` refuses: its chain cap
    and block limit are the wrapper's constants."""
    src = (pathlib.Path(K.__file__).parent / "csrc" / "smem_collect.cu").read_text()
    expr = re.search(rf"constexpr \w+ {cu} = ([0-9 *]+);", src).group(1)
    assert eval(expr) == getattr(K, py)
