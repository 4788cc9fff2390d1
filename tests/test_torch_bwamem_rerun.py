"""The port's BwaMemDevicePipeline on reads that overflow the SMEM
kernel's caps (6/4 here, on a genome with repeats): ``retry_arrays``
reruns them once on the calling thread (span ``bwa.pipe.rerun``: a
second launch at wide caps, the native host SMEM for what it flags), and
their seeds take the card route's enumeration and fused extension with
every other read's; only reads past ``seq_length`` are handed back.
SeedHits are compared exactly with ``BwaMemSeeding`` and the JAX
pipeline (which hands the capped reads back to its host route)."""

import dataclasses
import functools

import numpy as np
import pytest

from acc_genomics_tpu.config import EngineConfig as JaxEngineConfig
from acc_genomics_tpu.config import SmemConfig as JaxSmemConfig
from acc_genomics_tpu.engine.genomics_engine import GenomicsEngine as JaxGenomicsEngine
from acc_genomics_tpu.io.synth import gen_reference_with_repeats, gen_smem_reads
from acc_genomics_tpu.models.bwa_mem import BwaMemDevicePipeline as JaxPipeline
from acc_genomics_tpu_torch import native
from acc_genomics_tpu_torch.config import EngineConfig, SmemConfig
from acc_genomics_tpu_torch.engine.genomics_engine import GenomicsEngine
from acc_genomics_tpu_torch.engine.packing import pack_rows
from acc_genomics_tpu_torch.models import BwaMemDevicePipeline, BwaMemSeeding
from acc_genomics_tpu_torch.ops.smem.reference import mem_collect_intv_oracle
from acc_genomics_tpu_torch.utils.timer import timers

CAPS = dict(curr_cap=6, mem_cap=4)
MAX_OCC, FLANK = 4, 60
LONG = 24  # the read past seq_length


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(17)
    genome = gen_reference_with_repeats(rng, 6000)
    reads = gen_smem_reads(rng, genome, 24, read_len=101)
    reads += [genome[2000:2300].copy(), np.tile(genome[40:48], 13)[:101].copy()]
    jax_eng = JaxGenomicsEngine(dataclasses.replace(JaxEngineConfig(),
                                                    smem=JaxSmemConfig(**CAPS)))
    jax_eng.load_reference(genome)
    eng = GenomicsEngine(dataclasses.replace(EngineConfig(), smem=SmemConfig(**CAPS)),
                         device="cpu")
    eng.load_reference(genome)
    pipe = BwaMemDevicePipeline(eng, max_occ=MAX_OCC, flank=FLANK)
    flagged = _flagged(pipe, reads)
    assert len(flagged) >= 2 and LONG not in flagged
    return dict(reads=reads, eng=eng, pipe=pipe, flagged=flagged,
                jax=JaxPipeline(jax_eng, max_occ=MAX_OCC, flank=FLANK),
                seeding=BwaMemSeeding(eng, max_occ=MAX_OCC, flank=FLANK))


def _flagged(pipe, reads):
    """The reads the SMEM kernel flags in the pipeline's own batch."""
    width = pipe._bucket(reads)
    rows_rm, rlens = pack_rows([r if len(r) <= width else r[:0] for r in reads],
                               width, len(reads))
    _, _, overflow = pipe.engine.smem.collect_arrays(np.ascontiguousarray(rows_rm.T), rlens)
    return np.flatnonzero(overflow).tolist()


def _tuples(per_read):
    return [[dataclasses.astuple(h) for h in hits] for hits in per_read]


def test_only_reads_past_seq_length_are_handed_back(case):
    reads = case["reads"]
    hits, rid, _, host_idx = case["pipe"].map_reads_arrays(reads)
    assert host_idx == [LONG]
    mapped = {k for k, hs in enumerate(case["seeding"].map_reads(reads)) if hs}
    assert set(rid.tolist()) == mapped - {LONG} and set(case["flagged"]) & mapped
    assert hits.shape == (8, len(rid)) and (np.diff(rid) >= 0).all()


@pytest.mark.parametrize("against", ["seeding", "jax"])
def test_capped_reads_match(case, against):
    reads, flagged = case["reads"], case["flagged"]
    got = case["pipe"].map_reads(reads)
    want = case[against].map_reads(reads)
    assert sum(bool(got[k]) for k in flagged) >= len(flagged) - 1
    if against == "seeding":
        assert [got[k] for k in flagged] == [want[k] for k in flagged]
        assert got == want
    else:
        assert _tuples([got[k] for k in flagged]) == _tuples([want[k] for k in flagged])
        assert _tuples(got) == _tuples(want)


def _spans(before):
    return {k: v["count"] - before.get(k, {"count": 0})["count"]
            for k, v in timers().items()}


def test_rerun_counter_and_span(case):
    pipe, reads, flagged = case["pipe"], case["reads"], case["flagged"]
    pipe.reset_anatomy()
    before = timers()
    pipe.map_reads_arrays(reads)
    assert _spans(before).get("bwa.pipe.rerun") == 1
    assert pipe.anatomy["rerun_reads"] == len(flagged) and pipe.anatomy["rerun_s"] > 0
    # a call without a flagged read opens no rerun span (at these caps
    # every read with a base is flagged)
    clean = [np.full(101, 4, np.uint8), np.full(30, 4, np.uint8)]
    assert _flagged(pipe, clean) == []
    before = timers()
    pipe.map_reads_arrays(clean)
    assert _spans(before).get("bwa.pipe.rerun", 0) == 0
    assert pipe.anatomy["rerun_reads"] == len(flagged)
    pipe.reset_anatomy()
    assert pipe.anatomy["rerun_reads"] == 0 and pipe.anatomy["rerun_s"] == 0.0


def test_rerun_read_past_mem_cap_stays_exact(case):
    reads, flagged, eng = case["reads"], case["flagged"], case["eng"]
    _, counts = eng.smem.host_arrays([reads[k] for k in flagged])
    wide = [k for k, c in zip(flagged, counts.tolist()) if c > CAPS["mem_cap"]]
    assert wide
    sub = [reads[k] for k in wide]
    assert case["pipe"].map_reads(sub) == case["seeding"].map_reads(sub)


def test_a_call_of_flagged_reads_only_stays_exact(case):
    sub = [case["reads"][k] for k in case["flagged"]]
    pipe = case["pipe"]
    assert _flagged(pipe, sub) == list(range(len(sub)))
    pipe.reset_anatomy()
    got = pipe.map_reads(sub)
    assert pipe.anatomy["rerun_reads"] == len(sub)
    assert got == case["seeding"].map_reads(sub)
    assert _tuples(got) == _tuples(case["jax"].map_reads(sub))


def test_host_arrays_match_collect_and_oracle(case, monkeypatch):
    """``SmemEngine.host_arrays`` gives ``collect``'s intervals; a read
    past the native buffer takes the oracle."""
    reads, eng = case["reads"], case["eng"]
    want = eng.smem.collect(reads)
    flat, counts = eng.smem.host_arrays(reads)
    assert counts.tolist() == [len(v) for v in want]
    assert flat.tolist() == [[iv[k] for k in ("x0", "x1", "s", "start", "end")]
                             for v in want for iv in v]
    # a native buffer of 3 rows: the reads with more intervals fall back
    monkeypatch.setattr(native, "smem_collect_host_arrays",
                        functools.partial(native.smem_collect_host_arrays, max_out=3))
    small_flat, small_counts = eng.smem.host_arrays(reads)
    assert (small_counts > 3).any()
    np.testing.assert_array_equal(small_counts, counts)
    np.testing.assert_array_equal(small_flat, flat)
    k = int(np.argmax(counts))
    assert len(mem_collect_intv_oracle(eng.smem.fm, reads[k], eng.smem.params)) == counts[k]


def test_a_mixed_call_merges_the_rerun_read_major(case):
    """At caps 8/8 some reads pass the card and some are flagged: the
    merged intervals keep every read's place."""
    reads = case["reads"]
    eng = GenomicsEngine(dataclasses.replace(
        EngineConfig(), smem=SmemConfig(curr_cap=8, mem_cap=8)), device="cpu")
    eng.set_index(case["eng"].smem.fm)
    pipe = BwaMemDevicePipeline(eng, max_occ=MAX_OCC, flank=FLANK)
    flagged = _flagged(pipe, reads)
    assert 0 < len(flagged) < len(reads) - 2
    got = pipe.map_reads(reads)
    assert pipe.anatomy["rerun_reads"] == len(flagged)
    assert got == BwaMemSeeding(eng, max_occ=MAX_OCC, flank=FLANK).map_reads(reads)
