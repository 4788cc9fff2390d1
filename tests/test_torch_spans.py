"""The port's spans (``utils/timer.Timer``): the registry under threads,
the profiler ranges they open only while a profiler records, and the
spans of the three model entry points on the CPU twins, each under its
parent, at a count that does not grow with the batch."""

import math
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from acc_genomics_tpu_torch.config import (
    EngineConfig,
    ExtendConfig,
    PairHMMConfig,
    SmemConfig,
    SWConfig,
)
from acc_genomics_tpu_torch.engine.genomics_engine import GenomicsEngine
from acc_genomics_tpu_torch.engine.pairhmm_engine import PairHMMEngine
from acc_genomics_tpu_torch.engine.sw_engine import SWEngine
from acc_genomics_tpu_torch.io.synth import gen_reference_with_repeats, gen_region, gen_smem_reads
from acc_genomics_tpu_torch.models import (
    BwaMemDevicePipeline,
    BwaMemSeeding,
    HaplotypeCallerCore,
    HCEngines,
)
from acc_genomics_tpu_torch.utils.timer import Timer, timers

# (parent, span) pairs each entry point opens on its calling thread; None
# is no parent.  The last set: spans on the engines' worker threads.
_PAIRHMM = {("pairhmm.call", k) for k in (
    "pairhmm.bucket", "pairhmm.pack", "pairhmm.stage", "pairhmm.launch", "pairhmm.wait",
    "pairhmm.host_join", "pairhmm.epilogue")}
_SMEM = {"smem.pack", "smem.launch", "smem.wait", "smem.fetch"}
TREES = {
    "hc": ({(None, "hc.prepare"), (None, "hc.realign"), (None, "hc.likelihoods"),
            (None, "hc.results"), ("hc.likelihoods", "hc.cat"),
            ("hc.likelihoods", "pairhmm.call"), ("pairhmm.epilogue", "pairhmm.recompute64")}
           | _PAIRHMM
           | {("hc.realign", k) for k in ("sw.group", "sw.pack", "sw.launch", "sw.fetch",
                                           "sw.decode", "sw.host_join")},
           {"pairhmm.host_forward", "sw.host_align"}),
    "pipe": ({(None, "bwa.pipe.smem"), (None, "bwa.pipe.rerun"), (None, "bwa.pipe.enum"),
              (None, "bwa.pipe.extend"), ("bwa.pipe.extend", "bwa.pipe.fetch")}
             | {("bwa.pipe.smem", k) for k in _SMEM}
             | {("bwa.pipe.rerun", k) for k in _SMEM},
             set()),
    "host": ({(None, "bwa.host")}
             | {("bwa.host", f"bwa.host.{k}") for k in ("smem", "enum", "extend", "hits")}
             | {("bwa.host.smem", k) for k in _SMEM | {"smem.split"}}
             | {("bwa.host.extend", f"extend.{k}") for k in (
                 "prep", "bucket", "pack", "launch", "fetch", "host_join", "resolve")},
             {"extend.host"}),
}
ZERO = {"total_s": 0.0, "count": 0}


def _delta(before):
    """{span: (count, total_s)} opened since ``before``."""
    out = {}
    for k, v in timers().items():
        b = before.get(k, ZERO)
        if v["count"] != b["count"]:
            out[k] = (v["count"] - b["count"], v["total_s"] - b["total_s"])
    return out


def _tree(prof, names):
    """(nearest enclosing span, span) pairs of the program's spans, by
    containment on each thread, from the profiler's raw events (the plain
    kernels record hundreds of thousands of operations)."""
    spans = [(e.name(), e.start_thread_id(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events() if e.name() in names]
    pairs = set()
    for name, thread, a, b in spans:
        outer = [s for s in spans if s[1] == thread and s[2] <= a and b <= s[3]
                 and s[3] - s[2] > b - a]
        parent = min(outer, key=lambda s: s[3] - s[2])[0] if outer else None
        pairs.add((parent, name))
    return pairs


def _hc_entry(rng):
    """Regions whose SW and PairHMM pairs partly pass the buckets (the
    host routes) and whose likelihoods all take the fp64 recompute."""
    regions = []
    for ref_len in (50, 50, 100):
        ref, haps, reads, _ = gen_region(rng, ref_len=ref_len, n_haps=2, n_reads=3,
                                         read_len=30)
        regions.append((ref, haps, reads))
    core = HaplotypeCallerCore(HCEngines(
        SWEngine(SWConfig(seq_buckets=(64,)), device="cpu"),
        PairHMMEngine(PairHMMConfig(read_buckets=(32,), hap_buckets=(64,),
                                    min_accepted=3e38), device="cpu")))
    return core, lambda k: core.process_regions(regions * k)


def _bwa_entries(rng):
    """Reads that overflow the SMEM caps (the retry at wide caps, in the
    pipeline and in the host route's ``collect``) and seeds past the extension's query cap
    (its host route)."""
    genome = gen_reference_with_repeats(rng, 8000, repeat_len=60, n_repeats=6)
    reads = gen_smem_reads(rng, genome, 12, read_len=75)
    cfg = EngineConfig(smem=SmemConfig(curr_cap=8, mem_cap=8),
                       extend=ExtendConfig(max_qlen=32))
    eng = GenomicsEngine(cfg, device="cpu")
    eng.load_reference(genome)
    pipe = BwaMemDevicePipeline(eng, max_occ=4, flank=40)
    seeding = BwaMemSeeding(eng, max_occ=4, flank=40)
    return pipe, (lambda k: pipe.map_reads_arrays(reads * k),
                  lambda k: seeding.map_reads(reads * k))


@pytest.fixture(scope="module")
def observed():
    """Per entry point: its model, the span pairs of a profiled call, and
    the spans of calls at one and three times the batch."""
    rng = np.random.default_rng(16)
    core, hc = _hc_entry(rng)
    pipe, (bwa_pipe, bwa_host) = _bwa_entries(rng)
    out = {}
    for name, model, call in (("hc", core, hc), ("pipe", pipe, bwa_pipe),
                              ("host", None, bwa_host)):
        call(1)  # warm
        if model is not None:
            model.reset_anatomy()
        before = timers()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            call(1)
        once = _delta(before)
        anatomy = dict(model.anatomy) if model is not None else None
        before = timers()
        call(3)
        thrice = _delta(before)
        out[name] = dict(tree=_tree(prof, set(timers())), once=once, thrice=thrice,
                         anatomy=anatomy)
    return out


@pytest.mark.parametrize("entry", sorted(TREES))
def test_entry_opens_every_span_under_its_parent(observed, entry):
    on_caller, on_workers = TREES[entry]
    got = observed[entry]
    assert got["tree"] == on_caller
    assert {k for _, k in on_caller} | on_workers == set(got["once"])


@pytest.mark.parametrize("entry", sorted(TREES))
def test_span_count_does_not_grow_with_the_batch(observed, entry):
    once, thrice = observed[entry]["once"], observed[entry]["thrice"]
    assert {k: n for k, (n, _) in once.items()} == {k: n for k, (n, _) in thrice.items()}


@pytest.mark.parametrize("entry,key,span", [
    ("hc", "host_s", "hc.prepare"), ("hc", "sw_s", "hc.realign"),
    ("hc", "pairhmm_s", "hc.likelihoods"), ("pipe", "smem_s", "bwa.pipe.smem"),
    ("pipe", "enum_s", "bwa.pipe.enum"), ("pipe", "extend_s", "bwa.pipe.extend"),
    ("pipe", "rerun_s", "bwa.pipe.rerun"),
])
def test_anatomy_is_the_span_reading(observed, entry, key, span):
    got = observed[entry]
    assert got["once"][span][0] == 1
    assert got["anatomy"][key] == pytest.approx(got["once"][span][1], rel=1e-9)


def test_no_span_is_named_device(observed):
    assert not [k for k in timers() if k.endswith(".device")]


def test_registry_counts_exactly_under_threads():
    threads, rounds = 8, 300
    start = threading.Barrier(threads)
    spent = [[] for _ in range(threads)]

    def work(j):
        start.wait()
        for _ in range(rounds):
            with Timer("test.outer") as outer:
                with Timer("test.inner") as inner:
                    pass
            spent[j].append((outer.elapsed, inner.elapsed))

    before = timers()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work, args=(j,)) for j in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    got = _delta(before)
    for k, key in enumerate(("test.outer", "test.inner")):
        want = math.fsum(s[k] for per in spent for s in per)
        assert got[key][0] == threads * rounds
        assert got[key][1] == pytest.approx(want, rel=1e-9)
    assert all(o >= i for per in spent for o, i in per)


@pytest.mark.parametrize("recording", [False, True])
def test_a_range_opens_only_while_a_profiler_records(monkeypatch, recording):
    real = torch.profiler.record_function
    opened = []

    class Counting:
        def __init__(self, name):
            opened.append(name)
            self.range = real(name)

        def __enter__(self):
            return self.range.__enter__()

        def __exit__(self, *exc):
            return self.range.__exit__(*exc)

    monkeypatch.setattr(torch.profiler, "record_function", Counting)

    def spans():
        with Timer("test.a"):
            with Timer("test.b"):
                pass

    if recording:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            spans()
        assert _tree(prof, {"test.a", "test.b"}) == {(None, "test.a"), ("test.a", "test.b")}
    else:
        spans()
    assert opened == (["test.a", "test.b"] if recording else [])
