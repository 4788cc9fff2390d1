"""The metrics read from the program's spans: a traced tiny run of each
cell on the CPU reports every one, and each self time subtracts exactly
the spans the program opens directly under its parent."""

import math
import time

import pytest
from torch.profiler import ProfilerActivity, profile

from port_bench import run
from port_bench.kinds import common

SEED = 2**31 + 16
SPAN_METRICS = {
    "gatk_hc_wgs30x.batched32": [
        "hc.prepare_ms_per_region", "hc.cat_ms_per_region", "hc.results_ms_per_region",
        "pairhmm.bucket_ms_per_call", "pairhmm.stage_ms_per_call",
        "pairhmm.launch_ms_per_call", "pairhmm.wait_ms_per_call",
        "pairhmm.epilogue_ms_per_call", "pairhmm.self_ms_per_call"],
    "bwamem_chr20.uniform": [
        "bwa.host_smem_ms_per_kread", "bwa.host_enum_ms_per_kread",
        "bwa.host_extend_ms_per_kread", "bwa.host_hits_ms_per_kread",
        "smem.host_join_ms_per_kread", "bwa.host_self_ms_per_kread"],
}


@pytest.mark.parametrize("wl", sorted(SPAN_METRICS))
def test_a_traced_run_reports_every_span_metric(tiny, wl):
    rec = run.run_cell(tiny, wl, SEED, 0.5, True, device="cpu", t_start=time.perf_counter())
    assert rec["correct"], rec["checks"]
    got = run.metrics(tiny, wl, rec, trace=True)
    for name in SPAN_METRICS[wl]:
        assert name in got, name
        assert math.isfinite(got[name]["value"]) and got[name]["value"] >= 0, (name, got[name])


def _direct_children(prof, names, parent):
    """The spans among ``names`` whose nearest enclosing span on their
    thread is ``parent`` (the profiler's raw events: the plain kernels
    record hundreds of thousands of operations)."""
    spans = [(e.name(), e.start_thread_id(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events() if e.name() in names]
    out = set()
    for name, thread, a, b in spans:
        outer = [s for s in spans if s[1] == thread and s[2] <= a and b <= s[3]
                 and s[3] - s[2] > b - a]
        if outer and min(outer, key=lambda s: s[3] - s[2])[0] == parent:
            out.add(name)
    return out


@pytest.mark.parametrize("wl,metric,parent", [
    ("gatk_hc_wgs30x.batched32", "pairhmm.self_ms_per_call", "pairhmm.call"),
    ("bwamem_chr20.uniform", "bwa.host_self_ms_per_kread", "bwa.host"),
])
def test_a_self_time_subtracts_the_programs_children(tiny, wl, metric, parent):
    from acc_genomics_tpu_torch.utils.timer import timers

    w = tiny.workload(wl)
    cfg, mix = tiny.config(w["config"]), tiny.traffic(w["traffic"])
    cell = tiny.kind(cfg["kind"]).Cell(cfg, mix, SEED, "cpu",
                                       common.cache_dir(tiny.bench_dir, w["config"]))
    cell.call(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cell.call(1)
    got = _direct_children(prof, set(timers()), parent)
    assert set(tiny.metric(metric).CHILDREN) == got
