"""Whole runs of each cell at tiny sizes on the CPU (the harness's look
for a card skipped, the port on its plain versions); the check fails
under the control and under each fault the cells can have; one ``gpu``
case runs a real cell on the card."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from conftest import ROOT
from port_bench import control, run

CELLS = ["gatk_hc_wgs30x.batched32", "gatk_hc_wgs30x.per_region",
         "bwamem_chr20.uniform", "bwamem_chr20.repeats"]
SEED = 2**31 + 12345


def _run(man, wl, hook=None, trace=False):
    return run.run_cell(man, wl, SEED, 0.5, trace, device="cpu",
                        t_start=time.perf_counter(), hook=hook)


@pytest.mark.parametrize("wl", CELLS)
def test_a_tiny_run_is_correct_and_reports_its_metrics(tiny, wl):
    rec = _run(tiny, wl)
    assert rec["correct"], rec["checks"]
    assert rec["calls"] >= 1 and rec["items"] > 0
    got = run.metrics(tiny, wl, rec, trace=False)
    assert {m["name"] for m in tiny.metrics_of(wl, False)} == set(got)
    assert all(v["value"] > 0 for v in got.values())


def test_a_traced_run_reads_the_trace(tiny):
    rec = _run(tiny, "gatk_hc_wgs30x.per_region", trace=True)
    assert rec["correct"]
    t = rec["trace"]
    assert t["window_s"] > 0 and t["busy_s"] == 0  # no device on the CPU
    got = run.metrics(tiny, "gatk_hc_wgs30x.per_region", rec, trace=True)
    assert "hc.pairhmm_ms_per_region" in got and "pairhmm_forward_roofline" not in got


@pytest.mark.parametrize("wl", ["gatk_hc_wgs30x.batched32", "bwamem_chr20.uniform"])
def test_the_control_fails_the_check(tiny, wl):
    r = control.readings(tiny, wl, SEED, 0.5, "cpu")
    lim = r["limits"]
    assert all(r["program"][n] <= lim[n] for n in lim)
    assert any(r["control"][n] > lim[n] for n in lim)


def _hc_half(cell):
    core = cell.core
    orig = core.process_regions

    def half(regions):
        keep = regions[: max(len(regions) // 2, 1)]
        return orig(keep)

    core.process_regions = half


def _hc_alter(cell):
    pairhmm = cell.engine.pairhmm
    orig = pairhmm.compute_pairs_flat

    def altered(*a, **kw):
        out = orig(*a, **kw)
        out = out.copy()
        out[0] += 0.01
        return out

    pairhmm.compute_pairs_flat = altered


def _hc_alter_cigar(cell):
    sw = cell.engine.sw
    orig = sw.align

    def altered(refs, alts, strategy):
        out = orig(refs, alts, strategy)
        cigar, off = out[0]
        out[0] = (cigar, off + 1)
        return out

    sw.align = altered


def _bwa_half(cell):
    pipe = cell.pipe
    orig = pipe.map_reads_arrays

    def half(reads):
        hits, rid, (qbeg, slen, occ), host = orig(reads)
        keep = rid < len(reads) // 2
        return hits[:, keep], rid[keep], (qbeg[keep], slen[keep], occ[keep]), host

    pipe.map_reads_arrays = half


def _bwa_alter(cell):
    pipe = cell.pipe
    orig = pipe.map_reads_arrays

    def altered(reads):
        hits, rid, meta, host = orig(reads)
        hits = hits.copy()
        hits[4] += 1  # every score
        return hits, rid, meta, host

    pipe.map_reads_arrays = altered


@pytest.mark.parametrize("wl,fault", [
    ("gatk_hc_wgs30x.batched32", _hc_half),
    ("gatk_hc_wgs30x.batched32", _hc_alter),
    ("gatk_hc_wgs30x.batched32", _hc_alter_cigar),
    ("bwamem_chr20.uniform", _bwa_half),
    ("bwamem_chr20.uniform", _bwa_alter),
], ids=["hc-half-batch", "hc-likelihood-altered", "hc-cigar-altered", "bwa-half-batch",
        "bwa-score-altered"])
def test_a_broken_timed_path_is_not_correct(tiny, wl, fault):
    rec = _run(tiny, wl, hook=fault)
    assert not rec["correct"], rec["checks"]


def test_no_result_without_a_card_or_with_jax_loaded():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", CELLS[0],
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    sys.modules.setdefault("jax", type(sys)("jax"))
    try:
        assert run.forbidden_modules() == ["jax"]
    finally:
        if sys.modules["jax"].__dict__.get("__file__") is None:
            del sys.modules["jax"]


@pytest.mark.gpu
def test_a_cell_runs_on_the_card(cuda):
    p = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", CELLS[0],
                        "--seed", str(SEED), "--seconds", "3", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert out["metrics"]["regions_per_s"]["value"] > 0
    assert np.isfinite(out["metrics"]["setup_s"]["value"])
