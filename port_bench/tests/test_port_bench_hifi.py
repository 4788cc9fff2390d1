"""The ``gatk_hc_hifi28x`` configuration (HaplotypeCaller on PacBio HiFi
reads) and its two metrics, ``hc.long_pair_pct`` and ``hc.host_pair_pct``."""

import json
import math
import os
import time

import numpy as np
import pytest

from conftest import make_tiny
from port_bench import run
from port_bench.gen.regions import make_regions
from port_bench.manifest import Manifest

CELL = "gatk_hc_hifi28x.batched32"


@pytest.fixture(scope="module")
def man():
    return Manifest()


@pytest.fixture(scope="module")
def cfg(man):
    return man.config("gatk_hc_hifi28x")


def test_the_configuration_loads_as_an_engine_config(cfg):
    from acc_genomics_tpu_torch.config import EngineConfig, engine_config_from_dict

    eng = engine_config_from_dict(cfg["engine"])
    assert eng.pairhmm.read_buckets[-1] == 576
    assert eng.pairhmm.read_buckets[:6] == EngineConfig().pairhmm.read_buckets
    assert eng.sw == engine_config_from_dict({"sw": cfg["engine"]["sw"]}).sw
    assert cfg["reduced"] == [] and cfg["region"]["read_len"] == 13500


def test_the_largest_bucket_holds_the_longest_read_the_generator_draws(cfg):
    """A clipped read is at most its haplotype: the widest window plus an
    insertion of the longest length at every site the haplotype cap
    keeps.  A bucket of R rows holds reads of up to R - 1 bases."""
    r, v = cfg["region"], cfg["variants"]
    longest = (r["active_max"] + 2 * r["padding"]
               + int(math.log2(v["max_haplotypes"])) * v["indel_len"][1])
    rows = cfg["engine"]["pairhmm"]["read_buckets"][-1]
    assert longest <= rows - 1
    regions = make_regions(np.random.default_rng(5), cfg, 24)
    lens = [len(rd["rs"]) for _, _, reads in regions for rd in reads]
    hlens = [len(h) for _, haps, _ in regions for h in haps]
    assert max(lens) <= max(hlens) <= longest
    assert np.mean(np.array(lens) > 255) > 0.5


def _rec(anatomy, pairs=1000):
    return dict(inputs=dict(pairhmm_lens=np.zeros(pairs, np.int64)),
                delta=dict(anatomy=anatomy, launches={}, timers={}))


def test_the_metrics_read_their_counters_and_none_without(man):
    long_pct, host_pct = man.metric("hc.long_pair_pct"), man.metric("hc.host_pair_pct")
    rec = _rec(dict(sw_s=1.0, long_pairs=950, host_pairs=3))
    assert long_pct.read(rec) == pytest.approx(95.0)
    assert host_pct.read(rec) == pytest.approx(0.3)
    assert host_pct.read(_rec(dict(host_pairs=0))) == 0.0
    parent = _rec(dict(sw_s=1.0, pairhmm_s=2.0, host_s=0.5))
    assert long_pct.read(parent) is None and host_pct.read(parent) is None
    assert long_pct.read(_rec(dict(long_pairs=5), pairs=0)) is None


def test_the_metrics_are_reported_in_their_cells(man):
    layer = {m["name"]: m for m in man.data["per_layer"]}
    assert layer["hc.long_pair_pct"]["workloads"] == [CELL]
    assert set(layer["hc.host_pair_pct"]["workloads"]) == {"gatk_hc_wgs30x.batched32", CELL}
    for m in man.data["end_to_end"] + man.data["per_layer"]:
        if "gatk_hc_wgs30x.batched32" in m.get("workloads", []):
            assert CELL in m["workloads"], m["name"]


def test_a_tiny_run_of_the_hifi_cell_scores_long_reads_on_the_device_route(tmp_path, cfg):
    """The cell at a tiny size on the CPU, windows of 260-300 bases so the
    clipped reads pass 255: correct, with ``hc.long_pair_pct`` above 0 and
    ``hc.host_pair_pct`` 0."""
    root = str(tmp_path)
    man = Manifest(root, make_tiny(root))
    small = json.loads(json.dumps(cfg))
    small["region"].update(active_min=60, active_max=100, coverage=2)
    small["variants"]["max_haplotypes"] = 4
    small["assumed"]["pool_regions"] = 4
    with open(os.path.join(root, "gatk_hc_hifi28x.json"), "w") as f:
        json.dump(small, f)
    rec = run.run_cell(man, CELL, 2**31 + 777, 0.5, False, device="cpu",
                       t_start=time.perf_counter())
    assert rec["correct"], rec["checks"]
    got = run.metrics(man, CELL, rec, trace=True)
    assert got["hc.long_pair_pct"]["value"] > 0
    assert got["hc.host_pair_pct"]["value"] == 0
