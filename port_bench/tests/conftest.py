"""Tests of the benchmark harness: CPU, tiny sizes; ``gpu`` cases skip
without a card (decided inside the test)."""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# tiny shapes of each configuration and mix, for CPU runs of the harness
TINY_REGION = dict(active_min=20, active_max=40, padding=20, read_len=40, coverage=4)
TINY_MIX = dict(regions_per_call=2, warm_calls=1, check_regions=2, reads_per_call=64,
                pool_calls=2, check_reads=6, check_host_reads=2)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


def make_tiny(root: str) -> str:
    """A copy of the benchmark at tiny sizes under ``root``: its
    BENCHMARK.json, configs and mixes; returns the bench directory."""
    bench = os.path.join(root, "bench")
    os.makedirs(os.path.join(bench, "traffic"), exist_ok=True)
    shutil.copytree(os.path.join(BENCH, "metrics"), os.path.join(bench, "metrics"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    for c in man["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        if cfg["kind"] == "hc":
            cfg["region"].update(TINY_REGION)
            cfg["assumed"]["pool_regions"] = 6
        else:
            cfg["genome"]["length"] = 300_000
            cfg["genome"]["families"]["segdup"]["len"] = [1000, 5000]
        c["file"] = os.path.join(root, f"{c['name']}.json")
        with open(c["file"], "w") as f:
            json.dump(cfg, f)
    # every mix of the folder gets a cell, those BENCHMARK.json leaves out too
    kinds = {c["name"]: json.load(open(c["file"]))["kind"] for c in man["configs"]}
    cells = {w["name"] for w in man["workloads"]}
    for name in sorted(os.listdir(os.path.join(BENCH, "traffic"))):
        with open(os.path.join(BENCH, "traffic", name)) as f:
            mix = json.load(f)
        mix.update({k: v for k, v in TINY_MIX.items() if k in mix})
        with open(os.path.join(bench, "traffic", name), "w") as f:
            json.dump(mix, f)
        config = next(c for c, k in kinds.items() if k == mix["kind"])
        cell = f"{config}.{name[:-5]}"
        if cell not in cells:
            man["workloads"].append(dict(name=cell, config=config, traffic=name[:-5], chips=1,
                                         why="tiny"))
            for m in man["end_to_end"] + man["per_layer"]:
                if any(w.startswith(config + ".") for w in m.get("workloads", [])):
                    m["workloads"].append(cell)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    return bench


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    from port_bench.manifest import Manifest

    root = str(tmp_path_factory.mktemp("tiny"))
    return Manifest(root, make_tiny(root))


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
