"""BENCHMARK.json against the benchmark's contract, and discovery by name."""

import json
import os
import re
import shutil

import pytest

from conftest import BENCH, ROOT
from port_bench.manifest import Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def man():
    return Manifest()


def test_top_level_keys(man):
    assert set(man.data) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert man.data["paths"] == ["port_bench"]
    assert 1 <= man.data["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in man.data["command"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source", "workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves", "workloads"}),
])
def test_entries_have_only_the_allowed_keys(man, section, keys):
    for e in man.data[section]:
        assert set(e) <= keys, e
        assert set(e) >= keys - {"workloads"}, e


def test_names_and_units_use_the_allowed_characters(man):
    names = [e["name"] for s in ("configs", "workloads", "end_to_end", "per_layer")
             for e in man.data[s]]
    names += [w["config"] for w in man.data["workloads"]]
    names += [w["traffic"] for w in man.data["workloads"]]
    names += [k for c in man.data["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for s in ("end_to_end", "per_layer"):
        for m in man.data[s]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
            assert m["source"] in SOURCES
    for s in ("configs", "workloads", "end_to_end", "per_layer"):
        ns = [e["name"] for e in man.data[s]]
        assert len(ns) == len(set(ns))
    texts = [e["why"] for s in ("configs", "workloads") for e in man.data[s]]
    texts += [c["source"] for c in man.data["configs"]] + [m["layer"] for m in man.data["per_layer"]]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)


def test_bounds_and_metric_sources(man):
    e2e = {m["name"]: m for m in man.data["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric(man):
    for w in man.data["workloads"]:
        assert w["chips"] in (1, 4)
        e2e = {m["name"] for m in man.metrics_of(w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = man.metrics_of(w["name"], True)
        assert layer and all(m["moves"] in e2e for m in layer)


def test_every_named_file_is_found(man):
    for c in man.data["configs"]:
        assert c["file"].startswith("port_bench/")
        cfg = man.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(BENCH, "kinds", f"{cfg['kind']}.py"))
    for w in man.data["workloads"]:
        assert man.traffic(w["traffic"])["kind"] == man.config(w["config"])["kind"]
    for s in ("end_to_end", "per_layer"):
        for m in man.data[s]:
            assert callable(man.metric(m["name"]).read)


def test_a_new_metric_is_found_by_its_file_and_entry(tmp_path):
    """A dummy metric added as a file and an entry, with no other edit,
    is read and reported in the cells it lists."""
    bench = tmp_path / "bench"
    shutil.copytree(os.path.join(BENCH, "metrics"), bench / "metrics")
    shutil.copytree(os.path.join(BENCH, "traffic"), bench / "traffic")
    data = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    for c in data["configs"]:
        c["file"] = os.path.join(ROOT, c["file"])
    data["per_layer"].append({"name": "dummy.calls_seen", "unit": "calls", "better": "higher",
                              "source": "program_counter", "layer": "Models",
                              "moves": "regions_per_s",
                              "workloads": ["gatk_hc_wgs30x.batched32"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    (bench / "metrics" / "dummy.calls_seen.py").write_text(
        "def read(rec):\n    return rec['calls'] * 2\n")
    from port_bench import run

    man = Manifest(str(tmp_path), str(bench))
    rec = dict(calls=21, items=21, window_s=1.0, item_kind="regions", call_s=[0.01] * 21,
               setup_s=3.0, delta=dict(anatomy={}, launches={}, timers={}), inputs={})
    got = run.metrics(man, "gatk_hc_wgs30x.batched32", rec, trace=True)
    assert got["dummy.calls_seen"] == {"value": 42.0, "unit": "calls"}
    assert "dummy.calls_seen" not in run.metrics(man, "bwamem_chr20.uniform", rec, True)
