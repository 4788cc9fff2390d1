"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is ``configs/<config>.json`` (its ``kind`` names the
driver ``kinds/<kind>.py``), a traffic mix ``traffic/<traffic>.json``, a
metric ``metrics/<name>.py`` with a ``read(rec)`` that returns a number
or None.  A new configuration, mix or metric is a new file and a new
entry in ``BENCHMARK.json``; nothing here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))


class Manifest:
    def __init__(self, root: str = os.path.dirname(BENCH_DIR), bench_dir: str = BENCH_DIR):
        self.root, self.bench_dir = root, bench_dir
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.data = json.load(f)
        self._metrics: Dict[str, object] = {}

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(os.path.join(self.bench_dir, "traffic", f"{name}.json")) as f:
            return json.load(f)

    def kind(self, name: str):
        return importlib.import_module(f"port_bench.kinds.{name}")

    def metric(self, name: str):
        """The reader module of ``metrics/<name>.py``."""
        if name not in self._metrics:
            path = os.path.join(self.bench_dir, "metrics", f"{name}.py")
            spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._metrics[name] = mod
        return self._metrics[name]

    def metrics_of(self, workload: str, trace: bool) -> List[dict]:
        """The cell's end-to-end metrics, or with ``trace`` its per-layer
        ones: those that list it, or that list no cells and move a
        metric the cell reports."""
        e2e = [m for m in self.data["end_to_end"]
               if workload in m.get("workloads", [workload])]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.data["per_layer"]
                if workload in m["workloads"] or ("workloads" not in m and m["moves"] in names)]
