"""Run one cell of the port's benchmark once.

    python -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the cell's inputs from the seed and the program under
test (``acc_genomics_tpu_torch`` through ``GenomicsEngine``), and warms
it with the cell's own calls.  The window then calls the program in a
closed loop, one caller, until ``--seconds`` have passed.  After it, the
program is freed and the plain reference checks a sample of the
window's answers.  The last line of standard output is one JSON object;
the numbers compared, each beside its limit, are the last lines of
standard error and the last key of that object.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Callable, Optional  # noqa: E402

from port_bench.manifest import BENCH_DIR, Manifest  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "acc_genomics_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _deltas(before: dict, after: dict) -> dict:
    anat = {k: after["anatomy"][k] - before["anatomy"].get(k, 0) for k in after["anatomy"]}
    launches = {k: v - before["launches"].get(k, 0) for k, v in after["launches"].items()}
    timers = {}
    for k, v in after["timers"].items():
        b = before["timers"].get(k, {"total_s": 0.0, "count": 0})
        timers[k] = dict(total_s=v["total_s"] - b["total_s"], count=v["count"] - b["count"])
    return dict(anatomy=anat, launches=launches, timers=timers)


def _spans(cell, on: bool):
    """Wrap the cell's layer entry points in profiler ranges."""
    if not on:
        return
    import functools

    import torch

    for obj, attr, name in cell.layer_spans():
        fn = getattr(obj, attr)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            with torch.profiler.record_function(_name):
                return _fn(*a, **kw)

        setattr(obj, attr, functools.wraps(fn)(wrapped))


def pin_host_threads(cfg: dict) -> None:
    """The configuration's host threads for the program's OpenMP loops
    and torch's CPU pool; set before either starts.  Idle OpenMP threads
    sleep rather than spin: the native library and torch each keep a
    pool, and spinning pools take the cores the caller's thread needs."""
    os.environ["OMP_NUM_THREADS"] = str(int(cfg["host_threads"]))
    os.environ["OMP_WAIT_POLICY"] = "PASSIVE"


def run_cell(man: Manifest, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = T_START,
             hook: Optional[Callable] = None) -> dict:
    """One run; ``hook(cell)`` may change the cell before the warm-up
    (the tests break the timed path with it)."""
    import numpy as np
    import torch

    from port_bench import trace as trace_mod
    from port_bench.kinds import common

    wl = man.workload(workload)
    cfg, mix = man.config(wl["config"]), man.traffic(wl["traffic"])
    cell = man.kind(cfg["kind"]).Cell(cfg, mix, seed, device,
                                      common.cache_dir(man.bench_dir, wl["config"]))
    if hook is not None:
        hook(cell)
    cuda = device.startswith("cuda")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cell.warm(int(mix["warm_calls"]))
    sync()
    # the inputs live until the check: keep the collector from walking
    # them on every collection of the program's own objects
    gc.collect()
    gc.freeze()
    _spans(cell, trace)
    before = cell.snapshot()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
    times, items, k = [], 0, 0
    t_first = time.perf_counter()
    with torch.profiler.record_function(trace_mod.WINDOW_SPAN):
        while True:
            t0 = time.perf_counter()
            if t0 - t_first >= seconds:
                break
            items += cell.call(k)
            times.append(time.perf_counter() - t0)
            k += 1
        sync()
    t_end = time.perf_counter()
    if prof is not None:
        prof.__exit__(None, None, None)
    after = cell.snapshot()
    rec = dict(setup_s=t_first - t_start, window_s=t_end - t_first, calls=k, items=items,
               item_kind=cell.items, call_s=times, delta=_deltas(before, after),
               inputs=cell.window_inputs(range(k)))
    rec["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated()) if cuda else 0
    if prof is not None:
        rec["trace"] = trace_mod.read(prof)
        del prof
    cell.free_program()
    t_check = time.perf_counter()
    nums = cell.check(k, seed, device)
    rec["check_s"] = time.perf_counter() - t_check
    rec["checks"] = nums
    rec["correct"] = all(np.isfinite(v) and v <= lim for _, v, lim in nums)
    return rec


def metrics(man: Manifest, workload: str, rec: dict, trace: bool) -> dict:
    out = {}
    for m in man.metrics_of(workload, trace):
        v = man.metric(m["name"]).read(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's kernel caches stay in the checkout, at fixed paths
    cache = os.path.join(BENCH_DIR, ".cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    man = Manifest()
    wl = man.workload(args.workload)
    pin_host_threads(man.config(wl["config"]))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(wl["chips"]):
        print(f"needs {wl['chips']} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    from port_bench import peaks

    rec = run_cell(man, args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    import numpy as np

    card = peaks.card()
    ms = 1e3 * np.percentile(rec["call_s"], [50, 95]) if rec["call_s"] else [0.0, 0.0]
    print(f"card {card}; {rec['calls']} calls, {rec['items']} {rec['item_kind']} in "
          f"{rec['window_s']:.3f} s; a call's median {ms[0]:.3f} ms, p95 {ms[1]:.3f} ms; "
          f"set-up {rec['setup_s']:.3f} s; check {rec['check_s']:.3f} s", file=sys.stderr)
    out = dict(correct=bool(rec["correct"]), attempted=rec["items"], failed=0,
               metrics=metrics(man, args.workload, rec, bool(args.trace)),
               device=dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                           count=int(wl["chips"]), memory_peak_bytes=rec["memory_peak_bytes"]))
    if args.trace:
        t = rec["trace"]
        out["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        out["breakdown"] = t["breakdown"]
    out["card"] = card
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rec["checks"]}
    for n, v, lim in rec["checks"]:
        print(f"check {n} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
