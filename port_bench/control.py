"""The controls of the correctness check, and the readings limits are set from.

    python -m port_bench.control --workload <name> --seeds 11,12,13 [--seconds 3]

For each seed: the cell's set-up, a short window of the program at the
cell's own load, then the check twice over the same sample: once of the
program's answers (a reading of a sound run) and once of the control in
the program's place.  The control is the reference computed one step
below what the configuration states: for HaplotypeCaller the PairHMM in
bfloat16 (the configuration states float32 with a float64 recompute of
underflows); for BWA-MEM, which states exact bwa mem seeding, the seeds
of the first SMEM pass alone (the re-seed and LAST-like passes off).
Prints one JSON line a seed.  The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from port_bench.manifest import Manifest


def readings(man: Manifest, workload: str, seed: int, seconds: float, device: str) -> dict:
    from port_bench.kinds import common

    wl = man.workload(workload)
    cfg, mix = man.config(wl["config"]), man.traffic(wl["traffic"])
    cell = man.kind(cfg["kind"]).Cell(cfg, mix, seed, device,
                                      common.cache_dir(man.bench_dir, wl["config"]))
    cell.warm(int(mix["warm_calls"]))
    t0, k = time.perf_counter(), 0
    while time.perf_counter() - t0 < seconds:
        cell.call(k)
        k += 1
    cell.free_program()
    prog = cell.check(k, seed, device)
    ctrl = cell.check(k, seed, device, control=True)
    return dict(workload=workload, seed=seed, calls=k,
                program={n: v for n, v, _ in prog}, control={n: v for n, v, _ in ctrl},
                limits={n: lim for n, _, lim in prog})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    man = Manifest()
    from port_bench.run import pin_host_threads

    pin_host_threads(man.config(man.workload(args.workload)["config"]))
    for s in args.seeds.split(","):
        print(json.dumps(readings(man, args.workload, int(s), args.seconds, args.device)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
