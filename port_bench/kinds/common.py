"""What the kinds share: seeds, the program's counters, cache paths."""

from __future__ import annotations

import gc
import hashlib
import os
from typing import Iterable, List

import torch


def seed_words(seed: int, *tags: int) -> List[int]:
    """A SeedSequence entropy list for any whole ``seed`` (negative and
    past 64 bits included) and stream ``tags``."""
    s = int(seed)
    words = [int(s < 0)]
    s = abs(s)
    while True:
        words.append(s & 0xFFFFFFFF)
        s >>= 32
        if not s:
            break
    return words + [len(words)] + [int(t) for t in tags]


def program_counters() -> dict:
    """The port's launch counters (by wrapper) and host timers, now."""
    from acc_genomics_tpu_torch.ops.extend import kernel as ext
    from acc_genomics_tpu_torch.ops.pairhmm import band_kernel, kernel as ph
    from acc_genomics_tpu_torch.ops.smem import kernel as smem
    from acc_genomics_tpu_torch.ops.sw import kernel as sw
    from acc_genomics_tpu_torch.utils.timer import timers

    launches = {}
    for mod in (ext, ph, band_kernel, smem, sw):
        for k, v in mod.LAUNCHES.items():
            launches[k] = launches.get(k, 0) + int(v)
    return dict(launches=launches, timers=timers())


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def file_hash(paths: Iterable[str], extra: str = "") -> str:
    h = hashlib.sha256(extra.encode())
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def cache_dir(bench_dir: str, name: str) -> str:
    """``<bench_dir>/.cache/<name>``, made if missing: a fixed path inside
    the checkout."""
    d = os.path.join(bench_dir, ".cache", name)
    os.makedirs(d, exist_ok=True)
    return d
