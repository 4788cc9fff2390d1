"""Reading a ``torch.profiler`` trace of the measured window.

Device time is every CUDA activity the profiler saw (kernels, copies,
sets; not the device-side annotations of host ranges) inside the
window's span; ``busy_s`` is the union of those
intervals, so overlapping streams count once.  Each idle gap of the
device is put down to the innermost host span or operation running at
its middle.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

WINDOW_SPAN = "port_bench.window"


def _is_device(evt) -> bool:
    from torch.autograd import DeviceType

    return evt.device_type != DeviceType.CPU


def read(prof) -> dict:
    events = list(prof.events())
    win = [e for e in events if e.name == WINDOW_SPAN and not _is_device(e)]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
    w0, w1 = win[0].time_range.start, win[0].time_range.end  # microseconds
    # a host range also shows on the device's timeline as an annotation
    # of the same name: that is no device work
    host_names = {e.name for e in events if not _is_device(e)}
    dev = [(max(e.time_range.start, w0), min(e.time_range.end, w1), e.name)
           for e in events if _is_device(e) and e.name not in host_names]
    dev = [d for d in dev if d[1] > d[0]]
    kernel_s: Dict[str, float] = defaultdict(float)
    for a, b, name in dev:
        kernel_s[name] += (b - a) / 1e6
    busy, gaps = _union_and_gaps([(a, b) for a, b, _ in dev], w0, w1)
    host = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                   if not _is_device(e) and e.name != WINDOW_SPAN),
                  key=lambda t: t[0] - t[1])  # longest first, innermost painted last
    idle = _label_gaps(gaps, host)
    top_ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy / 1e6, window_s=(w1 - w0) / 1e6, kernel_s=dict(kernel_s),
                breakdown=dict(device_ops=[[n[:120], s] for n, s in top_ops],
                               idle_gaps=[[n[:120], s] for n, s in idle[:10]]))


def _union_and_gaps(spans: List[Tuple[float, float]], w0: float, w1: float):
    busy, gaps, end = 0.0, [], w0
    for a, b in sorted(spans):
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if w1 > end:
        gaps.append((end, w1))
    return busy, gaps


def _label_gaps(gaps, host) -> List[Tuple[str, float]]:
    """Idle seconds summed by the host span at each gap's middle."""
    if not gaps:
        return []
    mids = np.array([(a + b) / 2 for a, b in gaps])
    order = np.argsort(mids)
    labels = np.full(len(gaps), "(no host span)", dtype=object)
    sorted_mids = mids[order]
    for a, b, name in host:
        lo, hi = np.searchsorted(sorted_mids, [a, b])
        labels[order[lo:hi]] = name
    out: Dict[str, float] = defaultdict(float)
    for (a, b), name in zip(gaps, labels):
        out[name] += (b - a) / 1e6
    return sorted(out.items(), key=lambda kv: -kv[1])
