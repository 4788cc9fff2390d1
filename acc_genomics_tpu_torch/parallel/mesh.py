"""Device mesh of the port: a ``(data, seq)`` grid of torch devices.

The counterpart of ``acc_genomics_tpu/parallel/mesh.py``.  Axis
``data`` shards batches of independent pairs, reads or seeds; axis
``seq`` shards haplotype columns (the DP x SP pipeline of
``parallel/sharded.py``).  A mesh may repeat a device: its positions then
run one after another on that device, which is how one card stands in
for a mesh (and how the CPU tests build one from ``cpu`` eight times).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from acc_genomics_tpu_torch.device import resolve_device


class Mesh:
    """``devices``: a 2-D object array of ``torch.device``, one per mesh
    position; ``shape`` maps each axis name to its size."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, str] = ("data", "seq")):
        if devices.ndim != len(axis_names):
            raise ValueError(f"devices has {devices.ndim} axes, names {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devices.shape))

    @property
    def first_device(self) -> torch.device:
        """Where the mesh forms gather their results."""
        return self.devices.flat[0]

    def distinct_devices(self) -> List[torch.device]:
        """Each device of the mesh once, in mesh order."""
        return list(dict.fromkeys(self.devices.flat))

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(
    shape: Tuple[int, int] = (1, 1),
    axis_names: Tuple[str, str] = ("data", "seq"),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A mesh of ``shape`` over ``devices`` (the first ``prod(shape)``, in
    row-major order).  With no devices given it takes the visible CUDA
    devices and raises when there are fewer than mesh positions; a caller
    may pass a list that repeats a device."""
    if devices is None:
        devices = [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    n = int(np.prod(shape))
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(shape), axis_names)


def lane_groups(n: int, parts: int) -> List[Tuple[int, int]]:
    """``parts`` contiguous ``[lo, hi)`` ranges that cover ``n`` lanes as
    evenly as possible (the first ones one longer); some may be empty."""
    base, extra = divmod(n, parts)
    out, lo = [], 0
    for k in range(parts):
        hi = lo + base + (k < extra)
        out.append((lo, hi))
        lo = hi
    return out
