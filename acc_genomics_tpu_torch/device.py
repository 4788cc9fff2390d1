"""Explicit device resolution for the port.

A caller names its device.  ``"cuda"`` (or ``"cuda:N"``) needs a CUDA
build of PyTorch and a card, and raises otherwise; the CPU is used only
when the caller asks for it, and then every kernel wrapper runs its plain
PyTorch version.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r} (cuda or cpu)")


def same_device(*tensors: torch.Tensor) -> torch.device:
    """The one device all ``tensors`` lie on; raises on a mix."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on mixed devices: {sorted(map(str, devs))}")
    return devs.pop()


def check_tensor(t: torch.Tensor, name: str, dtype, shape):
    """Raise unless ``t`` has ``dtype`` and ``shape`` and is contiguous
    (what a kernel's C interface takes)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
