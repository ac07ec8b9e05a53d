"""Device resolution for the port's entry points.

Every entry point takes ``device=None``.  ``None`` means ``"cuda"``: the
port is written for the GPU, and a missing card is an error, not a
reason to fall back to the CPU.  Callers that want the CPU (the tests)
ask for it by name.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raises when a CUDA device is asked for and
    none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' explicitly to run on the CPU")
    return dev


def require_on(t: torch.Tensor, dev: torch.device, what: str) -> None:
    """Raise unless ``t`` lies on ``dev`` (nothing moves implicitly)."""
    if t.device.type != dev.type or (
            dev.index is not None and t.device.index != dev.index):
        raise ValueError(f"{what} is on {t.device}, expected {dev}")
