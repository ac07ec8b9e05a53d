"""Moving weights into the port.

The JAX package and the port use different random generators, so the
same seed never gives the same weights.  Tests and comparisons therefore
carry one set of weights across as numpy arrays: both packages keep the
same parameter tree and layouts, so this is a tree map.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """Nested dict of numpy arrays (the JAX package's filter parameters
    ``{"proj", "pos", "trunk", "branch"}`` after ``np.asarray`` on every
    leaf) -> the same tree of tensors on ``device`` (default CUDA)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.as_tensor(np.array(x, copy=True), device=dev)

    return conv(tree)
