"""Moving weights into the port.

The JAX package and the port use different random generators, so the
same seed never gives the same weights.  Tests and comparisons therefore
carry one set of weights across as numpy arrays: both packages keep the
same parameter tree and layouts, so this is a tree map.  bfloat16 leaves
(numpy arrays of ``ml_dtypes.bfloat16``, which is what a JAX bf16 array
becomes) are carried bit for bit through their 16-bit patterns.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """Nested dict of numpy arrays (a JAX parameter tree after
    ``np.asarray`` on every leaf) -> the same tree of tensors on
    ``device`` (default CUDA)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        a = np.array(x, copy=True)
        if a.dtype.name == "bfloat16":
            bits = torch.from_numpy(a.view(np.int16))
            return bits.view(torch.bfloat16).to(dev)
        return torch.as_tensor(a, device=dev)

    return conv(tree)
