"""Dispatch from the model and the planner to the kernel wrappers.

A CPU tensor goes to the plain version and a CUDA tensor to the kernel
(the wrappers decide, from the tensor's device alone).  Layout adapters
live here so callers keep the JAX package's (B, g, g, ·) layouts.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cam_head import cam_head_bgd
from repro_torch.kernels.spatial_predicate import (spatial_stats_bgc,
                                                   spatial_stats_rows_bgc)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last ``reset_launch_counts``."""
    return dict(build.LAUNCHES)


def reset_launch_counts() -> None:
    build.reset_launches()


def cam_head(feat: torch.Tensor, w: torch.Tensor, b: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """feat: (B, g, g, D); w: (D, C); b: (C,) -> (counts, cam (B,g,g,C))."""
    B, g, _, D = feat.shape
    C = w.shape[1]
    counts, cam = cam_head_bgd(feat.reshape(B, g * g, D).contiguous(),
                               w.contiguous(), b.contiguous())
    return counts, cam.reshape(B, g, g, C)


def spatial_stats_inline(grid_logits: torch.Tensor,
                         tau: float = 0.2) -> torch.Tensor:
    """(B, g, g, C) -> per-class stats (B, C, 5)."""
    return spatial_stats_bgc(grid_logits.contiguous(), tau=tau)


def spatial_stats_rows_inline(grid_logits: torch.Tensor, rows: torch.Tensor,
                              tau: float = 0.2) -> torch.Tensor:
    """Stats over a row subset: (B, g, g, C) x (R,) -> (R, C, 5)."""
    return spatial_stats_rows_bgc(grid_logits.contiguous(), rows, tau=tau)

