"""Plain PyTorch versions of the ported kernels.

``spatial_stats_ref`` and ``cam_head_ref`` mirror the JAX package's
``kernels/ref.py`` oracles; ``spatial_stats_proj`` mirrors its
``ops._spatial_stats_proj``, the projection reduction that is the plain
version of both spatial-stats kernels here.  The CPU path of every
kernel wrapper runs these, and on the card they are what the kernels
are compared with.
"""
from __future__ import annotations

from typing import Tuple

import torch


def cam_head_ref(feat: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paper Eq. 1 head. feat: (B, g, g, D); w: (D, C); b: (C,).

    counts = relu(GAP(feat) @ w + b);  cam[b,i,j,c] = sum_d feat*w."""
    cam = torch.einsum("bijd,dc->bijc", feat.float(), w.float())
    counts = torch.relu(cam.mean(dim=(1, 2)) + b.float())
    return counts, cam


def spatial_stats_ref(grid_logits: torch.Tensor,
                      tau: float = 0.2) -> torch.Tensor:
    """Per-class occupancy statistics from CAM logits.

    grid_logits: (B, g, g, C) -> stats (B, C, 5) float32:
      [min_row, max_row, min_col, max_col, n_cells]
    Empty classes: min=g, max=-1, n=0.
    """
    B, g, _, C = grid_logits.shape
    dev = grid_logits.device
    occ = grid_logits.float() > tau
    rows = torch.arange(g, device=dev)[None, :, None, None]
    cols = torch.arange(g, device=dev)[None, None, :, None]
    big = torch.full((), g, device=dev)
    neg = torch.full((), -1, device=dev)

    def ext(idx, fill, op):
        return op(op(torch.where(occ, idx, fill), 1).values, 1).values

    min_row = ext(rows, big, torch.min).float()
    max_row = ext(rows, neg, torch.max).float()
    min_col = ext(cols, big, torch.min).float()
    max_col = ext(cols, neg, torch.max).float()
    n = occ.sum(dim=(1, 2)).float()
    return torch.stack([min_row, max_row, min_col, max_col, n], dim=-1)


def spatial_stats_proj(grid_logits: torch.Tensor,
                       tau: float = 0.2) -> torch.Tensor:
    """Spatial stats via row/column occupancy projections.

    Extrema only need ``any`` along the opposite axis, so after one
    threshold pass the min/max reductions run on (B, g, C) projections.
    Bit-identical to ``spatial_stats_ref``."""
    B, g, _, C = grid_logits.shape
    occ = grid_logits.float() > tau
    prow = occ.any(2)                                # (B, g, C) row occupied
    pcol = occ.any(1)                                # (B, g, C) col occupied
    idx = torch.arange(g, dtype=torch.float32,
                       device=grid_logits.device)[None, :, None]
    big = torch.full((), float(g), device=grid_logits.device)
    neg = torch.full((), -1.0, device=grid_logits.device)
    min_row = torch.where(prow, idx, big).amin(1)
    max_row = torch.where(prow, idx, neg).amax(1)
    min_col = torch.where(pcol, idx, big).amin(1)
    max_col = torch.where(pcol, idx, neg).amax(1)
    n = occ.sum(dim=(1, 2)).float()
    return torch.stack([min_row, max_row, min_col, max_col, n], dim=-1)
