"""Class Activation Maps — the paper's Eq. 1.

    M_c(i, j) = sum_k  w_k^c  a_k(i, j)

The (B, S, D) trunk tap is *spatialized* to a (B, g, g, D) grid first
(the synthetic frontend lays frames out in raster order), and
thresholding the CAM yields the per-class occupancy bitmap the CLF
filters evaluate spatial constraints on.  Layouts follow the JAX
package: (B, g, g, C) with C innermost.
"""
from __future__ import annotations

import torch


def spatialize(tap: torch.Tensor, grid: int) -> torch.Tensor:
    """(B, S, D) -> (B, g, g, D) by segment-mean folding of the sequence.

    If S == g*g this is a pure reshape (raster order).  If S > g*g, each
    grid cell averages a contiguous token segment.  If S < g*g, tokens are
    repeated (nearest-neighbour upsample)."""
    B, S, D = tap.shape
    g2 = grid * grid
    if S == g2:
        return tap.reshape(B, grid, grid, D)
    if S > g2:
        pad = (-S) % g2
        if pad:
            tap = torch.cat([tap, tap[:, -1:].expand(B, pad, D)], dim=1)
        r = tap.shape[1] // g2
        return tap.reshape(B, g2, r, D).mean(dim=2).reshape(B, grid, grid, D)
    idx = (torch.arange(g2, device=tap.device) * S) // g2
    return tap[:, idx].reshape(B, grid, grid, D)


def class_activation_map(feat: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Eq. 1. feat: (B, g, g, D); w: (D, C) -> (B, g, g, C)."""
    return torch.einsum("bijd,dc->bijc", feat.float(), w.float())


def upscale_map(cam: torch.Tensor, out: int) -> torch.Tensor:
    """Nearest-neighbour upscale of a (B, g, g, C) map to (B, out, out, C)."""
    g = cam.shape[1]
    idx = (torch.arange(out, device=cam.device) * g) // out
    return cam[:, idx][:, :, idx]


def threshold_map(cam: torch.Tensor, tau: float = 0.2,
                  logits: bool = False) -> torch.Tensor:
    """Occupancy bitmap: raw map values thresholded at ``tau`` (paper
    §IV uses 0.2); ``logits=True`` thresholds the sigmoid instead."""
    scores = torch.sigmoid(cam) if logits else cam
    return scores > tau


def _band(n: int, device) -> torch.Tensor:
    return (torch.eye(n, dtype=torch.float32, device=device)
            + torch.diag(torch.ones(n - 1, device=device), 1)
            + torch.diag(torch.ones(n - 1, device=device), -1))


def dilate_manhattan(occ: torch.Tensor, radius: int) -> torch.Tensor:
    """Dilate a (B, g, g, C) boolean map by Manhattan distance ``radius``.

    Each unit step is the union of the cell with its 4-neighbourhood,
    computed as two banded (g, g) matmuls (tridiagonal row band + column
    band; double-counting the centre is harmless under ``> 0``).  The
    products are small integers, exact in float32, so the result is
    bit-identical to the JAX package's."""
    out = occ
    if radius <= 0:
        return out
    band_r = _band(occ.shape[1], occ.device)
    band_c = _band(occ.shape[2], occ.device)
    for _ in range(radius):
        f = out.float()
        out = (torch.einsum("ij,bjkc->bikc", band_r, f)
               + torch.einsum("kl,bilc->bikc", band_c, f)) > 0
    return out
