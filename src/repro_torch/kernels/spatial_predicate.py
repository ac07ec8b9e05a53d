"""Spatial-predicate statistics: the CUDA kernel and its plain version.

Evaluating ORDER()/Region constraints needs, per frame and per class, the
occupancy extrema of the thresholded CAM: min/max row, min/max column and
the occupied-cell count.  Those five statistics are sufficient for every
pairwise relation the query language supports, so one reduction of the
(g, g, C) grid per frame serves every spatial leaf of every query.

``spatial_stats_bgc`` (full batch) and ``spatial_stats_rows_bgc`` (an
(R,) row list, any order, duplicates allowed) launch the kernel of
``csrc/spatial_stats.cu`` on a CUDA tensor and run their plain versions
(``spatial_stats_plain`` / ``spatial_stats_rows_plain``, the projection
reduction of ``ref.spatial_stats_proj``) on a CPU tensor; any other
device raises.  The kernel is bit-exact with the plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build, ref


def _check_grid(grid_logits: torch.Tensor) -> Tuple[int, int, int]:
    if grid_logits.dim() != 4 or grid_logits.shape[1] != grid_logits.shape[2]:
        raise ValueError(f"expected a (B, g, g, C) grid, got "
                         f"{tuple(grid_logits.shape)}")
    B, g, _, C = grid_logits.shape
    return B, g, C


def _launch(grid_logits: torch.Tensor, rows: Optional[torch.Tensor],
            tau: float) -> torch.Tensor:
    B, g, C = _check_grid(grid_logits)
    if grid_logits.dtype != torch.float32:
        raise TypeError(f"spatial_stats kernel takes float32, got "
                        f"{grid_logits.dtype}")
    if not grid_logits.is_contiguous():
        raise ValueError("spatial_stats kernel needs a contiguous "
                         "(B, g, g, C) grid")
    if not 1 <= C <= 1024:
        raise ValueError(f"spatial_stats kernel takes 1..1024 classes, "
                         f"got {C}")
    R = B if rows is None else rows.shape[0]
    out = torch.empty((R, C, 5), dtype=torch.float32,
                      device=grid_logits.device)
    if R == 0:
        return out
    rows_ptr = None
    if rows is not None:
        if rows.dim() != 1 or rows.dtype.is_floating_point:
            raise ValueError("rows must be a 1-D integer tensor")
        if rows.device.type == "cpu":
            if rows.numel() and (int(rows.min()) < 0 or int(rows.max()) >= B):
                raise IndexError(f"row ids must lie in [0, {B})")
            rows = rows.to(torch.int32).pin_memory().to(
                grid_logits.device, non_blocking=True)
        else:
            # checked on the device, without a host sync: a bad id fails
            # the asynchronous assert and raises at the next sync
            torch._assert_async(((rows >= 0) & (rows < B)).all(),
                                f"row ids must lie in [0, {B})")
            rows = rows.to(device=grid_logits.device, dtype=torch.int32)
        rows = rows.contiguous()
        rows_ptr = rows.data_ptr()
    lib = build.library("spatial_stats")
    stream = torch.cuda.current_stream(grid_logits.device).cuda_stream
    rc = lib.spatial_stats_launch(grid_logits.data_ptr(), rows_ptr,
                                  out.data_ptr(), R, g, C, float(tau),
                                  stream)
    build.check(rc, "spatial_stats_launch")
    build.LAUNCHES["spatial_stats_rows_bgc" if rows is not None
                   else "spatial_stats_bgc"] += 1
    return out


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def spatial_stats_plain(grid_logits: torch.Tensor,
                        tau: float = 0.2) -> torch.Tensor:
    """Plain version of ``spatial_stats_bgc``."""
    _check_grid(grid_logits)
    return ref.spatial_stats_proj(grid_logits, tau)


def spatial_stats_rows_plain(grid_logits: torch.Tensor, rows: torch.Tensor,
                             tau: float = 0.2) -> torch.Tensor:
    """Plain version of ``spatial_stats_rows_bgc`` (gathers the rows)."""
    _check_grid(grid_logits)
    return ref.spatial_stats_proj(grid_logits[rows.long()], tau)


def spatial_stats_bgc(grid_logits: torch.Tensor, *,
                      tau: float = 0.2) -> torch.Tensor:
    """grid_logits: (B, g, g, C) -> stats (B, C, 5) float32."""
    if _device_kind(grid_logits) == "cpu":
        return spatial_stats_plain(grid_logits, tau)
    return _launch(grid_logits, None, tau)


def spatial_stats_rows_bgc(grid_logits: torch.Tensor, rows: torch.Tensor, *,
                           tau: float = 0.2) -> torch.Tensor:
    """Stats over a row subset: (B, g, g, C) x (R,) int -> (R, C, 5).

    On the card the kernel reads frame ``rows[r]`` in place; the gathered
    (R, g, g, C) tensor is never built."""
    if _device_kind(grid_logits) == "cpu":
        return spatial_stats_rows_plain(grid_logits, rows, tau)
    return _launch(grid_logits, rows, tau)


def stage_class_slice(cls_a: np.ndarray, cls_b: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Compact the class set a spatial stage touches.

    Returns ``(classes, a_idx, b_idx)``: the sorted unique class ids the
    stage's leaves mention, and the leaf arrays remapped into that
    compact set.  The caller gathers ``grid[..., classes]`` before the
    stats reduction, so it reduces C' <= C planes; per-class statistics
    are independent, so the sliced evaluation is bit-identical."""
    classes, inv = np.unique(np.concatenate([cls_a, cls_b]),
                             return_inverse=True)
    a_idx = inv[:len(cls_a)].astype(np.int32)
    b_idx = inv[len(cls_a):].astype(np.int32)
    return classes.astype(np.int32), a_idx, b_idx


def eval_spatial_leaves(stats: torch.Tensor, cls_a: torch.Tensor,
                        cls_b: torch.Tensor, use_row: torch.Tensor,
                        radius: torch.Tensor, *, grid: int) -> torch.Tensor:
    """Batched evaluation of L canonical ORDER() leaves at once.

    stats: (B, C, 5); cls_a/cls_b/use_row/radius: (L,) -> (B, L) bool.
    Manhattan dilation by r shifts the extrema exactly (min - r clamped
    to 0, max + r clamped to g - 1) and never changes emptiness."""
    sa = stats[:, cls_a.long()]                          # (B, L, 5)
    sb = stats[:, cls_b.long()]
    any_a = sa[..., 4] > 0
    any_b = sb[..., 4] > 0
    r = radius.to(stats.dtype)
    min_a = torch.where(use_row, sa[..., 0], sa[..., 2])
    max_b = torch.where(use_row, sb[..., 1], sb[..., 3])
    min_a = torch.clamp(min_a - r, min=0.0)
    max_b = torch.clamp(max_b + r, max=float(grid - 1))
    return any_a & any_b & (min_a < max_b)
