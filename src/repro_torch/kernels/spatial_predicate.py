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

Both take ``classes``, a (C',) integer tensor: the result is that of the
grid ``grid[..., classes]``, and on the card the kernel reads those
planes from the full grid in place (the plain versions gather them).
Row and class ids on the card are read by the kernel itself, int32 or
int64, with no cast and no separate check: an id out of range faults
the launch, and the error surfaces at the next synchronisation.  Host
ids are checked on the host (``IndexError``) and copied over.  Grids
may be float32, bfloat16 or float16; values are widened to float32
before the compare, as the TPU kernel's ``astype`` does.
"""
from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build, ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ID_DTYPES = (torch.int32, torch.int64)
MAX_CLASSES = 1024
_pack_args = struct.Struct("15q").pack   # see spatial_stats_launch
_LIB = None


def _check_grid(grid_logits: torch.Tensor) -> Tuple[int, int, int]:
    shape = grid_logits.shape
    if len(shape) != 4 or shape[1] != shape[2]:
        raise ValueError(f"expected a (B, g, g, C) grid, got "
                         f"{tuple(shape)}")
    return shape[0], shape[1], shape[3]


def _ids(ids: torch.Tensor, n: int, dev: torch.device, what: str
         ) -> torch.Tensor:
    """A 1-D id tensor the kernel can read on ``dev``: device ids as they
    are (int32 or int64, any stride), host ids checked and copied."""
    if ids.dim() != 1 or ids.dtype.is_floating_point \
            or ids.dtype == torch.bool:
        raise ValueError(f"{what} ids must be a 1-D integer tensor")
    if ids.is_cuda:
        if ids.device != dev:
            raise ValueError(f"{what} ids on {ids.device}, grid on {dev}")
        if ids.dtype not in _ID_DTYPES:
            raise TypeError(f"spatial_stats kernel reads int32 or int64 "
                            f"{what} ids on the card, got {ids.dtype}")
        return ids
    if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= n):
        raise IndexError(f"{what} ids must lie in [0, {n})")
    if ids.dtype not in _ID_DTYPES:
        ids = ids.long()
    return ids.pin_memory().to(dev, non_blocking=True)


def _args(grid_logits: torch.Tensor, rows: Optional[torch.Tensor],
          classes: Optional[torch.Tensor], cluster: int):
    """Checks the inputs; returns the id tensors the kernel reads (to be
    kept alive until the launch is queued), (R, C') and the arguments of
    ``spatial_stats_launch``, the output pointer (the fourth) left 0."""
    B, g, C = _check_grid(grid_logits)
    code = _DTYPE_CODES.get(grid_logits.dtype)
    if code is None:
        raise TypeError(f"spatial_stats kernel takes float32, bfloat16 or "
                        f"float16, got {grid_logits.dtype}")
    if not grid_logits.is_contiguous():
        raise ValueError("spatial_stats kernel needs a contiguous "
                         "(B, g, g, C) grid")
    if not 1 <= C <= MAX_CLASSES:
        raise ValueError(f"spatial_stats kernel takes 1..{MAX_CLASSES} "
                         f"classes, got {C}")
    dev = grid_logits.device
    Cp, cls_ptr, cls64, cls_stride = C, 0, 0, 0
    if classes is not None:
        classes = _ids(classes, C, dev, "class")
        Cp = classes.shape[0]
        if Cp > MAX_CLASSES:
            raise ValueError(f"spatial_stats kernel takes at most "
                             f"{MAX_CLASSES} listed classes, got {Cp}")
        cls_ptr, cls_stride = classes.data_ptr(), classes.stride(0)
        cls64 = classes.dtype == torch.int64
    R, rows_ptr, rows64, rows_stride = B, 0, 0, 0
    if rows is not None:
        rows = _ids(rows, B, dev, "row")
        R, rows_ptr, rows_stride = (rows.shape[0], rows.data_ptr(),
                                    rows.stride(0))
        rows64 = rows.dtype == torch.int64
    return (rows, classes), (R, Cp), [
        grid_logits.data_ptr(), rows_ptr, cls_ptr, 0, B, R, g, C, Cp, code,
        rows64, rows_stride, cls64, cls_stride, cluster]


def _launch(grid_logits: torch.Tensor, rows: Optional[torch.Tensor],
            classes: Optional[torch.Tensor], tau: float,
            cluster: int = 0) -> torch.Tensor:
    """One kernel launch, with a lean host path (the planner calls this
    per stage).  ``cluster`` forces the thread-block cluster size (1..8),
    for timing the host's pick against the others; 0 lets the host pick
    it."""
    ids, (R, Cp), a = _args(grid_logits, rows, classes, cluster)
    dev = grid_logits.device
    out = torch.empty((R, Cp, 5), dtype=torch.float32, device=dev)
    if R == 0 or Cp == 0:
        return out
    a[3] = out.data_ptr()
    rc = (_LIB or _load()).spatial_stats_launch(
        _pack_args(*a), tau, torch._C._cuda_getCurrentRawStream(dev.index))
    if rc:
        build.check(rc, "spatial_stats_launch")
    build.LAUNCHES["spatial_stats_bgc" if rows is None
                   else "spatial_stats_rows_bgc"] += 1
    return out


def _load():
    """The kernel's library, looked up once."""
    global _LIB
    _LIB = build.library("spatial_stats")
    return _LIB


def _check_cpu(t: torch.Tensor) -> None:
    if not t.is_cpu:
        raise ValueError(f"unsupported device {t.device}")


def _planes(grid_logits: torch.Tensor,
            classes: Optional[torch.Tensor]) -> torch.Tensor:
    return grid_logits if classes is None \
        else grid_logits[..., classes.long()]


def spatial_stats_plain(grid_logits: torch.Tensor, tau: float = 0.2, *,
                        classes: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Plain version of ``spatial_stats_bgc`` (gathers the classes)."""
    _check_grid(grid_logits)
    return ref.spatial_stats_proj(_planes(grid_logits, classes), tau)


def spatial_stats_rows_plain(grid_logits: torch.Tensor, rows: torch.Tensor,
                             tau: float = 0.2, *,
                             classes: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Plain version of ``spatial_stats_rows_bgc`` (gathers the rows and
    the classes)."""
    _check_grid(grid_logits)
    return ref.spatial_stats_proj(
        _planes(grid_logits[rows.long()], classes), tau)


def spatial_stats_bgc(grid_logits: torch.Tensor, *, tau: float = 0.2,
                      classes: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """grid_logits: (B, g, g, C) -> stats (B, C', 5) float32 of the planes
    ``classes`` (all C when None)."""
    if grid_logits.is_cuda:
        return _launch(grid_logits, None, classes, tau)
    _check_cpu(grid_logits)
    return spatial_stats_plain(grid_logits, tau, classes=classes)


def spatial_stats_rows_bgc(grid_logits: torch.Tensor, rows: torch.Tensor, *,
                           tau: float = 0.2,
                           classes: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Stats over a row subset: (B, g, g, C) x (R,) int -> (R, C', 5).

    On the card the kernel reads frame ``rows[r]`` in place; the gathered
    (R, g, g, C) tensor is never built."""
    if grid_logits.is_cuda:
        return _launch(grid_logits, rows, classes, tau)
    _check_cpu(grid_logits)
    return spatial_stats_rows_plain(grid_logits, rows, tau, classes=classes)


def stage_class_slice(cls_a: np.ndarray, cls_b: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Compact the class set a spatial stage touches.

    Returns ``(classes, a_idx, b_idx)``: the sorted unique class ids the
    stage's leaves mention, and the leaf arrays remapped into that
    compact set.  The caller passes ``classes`` to the stats reduction,
    so it reduces C' <= C planes; per-class statistics are independent,
    so the sliced evaluation is bit-identical."""
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
