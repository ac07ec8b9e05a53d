"""The paper's approximate filters (Sections II-A, II-B, II-B.1).

Three heads, each consuming the trunk activation *tap* after the first k
layers (``BranchSpec.layer``):

- IC      — §II-A: GAP + fully-connected count head; the FC weights
            double as the CAM projection (Eq. 1).
- OD      — §II-B: three convolution layers on the spatial grid, then
            GAP + FC counts and a per-cell class grid.
- OD-COF  — §II-B.1 Table I: count-only classifier.

Parameters keep the JAX package's layouts: dense weights (in, out), conv
weights HWIO (permuted to OIHW inside ``_conv2d``), grids (B, g, g, C).
The Eq. 2/3 losses arrive with the training slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import cam as CAM
from repro_torch.models.config import BranchSpec
from repro_torch.models.layers import dense_init

Params = Dict[str, Any]


@dataclasses.dataclass
class FilterOutputs:
    """What every head emits (OD-COF emits counts only)."""
    counts: torch.Tensor                     # (B, C) float regression
    grid: Optional[torch.Tensor] = None      # (B, g, g, C) logits

    def count_pred(self, max_count: int = 64) -> torch.Tensor:
        # torch.round, like jnp.round, rounds half to even
        return torch.clamp(torch.round(self.counts), 0,
                           max_count).to(torch.int32)

    def occupancy(self, tau: float = 0.2, radius: int = 0) -> torch.Tensor:
        occ = CAM.threshold_map(self.grid, tau, logits=False)
        if radius:
            occ = CAM.dilate_manhattan(occ, radius)
        return occ

    def spatial_stats(self, tau: float = 0.2) -> torch.Tensor:
        """(B, C, 5) per-class occupancy extrema + cell count, from the
        spatial-stats kernel (its plain version on the CPU)."""
        from repro_torch.kernels import ops as kops
        return kops.spatial_stats_inline(self.grid, tau)


# --------------------------------------------------------------------------
# IC head (§II-A): GAP + FC; CAM from the FC weights (Eq. 1)
# --------------------------------------------------------------------------

def ic_init(gen: torch.Generator, spec: BranchSpec, d_model: int,
            device=None) -> Params:
    return {
        "proj": dense_init(gen, d_model, (d_model, spec.head_dim),
                           torch.float32, device),
        "w": dense_init(gen, spec.head_dim, (spec.head_dim, spec.n_classes),
                        torch.float32, device),
        "b": torch.zeros(spec.n_classes, dtype=torch.float32, device=device),
    }


def ic_apply(p: Params, tap: torch.Tensor, spec: BranchSpec,
             use_kernel: bool = False) -> FilterOutputs:
    feat = CAM.spatialize(tap.float(), spec.grid)                # (B,g,g,D)
    feat = torch.relu(torch.einsum("bijd,de->bije", feat, p["proj"]))
    if use_kernel:
        from repro_torch.kernels import ops as kops
        counts, cam = kops.cam_head(feat, p["w"], p["b"])
    else:
        pooled = feat.mean(dim=(1, 2))                           # GAP
        counts = torch.relu(pooled @ p["w"] + p["b"])            # (B,C)
        cam = CAM.class_activation_map(feat, p["w"])             # Eq. 1
    return FilterOutputs(counts=counts, grid=cam)


# --------------------------------------------------------------------------
# OD head (§II-B): 3 grid-mixing layers + GAP/FC counts + per-cell grid
# --------------------------------------------------------------------------

def _conv2d_init(gen: torch.Generator, cin, cout, ksize,
                 device=None) -> torch.Tensor:
    fan = cin * ksize * ksize
    w = torch.randn((ksize, ksize, cin, cout), generator=gen,
                    device=gen.device) / math.sqrt(fan)
    return w.to(device)


def _conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1
            ) -> torch.Tensor:
    """NHWC x HWIO -> NHWC, "SAME" padding (odd kernels, stride 1)."""
    k = w.shape[0]
    if stride != 1 or k % 2 == 0:
        raise NotImplementedError("only odd kernels at stride 1 are ported")
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=k // 2)
    return y.permute(0, 2, 3, 1)


def od_init(gen: torch.Generator, spec: BranchSpec, d_model: int,
            device=None) -> Params:
    h = spec.head_dim
    return {
        "c1": _conv2d_init(gen, d_model, 2 * h, 1, device),
        "c2": _conv2d_init(gen, 2 * h, h, 3, device),
        "c3": _conv2d_init(gen, h, 2 * h, 1, device),
        "w": dense_init(gen, 2 * h, (2 * h, spec.n_classes), torch.float32,
                        device),
        "b": torch.zeros(spec.n_classes, dtype=torch.float32, device=device),
        "grid_w": dense_init(gen, 2 * h, (2 * h, spec.n_classes),
                             torch.float32, device),
        "grid_b": torch.zeros(spec.n_classes, dtype=torch.float32,
                              device=device),
    }


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.1)


def od_apply(p: Params, tap: torch.Tensor, spec: BranchSpec) -> FilterOutputs:
    feat = CAM.spatialize(tap.float(), spec.grid)
    h = _lrelu(_conv2d(feat, p["c1"]))
    h = _lrelu(_conv2d(h, p["c2"]))
    h = _lrelu(_conv2d(h, p["c3"]))                              # (B,g,g,2h)
    counts = torch.relu(h.mean(dim=(1, 2)) @ p["w"] + p["b"])
    grid = torch.einsum("bijd,dc->bijc", h, p["grid_w"]) + p["grid_b"]
    return FilterOutputs(counts=counts, grid=grid)


# --------------------------------------------------------------------------
# OD-COF head (§II-B.1, Table I): count-only classifier
# --------------------------------------------------------------------------

def cof_init(gen: torch.Generator, spec: BranchSpec, d_model: int,
             device=None) -> Params:
    h = spec.head_dim
    return {
        "c1": _conv2d_init(gen, d_model, 4 * h, 1, device),
        "c2": _conv2d_init(gen, 4 * h, 2 * h, 3, device),
        "c3": _conv2d_init(gen, 2 * h, 4 * h, 1, device),
        "c4": _conv2d_init(gen, 4 * h, 4 * h, 1, device),
        "w": dense_init(gen, 4 * h, (4 * h, spec.n_classes), torch.float32,
                        device),
        "b": torch.zeros(spec.n_classes, dtype=torch.float32, device=device),
    }


def cof_apply(p: Params, tap: torch.Tensor, spec: BranchSpec
              ) -> FilterOutputs:
    feat = CAM.spatialize(tap.float(), spec.grid)
    g = spec.grid
    f = max(g // 2, 1)
    feat = feat.reshape(feat.shape[0], f, g // f, f, g // f, -1).amax((2, 4))
    h = _lrelu(_conv2d(feat, p["c1"]))
    h = _lrelu(_conv2d(h, p["c2"]))
    h = _lrelu(_conv2d(h, p["c3"]))
    h = _lrelu(_conv2d(h, p["c4"]))
    counts = torch.relu(h.mean(dim=(1, 2)) @ p["w"] + p["b"])
    return FilterOutputs(counts=counts, grid=None)


HEADS = {
    "ic": (ic_init, ic_apply),
    "od": (od_init, od_apply),
    "cof": (cof_init, cof_apply),
}


def branch_init(gen: torch.Generator, spec: BranchSpec, d_model: int,
                device=None) -> Params:
    return HEADS[spec.kind][0](gen, spec, d_model, device)


def branch_apply(p: Params, tap: torch.Tensor, spec: BranchSpec,
                 **kw) -> FilterOutputs:
    return HEADS[spec.kind][1](p, tap, spec, **kw) if spec.kind == "ic" \
        else HEADS[spec.kind][1](p, tap, spec)
