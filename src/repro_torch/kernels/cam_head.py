"""Fused CAM head (paper Eq. 1): the CUDA kernel and its plain version.

Because GAP and the FC are linear, ``counts = relu(mean_cells(CAM) + b)``,
so one pass over the features computes the CAM and derives the counts
from its column sums.  ``cam_head_bgd`` launches ``csrc/cam_head.cu`` on
a CUDA tensor (any number of classes; feat, w and b each float32 or
bfloat16, widened to float32 as they are loaded, as the Pallas body
widens them; the outputs float32) and runs ``cam_head_plain`` on a CPU
or ``meta`` tensor; any other device raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

CELL_TILE = 64        # cells per block of csrc/cam_head.cu (its kTile)
_BF16_BITS = {"feat": 1, "w": 2, "b": 4}    # cam_head_launch's ``types``


def cam_head_plain(feat: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """feat: (B, P, D); w: (D, C); b: (C,) -> (counts (B,C), cam (B,P,C))."""
    cam = torch.einsum("bpd,dc->bpc", feat.float(), w.float())
    counts = torch.relu(cam.sum(dim=1) / feat.shape[1] + b.float())
    return counts, cam


def cam_head_bgd(feat: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """feat: (B, P, D); w: (D, C); b: (C,) -> (counts (B,C), cam (B,P,C))."""
    if feat.dim() != 3 or w.dim() != 2 or b.dim() != 1 \
            or w.shape[0] != feat.shape[2] or b.shape[0] != w.shape[1]:
        raise ValueError(f"cam_head: shapes {tuple(feat.shape)}, "
                         f"{tuple(w.shape)}, {tuple(b.shape)} do not match "
                         f"(B, P, D), (D, C), (C,)")
    if feat.device.type in build.PLAIN_DEVICES:
        return cam_head_plain(feat, w, b)
    if feat.device.type != "cuda":
        raise ValueError(f"unsupported device {feat.device}")
    types = 0
    for name, t in (("feat", feat), ("w", w), ("b", b)):
        if t.device != feat.device:
            raise ValueError(f"cam_head: {name} is on {t.device}, feat on "
                             f"{feat.device}")
        if t.dtype not in (torch.float32, torch.bfloat16) \
                or not t.is_contiguous():
            raise ValueError(f"cam_head kernel takes contiguous float32 or "
                             f"bfloat16; {name} is {t.dtype}, contiguous="
                             f"{t.is_contiguous()}")
        types |= _BF16_BITS[name] if t.dtype == torch.bfloat16 else 0
    B, P, D = feat.shape
    C = w.shape[1]
    if C < 1 or P < 1 or B > 65535:
        raise ValueError(f"cam_head kernel takes at least one class and one "
                         f"cell and at most 65535 frames, got C={C}, P={P}, "
                         f"B={B}")
    lib = build.library("cam_head")
    counts = torch.empty((B, C), dtype=torch.float32, device=feat.device)
    cam = torch.empty((B, P, C), dtype=torch.float32, device=feat.device)
    if B == 0:
        return counts, cam
    # per-tile column sums of the CAM, summed in tile order by the kernel's
    # second launch
    part = torch.empty((B, -(-P // CELL_TILE), C), dtype=torch.float32,
                       device=feat.device)
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    rc = lib.cam_head_launch(feat.data_ptr(), w.data_ptr(), b.data_ptr(),
                             counts.data_ptr(), cam.data_ptr(),
                             part.data_ptr(), B, P, D, C, types, stream)
    build.check(rc, "cam_head_launch")
    build.LAUNCHES["cam_head_bgd"] += 1
    return counts, cam
