"""Fused CAM head (paper Eq. 1): the CUDA kernel and its plain version.

Because GAP and the FC are linear, ``counts = relu(mean_cells(CAM) + b)``,
so one pass over the features computes the CAM and derives the counts
from its column sums.  ``cam_head_bgd`` launches ``csrc/cam_head.cu`` on
a CUDA tensor (any number of classes; feat, w and b each float32 or
bfloat16, widened to float32 as they are loaded, as the Pallas body
widens them; the outputs float32) and runs ``cam_head_plain`` on a CPU
or ``meta`` tensor; any other device raises.  The source has two bodies
(``body_for`` picks one): a streaming one for the few classes of a
filter head, and a tiled product on warpgroup MMA for many classes
(``CAM_MMA_MIN_CLASSES`` and up), which takes features whose rows are a
multiple of 16 bytes from a 16-byte boundary (TMA's rule) and splits w
once a call into a workspace the wrapper allocates.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

# cells a tile of each body (its column sums go to a (B, n_tiles, C)
# scratch): the streaming body's kTile, the MMA body's kBM
CELL_TILE = {"stream": 64, "mma": 128}
BODIES = ("stream", "mma")                  # cam_head_launch's ``body``
# The crossover: the MMA body from this many classes on.  Measured by
# `tools/wide_bodies_times.py` at (32, 3136, 256) float32, 50 calls back
# to back, streaming / MMA body ms (NVIDIA H100 80GB HBM3, 700 W): C 3
# 0.0576 / 0.0516-0.0518, C 4 0.0590-0.0591 / 0.0513-0.0519, C 8 0.0825 /
# 0.0517-0.0522, C 16 0.1353-0.1365 / 0.0554-0.0555, C 128 1.4463-1.4517 /
# 0.0963-0.0966.  The MMA body wins from 4 on; at the filter's 3 it is
# ahead too, but the filter head stays on the streaming body, unchanged
# on the main path (its device time, 0.0443 ms, is not yet compared).
CAM_MMA_MIN_CLASSES = 4
_BF16_BITS = {"feat": 1, "w": 2, "b": 4}    # cam_head_launch's ``types``


def cam_head_plain(feat: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """feat: (B, P, D); w: (D, C); b: (C,) -> (counts (B,C), cam (B,P,C))."""
    cam = torch.einsum("bpd,dc->bpc", feat.float(), w.float())
    counts = torch.relu(cam.sum(dim=1) / feat.shape[1] + b.float())
    return counts, cam


def body_for(C: int, D: int, feat_dtype: torch.dtype, feat_ptr: int) -> str:
    """The body ``cam_head_bgd`` launches for C classes over D features of
    ``feat_dtype`` at address ``feat_ptr``: ``"mma"`` from
    ``CAM_MMA_MIN_CLASSES`` classes on where TMA can read the features
    (rows a multiple of 16 bytes, a 16-byte aligned start), else
    ``"stream"``."""
    esize = 2 if feat_dtype == torch.bfloat16 else 4
    if C >= CAM_MMA_MIN_CLASSES and D * esize % 16 == 0 \
            and feat_ptr % 16 == 0:
        return "mma"
    return "stream"


def cam_head_bgd(feat: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """feat: (B, P, D); w: (D, C); b: (C,) -> (counts (B,C), cam (B,P,C))."""
    _check(feat, w, b)
    if feat.device.type in build.PLAIN_DEVICES:
        return cam_head_plain(feat, w, b)
    return launch_body(feat, w, b, body_for(w.shape[1], feat.shape[2],
                                            feat.dtype, feat.data_ptr()))


def _check(feat: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if feat.dim() != 3 or w.dim() != 2 or b.dim() != 1 \
            or w.shape[0] != feat.shape[2] or b.shape[0] != w.shape[1]:
        raise ValueError(f"cam_head: shapes {tuple(feat.shape)}, "
                         f"{tuple(w.shape)}, {tuple(b.shape)} do not match "
                         f"(B, P, D), (D, C), (C,)")


def launch_body(feat: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                body: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cam_head_bgd`` on the card through the named body (``BODIES``),
    whatever ``body_for`` would pick: the main path calls
    ``cam_head_bgd``; this is for timing and testing each body where both
    run.  Counts its launch as ``cam_head_bgd``'s."""
    _check(feat, w, b)
    if feat.device.type != "cuda":
        raise ValueError(f"unsupported device {feat.device}")
    if body not in BODIES:
        raise ValueError(f"cam_head: body {body!r} is not one of {BODIES}")
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
    if body == "mma" and (D * feat.element_size() % 16
                          or feat.data_ptr() % 16):
        raise ValueError(f"cam_head: the mma body reads rows of a multiple "
                         f"of 16 bytes from a 16-byte boundary; D={D} "
                         f"{feat.dtype} at {feat.data_ptr() % 16} bytes off")
    lib = build.library("cam_head")
    counts = torch.empty((B, C), dtype=torch.float32, device=feat.device)
    cam = torch.empty((B, P, C), dtype=torch.float32, device=feat.device)
    if B == 0:
        return counts, cam
    # per-tile column sums of the CAM, summed in tile order by the counts
    # kernel
    part = torch.empty((B, -(-P // CELL_TILE[body]), C), dtype=torch.float32,
                       device=feat.device)
    ws = (torch.empty(lib.cam_head_workspace_bytes(D, C, types),
                      dtype=torch.uint8, device=feat.device)
          if body == "mma" else None)
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    rc = lib.cam_head_launch(feat.data_ptr(), w.data_ptr(), b.data_ptr(),
                             counts.data_ptr(), cam.data_ptr(),
                             part.data_ptr(),
                             None if ws is None else ws.data_ptr(), B, P, D,
                             C, types, BODIES.index(body), stream)
    build.check(rc, "cam_head_launch")
    build.LAUNCHES["cam_head_bgd"] += 1
    return counts, cam


def body_launches() -> dict:
    """Launches of each body (``BODIES``) since the card's library was
    loaded, as its launcher counts them: which body ran."""
    import ctypes
    out = (ctypes.c_int * 2)()
    build.library("cam_head").cam_head_body_launches(out)
    return dict(zip(BODIES, out))


def mma_info(C: int, feat_dtype: torch.dtype, w_dtype: torch.dtype
             ) -> dict:
    """The MMA body's launch shape and resources for C classes and these
    types, on the card: shared memory, threads, registers and local
    memory a thread, blocks an SM, the ring's stages, the class block."""
    import ctypes
    types = (1 if feat_dtype == torch.bfloat16 else 0) \
        | (2 if w_dtype == torch.bfloat16 else 0)
    out = (ctypes.c_int * 7)()
    build.check(build.library("cam_head").cam_head_mma_info(C, types, out),
                "cam_head_mma_info")
    return dict(zip(("smem_bytes", "threads", "registers", "local_bytes",
                     "blocks_per_sm", "stages", "class_block"), out))
