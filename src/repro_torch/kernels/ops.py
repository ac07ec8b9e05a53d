"""Dispatch from the model and the planner to the kernel wrappers.

A CPU tensor goes to the plain version and a CUDA tensor to the kernel
(the wrappers decide, from the tensor's device alone).  Layout adapters
live here so callers keep the JAX package's (B, g, g, ·) layouts.

``decode_attention(block_k=)`` and ``rwkv6_scan(chunk=)`` are the TPU
kernels' tile sizes.  They are accepted only to keep the JAX wrappers'
signatures, and ignored: the CUDA kernels choose their own tiles and
take every length.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cam_head import cam_head_bgd
from repro_torch.kernels.decode_attention import decode_attention_bkgd
from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_bhtk
from repro_torch.kernels.spatial_predicate import (spatial_stats_bgc,
                                                   spatial_stats_rows_bgc)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last ``reset_launch_counts``."""
    return dict(build.LAUNCHES)


def reset_launch_counts() -> None:
    build.reset_launches()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    sliding_window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) -> (B, Sq, H, hd).

    Every Sq and Sk goes to the kernel on the card: it masks the ragged
    edge itself, where the JAX wrapper falls back to the reference for
    lengths that its tiles do not divide (the same function)."""
    q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    out = flash_attention_bhsd(q, k, v, causal=causal,
                               sliding_window=sliding_window)
    return out.transpose(1, 2)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len, *, block_k: int = 256) -> torch.Tensor:
    """q: (B, H, hd); k, v: (B, S, KV, hd); kv_len: int or a one-element
    tensor -> (B, H, hd).

    Every S goes to the kernel on the card, which masks the ragged edge
    itself and reads the cache in place: k and v go to it as (B, KV, S,
    hd) views, never copied."""
    del block_k
    B, H, hd = q.shape
    KV = k.shape[2]
    out = decode_attention_bkgd(q.reshape(B, KV, H // KV, hd),
                                k.transpose(1, 2), v.transpose(1, 2), kv_len)
    return out.reshape(B, H, hd)


def cam_head(feat: torch.Tensor, w: torch.Tensor, b: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """feat: (B, g, g, D); w: (D, C); b: (C,) -> (counts, cam (B,g,g,C))."""
    B, g, _, D = feat.shape
    C = w.shape[1]
    counts, cam = cam_head_bgd(feat.reshape(B, g * g, D).contiguous(),
                               w.contiguous(), b.contiguous())
    return counts, cam.reshape(B, g, g, C)


def spatial_stats_inline(grid_logits: torch.Tensor, tau: float = 0.2, *,
                         classes: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """(B, g, g, C) -> per-class stats (B, C', 5) of the planes
    ``classes`` (all C when None), read in place on the card."""
    return spatial_stats_bgc(grid_logits.contiguous(), tau=tau,
                             classes=classes)


def spatial_stats_rows_inline(grid_logits: torch.Tensor, rows: torch.Tensor,
                              tau: float = 0.2, *,
                              classes: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Stats over a row subset: (B, g, g, C) x (R,) -> (R, C', 5)."""
    return spatial_stats_rows_bgc(grid_logits.contiguous(), rows, tau=tau,
                                  classes=classes)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, *,
               chunk: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, lw: (B, H, T, K); u: (H, K); s0: (B, H, K, V) ->
    (out (B, H, T, V) in r's dtype, sT (B, H, K, V) float32).

    Every T goes to the kernel on the card (it runs token by token), and
    r, k, v and lw go to it as they are: it reads them through their
    strides."""
    del chunk
    return rwkv6_scan_bhtk(r, k, v, lw, u.contiguous(), s0.contiguous())
