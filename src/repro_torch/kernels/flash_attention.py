"""Blocked online-softmax (flash) attention: the CUDA kernel and its plain
version.

``flash_attention_bhsd`` takes q (B, H, Sq, hd) and k, v (B, KV, Sk, hd)
(query head h reads kv head ``h // (H // KV)``), with ``causal`` and
``sliding_window`` masks, in float32 or bfloat16.  On a CUDA tensor it
launches ``csrc/flash_attention.cu``, whose bodies take hd 32, 64, 128
and 256 (``HEAD_DIMS``) and any Sq and Sk (the kernel masks the ragged
edge itself).  Every other hd up to 256 runs through the kernel too, as
the Pallas kernel runs any hd: q, k and v are zero-padded along hd up to
the next body, which runs with the true hd's scale, and the output is
sliced back.  Zero columns add nothing to a score and leave the kept
columns as they are, so this is the same function; the pad costs a copy
of q, k and v and the slice one of o.  A head dim above 256 raises on
the card.  On a CPU or ``meta`` tensor it runs ``flash_attention_plain``,
the full-softmax ``ref.flash_attention_ref``; any other device raises.
The JAX package's kernel has no gradient, and neither has this one:
inputs that require grad raise.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (32, 64, 128, 256)      # the kernel's bodies
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          sliding_window: Optional[int] = None
                          ) -> torch.Tensor:
    """(B, H, Sq, hd), (B, KV, Sk, hd) -> (B, H, Sq, hd), full softmax."""
    out = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  sliding_window=sliding_window)
    return out.transpose(1, 2)


def body_head_dim(hd: int) -> int:
    """The kernel body that runs head dim ``hd``: the least of
    ``HEAD_DIMS`` at or above it (the rest is zero padding)."""
    for body in HEAD_DIMS:
        if hd <= body:
            return body
    raise ValueError(f"flash_attention kernel takes head_dim up to "
                     f"{HEAD_DIMS[-1]} (bodies {HEAD_DIMS}, smaller ones "
                     f"zero-padded), got {hd}")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           sliding_window: Optional[int]) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or k.shape[1] < 1 or q.shape[1] % k.shape[1] or k.shape[2] < 1:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} do not match "
                         f"(B, H, Sq, hd), (B, KV, Sk, hd) with H % KV == 0")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window must be >= 1, got {sliding_window}")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError("flash_attention has no backward (neither has the "
                           "TPU kernel it ports); train with "
                           "attn_impl='xla_naive'")


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         sliding_window: Optional[int] = None
                         ) -> torch.Tensor:
    """q: (B, H, Sq, hd); k, v: (B, KV, Sk, hd) -> (B, H, Sq, hd)."""
    _check(q, k, v, sliding_window)
    if q.device.type in build.PLAIN_DEVICES:
        return flash_attention_plain(q, k, v, causal=causal,
                                     sliding_window=sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    body = body_head_dim(hd)
    if H > 65535 or B > 65535:
        raise ValueError(f"flash_attention kernel takes at most 65535 heads "
                         f"and batch rows, got H={H}, B={B}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous inputs")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention kernel copies 16-byte chunks: "
                         "q, k and v must start on a 16-byte boundary")
    lib = build.library("flash_attention")
    if q.numel() == 0:
        return torch.empty_like(q)
    if body != hd:
        q, k, v = (torch.nn.functional.pad(t, (0, body - hd))
                   for t in (q, k, v))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, KV,
        Sq, Sk, body, _DTYPE_CODES[q.dtype], int(causal),
        0 if sliding_window is None else int(sliding_window),
        1.0 / math.sqrt(hd), stream)
    build.check(rc, "flash_attention_launch")
    build.LAUNCHES["flash_attention_bhsd"] += 1
    return out if body == hd else out[..., :hd].contiguous()
