"""RWKV-6 WKV recurrence: the CUDA kernel and its plain version.

``rwkv6_scan_bhtk`` takes r, k, lw (B, H, T, K), v (B, H, T, V), u (H, K)
and s0 (B, H, K, V) and returns ``(out (B, H, T, V) in r's dtype,
sT (B, H, K, V) float32)``.  r, k and v are float32 or bfloat16 (the
model's dtype); lw, u and s0 are float32, as the RWKV time-mix passes
them.  On a CUDA tensor it launches ``csrc/rwkv6_scan.cu`` (K in 16, 32,
64 or 128; any T >= 1 and V >= 1); on a CPU tensor it runs
``rwkv6_scan_plain``, the sequential ``ref.rwkv6_scan_ref``; any other
device raises.  The JAX package's kernel has no gradient, and neither
has this one: inputs that require grad raise.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build, ref

KEY_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def rwkv6_scan_plain(r, k, v, lw, u, s0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential recurrence; ``out`` cast to r's dtype, as the
    kernel writes it."""
    out, sT = ref.rwkv6_scan_ref(r, k, v, lw, u, s0)
    return out.to(r.dtype), sT


def _check(r, k, v, lw, u, s0) -> None:
    if r.dim() != 4 or k.shape != r.shape or lw.shape != r.shape \
            or v.dim() != 4 or v.shape[:3] != r.shape[:3] \
            or u.shape != (r.shape[1], r.shape[3]) \
            or s0.shape != (r.shape[0], r.shape[1], r.shape[3], v.shape[3]):
        raise ValueError(
            f"rwkv6_scan: shapes r {tuple(r.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, lw {tuple(lw.shape)}, u {tuple(u.shape)}, "
            f"s0 {tuple(s0.shape)} do not match (B, H, T, K), (B, H, T, V), "
            f"(H, K), (B, H, K, V)")
    if r.shape[2] < 1:
        raise ValueError("rwkv6_scan needs at least one token")
    if any(t.requires_grad for t in (r, k, v, lw, u, s0)):
        raise RuntimeError("rwkv6_scan has no backward (neither has the TPU "
                           "kernel it ports)")


def rwkv6_scan_bhtk(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, lw: (B, H, T, K); v: (B, H, T, V); u: (H, K);
    s0: (B, H, K, V) -> (out (B, H, T, V), sT (B, H, K, V))."""
    _check(r, k, v, lw, u, s0)
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, lw, u, s0)
    if r.device.type != "cuda":
        raise ValueError(f"unsupported device {r.device}")
    if r.dtype not in _DTYPE_CODES:
        raise TypeError(f"rwkv6_scan kernel takes float32 or bfloat16 r, k, "
                        f"v, got {r.dtype}")
    for name, t, dt in (("k", k, r.dtype), ("v", v, r.dtype),
                        ("lw", lw, torch.float32), ("u", u, torch.float32),
                        ("s0", s0, torch.float32)):
        if t.device != r.device or t.dtype != dt:
            raise ValueError(f"rwkv6_scan: {name} is {t.dtype} on "
                             f"{t.device}, want {dt} on {r.device}")
    for name, t in (("r", r), ("k", k), ("v", v), ("lw", lw), ("u", u),
                    ("s0", s0)):
        if not t.is_contiguous():
            raise ValueError(f"rwkv6_scan kernel needs contiguous inputs; "
                             f"{name} is not")
    B, H, T, K = r.shape
    V = v.shape[3]
    if K not in KEY_DIMS:
        raise ValueError(f"rwkv6_scan kernel takes K in {KEY_DIMS}, got {K}")
    if H > 65535 or B > 65535:
        raise ValueError(f"rwkv6_scan kernel takes at most 65535 heads and "
                         f"batch rows, got H={H}, B={B}")
    lib = build.library("rwkv6_scan")
    out = torch.empty((B, H, T, V), dtype=r.dtype, device=r.device)
    sT = torch.empty((B, H, K, V), dtype=torch.float32, device=r.device)
    if out.numel() == 0:
        return out, sT
    stream = torch.cuda.current_stream(r.device).cuda_stream
    rc = lib.rwkv6_scan_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
        u.data_ptr(), s0.data_ptr(), out.data_ptr(), sT.data_ptr(), B, H, T,
        K, V, _DTYPE_CODES[r.dtype], stream)
    build.check(rc, "rwkv6_scan_launch")
    build.LAUNCHES["rwkv6_scan_bhtk"] += 1
    return out, sT
