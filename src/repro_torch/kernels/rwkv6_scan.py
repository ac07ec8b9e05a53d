"""RWKV-6 WKV recurrence: the CUDA kernel and its plain version.

``rwkv6_scan_bhtk`` takes r, k, lw (B, H, T, K), v (B, H, T, V), u (H, K)
and s0 (B, H, K, V) and returns ``(out (B, H, T, V) in r's dtype,
sT (B, H, K, V) float32)``.  r, k and v are float32 or bfloat16 (the
model's dtype); lw, u and s0 are float32, as the RWKV time-mix passes
them.  On a CUDA tensor it launches ``csrc/rwkv6_scan.cu`` (K in 16, 32,
64 or 128; any T >= 1 and V >= 1; r, k, v and lw read in place
through their strides, with 16-byte aligned rows; u and s0
contiguous); on a CPU tensor it runs
``rwkv6_scan_plain``, the sequential ``ref.rwkv6_scan_ref``; any other
device raises.  The JAX package's kernel has no gradient, and neither
has this one: inputs that require grad raise.
"""
from __future__ import annotations

import ctypes
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
    shape = r.shape
    if len(shape) != 4 or k.shape != shape or lw.shape != shape \
            or v.dim() != 4 or v.shape[:3] != shape[:3] \
            or u.shape != (shape[1], shape[3]) \
            or s0.shape != (shape[0], shape[1], shape[3], v.shape[3]):
        raise ValueError(
            f"rwkv6_scan: shapes r {tuple(r.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, lw {tuple(lw.shape)}, u {tuple(u.shape)}, "
            f"s0 {tuple(s0.shape)} do not match (B, H, T, K), (B, H, T, V), "
            f"(H, K), (B, H, K, V)")
    if shape[2] < 1:
        raise ValueError("rwkv6_scan needs at least one token")
    if r.requires_grad or k.requires_grad or v.requires_grad \
            or lw.requires_grad or u.requires_grad or s0.requires_grad:
        raise RuntimeError("rwkv6_scan has no backward (neither has the TPU "
                           "kernel it ports)")


def scan_strides(t: torch.Tensor) -> Tuple[int, int, int]:
    """The (batch, head, token) element strides through which the kernel
    reads a (B, H, T, ·) input in place; the last dimension must be
    contiguous.  The kernel copies rows by 16-byte cp.async, so it also
    needs the start and the strides of dimensions longer than one 16-byte
    aligned; the launch checks that (its inputs are on the card), and the
    wrapper raises ValueError.  Kept lean: the decode path calls this four
    times a layer."""
    s = t.stride()
    if s[3] != 1:
        raise ValueError(f"rwkv6_scan kernel needs a contiguous last "
                         f"dimension; got strides {s}")
    return s[0], s[1], s[2]


def rwkv6_scan_bhtk(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, lw: (B, H, T, K); v: (B, H, T, V); u: (H, K);
    s0: (B, H, K, V) -> (out (B, H, T, V), sT (B, H, K, V)).

    On the card r, k, v and lw are read in place through their strides
    (the time-mix passes (B, T, H, K) tensors transposed), and ``out`` is
    a (B, H, T, V) view of a (B, T, H, V) tensor, the layout the time-mix
    reads next.  The checks are kept cheap: at the decode shape the call
    is host time."""
    _check(r, k, v, lw, u, s0)
    dev = r.device
    if dev.type == "cpu":
        return rwkv6_scan_plain(r, k, v, lw, u, s0)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    code = _DTYPE_CODES.get(r.dtype)
    if code is None:
        raise TypeError(f"rwkv6_scan kernel takes float32 or bfloat16 r, k, "
                        f"v, got {r.dtype}")
    f32 = torch.float32
    if k.dtype != r.dtype or v.dtype != r.dtype \
            or lw.dtype != f32 or u.dtype != f32 or s0.dtype != f32 \
            or not (dev == k.device == v.device == lw.device == u.device
                    == s0.device):
        raise ValueError(
            f"rwkv6_scan kernel takes r, k, v of one type (float32 or "
            f"bfloat16) and float32 lw, u, s0, all on one device; got "
            f"{[(t.dtype, str(t.device)) for t in (r, k, v, lw, u, s0)]}")
    if not (u.is_contiguous() and s0.is_contiguous()):
        raise ValueError("rwkv6_scan kernel needs contiguous u and s0")
    B, H, T, K = r.shape
    V = v.shape[3]
    if K not in KEY_DIMS:
        raise ValueError(f"rwkv6_scan kernel takes K in {KEY_DIMS}, got {K}")
    if H > 65535 or B > 65535:
        raise ValueError(f"rwkv6_scan kernel takes at most 65535 heads and "
                         f"batch rows, got H={H}, B={B}")
    out = torch.empty_strided((B, H, T, V), (T * H * V, V, H * V, 1),
                              dtype=r.dtype, device=dev)
    sT = torch.empty((B, H, K, V), dtype=f32, device=dev)
    if V == 0:
        return out, sT
    args = _Args(r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
                 u.data_ptr(), s0.data_ptr(), out.data_ptr(), sT.data_ptr(),
                 B, H, T, K, V, code, *scan_strides(r), *scan_strides(k),
                 *scan_strides(lw), *scan_strides(v), T * H * V, V, H * V)
    rc = (_LIB or _load()).rwkv6_scan_launch(
        args,
        # the current stream's handle, as torch.cuda.current_stream(dev)
        # .cuda_stream gives it, without building a Stream object
        torch._C._cuda_getCurrentRawStream(dev.index))
    if rc == _INVALID_VALUE:
        raise ValueError("rwkv6_scan kernel needs 16-byte aligned rows of "
                         "r, k, v and lw (start and strides) and at most "
                         "65535 heads and batch rows")
    if rc:
        build.check(rc, "rwkv6_scan_launch")
    build.LAUNCHES["rwkv6_scan_bhtk"] += 1
    return out, sT


_Args = ctypes.c_longlong * 29          # see rwkv6_scan_launch
_INVALID_VALUE = 1                      # cudaErrorInvalidValue
_LIB = None


def _load():
    """The scan's library, looked up once (``build.library`` caches it
    too; this skips the call on the decode path)."""
    global _LIB
    _LIB = build.library("rwkv6_scan")
    return _LIB
