"""Single-token KV-cache attention: the CUDA kernel and its plain version.

``decode_attention_bkgd`` takes q (B, KV, G, hd), the G query heads of
each kv head, and k, v (B, KV, S, hd), with ``kv_len`` an int or a
one-element integer tensor in 1..S; keys at ``kv_len`` or later are
masked.  On a CUDA tensor it launches ``csrc/decode_attention.cu`` (hd 64
or 128, G up to 16, float32 or bfloat16, any S: the kernel masks the
ragged edge itself); on a CPU tensor it runs ``decode_attention_plain``,
the full-softmax ``ref.decode_attention_ref``; any other device raises.
k and v are read in place through their strides, so a transposed view of
the model's (B, S, KV, hd) cache launches without a copy.  A ``kv_len``
tensor stays on the device: the kernel reads it there and cuts the valid
keys into splits itself, so a call never waits for the card.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (64, 128)
MAX_GROUP = 16
TILE = 64                 # keys per tile of the kernel (kTile in the source)
MAX_SPLITS = 64
WAVE_FILL = 0.9           # least share of the last wave's slots in use
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SLOTS: Dict[tuple, Tuple[int, int]] = {}


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_len) -> torch.Tensor:
    """(B, KV, G, hd), (B, KV, S, hd) -> (B, KV, G, hd), full softmax."""
    B, KV, G, hd = q.shape
    out = ref.decode_attention_ref(q.reshape(B, KV * G, hd),
                                   k.transpose(1, 2), v.transpose(1, 2),
                                   kv_len)
    return out.reshape(B, KV, G, hd)


@functools.lru_cache(maxsize=256)
def split_count(B: int, KV: int, S: int, n_sm: int, per_sm: int) -> int:
    """How many splits each (b, kv head) gets: the fewest whose grid of
    B KV nsplit blocks fills its last wave of ``n_sm * per_sm`` resident
    blocks to ``WAVE_FILL``, else the best-filled, never more splits than
    tiles of S or ``MAX_SPLITS``.  The kernel cuts the valid keys, not S,
    into that many spans (``split_span``)."""
    slots = max(n_sm * per_sm, 1)
    cap = max(1, min(-(-S // TILE), MAX_SPLITS))
    best, best_fill = 1, 0.0
    for n in range(1, cap + 1):
        blocks = B * KV * n
        fill = blocks / (-(-blocks // slots) * slots)
        if fill >= WAVE_FILL:
            return n
        if fill > best_fill:
            best, best_fill = n, fill
    return best


def split_span(kv_len: int, nsplit: int, split: int) -> Tuple[int, int]:
    """Keys [lo, hi) of one split, as the kernel derives them from kv_len
    on the device: ceil(tiles / nsplit) whole tiles per split, the last
    live split ragged and any after it empty."""
    per = -(-(-(-kv_len // TILE)) // nsplit)
    lo = min(split * per * TILE, kv_len)
    return lo, min(lo + per * TILE, kv_len)


def cache_strides(t: torch.Tensor) -> Tuple[int, int, int]:
    """The (batch, kv head, key) element strides through which the kernel
    reads a (B, KV, S, hd) k or v in place (0 for a dimension of size 1).
    It needs the last dimension contiguous and 16-byte aligned rows."""
    align = 16 // t.element_size()
    strides = tuple(s if n > 1 else 0 for s, n in zip(t.stride()[:3],
                                                      t.shape[:3]))
    if t.stride(3) != 1 or t.data_ptr() % 16 or any(s % align
                                                     for s in strides):
        raise ValueError(f"decode_attention kernel reads k and v in place "
                         f"and needs a contiguous last dimension and "
                         f"16-byte aligned rows; got strides {t.stride()}")
    return strides


def _slots(device: torch.device, hd: int, dtype: int, G: int, lib
           ) -> Tuple[int, int]:
    """(SMs, resident blocks per SM) of the kernel that (hd, dtype, G)
    launches, read once per device and kernel."""
    key = (device.index, hd, dtype, 4 if G <= 4 else 8 if G <= 8 else 16)
    got = _SLOTS.get(key)
    if got is None:
        per_sm = ctypes.c_int(0)
        build.check(lib.decode_attention_blocks_per_sm(
            hd, dtype, G, ctypes.byref(per_sm)), "decode_attention occupancy")
        got = _SLOTS[key] = (torch.cuda.get_device_properties(
            device).multi_processor_count, max(per_sm.value, 1))
    return got


def decode_attention_bkgd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len) -> torch.Tensor:
    """q: (B, KV, G, hd); k, v: (B, KV, S, hd), any strides with a
    contiguous last dimension; kv_len -> (B, KV, G, hd)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3] \
            or k.shape[2] < 1:
        raise ValueError(f"decode_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} do not match "
                         f"(B, KV, G, hd), (B, KV, S, hd)")
    S = k.shape[2]
    if not isinstance(kv_len, torch.Tensor) and not 1 <= int(kv_len) <= S:
        raise ValueError(f"decode_attention: kv_len {kv_len} not in 1..{S}")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"decode_attention: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"decode_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    B, KV, G, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {hd}")
    if not 1 <= G <= MAX_GROUP or KV > 65535 or B > 65535:
        raise ValueError(f"decode_attention kernel takes 1..{MAX_GROUP} query "
                         f"heads per kv head and at most 65535 kv heads and "
                         f"batch rows, got G={G}, KV={KV}, B={B}")
    if not q.is_contiguous():
        raise ValueError("decode_attention kernel needs a contiguous q")
    ks, vs = cache_strides(k), cache_strides(v)
    if isinstance(kv_len, torch.Tensor):
        if kv_len.numel() != 1 or kv_len.dtype.is_floating_point:
            raise ValueError(f"decode_attention: kv_len must be one integer, "
                             f"got {kv_len.dtype} of shape "
                             f"{tuple(kv_len.shape)}")
        length = kv_len.reshape(1).to(device=q.device, dtype=torch.int32)
    else:
        length = torch.full((1,), int(kv_len), dtype=torch.int32,
                            device=q.device)
    lib = build.library("decode_attention")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    code = _DTYPE_CODES[q.dtype]
    nsplit = split_count(B, KV, S, *_slots(q.device, hd, code, G, lib))
    part = (torch.empty((B, KV, nsplit, G * (hd + 2)), dtype=torch.float32,
                        device=q.device) if nsplit > 1 else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
        out.data_ptr(), 0 if part is None else part.data_ptr(), B, KV, G, S,
        hd, code, nsplit, 1.0 / math.sqrt(hd), *ks, *vs, stream)
    build.check(rc, "decode_attention_launch")
    build.LAUNCHES["decode_attention_bkgd"] += 1
    return out
