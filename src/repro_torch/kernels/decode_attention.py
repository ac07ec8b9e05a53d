"""Single-token KV-cache attention: the CUDA kernel and its plain version.

``decode_attention_bkgd`` takes q (B, KV, G, hd), the G query heads of
each kv head, and k, v (B, KV, S, hd), with ``kv_len`` an int or a
one-element integer tensor in 1..S; keys at ``kv_len`` or later are
masked.  On a CUDA tensor it launches ``csrc/decode_attention.cu`` (hd 64
or 128, G up to 16, float32 or bfloat16, any S: the kernel masks the
ragged edge itself); on a CPU tensor it runs ``decode_attention_plain``,
the full-softmax ``ref.decode_attention_ref``; any other device raises.
A ``kv_len`` tensor stays on the device: the kernel reads it there, so a
call never waits for the card.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (64, 128)
MAX_GROUP = 16
TILE = 64                 # keys per tile of the kernel (kTile in the source)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_len) -> torch.Tensor:
    """(B, KV, G, hd), (B, KV, S, hd) -> (B, KV, G, hd), full softmax."""
    B, KV, G, hd = q.shape
    out = ref.decode_attention_ref(q.reshape(B, KV * G, hd),
                                   k.transpose(1, 2), v.transpose(1, 2),
                                   kv_len)
    return out.reshape(B, KV, G, hd)


def splits(B: int, KV: int, S: int, n_sm: int):
    """(span, nsplit): the cache cut into ``nsplit`` spans of ``span`` keys
    (a multiple of TILE), enough blocks for eight per SM at small
    batches, never more splits than tiles."""
    tiles = -(-S // TILE)
    want = -(-8 * n_sm // max(B * KV, 1))
    nsplit = max(1, min(tiles, want))
    span = -(-tiles // nsplit) * TILE
    return span, -(-S // span)


def decode_attention_bkgd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len) -> torch.Tensor:
    """q: (B, KV, G, hd); k, v: (B, KV, S, hd); kv_len -> (B, KV, G, hd)."""
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
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode_attention kernel needs contiguous inputs")
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
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    span, nsplit = splits(B, KV, S, n_sm)
    part = (torch.empty((B, KV, nsplit, G * (hd + 2)), dtype=torch.float32,
                        device=q.device) if nsplit > 1 else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
        out.data_ptr(), 0 if part is None else part.data_ptr(), B, KV, G, S,
        hd, _DTYPE_CODES[q.dtype], span, nsplit, 1.0 / math.sqrt(hd), stream)
    build.check(rc, "decode_attention_launch")
    build.LAUNCHES["decode_attention_bkgd"] += 1
    return out
