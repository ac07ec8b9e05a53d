"""Blocked online-softmax (flash) attention: the CUDA kernel and its plain
version.

``flash_attention_bhsd`` takes q (B, H, Sq, hd) and k, v (B, KV, Sk, hd)
(query head h reads kv head ``h // (H // KV)``), with ``causal`` and
``sliding_window`` masks, in float32 or bfloat16.  On a CUDA tensor it
launches ``csrc/flash_attention.cu``, whose bodies take hd 32, 64, 128
and 256 (``HEAD_DIMS``) and any Sq and Sk (the kernel masks the ragged
edge itself); hd 256 runs Hopper bodies of its own, bf16's and float32's
(warpgroup MMA on TMA-fed tiles, whose tensor maps the driver may
refuse: that raises too; float32's first splits k and v into TF32
planes, in a workspace the wrapper allocates).  ``wgmma_probe`` and
``f32_wgmma_probe`` run each body's two products on one tile, for a card
test.  Above 256, bf16 up to ``WIDE_MAX_HD`` runs a wgmma body of its
own (``flash_attention_kernel_wide_wgmma``: a block owns 64 query rows and
all of hd, two warpgroups each computing half of the scores and all of
their half of o, through TMA maps with the true hd's extent); float32 and
wider bf16 head dims run the slab body (``flash_attention_slab``: a block
owns 128 columns of o and computes the scores over the whole hd in chunks
of 64, on mma.sync in either type).  ``kernel_for`` names the body.
Every other hd runs through the kernel too, as the Pallas kernel runs any
hd: q, k and v are zero-padded along hd up to the body's
(``body_head_dim``: the next of ``HEAD_DIMS`` up to 256, the next multiple
of 8 above: TMA's rows and the slab body's copies move 16-byte units), which
runs with the true hd's scale, and the output is sliced back.  Zero columns add nothing to a score and leave the kept
columns as they are, so this is the same function; the pad costs a copy
of q, k and v and the slice one of o.  No head dim is refused.  On a CPU
or ``meta`` tensor it runs ``flash_attention_plain``,
the full-softmax ``ref.flash_attention_ref``; any other device raises.
The JAX package's kernel has no gradient, and neither has this one:
inputs that require grad raise.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (32, 64, 128, 256)      # the kernel's bodies up to 256
SLAB_ALIGN = 8          # head dims above 256: multiples of 8 (16-byte rows)
WIDE_MAX_HD = 512       # bf16's wide wgmma body: head dims 257 to this
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
    """The head dim the kernel runs for ``hd``: the least of ``HEAD_DIMS``
    at or above it, or above 256 the next multiple of ``SLAB_ALIGN`` (the
    slab body's; 16-byte rows in either type).  The rest is zero
    padding."""
    for body in HEAD_DIMS:
        if hd <= body:
            return body
    return -(-hd // SLAB_ALIGN) * SLAB_ALIGN


def kernel_for(hd: int, dtype: torch.dtype) -> str:
    """The name of the kernel function ``flash_attention_bhsd`` runs on the
    card for head dim ``hd`` in ``dtype``."""
    body = body_head_dim(hd)
    if body < 256:
        return "flash_attention_kernel"
    bf = dtype == torch.bfloat16
    if body == 256:
        return "flash_attention_kernel_hd256_" + ("wgmma" if bf else "tf32")
    if bf and body <= WIDE_MAX_HD:
        return "flash_attention_kernel_wide_wgmma"
    return "flash_attention_slab"


# the bodies in the order flash_attention_body_launches counts them
KERNELS = ("flash_attention_kernel", "flash_attention_kernel_hd256_wgmma",
           "flash_attention_kernel_hd256_tf32",
           "flash_attention_kernel_wide_wgmma", "flash_attention_slab")


def body_launches() -> dict:
    """Launches of each body (by ``KERNELS`` name) since the card's library
    was loaded, as its launcher counts them: which body ran."""
    import ctypes
    out = (ctypes.c_int * len(KERNELS))()
    build.library("flash_attention").flash_attention_body_launches(out)
    return dict(zip(KERNELS, out))


def wide_info(hd: int) -> dict:
    """The bf16 wide body's launch shape and resources at head dim ``hd``
    (257 to ``WIDE_MAX_HD``), on the card: shared memory, threads, the
    registers a consumer and a producer thread get, registers at entry,
    local memory a thread, blocks an SM, the ring's stages."""
    import ctypes
    out = (ctypes.c_int * 8)()
    build.check(build.library("flash_attention").flash_attention_wide_info(
        body_head_dim(hd), out), "flash_attention_wide_info")
    return dict(zip(("smem_bytes", "threads", "consumer_registers",
                     "producer_registers", "registers", "local_bytes",
                     "blocks_per_sm", "stages"), out))


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
    ws = (_workspace(lib, B * KV, Sk, q.device)
          if body == 256 and q.dtype == torch.float32 else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), B, H, KV,
        Sq, Sk, body, _DTYPE_CODES[q.dtype], int(causal),
        0 if sliding_window is None else int(sliding_window),
        1.0 / math.sqrt(hd), stream)
    build.check(rc, "flash_attention_launch")
    build.LAUNCHES["flash_attention_bhsd"] += 1
    return out if body == hd else out[..., :hd].contiguous()


def _workspace(lib, heads: int, Sk: int, device) -> torch.Tensor:
    """float32 hd 256's workspace: the TF32 planes of k and v^T."""
    return torch.empty(lib.flash_attention_workspace_floats(heads, Sk),
                       dtype=torch.float32, device=device)


def _probe_operands(what: str, dtype: torch.dtype, tensors: dict) -> None:
    """Raise unless each of ``tensors`` ({name: (t, shape)}) is a
    contiguous, 16-byte aligned CUDA tensor of ``dtype`` and that shape,
    all on one card."""
    dev = next(iter(tensors.values()))[0].device
    for name, (t, shape) in tensors.items():
        if t.device.type != "cuda" or t.device != dev or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be a contiguous, 16-byte "
                             f"aligned {shape} {dtype} CUDA tensor on one "
                             f"card, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")


def f32_wgmma_probe(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The float32 hd 256 body's two 3xTF32 products on one tile, on the
    card: a (64, 256), b and c (32, 256) float32 -> (a b^T, (a b^T) c),
    (64, 32) and (64, 256), through the body's split pass, tensor maps,
    shared-memory descriptors and wgmma operand layouts (the second
    product's A is the first's result, split as the body splits p).  It
    counts no launch: it is no part of any path."""
    _probe_operands("f32_wgmma_probe", torch.float32,
                    {"a": (a, (64, 256)), "b": (b, (32, 256)),
                     "c": (c, (32, 256))})
    lib = build.library("flash_attention")
    d = torch.empty(64, 32, dtype=torch.float32, device=a.device)
    e = torch.empty(64, 256, dtype=torch.float32, device=a.device)
    ws = _workspace(lib, 1, 32, a.device)
    rc = lib.flash_attention_f32_wgmma_probe(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(), e.data_ptr(),
        ws.data_ptr(), torch.cuda.current_stream(a.device).cuda_stream)
    build.check(rc, "flash_attention_f32_wgmma_probe")
    return d, e


def wgmma_probe(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16 hd 256 body's two products on one tile, on the card: a, b,
    c (64, 256) bf16 -> (a b^T, bf16(a b^T) c) in float32, (64, 64) and
    (64, 256), through the body's tensor maps, shared-memory descriptors
    and wgmma operand layouts.  It counts no launch: it is no part of
    any path."""
    _probe_operands("wgmma_probe", torch.bfloat16,
                    {n: (t, (64, 256)) for n, t in zip("abc", (a, b, c))})
    lib = build.library("flash_attention")
    d = torch.empty(64, 64, dtype=torch.float32, device=a.device)
    e = torch.empty(64, 256, dtype=torch.float32, device=a.device)
    rc = lib.flash_attention_wgmma_probe(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(), e.data_ptr(),
        torch.cuda.current_stream(a.device).cuda_stream)
    build.check(rc, "flash_attention_wgmma_probe")
    return d, e
