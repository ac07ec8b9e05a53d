"""Single-token KV-cache attention: the CUDA kernel and its plain version.

``decode_attention_bkgd`` takes q (B, KV, G, hd), the G query heads of
each kv head, and k, v (B, KV, S, hd), with ``kv_len`` an int or a
one-element integer tensor in 1..S; keys at ``kv_len`` or later are
masked.  On a CUDA tensor it launches ``csrc/decode_attention.cu`` at any
hd >= 1, any G >= 1, any S (the kernel masks the ragged edge itself), in
float32 or bfloat16; on a CPU or ``meta`` tensor it runs
``decode_attention_plain``, the full-softmax ``ref.decode_attention_ref``;
any other device raises.  ``body_for`` says which body runs a shape: an
hd up to 256 the least of the 64, 128 and 256 wide bodies at or above it
(the columns past hd zero in shared memory, never in device memory), in
chunks of 16 query heads (bf16 at widths 64 and 128 beyond 16 heads: the
rows body, 16 heads a warp and up to 128 a block, each cache row read
once a block); an hd above 256, or a cache whose rows are not 16-byte
aligned, the slab body (128 columns of the output a block, the scores
over the whole hd).
k and v are read in place through their strides, so a transposed view of
the model's (B, S, KV, hd) cache launches without a copy.  A ``kv_len``
tensor stays on the device: the kernel reads it there and cuts the valid
keys into splits itself, so a call never waits for the card.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (64, 128, 256)  # the widths of the bodies that take hd <= 256
GROUP_CHUNK = 16          # query heads a block (the mma A operand's rows)
SLAB = 128                # output columns a block of the slab body
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


class Body(NamedTuple):
    """The body that runs a shape: ``width`` 64, 128 or 256 (its columns;
    the hd past the true one is zero in shared memory), or 0 for the slab
    body; ``rows`` query heads a block (``GROUP_CHUNK``, or the rows
    body's 32, 64 or 128) in ``chunks`` blocks a kv head; ``slabs`` blocks
    of ``SLAB`` output columns (the slab body's, else 1)."""
    width: int
    chunks: int
    slabs: int
    rows: int = GROUP_CHUNK

    @property
    def name(self) -> str:
        if self.width == 0:
            return "slab"
        return f"w{self.width}" + ("_rows" if self.rows > GROUP_CHUNK
                                   else "")


def body_for(hd: int, dtype: torch.dtype, G: int, aligned: bool = True
             ) -> Body:
    """The body of the CUDA kernel that runs head dim ``hd`` in ``dtype``
    at ``G`` query heads a kv head: the least of ``HEAD_DIMS`` at or above
    hd where the cache's rows are 16-byte ``aligned`` (start and strides),
    else the slab body, which also takes every hd above 256.  bf16 at
    widths 64 and 128 beyond 16 heads runs the rows body: a warp a 16
    heads, the least of 32, 64 and 128 heads a block that holds G (128
    and more blocks beyond)."""
    if hd < 1 or G < 1:
        raise ValueError(f"decode_attention: hd {hd} and G {G} must be >= 1")
    if aligned:
        for width in HEAD_DIMS:
            if hd <= width:
                rows = GROUP_CHUNK
                if dtype == torch.bfloat16 and width < 256 \
                        and G > GROUP_CHUNK:
                    rows = 32 if G <= 32 else 64 if G <= 64 else 128
                return Body(width, -(-G // rows), 1, rows)
    return Body(0, -(-G // GROUP_CHUNK), -(-hd // SLAB))


def split_span(kv_len: int, nsplit: int, split: int) -> Tuple[int, int]:
    """Keys [lo, hi) of one split, as the kernel derives them from kv_len
    on the device: ceil(tiles / nsplit) whole tiles per split, the last
    live split ragged and any after it empty."""
    per = -(-(-(-kv_len // TILE)) // nsplit)
    lo = min(split * per * TILE, kv_len)
    return lo, min(lo + per * TILE, kv_len)


def scratch_floats(B: int, KV: int, G: int, hd: int, nsplit: int,
                   rows: int = GROUP_CHUNK) -> int:
    """float32 scratch of a call of ``nsplit`` splits whose body takes
    ``rows`` query heads a block: each (b, kv head, chunk of query heads,
    split)'s (acc, m, l) at a pitch of min(G, rows) rows, B KV ceil(G /
    rows) nsplit min(G, rows) (hd + 2); none for one split."""
    if nsplit == 1:
        return 0
    return B * KV * -(-G // rows) * nsplit * min(G, rows) * (hd + 2)


def cache_strides(t: torch.Tensor) -> Tuple[int, int, int]:
    """The (batch, kv head, key) element strides through which the kernel
    reads a (B, KV, S, hd) k or v in place (0 for a dimension of size 1).
    It needs the last dimension contiguous."""
    if t.stride(3) != 1 and t.shape[3] > 1:
        raise ValueError(f"decode_attention kernel reads k and v in place "
                         f"and needs a contiguous last dimension; got "
                         f"strides {t.stride()}")
    return tuple(s if n > 1 else 0 for s, n in zip(t.stride()[:3],
                                                   t.shape[:3]))


def rows_aligned(t: torch.Tensor, strides: Tuple[int, int, int]) -> bool:
    """Whether every row of ``t`` starts on a 16-byte boundary (its start
    and its ``cache_strides``), as 16-byte copies and tensor maps need."""
    align = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and not any(s % align for s in strides)


def _slots(device: torch.device, width: int, dtype: int, G: int, lib
           ) -> Tuple[int, int]:
    """(SMs, resident blocks per SM) of the body of ``width`` (0: the slab
    body) that (dtype, G) launches, read once per device and body."""
    key = (device.index, width, dtype,
           next(n for n in (4, 8, 16, 32, 64, 128, 1 << 16) if G <= n))
    got = _SLOTS.get(key)
    if got is None:
        per_sm = ctypes.c_int(0)
        build.check(lib.decode_attention_blocks_per_sm(
            width, dtype, G, ctypes.byref(per_sm)),
            "decode_attention occupancy")
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
    if q.device.type in build.PLAIN_DEVICES:
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
    if KV > 65535 or B > 65535 or G > 65535:
        raise ValueError(f"decode_attention kernel takes at most 65535 query "
                         f"heads per kv head, kv heads and batch rows, got "
                         f"G={G}, KV={KV}, B={B}")
    if not q.is_contiguous():
        raise ValueError("decode_attention kernel needs a contiguous q")
    ks, vs = cache_strides(k), cache_strides(v)
    body = body_for(hd, q.dtype, G,
                    rows_aligned(k, ks) and rows_aligned(v, vs))
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
    nsplit = split_count(B, KV * body.chunks * body.slabs, S,
                         *_slots(q.device, body.width, code, G, lib))
    floats = scratch_floats(B, KV, G, hd, nsplit, body.rows)
    part = (torch.empty(floats, dtype=torch.float32, device=q.device)
            if floats else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
        out.data_ptr(), 0 if part is None else part.data_ptr(), B, KV, G, S,
        hd, body.width, code, nsplit, body.chunks, body.slabs,
        1.0 / math.sqrt(hd), *ks, *vs, stream)
    build.check(rc, "decode_attention_launch")
    build.LAUNCHES["decode_attention_bkgd"] += 1
    return out


def hd256_body_info(dtype: str = "bfloat16", group: int = 8
                    ) -> Dict[str, int]:
    """An hd 256 ring body's launch shape and resources as the CUDA
    runtime reads them from the built library: dynamic shared memory,
    threads, consumer warps, ring stages, registers and local bytes a
    thread, blocks an SM.  ``dtype`` "bfloat16" (the mma.sync body) or
    "float32" (the fp32 FMA body, at the rows, 4, 8 or 16, that ``group``
    query heads a kv head pad to)."""
    code = _DTYPE_CODES[getattr(torch, dtype)]
    info = (ctypes.c_int * 7)()
    build.check(build.library("decode_attention").decode_attention_hd256_info(
        code, group, info), "decode_attention_hd256_info")
    return dict(zip(("smem_bytes", "threads", "consumer_warps", "stages",
                     "regs", "local_bytes", "blocks_per_sm"), info))
