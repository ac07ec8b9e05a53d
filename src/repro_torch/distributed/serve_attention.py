"""Sequence-sharded decode attention — the serving path of a mesh (the
JAX package's ``distributed/serve_attention.py``).

The KV cache is sharded along *sequence* over the mesh's ``seq_axis``:
each rank owns a contiguous S_local = S/n slice of it.  One decode step
then needs no gather of the cache:

- the new token's k / v row is written shard-locally: only the rank
  whose range holds ``idx`` commits it, and it writes one row, in place
  (``write_rows``; JAX selects over the whole local cache, which here
  would be gigabytes per layer);
- each rank computes partial attention (m, l, acc) over its slice in
  float32, masked ``pos <= idx``;
- ranks combine with the online-softmax reduction over the seq axis's
  process group: ``all_reduce(MAX)`` of m, then ``all_reduce(SUM)`` of l
  and acc, in float32 — O(B x H x hd) on the wire per layer.

A rank whose slice lies wholly past ``idx`` contributes exp(NEG_INF -
max) = 0; NEG_INF is -0.7 x float32's max so that nothing overflows.

Tensors are DTensors placed by the plan (the cache batch over the batch
axes and seq over ``seq_axis``); the body runs on their ``to_local()``
chunks, and the cache is written in place there.  The products
are plain float32 torch products, as in JAX, where they run outside any
Pallas kernel: the decode-attention kernel does not return its (m, l),
so the ranks cannot combine its outputs (ROADMAP).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.distributed as dist

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def write_rows(bufs, news, rel) -> None:
    """Write rows ``rel .. rel + S - 1`` of this rank's slices ``bufs``
    (B, S_local, ...) from ``news`` (B, S, ...), in place, keeping only
    the rows that fall inside the slice.  ``rel`` (a device scalar) is
    the global start minus the slice's first row and may lie outside
    it; nothing waits for the card.  The write covers a window of
    min(S, S_local) distinct rows placed to hold every row the slice
    owns; rows of the window that are not written keep their values."""
    S, s_local, dev = news[0].shape[1], bufs[0].shape[1], bufs[0].device
    w = min(S, s_local)
    rel = torch.as_tensor(rel, device=dev).reshape(()).long()
    rows = torch.clamp(rel, 0, s_local - w) + torch.arange(w, device=dev)
    src = rows - rel
    ok = (src >= 0) & (src < S)
    src = torch.clamp(src, 0, S - 1)
    shape = (1, w) + (1,) * (bufs[0].dim() - 2)
    for buf, new in zip(bufs, news):
        val = torch.where(ok.reshape(shape),
                          new.index_select(1, src).to(buf.dtype),
                          buf.index_select(1, rows))
        buf.index_copy_(1, rows, val)


def _batch_placements(cache, mesh, seq_axis: str):
    """Placements of q / the output: the cache's batch split, replicated
    over every other mesh axis.  Raises unless the cache is split on
    seq over ``seq_axis`` (its layout under the plan's default rules;
    an axis of one rank splits nothing): anything else would need the
    cache copied."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(cache, DTensor):
        raise TypeError("the decode shard reads the plan's DTensor cache "
                        "(ShardPlan.place_inputs); got a plain tensor")
    seq = list(mesh.mesh_dim_names).index(seq_axis)
    pl = cache.placements
    if cache.device_mesh != mesh or (mesh.size(seq) > 1 and
                                     pl[seq] != Shard(1)):
        raise ValueError(f"the cache must be split on sequence over "
                         f"{seq_axis!r} on the decode shard's mesh; it is "
                         f"placed {pl}")
    return tuple(Shard(0) if p == Shard(0) else Replicate() for p in pl)


def sharded_decode_attention(
    q: torch.Tensor,          # (B, 1, H, hd)
    k_new: torch.Tensor,      # (B, 1, KV, hd)
    v_new: torch.Tensor,
    cache_k: torch.Tensor,    # (B, S, KV, hd)  seq sharded over `seq_axis`
    cache_v: torch.Tensor,
    idx: torch.Tensor,        # () int32 — current cache length
    *,
    mesh,
    seq_axis: str = "model",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (attn_out (B, 1, H, hd), cache_k, cache_v), the caches
    written in place.  The batch split is the cache's placement."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.sharding import local_offset
    bpl = _batch_placements(cache_k, mesh, seq_axis)
    base = local_offset(cache_k, 1)
    ql, kl, vl = (t.redistribute(mesh, bpl).to_local()
                  for t in (q, k_new, v_new))
    kc, vc = cache_k.to_local(), cache_v.to_local()
    idx_l = idx.to_local() if isinstance(idx, DTensor) else idx
    group = mesh.get_group(seq_axis)
    B, _, H, hd = ql.shape
    s_local, KV = kc.shape[1], kc.shape[2]
    G = H // KV
    dev = kc.device

    # owner-only write of the new row, at the clamped local slot
    write_rows((kc, vc), (kl, vl), idx_l - base)

    qg = ql.reshape(B, 1, KV, G, hd).float()
    s = torch.einsum("bqngd,bsnd->bnqgs", qg,
                     kc.float()) * (1.0 / math.sqrt(hd))   # (B,KV,1,G,Sl)
    pos = base + torch.arange(s_local, device=dev)
    valid = pos <= idx_l                          # causal: <= the new token
    s = torch.where(valid[None, None, None, None, :], s,
                    torch.full((), NEG_INF, device=dev))
    # collectives take contiguous payloads (NCCL; gloo on CUDA tensors)
    m = s.amax(-1).contiguous()                   # (B, KV, 1, G)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    p = torch.exp(s - m[..., None])
    del s
    l = p.sum(-1).contiguous()
    dist.all_reduce(l, op=dist.ReduceOp.SUM, group=group)
    acc = torch.einsum("bnqgs,bsnd->bnqgd", p.to(vc.dtype).float(),
                       vc.float()).contiguous()
    dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
    out = (acc / torch.clamp(l, min=1e-30)[..., None])   # (B,KV,1,G,hd)
    out = out.reshape(B, 1, H, hd).to(ql.dtype)
    return (DTensor.from_local(out, mesh, bpl, run_check=False), cache_k,
            cache_v)
