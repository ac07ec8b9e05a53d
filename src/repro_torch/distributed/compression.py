"""Gradient compression for data-parallel all-reduce.

The JAX package's ``distributed/compression.py`` over nested dicts of
tensors.  Error-feedback int8 quantisation (1-bit-Adam family): each
worker quantises its local gradient to int8 with a per-tensor scale,
keeps the quantisation residual, and adds it back into the next step's
gradient, so the sum of what is sent follows the sum of the gradients;
int8 is a quarter of float32's all-reduce traffic (half of bf16's).

``allreduce_compressed`` runs ``torch.distributed.all_reduce`` over a
process group (gloo on the CPU, NCCL on the card) where the reference
runs ``psum`` inside ``shard_map``: the payloads summed as int32
(exact), the scales as float32, two all-reduces per leaf.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.optim.optimizers import tree_map


def init_error_state(params: Any) -> Any:
    """Zero float32 residuals, one per leaf, on each leaf's device."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _compress_one(g: torch.Tensor, e: torch.Tensor):
    gf = g.float() + e
    scale = torch.clamp(gf.abs().amax(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale, gf - q.float() * scale


def compress(grads: Any, err: Any) -> Tuple[Any, Any, Any]:
    """Returns (int8 payloads, float32 scales, new residuals), each in the
    tree of ``grads``: scale = max(max|g + e|, 1e-12) / 127, payload =
    round((g + e) / scale) clipped to +-127 (round half to even, as
    ``jnp.round``), residual = g + e - payload * scale."""
    parts = tree_map(_compress_one, grads, err)
    return tuple(tree_map(lambda t, i=i: t[i], parts) for i in range(3))


def decompress(q: Any, scales: Any) -> Any:
    return tree_map(lambda qq, s: qq.float() * s, q, scales)


def allreduce_compressed(grads: Any, err: Any,
                         group: Optional[dist.ProcessGroup] = None
                         ) -> Tuple[Any, Any]:
    """Error-feedback int8 all-reduce mean over ``group`` (the default
    group when None).  Returns (the mean gradient tree, float32; the new
    residuals).  As in the reference, the summed payloads are scaled by
    the mean of the workers' scales: the mean of the dequantised
    gradients where the scales agree."""
    q, scales, new_err = compress(grads, err)
    n = dist.get_world_size(group)

    def reduce_one(qq, s):
        # a gradient may be a strided view; NCCL takes contiguous tensors
        acc = qq.to(torch.int32, memory_format=torch.contiguous_format)
        dist.all_reduce(acc, group=group)
        s_sum = s.reshape(1).clone()
        dist.all_reduce(s_sum, group=group)
        return acc.float() * (s_sum[0] / n) / n

    return tree_map(reduce_one, q, scales), new_err
