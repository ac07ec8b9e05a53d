"""Token losses of the model zoo, in float32 (the JAX package's
``train/losses.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.distributed import ctx


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean token cross-entropy.  logits (B, S, V), labels (B, S) int;
    ``mask`` defaults to ``labels >= 0``.  As ``jnp.take_along_axis``
    reads labels, a negative one is ``label + V`` and one still outside
    the vocabulary picks NaN, which the mask does not remove.  Returns
    (loss, n_tokens)."""
    lf = logits.float()
    V = lf.shape[-1]
    idx = labels.long()
    idx = torch.where(idx < 0, idx + V, idx)
    if _vocab_split(lf):
        # DTensor has no rule for a gather along a split dimension: the
        # label's logit summed out of a mask built on each rank's slice
        lse = _logsumexp(lf)
        hit = _vocab_iota(lf) == idx[..., None]
        ll = _whole_vocab(torch.where(hit, lf, 0.0).sum(-1), lf)
    else:
        # under a sharding plan, each rank's tokens by the batch rule
        lf = ctx.constrain(lf, "logits")
        lse = torch.logsumexp(lf, dim=-1)
        ll = torch.gather(lf, -1, idx.clamp(0, V - 1)[..., None])[..., 0]
    ll = torch.where((idx >= 0) & (idx < V), ll, float("nan"))
    nll = lse - ll
    if mask is None:
        mask = labels >= 0
    mask = mask.float()
    n = torch.clamp(mask.sum(), min=1.0)
    return (nll * mask).sum() / n, n


def _vocab_split(lf) -> bool:
    """Whether ``lf`` is a DTensor split along its last dimension."""
    if not ctx.is_dtensor(lf):
        return False
    from torch.distributed.tensor import Shard
    return any(isinstance(p, Shard) and p.dim == lf.ndim - 1
               for p in lf.placements)


def _logsumexp(lf: torch.Tensor) -> torch.Tensor:
    """logsumexp over the last dimension.  Over a split vocabulary it is
    written out: DTensor gathers the vocabulary for ``torch.logsumexp``,
    while its max and sum over a split dimension are partial results
    that one all-reduce each completes."""
    if not _vocab_split(lf):
        return torch.logsumexp(lf, dim=-1)
    m = _whole_vocab(lf.detach().amax(-1, keepdim=True), lf)
    s = _whole_vocab(torch.exp(lf - m).sum(-1, keepdim=True), lf)
    return (m + torch.log(s))[..., 0]


def _whole_vocab(r, lf):
    """``r``, a reduction of DTensor ``lf`` over its last dimension, laid
    out as ``lf`` with that dimension's split replicated: the partial
    results all-reduced, so that the ops that combine ``r`` with ``lf``
    leave ``lf`` where it lies (DTensor would otherwise move the
    vocabulary to split the batch as ``r``)."""
    from torch.distributed.tensor import Replicate, Shard
    last = lf.ndim - 1
    return r.redistribute(lf.device_mesh, tuple(
        Replicate() if not isinstance(p, Shard) or p.dim == last else p
        for p in lf.placements))


def _vocab_iota(lf) -> torch.Tensor:
    """0 .. V - 1 as a DTensor laid out as ``lf``'s last dimension."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    last = lf.ndim - 1
    pl = tuple(Shard(0) if isinstance(p, Shard) and p.dim == last
               else Replicate() for p in lf.placements)
    return distribute_tensor(torch.arange(lf.shape[-1], device=lf.device),
                             lf.device_mesh, pl, src_data_rank=None)


def z_loss(logits: torch.Tensor, coef: float = 1e-4) -> torch.Tensor:
    """PaLM-style logit regulariser: keeps logsumexp near 0."""
    return coef * torch.mean(torch.square(_logsumexp(logits.float())))
