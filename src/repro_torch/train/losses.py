"""Token losses of the model zoo, in float32 (the JAX package's
``train/losses.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


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
    lse = torch.logsumexp(lf, dim=-1)
    idx = labels.long()
    idx = torch.where(idx < 0, idx + V, idx)
    ll = torch.gather(lf, -1, idx.clamp(0, V - 1)[..., None])[..., 0]
    ll = torch.where((idx >= 0) & (idx < V), ll, float("nan"))
    nll = lse - ll
    if mask is None:
        mask = labels >= 0
    mask = mask.float()
    n = torch.clamp(mask.sum(), min=1.0)
    return (nll * mask).sum() / n, n


def z_loss(logits: torch.Tensor, coef: float = 1e-4) -> torch.Tensor:
    """PaLM-style logit regulariser: keeps logsumexp near 0."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    return coef * torch.mean(torch.square(lse))
