"""Step factories of the model zoo: train, prefill and decode.

The JAX package's ``train/step.py`` on one card.  ``build_train_step``
follows the reference line for line: the VLM's logits cut to the text
suffix, ``frames`` to the encoder, the MoE aux loss and an optional
z-loss added to the cross-entropy, float32 gradient sums under
``grad_accum`` (with ``aux`` reported as 0, as the reference's scan
reports it), global-norm clipping, ``opt.update`` and the update added
in float32 and cast back to each parameter's dtype.  Gradients come from
``torch.autograd.grad`` over the parameter leaves; layers run under
``cfg.remat`` (``models/model.run_layers``).

``step_for_cell`` is the one-card counterpart of ``jit_step_for_cell``:
no mesh, one MoE routing group.  The reference's sharding plan
(``ShardPlan``, ``make_plan``, ``state_axes``: logical axes and
NamedShardings for a mesh, donation) is not applicable on one card and
has no counterpart here; steps return new trees and the caller drops the
old ones.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as M
from repro_torch.models import serve as SV
from repro_torch.models.config import ModelConfig, ShapeCell
from repro_torch.optim.optimizers import (Optimizer, clip_by_global_norm,
                                          tree_leaves, tree_map)
from repro_torch.train.losses import softmax_cross_entropy, z_loss

Params = Dict[str, Any]


def init_state(gen: torch.Generator, cfg: ModelConfig, opt: Optimizer,
               device: DeviceLike = None) -> Params:
    """{"params", "opt", "step"} on ``device`` (default CUDA; ``"meta"``
    gives the structure without memory)."""
    dev = resolve_device(device)
    params = M.init_params(gen, cfg, device=dev)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def value_and_grad(loss_fn: Callable, params: Params, batch: Params
                   ) -> Tuple[Tuple[torch.Tensor, Any], Params]:
    """``jax.value_and_grad(loss_fn, has_aux=True)`` for a ``loss_fn``
    returning (total, a tuple of tensors): ((total, the tuple),
    gradients in the tree of ``params``).  A leaf the loss does not
    reach gets zeros, as under ``jax.grad``."""
    p = tree_map(lambda x: x.detach().requires_grad_(), params)
    leaves = tree_leaves(p)
    total, aux = loss_fn(p, batch)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    by_id = {id(x): torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)}
    return ((total.detach(), tuple(a.detach() for a in aux)),
            tree_map(lambda x: by_id[id(x)], p))


def build_train_step(cfg: ModelConfig, opt: Optimizer, *,
                     aux_coef: float = 0.01, zloss_coef: float = 0.0,
                     clip_norm: float = 1.0, moe_groups: int = 1,
                     grad_accum: int = 1) -> Callable:
    """``train_step(state, batch) -> (new state, {"loss", "aux",
    "grad_norm"})``.  ``batch``: "tokens" and "labels" (B, S), and
    "embeds" (B, P, d) for a VLM or "frames" (B, enc_len, d) for an
    encoder-decoder.  The state given is not modified."""
    clip = clip_by_global_norm(clip_norm)

    def loss_fn(params, batch):
        out = M.forward(params, cfg, batch["tokens"],
                        embeds=batch.get("embeds"),
                        frames=batch.get("frames"),
                        moe_groups=moe_groups)
        logits = out.logits
        if "embeds" in batch:               # VLM: loss on the text suffix
            logits = logits[:, batch["embeds"].shape[1]:]
        loss, n = softmax_cross_entropy(logits, batch["labels"])
        total = loss + aux_coef * out.aux
        if zloss_coef:
            total = total + z_loss(logits, zloss_coef)
        return total, (loss, out.aux)

    def train_step(state, batch):
        params = state["params"]
        if grad_accum > 1:
            micro = {k: v.reshape((grad_accum, -1) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=state["step"].device)
            for i in range(grad_accum):
                (_, (loss, _)), g = value_and_grad(
                    loss_fn, params, {k: v[i] for k, v in micro.items()})
                grads = tree_map(torch.add, grads, g)
                loss_sum = loss_sum + loss
            grads = tree_map(lambda g: g / grad_accum, grads)
            loss = loss_sum / grad_accum
            aux = torch.zeros_like(loss)
        else:
            (_, (loss, aux)), grads = value_and_grad(loss_fn, params, batch)
        with torch.no_grad():
            grads, gnorm = clip(grads)
            updates, opt_state = opt.update(grads, state["opt"], params,
                                            state["step"])
            del grads
            new = tree_map(lambda p, u: (p.float() + u).to(p.dtype), params,
                           updates)
        return ({"params": new, "opt": opt_state,
                 "step": state["step"] + 1},
                {"loss": loss, "aux": aux, "grad_norm": gnorm})

    return train_step


def build_prefill_step(cfg: ModelConfig) -> Callable:
    """``prefill_step(params, batch) -> (last logits, cache)``; the batch
    holds "tokens", "cache" and optionally "embeds" / "frames"."""
    def prefill_step(params, batch):
        logits, cache, _ = SV.prefill(
            params, cfg, batch["tokens"], cache=batch["cache"],
            embeds=batch.get("embeds"), frames=batch.get("frames"))
        return logits, cache
    return prefill_step


def build_decode_step(cfg: ModelConfig) -> Callable:
    """``decode_step(params, batch) -> (logits, cache)`` of one token."""
    def decode_step(params, batch):
        return SV.decode_step(params, cfg, batch["tokens"],
                              cache=batch["cache"])
    return decode_step


def step_for_cell(cfg: ModelConfig, cell: ShapeCell,
                  opt: Optional[Optimizer] = None, **step_kw) -> Callable:
    """The step of a shape cell's kind on one card (``jit_step_for_cell``
    without a mesh: ``moe_groups`` 1, nothing sharded or donated)."""
    if cell.kind == "train":
        if opt is None:
            raise ValueError("a train cell needs an optimizer")
        return build_train_step(cfg, opt, moe_groups=1, **step_kw)
    if cell.kind == "prefill":
        return build_prefill_step(cfg)
    return build_decode_step(cfg)
