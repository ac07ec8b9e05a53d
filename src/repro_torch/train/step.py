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

``step_for_cell`` runs a cell's step on one card with no mesh: one MoE
routing group, plain tensors.  ``jit_step_for_cell`` runs it over a
``DeviceMesh`` (``launch/mesh.py``) through a ``ShardPlan``: the state
(or the parameters), the inputs and the cache become DTensors placed by
their logical axes (``state_axes``, ``specs.input_shardings``,
``distributed/sharding.py``), MoE routing groups follow the batch's
split, and the step runs under ``plan.sharder()``.  There is no
``jax.jit``: the name is the reference's, and the step runs eagerly.
Steps return new trees and the caller drops the old ones (JAX donates
them).

Under the plan, three things that JAX's partitioner does silently are
explicit here:

- **plain tensors meeting DTensors** (positions, rope tables, masks,
  constants the model makes) are taken as replicated:
  ``plan.sharder()`` enters DTensor's ``implicit_replication``;
- **gradients** come back from autograd as DTensors of their own
  placement (``Partial`` sums under a batch split); ``value_and_grad``
  redistributes each to its parameter's placements before clipping and
  AdamW, so the moments and the new parameters keep the plan's layout;
- **ops DTensor has no rule for** are run on each rank's local chunk:
  the cache writes (``index_copy_``; ``layers._dyn_update``), the
  kernels' wrappers, attention, MoE routing and the WKV and Mamba scans
  (``layers.local_call``) and the sequence-sharded decode attention
  (``distributed/serve_attention.py``); the products with weights are
  laid out explicitly (``layers.product``, ``layers.lookup``), since
  DTensor's own strategies refuse some (torch 2.11 more than 2.13) and
  replicate work in others.

Every block kind of the zoo runs sharded: attention (with contiguous
and ring caches, cross-attention and a prefix), MoE, RWKV-6 and the
Hymba hybrid.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import ctx
from repro_torch.distributed import sharding as SH
from repro_torch.launch import specs as SPECS
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


def state_axes(cfg: ModelConfig, opt_state_like: Params) -> Params:
    """Logical axes for a train state: moments shard like their params."""
    pax = M.param_axes(cfg)
    return {"params": pax, "opt": {k: pax for k in opt_state_like},
            "step": ()}


def _as_param(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient laid out as its parameter is (a ``Partial``
    sum is reduced); a plain one as it is."""
    from torch.distributed.tensor import DTensor
    if isinstance(g, DTensor):
        return g.redistribute(p.device_mesh, p.placements)
    return g


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
    by_id = {id(x): torch.zeros_like(x) if g is None else _as_param(g, x)
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


# --------------------------------------------------------------------------
# Sharding plan over a device mesh
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ShardPlan:
    """Specs (``distributed/sharding.py``) for a cell's step on a mesh:
    the parameters, the state (train) and the inputs, beside their
    meta-device stand-ins; ``moe_groups`` routing groups."""
    mesh: Any
    rules: Dict[str, Any]
    param_shardings: Any
    state_shardings: Any
    input_shardings: Any
    abstract_state: Any
    abstract_inputs: Any
    moe_groups: int

    def sharder(self):
        """A context: activations laid out by the batch rule at every
        ``ctx.constrain`` (replicated where the batch does not divide),
        and plain tensors that meet DTensors taken as replicated."""
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import \
            implicit_replication
        ma = SH.mesh_axes(self.mesh)

        def fn(x, kind):
            if not isinstance(x, DTensor) or x.ndim < 2:
                return x
            ax = SH._resolve_axis(self.rules["batch"], x.shape[0], ma)
            spec = (ax,) if ax is not None else ()
            return x.redistribute(self.mesh, SH.placements(spec, self.mesh))

        @contextlib.contextmanager
        def both():
            with ctx.activation_sharder(fn), implicit_replication():
                yield
        return both()

    def place(self, tree: Any, specs: Any) -> Any:
        """DTensors of ``tree`` placed by ``specs``: a whole tensor that
        every rank holds alike is split locally (``sharding.distribute``);
        a DTensor passes as it is."""
        from torch.distributed.tensor import DTensor

        def one(spec, t):
            return t if isinstance(t, DTensor) else \
                SH.distribute(t, self.mesh, spec)
        return SH.map_axes(one, specs, tree)

    def place_inputs(self, inputs: Params) -> Params:
        return self.place(inputs, {k: self.input_shardings[k]
                                   for k in inputs})


def make_plan(cfg: ModelConfig, cell: ShapeCell, mesh,
              opt: Optional[Optimizer] = None, rules=None) -> ShardPlan:
    rules = dict(rules or SH.DEFAULT_RULES)
    abstract_inputs = SPECS.input_specs(cfg, cell)
    in_sh = SPECS.input_shardings(cfg, cell, mesh, rules)

    gen = torch.Generator()
    if cell.kind == "train":
        if opt is None:
            raise ValueError("a train cell needs an optimizer")
        abstract_state = init_state(gen, cfg, opt, device="meta")
        sax = state_axes(cfg, abstract_state["opt"])
    else:
        abstract_state = M.init_params(gen, cfg, device="meta")
        sax = M.param_axes(cfg)
    st_sh = SH.tree_specs(sax, abstract_state, mesh, rules)
    p_sh = st_sh["params"] if cell.kind == "train" else st_sh

    # MoE routing groups align with however the batch is actually split,
    # so sort / dispatch stays shard-local
    ma = SH.mesh_axes(mesh)
    bax = SH._resolve_axis(rules["batch"], cell.global_batch, ma)
    moe_groups = 1
    if bax is not None:
        for a in ((bax,) if isinstance(bax, str) else bax):
            moe_groups *= ma[a]

    return ShardPlan(mesh=mesh, rules=rules, param_shardings=p_sh,
                     state_shardings=st_sh, input_shardings=in_sh,
                     abstract_state=abstract_state,
                     abstract_inputs=abstract_inputs, moe_groups=moe_groups)


def jit_step_for_cell(cfg: ModelConfig, cell: ShapeCell, mesh,
                      opt: Optional[Optimizer] = None, rules=None,
                      **step_kw) -> Tuple[Callable, ShardPlan]:
    """Returns (step, plan).  ``step(state, batch)`` for a train cell ->
    (new state, metrics); ``step(params, batch)`` for prefill / decode ->
    (logits (B, V), cache).  Leaves may be DTensors placed by the plan
    or whole tensors that every rank holds alike, which the step places
    first.  Outputs are DTensors (logits split on the batch, the cache
    as placed and written in place); a train step's metrics are whole
    (replicated) tensors."""
    plan = make_plan(cfg, cell, mesh, opt, rules)
    if cell.kind == "train":
        fn = build_train_step(cfg, opt, moe_groups=plan.moe_groups,
                              **step_kw)

        def train_step(state, batch):
            state = plan.place(state, plan.state_shardings)
            batch = plan.place_inputs(batch)
            with plan.sharder():
                new, metrics = fn(state, batch)
            return new, {k: v.full_tensor() if hasattr(v, "full_tensor")
                         else v for k, v in metrics.items()}
        return train_step, plan

    fn = (build_prefill_step(cfg) if cell.kind == "prefill"
          else build_decode_step(cfg))
    out_spec = SH.spec_for(("batch", None),
                           (cell.global_batch, cfg.vocab_size), mesh,
                           plan.rules)

    def serve_step(params, batch):
        params = plan.place(params, plan.param_shardings)
        batch = plan.place_inputs(batch)
        with plan.sharder():
            logits, cache = fn(params, batch)
            logits = logits.redistribute(
                plan.mesh, SH.placements(out_spec, plan.mesh))
        return logits, cache
    return serve_step, plan
