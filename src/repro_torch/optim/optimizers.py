"""Minimal functional optimizers over nested dicts of tensors.

``Optimizer`` is an (init, update) pair, as in the JAX package:

    state = opt.init(params)
    updates, state = opt.update(grads, state, params, step)
    params = apply_updates(params, updates)

The arithmetic follows the JAX package's order of operations, which is
the point: ``torch.optim.AdamW`` applies the decay and the step in
another order.  Adam: bias-corrected m and v, ``eps`` outside the
square root, then decoupled decay times the step's learning rate.
Moments are float32.  Nothing is updated in place: every call returns
new trees.  Leaves are visited in sorted key order, the order of JAX's
tree flattening, so reductions over the tree sum in the same order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

import torch

Schedule = Callable[[Any], torch.Tensor]


def tree_map(fn: Callable, *trees: Any) -> Any:
    """Map ``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Leaves in sorted key order (JAX's flattening order for dicts)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [] if tree is None else [tree]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]   # (grads, state, params, step)


def apply_updates(params: Any, updates: Any) -> Any:
    return tree_map(lambda p, u: (p + u.to(p.dtype)) if u is not None else p,
                    params, updates)


def _to_f32(t: Any) -> Any:
    return tree_map(lambda x: x.to(torch.float32), t)


def _schedule(lr) -> Schedule:
    return lr if callable(lr) else (
        lambda step: torch.tensor(lr, dtype=torch.float32))


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    """A float32 moment of zeros shaped and placed as ``p`` (a DTensor's
    moment is a DTensor of the same placements, each rank its chunk)."""
    return torch.zeros_like(p, dtype=torch.float32,
                            memory_format=torch.contiguous_format)


def adamw(lr, *, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    sched = _schedule(lr)

    def init(params):
        zeros = tree_map(_zeros_f32, params)
        return {"m": zeros, "v": tree_map(torch.clone, zeros)}

    def update(grads, state, params, step):
        g = _to_f32(grads)
        m = tree_map(lambda m_, g_: b1 * m_ + (1 - b1) * g_, state["m"], g)
        v = tree_map(lambda v_, g_: b2 * v_ + (1 - b2) * g_ * g_,
                     state["v"], g)
        t = torch.as_tensor(step).to(torch.float32) + 1.0
        mhat_scale = 1.0 / (1 - b1 ** t)
        vhat_scale = 1.0 / (1 - b2 ** t)
        lr_t = sched(step)

        def upd(m_, v_, p_):
            u = -(lr_t * (m_ * mhat_scale)
                  / (torch.sqrt(v_ * vhat_scale) + eps))
            if weight_decay:
                u = u - lr_t * weight_decay * p_.to(torch.float32)
            return u

        return tree_map(upd, m, v, params), {"m": m, "v": v}

    return Optimizer(init, update)


def sgd_momentum(lr, *, momentum: float = 0.9,
                 weight_decay: float = 0.0) -> Optimizer:
    sched = _schedule(lr)

    def init(params):
        return {"mom": tree_map(_zeros_f32, params)}

    def update(grads, state, params, step):
        g = _to_f32(grads)
        if weight_decay:
            g = tree_map(lambda g_, p_: g_ + weight_decay
                         * p_.to(torch.float32), g, params)
        mom = tree_map(lambda m_, g_: momentum * m_ + g_, state["mom"], g)
        lr_t = sched(step)
        return tree_map(lambda m_: -lr_t * m_, mom), {"mom": mom}

    return Optimizer(init, update)


def clip_by_global_norm(max_norm: float
                        ) -> Callable[[Any], Tuple[Any, torch.Tensor]]:
    """Returns fn: grads -> (clipped grads, global_norm)."""
    def clip(grads):
        sq = torch.zeros((), dtype=torch.float32)
        for g in tree_leaves(grads):
            sq = sq.to(g.device) + torch.sum(torch.square(g.to(torch.float32)))
        gnorm = torch.sqrt(sq)
        scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        return tree_map(lambda g: g * scale.to(g.dtype), grads), gnorm
    return clip


def scale_by_schedule(opt: Optimizer, sched: Schedule) -> Optimizer:
    def update(grads, state, params, step):
        upd, st = opt.update(grads, state, params, step)
        s = sched(step)
        return tree_map(lambda u: u * s, upd), st
    return Optimizer(opt.init, update)


def chain(*fns):
    """Compose gradient transforms (each: grads -> grads) before an
    optimizer."""
    def apply(grads):
        for f in fns:
            grads = f(grads)
        return grads
    return apply
