"""The filter trunk: a stacked-layer transformer over frame embeddings.

Only the path the paper's filter uses is ported: ``init_params`` for an
attention + MLP stack, ``run_layers`` over stacked per-layer parameters
(a Python loop stands in for ``lax.scan``), and ``forward`` from
embeddings with ``tap_layer=k, stop_at_tap=True``, which returns the
activation after the first k layers — the feature map the filter branch
consumes.  Parameters keep the JAX package's tree (embed, final_norm,
stacked layers with a leading ``L`` axis, lm_head), so weights carry
across with a tree map even where this slice does not read them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import tree_map

Params = Dict[str, Any]


def _layer_init(gen: torch.Generator, cfg: ModelConfig,
                device=None) -> Params:
    return {"ln1": L.norm_init(cfg, device),
            "attn": L.attn_init(gen, cfg, device),
            "ln2": L.norm_init(cfg, device),
            "mlp": L.mlp_init(gen, cfg, device)}


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device=None) -> Params:
    L.check_ported(cfg)
    dt = L.dtype_of(cfg)
    layers = [_layer_init(gen, cfg, device) for _ in range(cfg.n_layers)]
    p: Params = {
        "embed": L._normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt,
                           device),
        "final_norm": L.norm_init(cfg, device),
        "layers": tree_map(lambda *xs: torch.stack(xs), *layers),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, cfg.d_model,
                                    (cfg.d_model, cfg.vocab_size), dt, device)
    return p


def _apply_layer(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                 causal: bool) -> torch.Tensor:
    h = L.apply_norm(p["ln1"], x, cfg.norm_eps)
    x = x + L.attention_block(p["attn"], h, cfg, causal=causal)
    h2 = L.apply_norm(p["ln2"], x, cfg.norm_eps)
    return x + L.apply_mlp(p["mlp"], h2, cfg)


def run_layers(stack: Params, x: torch.Tensor, cfg: ModelConfig, *,
               lo: int = 0, hi: Optional[int] = None,
               causal: bool = True) -> torch.Tensor:
    """Run layers [lo, hi) of a stacked tree."""
    hi = stack["ln1"]["w"].shape[0] if hi is None else hi
    for i in range(lo, hi):
        x = _apply_layer(tree_map(lambda a: a[i], stack), x, cfg,
                         causal=causal)
    return x


@dataclasses.dataclass
class ForwardOut:
    tap: Optional[torch.Tensor] = None        # activations after layer k


def forward(params: Params, cfg: ModelConfig, tokens=None, *,
            embeds: Optional[torch.Tensor] = None,
            tap_layer: Optional[int] = None, stop_at_tap: bool = False,
            causal: bool = True) -> ForwardOut:
    """The filter's trunk forward: embeddings in, the activation after
    the first ``tap_layer`` layers out.  A tap outside 1..n_layers is
    ``None``, as in the JAX package."""
    L.check_ported(cfg)
    if tokens is not None or embeds is None or not stop_at_tap:
        raise NotImplementedError("only the filter's embeddings-only, "
                                  "stop-at-tap trunk forward is ported")
    if tap_layer is None or not 0 < tap_layer <= cfg.n_layers:
        return ForwardOut(tap=None)
    x = run_layers(params["layers"], embeds.to(L.dtype_of(cfg)), cfg,
                   hi=tap_layer, causal=causal)
    return ForwardOut(tap=x)
