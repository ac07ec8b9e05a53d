"""Stacked-layer models: the filter trunk and the RWKV-6 language model.

Two block kinds are ported (``layers.check_ported``): attention + MLP, the
filter trunk's blocks, driven from embeddings without a cache; and RWKV-6
time-mix + channel-mix, driven from tokens with or without its recurrent
cache.  ``run_layers`` runs stacked per-layer parameters in a Python loop
(``lax.scan`` in JAX) and restacks the per-layer caches on the leading
``L`` axis; ``forward`` returns the full logits, the new caches and
length, and the activation *tap* after the first k layers — the feature
map the paper's filter branch consumes.  Parameters keep the JAX
package's tree (embed, final_norm, stacked layers with a leading ``L``
axis, lm_head), so weights carry across with a tree map.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import BlockKind, ModelConfig
from repro_torch.optim.optimizers import tree_map

Params = Dict[str, Any]


def _layer_init(gen: torch.Generator, cfg: ModelConfig,
                device=None) -> Params:
    if cfg.block == BlockKind.RWKV6:
        return {"ln1": L.norm_init(cfg, device),
                "ln2": L.norm_init(cfg, device),
                "rwkv": S.rwkv_init(gen, cfg, device)}
    return {"ln1": L.norm_init(cfg, device),
            "attn": L.attn_init(gen, cfg, device),
            "ln2": L.norm_init(cfg, device),
            "mlp": L.mlp_init(gen, cfg, device)}


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device: DeviceLike = None) -> Params:
    """Random weights drawn on the generator's device (a CUDA generator
    draws a full-width model in a fraction of a second), placed on
    ``device`` (default CUDA)."""
    L.check_ported(cfg)
    device = resolve_device(device)
    dt = L.dtype_of(cfg)
    layers = [_layer_init(gen, cfg, device) for _ in range(cfg.n_layers)]
    p: Params = {
        "embed": L._normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt,
                           device),
        "final_norm": L.norm_init(cfg, device),
        "layers": tree_map(lambda *xs: torch.stack(xs), *layers),
    }
    del layers
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, cfg.d_model,
                                    (cfg.d_model, cfg.vocab_size), dt, device)
    return p


def _apply_layer(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                 causal: bool, cache: Optional[Params]
                 ) -> Tuple[torch.Tensor, Optional[Params]]:
    """One block.  Returns (x, the layer's new cache or None)."""
    if cfg.block == BlockKind.RWKV6:
        st = dict(cache) if cache is not None else None
        h, st = S.rwkv_time_mix(p["rwkv"],
                                L.apply_norm(p["ln1"], x, cfg.norm_eps), cfg,
                                state=st, use_kernel=cfg.attn_impl == "pallas")
        x = x + h
        h2, st = S.rwkv_channel_mix(
            p["rwkv"], L.apply_norm(p["ln2"], x, cfg.norm_eps), state=st)
        return x + h2, st
    h = L.apply_norm(p["ln1"], x, cfg.norm_eps)
    x = x + L.attention_block(p["attn"], h, cfg, causal=causal)
    h2 = L.apply_norm(p["ln2"], x, cfg.norm_eps)
    return x + L.apply_mlp(p["mlp"], h2, cfg), None


def run_layers(stack: Params, x: torch.Tensor, cfg: ModelConfig, *,
               lo: int = 0, hi: Optional[int] = None, causal: bool = True,
               caches: Optional[Params] = None
               ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Run layers [lo, hi) of a stacked tree.  Returns (x, the new caches
    of those layers stacked on ``L``, or None without caches)."""
    hi = stack["ln1"]["w"].shape[0] if hi is None else hi
    new = []
    for i in range(lo, hi):
        cl = None if caches is None else tree_map(lambda a: a[i], caches)
        x, nc = _apply_layer(tree_map(lambda a: a[i], stack), x, cfg,
                             causal=causal, cache=cl)
        new.append(nc)
    if caches is None:
        return x, None
    if not new:
        return x, tree_map(lambda a: a[lo:hi], caches)
    return x, tree_map(lambda *xs: torch.stack(xs), *new)


@dataclasses.dataclass
class ForwardOut:
    logits: Optional[torch.Tensor] = None     # (B, S, V)
    caches: Optional[Params] = None           # stacked per-layer caches
    cache_len: Optional[torch.Tensor] = None
    tap: Optional[torch.Tensor] = None        # activations after layer k


def embed_tokens(params: Params, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


def unembed(params: Params, cfg: ModelConfig, x: torch.Tensor
            ) -> torch.Tensor:
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params["embed"])
    return torch.einsum("bsd,dv->bsv", x, params["lm_head"])


def forward(params: Params, cfg: ModelConfig,
            tokens: Optional[torch.Tensor] = None, *,
            embeds: Optional[torch.Tensor] = None,
            caches: Optional[Params] = None,
            cache_len: Optional[torch.Tensor] = None,
            tap_layer: Optional[int] = None, stop_at_tap: bool = False,
            causal: bool = True) -> ForwardOut:
    """Tokens (B, S) or embeddings (B, S, d) in; full logits, the new
    caches and length, and the tap after ``tap_layer`` layers out.

    Prefill: caches given with ``cache_len`` 0; decode: tokens (B, 1)
    with the caches and length of the previous call.  A tap outside
    1..n_layers is ``None`` and the whole stack runs, as in the JAX
    package; ``stop_at_tap`` returns right after the tap (the filter's
    forward)."""
    L.check_ported(cfg)
    if tokens is not None and embeds is not None:
        raise NotImplementedError("prefix embeddings before tokens (the "
                                  "VLM path) are not ported")
    if tokens is not None:
        x = embed_tokens(params, cfg, tokens)
    elif embeds is not None:
        x = embeds.to(L.dtype_of(cfg))
    else:
        raise ValueError("forward needs tokens or embeds")
    if caches is not None and cfg.block != BlockKind.RWKV6:
        raise NotImplementedError("KV caches of attention blocks are not "
                                  "ported; the port serves RWKV-6 models")
    n_tok = x.shape[1]
    tap = None
    if tap_layer is not None and 0 < tap_layer <= cfg.n_layers:
        x, c1 = run_layers(params["layers"], x, cfg, hi=tap_layer,
                           causal=causal, caches=caches)
        tap = x
        if stop_at_tap:
            return ForwardOut(caches=c1, tap=tap)
        x, c2 = run_layers(params["layers"], x, cfg, lo=tap_layer,
                           causal=causal, caches=caches)
        new_caches = (None if caches is None else
                      tree_map(lambda a, b: torch.cat([a, b]), c1, c2))
    else:
        x, new_caches = run_layers(params["layers"], x, cfg, causal=causal,
                                   caches=caches)
    x = L.apply_norm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed(params, cfg, x)
    new_len = None if cache_len is None else cache_len + n_tok
    return ForwardOut(logits=logits, caches=new_caches, cache_len=new_len,
                      tap=tap)
