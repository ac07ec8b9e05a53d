"""Serving: cache construction, prefill and decode steps.

The cache is a dict of per-layer tensors stacked on a leading ``L`` axis
plus a scalar ``len``, as in the JAX package.  The port serves RWKV-6
models, whose cache is the WKV state (B, H, K, K) in float32 and the two
token-shift states (B, D) in the model's dtype; the caches of the other
block kinds (attention k/v, Mamba, encoder memory) are not ported.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import ssm as S
from repro_torch.models.config import BlockKind, ModelConfig

Params = Dict[str, Any]


def _layer_cache_spec(cfg: ModelConfig, batch: int,
                      device: torch.device) -> Params:
    if cfg.block != BlockKind.RWKV6:
        raise NotImplementedError(f"the {cfg.block.value} cache is not "
                                  f"ported; the port serves RWKV-6 models")
    return S.rwkv_state_init(cfg, batch, device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Params:
    """Zero cache for all layers: {'layers': stacked, 'len': int32 scalar},
    on ``device`` (default CUDA).  An RWKV-6 cache does not grow with the
    sequence, so ``max_len`` (the JAX signature's) changes nothing."""
    L.check_ported(cfg)
    dev = resolve_device(device)
    one = _layer_cache_spec(cfg, batch, dev)
    return {"layers": {k: a[None].repeat((cfg.n_layers,) + (1,) * a.dim())
                       for k, a in one.items()},
            "len": torch.zeros((), dtype=torch.int32, device=dev)}


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            cache: Params, tap_layer: Optional[int] = None
            ) -> Tuple[torch.Tensor, Params, Any]:
    """Process a full prompt, filling the cache.  Returns (last_logits,
    cache, tap)."""
    out = M.forward(params, cfg, tokens, caches=cache["layers"],
                    cache_len=cache["len"], tap_layer=tap_layer)
    return (out.logits[:, -1], {"layers": out.caches, "len": out.cache_len},
            out.tap)


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
                cache: Params) -> Tuple[torch.Tensor, Params]:
    """One-token decode. tokens: (B, 1). Returns (logits (B, V), cache)."""
    out = M.forward(params, cfg, tokens, caches=cache["layers"],
                    cache_len=cache["len"])
    return out.logits[:, -1], {"layers": out.caches, "len": out.cache_len}


def greedy_generate(params: Params, cfg: ModelConfig, prompt: torch.Tensor,
                    n_steps: int, max_len: int) -> torch.Tensor:
    """Greedy generation: prefill, then ``n_steps - 1`` decode steps, on
    the prompt's device.  Returns the (B, n_steps) generated tokens."""
    cache = init_cache(cfg, prompt.shape[0], max_len, device=prompt.device)
    logits, cache, _ = prefill(params, cfg, prompt, cache=cache)
    toks = [torch.argmax(logits, -1)[:, None]]
    for _ in range(n_steps - 1):
        logits, cache = decode_step(params, cfg, toks[-1], cache=cache)
        toks.append(torch.argmax(logits, -1)[:, None])
    return torch.cat(toks, dim=1)
