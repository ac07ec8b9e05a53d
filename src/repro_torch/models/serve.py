"""Serving: cache construction, prefill and decode steps.

The cache is a dict of per-layer tensors stacked on a leading ``L`` axis
plus a scalar ``len`` on the device, as in the JAX package.  Its kind
follows the block kind:

- attention: k / v buffers (L, B, S_max, KV, hd) in the model's dtype;
  sliding-window models allocate ``min(S_max, window)`` rows and a
  ``pos`` (L, rows) of each slot's position, -1 when empty (a ring
  buffer);
- hybrid (Hymba): the attention k / v (a ring at its window) and the
  Mamba states, ``ssm`` (B, d_inner, N) in float32 and ``conv`` (B,
  conv width - 1, d_inner) in the model's dtype;
- enc-dec: the decoder's k / v and the (fixed) encoder memory
  ``enc_out`` (B, enc_len, d);
- rwkv6: the WKV state (B, H, K, K) in float32 and the two token-shift
  states (B, D).

**Attention and Mamba caches are written in place**: ``prefill`` and
``decode_step`` write the new rows and states into the tensors of the
cache they are given and return them (with a new ``len``), so the cache
a call was given is spent.  Nothing copies it, and ``len`` never leaves
the device.  ``cache_axes`` gives the logical axes of the cache's tree
for the sharding plan (``train/step.make_plan``).
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


def _layer_cache_spec(cfg: ModelConfig, batch: int, max_len: int
                      ) -> Params:
    """One layer's cache: name -> (shape, dtype, fill value)."""
    if cfg.block == BlockKind.RWKV6:
        return {k: (tuple(a.shape), a.dtype, 0) for k, a in
                S.rwkv_state_init(cfg, batch, device="meta").items()}
    dt = L.dtype_of(cfg)
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    kv_len = max_len
    if cfg.sliding_window is not None:
        kv_len = min(max_len, cfg.sliding_window)
    c = {"k": ((batch, kv_len, KV, hd), dt, 0),
         "v": ((batch, kv_len, KV, hd), dt, 0)}
    if kv_len < max_len:           # ring buffer: track per-slot positions
        c["pos"] = ((kv_len,), torch.int32, -1)
    if cfg.block == BlockKind.HYBRID:
        c.update({k: (tuple(a.shape), a.dtype, 0) for k, a in
                  S.mamba_state_init(cfg, batch, device="meta").items()})
    return c


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Params:
    """Empty cache for all layers: {'layers': stacked, 'len': int32
    scalar (, 'enc_out')}, on ``device`` (default CUDA), each leaf
    allocated stacked, once.  An RWKV-6 cache does not grow with the
    sequence, so ``max_len`` changes nothing there."""
    dev = resolve_device(device)
    cache: Params = {
        "layers": {k: torch.full((cfg.n_layers,) + shape, fill, dtype=dt,
                                 device=dev)
                   for k, (shape, dt, fill) in
                   _layer_cache_spec(cfg, batch, max_len).items()},
        "len": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.enc_dec:
        cache["enc_out"] = torch.zeros((batch, cfg.enc_len, cfg.d_model),
                                       dtype=L.dtype_of(cfg), device=dev)
    return cache


def cache_axes(cfg: ModelConfig) -> Params:
    """Logical axes mirroring ``init_cache``, for the sharding plan."""
    ax: Params = {}
    if cfg.block in (BlockKind.ATTN, BlockKind.MOE, BlockKind.HYBRID):
        ax["k"] = ("layers", "cache_batch", "cache_seq", "cache_kv", None)
        ax["v"] = ("layers", "cache_batch", "cache_seq", "cache_kv", None)
        if cfg.sliding_window is not None:
            ax["pos"] = ("layers", None)
    if cfg.block == BlockKind.HYBRID:
        ax["ssm"] = ("layers", "cache_batch", "inner", None)
        ax["conv"] = ("layers", "cache_batch", None, "inner")
    if cfg.block == BlockKind.RWKV6:
        ax["wkv"] = ("layers", "cache_batch", None, None, None)
        ax["shift_tm"] = ("layers", "cache_batch", "embed")
        ax["shift_cm"] = ("layers", "cache_batch", "embed")
    cache_ax: Params = {"layers": ax, "len": ()}
    if cfg.enc_dec:
        cache_ax["enc_out"] = ("cache_batch", None, "embed")
    return cache_ax


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            cache: Params, embeds: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None,
            tap_layer: Optional[int] = None
            ) -> Tuple[torch.Tensor, Params, Any]:
    """Process a full prompt, filling the cache.  A VLM's ``embeds`` (B,
    P, d) go before the tokens as a bidirectional prefix; an
    encoder-decoder encodes ``frames`` here (else it reads the cache's
    ``enc_out``).  Returns (last_logits, cache, tap)."""
    enc_out = cache.get("enc_out") if cfg.enc_dec and frames is None \
        else None
    out = M.forward(params, cfg, tokens, embeds=embeds, frames=frames,
                    enc_out=enc_out,
                    caches=cache["layers"], cache_len=cache["len"],
                    tap_layer=tap_layer)
    new_cache = {"layers": out.caches, "len": out.cache_len}
    if cfg.enc_dec:
        new_cache["enc_out"] = out.enc_out
    return out.logits[:, -1], new_cache, out.tap


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
                cache: Params) -> Tuple[torch.Tensor, Params]:
    """One-token decode. tokens: (B, 1). Returns (logits (B, V), cache)."""
    enc_out = cache.get("enc_out") if cfg.enc_dec else None
    out = M.forward(params, cfg, tokens, enc_out=enc_out,
                    caches=cache["layers"], cache_len=cache["len"])
    new_cache = {"layers": out.caches, "len": out.cache_len}
    if cfg.enc_dec:
        new_cache["enc_out"] = enc_out
    return out.logits[:, -1], new_cache


def greedy_generate(params: Params, cfg: ModelConfig, prompt: torch.Tensor,
                    n_steps: int, max_len: int) -> torch.Tensor:
    """Greedy generation: prefill, then ``n_steps - 1`` decode steps, on
    the prompt's device (an encoder-decoder reads the zero encoder memory
    of a fresh cache, as in the JAX package).  Returns the (B, n_steps)
    generated tokens."""
    cache = init_cache(cfg, prompt.shape[0], max_len, device=prompt.device)
    logits, cache, _ = prefill(params, cfg, prompt, cache=cache)
    toks = [torch.argmax(logits, -1)[:, None]]
    for _ in range(n_steps - 1):
        logits, cache = decode_step(params, cfg, toks[-1], cache=cache)
        toks.append(torch.argmax(logits, -1)[:, None])
    return torch.cat(toks, dim=1)
