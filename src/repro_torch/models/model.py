"""Stacked-layer models: the filter trunk and every block kind of the
zoo.

Four block kinds, as in the JAX package: attention + MLP (the filter
trunk, dense GQA decoders with rope and qkv biases, PaliGemma's
prefix-LM, and whisper's encoder and decoder, the decoder with
cross-attention to the encoder memory), attention + mixture-of-experts
(granite, grok), Hymba's hybrid (attention and Mamba side by side on the
same normed input, averaged, then the MLP) and RWKV-6 time-mix +
channel-mix.  ``run_layers`` runs stacked per-layer parameters in a
Python loop (``lax.scan`` in JAX) and sums the layers' MoE aux losses.
Attention caches are written in place, each layer into its view of the
stacked (L, B, S, KV, hd) tensors, and so are a hybrid layer's Mamba
states; the same tensors come back.  RWKV-6 states are small and are
restacked on the leading ``L`` axis.  ``forward`` returns the full
logits, the new caches and length, the encoder memory, the aux loss and
the activation *tap* after the first k layers — the feature map the
paper's filter branch consumes.  Parameters keep the JAX package's tree
(embed, final_norm, stacked layers with a leading ``L`` axis, lm_head,
pos_embed, enc_layers, enc_norm), so weights carry across with a tree
map.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import ctx
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import BlockKind, ModelConfig
from repro_torch.optim.optimizers import tree_map

Params = Dict[str, Any]


def _layer_init(gen: torch.Generator, cfg: ModelConfig, *,
                cross: bool = False, is_encoder: bool = False,
                device=None) -> Params:
    blk = BlockKind.ATTN if is_encoder else cfg.block
    if blk == BlockKind.RWKV6:
        return {"ln1": L.norm_init(cfg, device),
                "ln2": L.norm_init(cfg, device),
                "rwkv": S.rwkv_init(gen, cfg, device)}
    p: Params = {"ln1": L.norm_init(cfg, device),
                 "attn": L.attn_init(gen, cfg, device=device)}
    if blk == BlockKind.HYBRID:
        p["mamba"] = S.mamba_init(gen, cfg, device)
    if cross:
        p["ln_x"] = L.norm_init(cfg, device)
        p["xattn"] = L.attn_init(gen, cfg, cross=True, device=device)
    p["ln2"] = L.norm_init(cfg, device)
    if blk == BlockKind.MOE:
        p["moe"] = L.moe_init(gen, cfg, device)
    else:
        p["mlp"] = L.mlp_init(gen, cfg, device=device)
    return p


def _stack_layers(gen: torch.Generator, cfg: ModelConfig, n: int,
                  device=None, **kw) -> Params:
    layers = [_layer_init(gen, cfg, device=device, **kw) for _ in range(n)]
    return tree_map(lambda *xs: torch.stack(xs), *layers)


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device: DeviceLike = None) -> Params:
    """Random weights drawn on the generator's device (a CUDA generator
    draws a full-width model in a fraction of a second), placed on
    ``device`` (default CUDA)."""
    device = resolve_device(device)
    dt = L.dtype_of(cfg)
    layers = _stack_layers(gen, cfg, cfg.n_layers, device,
                           cross=cfg.enc_dec)
    p: Params = {
        "embed": L._normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt,
                           device),
        "final_norm": L.norm_init(cfg, device),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, cfg.d_model,
                                    (cfg.d_model, cfg.vocab_size), dt, device)
    if cfg.learned_pos:
        p["pos_embed"] = L._normal(gen, (cfg.max_seq_len, cfg.d_model), 0.02,
                                   dt, device)
    if cfg.enc_dec:
        p["enc_layers"] = _stack_layers(gen, cfg, cfg.n_enc_layers, device,
                                        is_encoder=True)
        p["enc_norm"] = L.norm_init(cfg, device)
    return p


def _layer_axes(cfg: ModelConfig, *, cross: bool = False,
                is_encoder: bool = False) -> Params:
    """Logical axes of one layer, leaf for leaf with ``_layer_init``."""
    blk = BlockKind.ATTN if is_encoder else cfg.block
    if blk == BlockKind.RWKV6:
        return {"ln1": L.norm_axes(cfg), "ln2": L.norm_axes(cfg),
                "rwkv": S.rwkv_axes(cfg)}
    a: Params = {"ln1": L.norm_axes(cfg), "attn": L.attn_axes(cfg)}
    if blk == BlockKind.HYBRID:
        a["mamba"] = S.mamba_axes(cfg)
    if cross:
        a["ln_x"] = L.norm_axes(cfg)
        a["xattn"] = L.attn_axes(cfg, cross=True)
    a["ln2"] = L.norm_axes(cfg)
    if blk == BlockKind.MOE:
        a["moe"] = L.moe_axes(cfg)
    else:
        a["mlp"] = L.mlp_axes(cfg)
    return a


def _bcast_axes(tree: Params, extra: Tuple) -> Params:
    """Prefix every axes tuple of ``tree`` with ``extra`` (the stacked
    layers' leading axis)."""
    if isinstance(tree, tuple):
        return extra + tree
    return {k: _bcast_axes(v, extra) for k, v in tree.items()}


def param_axes(cfg: ModelConfig) -> Params:
    """Logical axes mirroring ``init_params``, for the sharding plan."""
    a: Params = {
        "embed": ("vocab", "embed"),
        "final_norm": L.norm_axes(cfg),
        "layers": _bcast_axes(_layer_axes(cfg, cross=cfg.enc_dec),
                              ("layers",)),
    }
    if not cfg.tie_embeddings:
        a["lm_head"] = ("embed", "vocab")
    if cfg.learned_pos:
        a["pos_embed"] = (None, "embed")
    if cfg.enc_dec:
        a["enc_layers"] = _bcast_axes(_layer_axes(cfg, is_encoder=True),
                                      ("layers",))
        a["enc_norm"] = L.norm_axes(cfg)
    return a


def _apply_layer(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                 causal: bool, positions, cache: Optional[Params],
                 cache_len,
                 enc_out: Optional[torch.Tensor], is_encoder: bool = False,
                 rope=None, prefix_len: int = 0, moe_groups: int = 1
                 ) -> Tuple[torch.Tensor, Optional[Params],
                            Optional[torch.Tensor]]:
    """One block.  Returns (x, the layer's new cache (no 'len') or None,
    the MoE aux loss or None).  ``rope``: the shared rope tables of
    ``positions``.  A hybrid layer's new Mamba states are copied into
    the cache's ``ssm`` / ``conv`` tensors (views of the stacked cache),
    as the attention rows are."""
    blk = BlockKind.ATTN if is_encoder else cfg.block
    if blk == BlockKind.RWKV6:
        st = dict(cache) if cache is not None else None
        h, st = S.rwkv_time_mix(p["rwkv"],
                                L.apply_norm(p["ln1"], x, cfg.norm_eps), cfg,
                                state=st, use_kernel=cfg.attn_impl == "pallas")
        x = x + h
        h2, st = S.rwkv_channel_mix(
            p["rwkv"], L.apply_norm(p["ln2"], x, cfg.norm_eps), state=st)
        return x + h2, st, None

    h = L.apply_norm(p["ln1"], x, cfg.norm_eps)
    attn_cache = None
    if cache is not None:
        attn_cache = {"k": cache["k"], "v": cache["v"], "len": cache_len}
        if "pos" in cache:
            attn_cache["pos"] = cache["pos"]
    a_out, attn_cache = L.attention_block(
        p["attn"], h, cfg, causal=causal, positions=positions,
        cache=attn_cache, rope=rope, prefix_len=prefix_len)
    new_cache = None
    if attn_cache is not None:
        new_cache = {k: attn_cache[k] for k in ("k", "v", "pos")
                     if k in attn_cache}
    if blk == BlockKind.HYBRID:
        m_state = None if cache is None else \
            {"ssm": cache["ssm"], "conv": cache["conv"]}
        m_out, m_state = S.mamba_block(p["mamba"], h, cfg, state=m_state)
        a_out = 0.5 * (a_out + m_out)
        if m_state is not None:
            for k in ("ssm", "conv"):
                new_cache[k] = cache[k].copy_(L.like(m_state[k], cache[k]))
    x = x + a_out
    del a_out                # (B, S, d): not held through the MLP

    if enc_out is not None and "xattn" in p:
        hx = L.apply_norm(p["ln_x"], x, cfg.norm_eps)
        x_out, _ = L.attention_block(p["xattn"], hx, cfg, causal=False,
                                     kv_source=enc_out, use_rope=False)
        x = x + x_out

    h2 = L.apply_norm(p["ln2"], x, cfg.norm_eps)
    if blk == BlockKind.MOE:
        m_out, aux = L.apply_moe(p["moe"], h2, cfg, groups=moe_groups)
        return x + m_out, new_cache, aux
    return x + L.apply_mlp(p["mlp"], h2, cfg), new_cache, None


_SAVED_BY_SELECTIVE = ("aten.mm.default", "aten.addmm.default")


def _selective_policy(ctx, op, *args, **kwargs):
    """``remat="selective"``: keep the outputs of matrix products without
    batch dimensions, recompute everything else (JAX's
    ``dots_with_no_batch_dims_saveable``).  ``torch.einsum`` lowers a
    product with no batch dimension, such as ``bsd,de->bse``, to a
    ``bmm`` with a batch of one, and attention's ``bqngd,bsnd->bnqgs``
    to a ``bmm`` over B·KV; so a ``bmm`` of batch one is kept too (also
    attention's at B = KV = 1, which JAX would recompute)."""
    from torch.utils.checkpoint import CheckpointPolicy
    name = str(op)
    if name in _SAVED_BY_SELECTIVE or (
            name == "aten.bmm.default" and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, cfg: ModelConfig):
    """``jax.checkpoint`` of JAX's ``_remat_wrap``: ``"full"`` saves only
    the layer's inputs and recomputes the rest in the backward pass;
    ``"selective"`` also keeps the products that ``_selective_policy``
    names."""
    from torch.utils import checkpoint as C
    if cfg.remat == "full":
        return lambda *a, **kw: C.checkpoint(fn, *a, use_reentrant=False,
                                             **kw)
    if cfg.remat == "selective":
        ctx = functools.partial(C.create_selective_checkpoint_contexts,
                                _selective_policy)
        return lambda *a, **kw: C.checkpoint(fn, *a, use_reentrant=False,
                                             context_fn=ctx, **kw)
    return fn


def _in_place(caches: Params) -> bool:
    """Attention caches (k / v, and a hybrid's Mamba states) are written
    in place; RWKV-6 states are restacked."""
    return "k" in caches


def run_layers(stack: Params, x: torch.Tensor, cfg: ModelConfig, *,
               lo: int = 0, hi: Optional[int] = None, causal: bool = True,
               positions=None, caches: Optional[Params] = None,
               cache_len=None,
               enc_out: Optional[torch.Tensor] = None,
               is_encoder: bool = False, rope=None, prefix_len: int = 0,
               moe_groups: int = 1
               ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """Run layers [lo, hi) of a stacked tree.  Returns (x, the caches of
    those layers stacked on ``L``, or None without caches, the sum of
    the layers' MoE aux losses (float32, 0 without MoE)).  Attention
    caches come back as the same tensors (views of [lo, hi)), written in
    place.  Under autograd without caches (training) each layer runs
    under ``cfg.remat``; serving never does."""
    n_total = stack["ln1"]["w"].shape[0]
    hi = n_total if hi is None else hi
    kw = dict(causal=causal, positions=positions, cache_len=cache_len,
              enc_out=enc_out, is_encoder=is_encoder, rope=rope,
              prefix_len=prefix_len, moe_groups=moe_groups)
    layer = _apply_layer
    if caches is None and torch.is_grad_enabled():
        layer = _remat_wrap(_apply_layer, cfg)
    new = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(lo, hi):
        cl = None if caches is None else tree_map(lambda a: a[i], caches)
        x, nc, layer_aux = layer(tree_map(lambda a: a[i], stack),
                                 ctx.constrain(x), cfg, cache=cl, **kw)
        x = ctx.constrain(x)
        if layer_aux is not None:
            aux = aux + layer_aux
        new.append(nc)
    if caches is None:
        return x, None, aux
    if _in_place(caches) or not new:
        if (lo, hi) == (0, n_total):
            return x, caches, aux
        return x, tree_map(lambda a: a[lo:hi], caches), aux
    return x, tree_map(lambda *xs: torch.stack(xs), *new), aux


@dataclasses.dataclass
class ForwardOut:
    logits: Optional[torch.Tensor] = None     # (B, S, V)
    caches: Optional[Params] = None           # stacked per-layer caches
    cache_len: Optional[torch.Tensor] = None
    enc_out: Optional[torch.Tensor] = None    # encoder memory (enc-dec)
    aux: Optional[torch.Tensor] = None        # MoE load-balance loss
    tap: Optional[torch.Tensor] = None        # activations after layer k


def embed_tokens(params: Params, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    x = L.lookup(params["embed"], tokens)
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def unembed(params: Params, cfg: ModelConfig, x: torch.Tensor
            ) -> torch.Tensor:
    if cfg.tie_embeddings:
        return L.product("bsd,vd->bsv", x, params["embed"], {0: 2})
    return L.product("bsd,dv->bsv", x, params["lm_head"], {1: 2})


def encode(params: Params, cfg: ModelConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """Whisper-style encoder over precomputed (stub) frame embeddings."""
    x = frames.to(L.dtype_of(cfg))
    x = x + L.sinusoid_pos(frames.shape[1], cfg.d_model, x.dtype,
                           x.device)[None]
    x, _, _ = run_layers(params["enc_layers"], x, cfg, causal=False,
                         is_encoder=True)
    return L.apply_norm(params["enc_norm"], x, cfg.norm_eps)


def forward(params: Params, cfg: ModelConfig,
            tokens: Optional[torch.Tensor] = None, *,
            embeds: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None,
            enc_out: Optional[torch.Tensor] = None,
            caches: Optional[Params] = None,
            cache_len: Optional[torch.Tensor] = None,
            tap_layer: Optional[int] = None, stop_at_tap: bool = False,
            causal: bool = True, moe_groups: int = 1) -> ForwardOut:
    """Tokens (B, S) and / or embeddings (B, P, d) in; full logits, the
    new caches and length, the encoder memory, the MoE aux loss and the
    tap after ``tap_layer`` layers out.

    With both, the embeddings (PaliGemma's patch embeddings) go before
    the tokens and every query sees them (a prefix-LM, ``prefix_len`` =
    P); embeddings alone are the input (the filter trunk).  Prefill:
    caches given with ``cache_len`` 0; decode: tokens (B, 1) with the
    caches and length of the previous call.  Caches are written in
    place.  An encoder-decoder takes ``frames`` (encoded here) or a
    precomputed ``enc_out``.  ``moe_groups``: the MoE routing groups.
    A tap outside 1..n_layers is ``None`` and the whole stack runs, as
    in the JAX package; ``stop_at_tap`` returns right after the tap (the
    filter's forward)."""
    prefix_len = 0
    if tokens is not None:
        x = embed_tokens(params, cfg, tokens)
        if embeds is not None:                        # paligemma prefix
            x = torch.cat([embeds.to(x.dtype), x], dim=1)
            prefix_len = embeds.shape[1]
    elif embeds is not None:
        x = embeds.to(L.dtype_of(cfg))
    else:
        raise ValueError("forward needs tokens or embeds")
    x = ctx.constrain(x)
    n_tok = x.shape[1]
    positions = torch.arange(n_tok, device=x.device)[None, :]
    if cache_len is not None:
        positions = cache_len + positions
    if cfg.learned_pos:
        pe = params["pos_embed"]
        x = x + pe[torch.clamp(positions[0], max=pe.shape[0] - 1)]
    if cfg.enc_dec and enc_out is None:
        if frames is None:
            raise ValueError("an encoder-decoder needs frames or enc_out")
        enc_out = encode(params, cfg, frames)

    # one rope table for every layer's q and k
    rope = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta) \
        if cfg.use_rope else None
    kw = dict(causal=causal, positions=positions, enc_out=enc_out,
              cache_len=cache_len, rope=rope, prefix_len=prefix_len,
              moe_groups=moe_groups)
    tap = None
    if tap_layer is not None and 0 < tap_layer <= cfg.n_layers:
        x, c1, aux = run_layers(params["layers"], x, cfg, hi=tap_layer,
                                caches=caches, **kw)
        tap = x
        if stop_at_tap:
            return ForwardOut(caches=c1, aux=aux, tap=tap, enc_out=enc_out)
        x, c2, aux2 = run_layers(params["layers"], x, cfg, lo=tap_layer,
                                 caches=caches, **kw)
        aux = aux + aux2
        new_caches = caches
        if caches is not None and not _in_place(caches):
            new_caches = tree_map(lambda a, b: torch.cat([a, b]), c1, c2)
    else:
        x, new_caches, aux = run_layers(params["layers"], x, cfg,
                                        caches=caches, **kw)
    x = L.apply_norm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed(params, cfg, x)
    new_len = None if cache_len is None else cache_len + n_tok
    return ForwardOut(logits=logits, caches=new_caches, cache_len=new_len,
                      enc_out=enc_out, aux=aux, tap=tap)
