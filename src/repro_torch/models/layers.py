"""The neural layers of the ported models, in plain PyTorch.

What ``train.filter_train.default_trunk`` reaches is ported here (the
RWKV-6 blocks live in ``ssm.py``): RMSNorm, multi-head attention without
a KV cache or rope (naive full softmax, or the flash-attention kernel
when the trunk is served with ``attn_impl="pallas"``; see ``_attend``),
and the gated SiLU MLP.  Parameters are plain dicts of tensors in the
JAX package's layouts (``wq`` (d, H, hd), ``wo`` (H, hd, d), ...), so
weights carry across with a tree map.  Initializers draw from an
explicit ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.models.config import Activation, BlockKind, ModelConfig

Params = Dict[str, Any]

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def check_ported(cfg: ModelConfig) -> None:
    """Raise for features this slice of the port does not carry.  Two
    block kinds are ported: attention + gated SiLU MLP without rope (the
    filter's ``default_trunk``) and RWKV-6; both with RMSNorm."""
    unsupported = {
        "block": cfg.block not in (BlockKind.ATTN, BlockKind.RWKV6),
        "enc_dec": cfg.enc_dec, "vlm_prefix": cfg.vlm_prefix > 0,
        "use_rope": cfg.use_rope, "layernorm": cfg.layernorm,
        "qkv_bias": cfg.qkv_bias, "glu": not cfg.glu,
        "activation": cfg.activation != Activation.SILU,
        "sliding_window": cfg.sliding_window is not None,
        "learned_pos": cfg.learned_pos, "scale_embed": cfg.scale_embed,
        "logits_softcap": cfg.logits_softcap != 0.0}
    bad = sorted(k for k, v in unsupported.items() if v)
    if bad:
        raise NotImplementedError(f"model features not ported: {bad} (the "
                                  f"port carries the filter's default_trunk "
                                  f"and RWKV-6)")


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _normal(gen: torch.Generator, shape, scale: float, dtype,
            device=None) -> torch.Tensor:
    """Normal init drawn on the generator's device, then moved, so one
    seed gives the same weights on every device."""
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device) * scale
    return x.to(device=device, dtype=dtype)


def dense_init(gen: torch.Generator, d_in: int, shape, dtype,
               device=None) -> torch.Tensor:
    """Fan-in scaled normal init (same shapes and scale as the JAX
    package's ``dense_init``)."""
    return _normal(gen, shape, 1.0 / math.sqrt(max(d_in, 1)), dtype, device)


def norm_init(cfg: ModelConfig, device=None) -> Params:
    return {"w": torch.ones(cfg.d_model, dtype=dtype_of(cfg), device=device)}


def apply_norm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm, computed in float32."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * p["w"].float()).to(x.dtype)


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Full-softmax attention as plain einsums.

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) -> (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqngd,bsnd->bnqgs", qg.float(),
                     k.float()) / math.sqrt(hd)
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(mask[None, None, :, None, :], s,
                        torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    del s                                # (B, KV, Sq, G, Sk): the big one
    out = torch.einsum("bnqgs,bsnd->bnqgd", p, v)        # (B, KV, Sq, G, hd)
    out = out.permute(0, 2, 1, 3, 4).reshape(B, Sq, H, hd)
    return out.to(q.dtype)


def attn_init(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = dtype_of(cfg)
    return {
        "wq": dense_init(gen, d, (d, H, hd), dt, device),
        "wk": dense_init(gen, d, (d, KV, hd), dt, device),
        "wv": dense_init(gen, d, (d, KV, hd), dt, device),
        "wo": dense_init(gen, H * hd, (H, hd, d), dt, device),
    }


def _attend(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, *, causal: bool) -> torch.Tensor:
    """The JAX package's dispatch, for the calls the trunk makes (no
    cache, no offset, no softcap):

    - ``xla_naive``, or at most 256 x 256 scores: naive attention;
    - ``pallas``: ``ops.flash_attention`` (the kernel on the card, its
      plain version on the CPU);
    - anything else (``xla_flash``): naive attention.  The JAX package
      runs its chunked ``flash_attention_xla`` there, the same function
      blocked for memory; the port has not got it yet.
    """
    if cfg.attn_impl == "pallas" and q.shape[1] * k.shape[1] > 256 * 256:
        from repro_torch.kernels import ops as kops
        return kops.flash_attention(q, k, v, causal=causal)
    return naive_attention(q, k, v, causal=causal)


def attention_block(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                    causal: bool = True) -> torch.Tensor:
    """QKV projection + attention (``_attend``) + output projection (no
    KV cache, no rope: the filter trunk's configuration)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    kk = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    vv = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    out = _attend(cfg, q, kk, vv, causal=causal)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]).to(x.dtype)


def mlp_init(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    d, f, dt = cfg.d_model, cfg.d_ff, dtype_of(cfg)
    return {"wi": dense_init(gen, d, (d, f), dt, device),
            "wo": dense_init(gen, f, (f, d), dt, device),
            "wg": dense_init(gen, d, (d, f), dt, device)}


def apply_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Gated SiLU MLP: silu(x wg) * (x wi), then wo."""
    h = torch.einsum("bsd,df->bsf", x, p["wi"])
    h = F.silu(torch.einsum("bsd,df->bsf", x, p["wg"])) * h
    return torch.einsum("bsf,fd->bsd", h, p["wo"]).to(x.dtype)
