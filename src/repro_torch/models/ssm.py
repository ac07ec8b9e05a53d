"""RWKV-6 ("Finch") time-mix and channel-mix, in plain PyTorch.

The JAX package's ``models/ssm.py`` RWKV-6 half: parameters in the same
tree and layouts (``mu`` (5, d), square mixing matrices (d, d), the decay
LoRA ``wa`` (d, 32) / ``wb`` (32, d), float32 ``w0`` and ``u``), so
weights carry across with a tree map.  The WKV recurrence runs either as
``rwkv_chunk_scan`` (the JAX package's chunked formulation, what
``attn_impl != "pallas"`` runs) or through ``ops.rwkv6_scan`` (the CUDA
kernel on the card, its sequential plain version on the CPU).  Mamba is
not ported.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, dtype_of

Params = Dict[str, Any]

RWKV_CHUNK = 32
DECAY_CLAMP = 2.0
LORA_RANK = 32


def rwkv_init(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    d, f, dt = cfg.d_model, cfg.d_ff, dtype_of(cfg)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    def dense(d_in, shape):
        return dense_init(gen, d_in, shape, dt, device)

    return {
        # time-mix
        "mu": full((5, d), 0.5, dt),            # r,k,v,w,g token-shift mix
        "wr": dense(d, (d, d)),
        "wk": dense(d, (d, d)),
        "wv": dense(d, (d, d)),
        "wg": dense(d, (d, d)),
        "w0": full((d,), -0.6, torch.float32),   # decay bias
        "wa": dense(d, (d, LORA_RANK)),
        "wb": dense(LORA_RANK, (LORA_RANK, d)),
        "u": full((d,), 0.0, torch.float32),     # per-channel bonus
        "wo": dense(d, (d, d)),
        "ln_w": full((d,), 1.0, dt), "ln_b": full((d,), 0.0, dt),
        # channel-mix
        "mu_ck": full((d,), 0.5, dt),
        "mu_cr": full((d,), 0.5, dt),
        "wck": dense(d, (d, f)),
        "wcv": dense(f, (f, d)),
        "wcr": dense(d, (d, d)),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """xx[t] = x[t-1]; position 0 takes ``prev`` (decode state) or zeros."""
    prev = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None, :]
    return torch.cat([prev, x[:, :-1]], dim=1)


def _rwkv_decay(p: Params, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent per-channel log-decay, clamped to [-DECAY_CLAMP, ~0)."""
    lora = torch.einsum("bsd,dr->bsr", xw, p["wa"])
    lora = torch.einsum("bsr,rd->bsd", torch.tanh(lora), p["wb"])
    raw = p["w0"].float() + lora.float()
    lw = -torch.exp(torch.clamp(raw, -20.0, math.log(DECAY_CLAMP)))
    return torch.clamp(lw, -DECAY_CLAMP, -1e-6)


def rwkv_chunk_scan(r, k, v, lw, u, state, chunk: int = RWKV_CHUNK):
    """Chunked RWKV-6 WKV recurrence (the JAX package's formulation).

    r, k, v, lw: (B, H, T, K); u: (H, K); state: (B, H, K, V).  Returns
    (out (B, H, T, V) float32, new state (B, H, K, V) float32).  Within a
    chunk the interactions are (c, c) products of decay-scaled r and k; a
    Python loop over chunks carries the state (``lax.scan`` in JAX).
    """
    B, H, T, K = r.shape
    chunk = min(chunk, T)
    while T % chunk:
        chunk -= 1
    tri_strict = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                       device=r.device), diagonal=-1)
    uf = u.float()
    S = state.float()
    outs = []
    for c0 in range(0, T, chunk):
        rb, kb, vb, wb = (a[:, :, c0:c0 + chunk].float()
                          for a in (r, k, v, lw))
        Lc = torch.cumsum(wb, dim=-2)                     # (B,H,c,K)
        Lprev = Lc - wb                                   # exclusive cumsum
        r_in = rb * torch.exp(Lprev)
        k_out = kb * torch.exp(-Lc)
        A = torch.einsum("bhck,bhdk->bhcd", r_in, k_out)  # (B,H,c,c)
        A = torch.where(tri_strict, A, torch.zeros((), device=A.device))
        diag = torch.einsum("bhck,hk,bhck->bhc", rb, uf, kb)
        out = torch.einsum("bhcd,bhdv->bhcv", A, vb)
        out = out + diag[..., None] * vb
        out = out + torch.einsum("bhck,bhkv->bhcv", r_in, S)
        Llast = Lc[..., -1:, :]                           # (B,H,1,K)
        k_in = kb * torch.exp(Llast - Lc)
        S = S * torch.exp(Llast[..., 0, :])[..., None] + \
            torch.einsum("bhck,bhcv->bhkv", k_in, vb)
        outs.append(out)
    return torch.cat(outs, dim=2), S


def rwkv_time_mix(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[Params] = None, use_kernel: bool = False
                  ) -> Tuple[torch.Tensor, Optional[Params]]:
    """RWKV-6 attention replacement. x: (B, S, D)."""
    B, S, D = x.shape
    H, K = cfg.n_rwkv_heads, cfg.rwkv_head_dim
    xx = _token_shift(x, None if state is None else state["shift_tm"])
    mix = x[:, None] + (xx - x)[:, None] * p["mu"][None, :, None, :]
    xr, xk, xv, xw, xg = mix.unbind(1)                   # (B, S, D) each
    r = torch.einsum("bsd,de->bse", xr, p["wr"]).reshape(B, S, H, K)
    k = torch.einsum("bsd,de->bse", xk, p["wk"]).reshape(B, S, H, K)
    v = torch.einsum("bsd,de->bse", xv, p["wv"]).reshape(B, S, H, K)
    g = F.silu(torch.einsum("bsd,de->bse", xg, p["wg"]))
    lw = _rwkv_decay(p, xw).reshape(B, S, H, K)
    u = p["u"].reshape(H, K)

    S0 = (state["wkv"] if state is not None else
          torch.zeros((B, H, K, K), dtype=torch.float32, device=x.device))
    rt, kt, vt, wt = (a.transpose(1, 2) for a in (r, k, v, lw))
    if use_kernel:
        from repro_torch.kernels import ops as kops
        out, S_new = kops.rwkv6_scan(rt, kt, vt, wt, u, S0)
    else:
        out, S_new = rwkv_chunk_scan(rt, kt, vt, wt, u, S0)
    out = out.transpose(1, 2)                            # (B, S, H, K)

    # per-head group norm (population variance), then gate and project
    mu_ = out.mean(-1, keepdim=True)
    var = out.var(-1, keepdim=True, correction=0)
    out = ((out - mu_) * torch.rsqrt(var + 64e-5)).reshape(B, S, D)
    out = out * p["ln_w"].to(out.dtype) + p["ln_b"].to(out.dtype)
    out = (out * g).to(x.dtype)
    out = torch.einsum("bsd,de->bse", out, p["wo"])

    new_state = None
    if state is not None:
        new_state = dict(state)
        new_state["wkv"] = S_new
        new_state["shift_tm"] = x[:, -1]
    return out.to(x.dtype), new_state


def rwkv_channel_mix(p: Params, x: torch.Tensor,
                     state: Optional[Params] = None
                     ) -> Tuple[torch.Tensor, Optional[Params]]:
    xx = _token_shift(x, None if state is None else state["shift_cm"])
    xk = x + (xx - x) * p["mu_ck"]
    xr = x + (xx - x) * p["mu_cr"]
    kk = torch.square(torch.relu(torch.einsum("bsd,df->bsf", xk, p["wck"])))
    out = torch.sigmoid(torch.einsum("bsd,de->bse", xr, p["wcr"])) * \
        torch.einsum("bsf,fd->bsd", kk, p["wcv"])
    new_state = None
    if state is not None:
        new_state = dict(state)
        new_state["shift_cm"] = x[:, -1]
    return out.to(x.dtype), new_state


def rwkv_state_init(cfg: ModelConfig, batch: int, device=None) -> Params:
    H, K = cfg.n_rwkv_heads, cfg.rwkv_head_dim
    dt = dtype_of(cfg)
    return {
        "wkv": torch.zeros((batch, H, K, K), dtype=torch.float32,
                           device=device),
        "shift_tm": torch.zeros((batch, cfg.d_model), dtype=dt,
                                device=device),
        "shift_cm": torch.zeros((batch, cfg.d_model), dtype=dt,
                                device=device),
    }
