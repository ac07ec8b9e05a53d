"""RWKV-6 ("Finch") and Mamba (S6), in plain PyTorch.

The JAX package's ``models/ssm.py``: parameters in the same trees and
layouts (RWKV-6: ``mu`` (5, d), square mixing matrices (d, d), the decay
LoRA ``wa`` (d, 32) / ``wb`` (32, d), float32 ``w0`` and ``u``; Mamba:
``in_proj`` (d, 2 d_inner), ``conv_w`` (width, d_inner), float32
``dt_bias``, ``A_log`` and ``D_skip``), so weights carry across with a
tree map.  The WKV recurrence runs either as ``rwkv_chunk_scan`` (the
JAX package's chunked formulation, what ``attn_impl != "pallas"`` runs)
or through ``ops.rwkv6_scan`` (the CUDA kernel on the card, its
sequential plain version on the CPU).  Mamba's selective scan has no
Pallas kernel in the JAX package and stays plain torch here:
``mamba_scan`` runs the JAX package's chunks, an inclusive scan inside
each (log2(chunk) doubling steps in place of ``lax.associative_scan``)
and a Python loop over the chunks (``lax.scan``).  Under a sharding plan
both scans run on each rank's chunk (``layers.local_call``): the WKV
scan on its batch rows and heads, the Mamba scan on its batch rows and
its slice of d_inner; the recurrent states keep the cache's placement.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.distributed.ctx import is_dtensor
from repro_torch.models.layers import (dense_init, dtype_of, like,
                                      local_call, product, summed)

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


def rwkv_axes(cfg: ModelConfig) -> Params:
    dd = ("embed", "heads_d")      # square mixing mats: shard output dim
    return {
        "mu": (None, "embed"), "wr": dd, "wk": dd, "wv": dd, "wg": dd,
        "w0": ("embed",), "wa": ("embed", None), "wb": (None, "embed"),
        "u": ("embed",), "wo": ("heads_d", "embed"),
        "ln_w": ("embed",), "ln_b": ("embed",),
        "mu_ck": ("embed",), "mu_cr": ("embed",),
        "wck": ("embed", "mlp"), "wcv": ("mlp", "embed"),
        "wcr": ("embed", "heads_d"),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """xx[t] = x[t-1]; position 0 takes ``prev`` (decode state) or zeros."""
    prev = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None, :]
    return torch.cat([prev, x[:, :-1]], dim=1)


def _rwkv_decay(p: Params, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent per-channel log-decay, clamped to [-DECAY_CLAMP, ~0)."""
    lora = product("bsd,dr->bsr", xw, p["wa"], {1: 2})
    lora = product("bsr,rd->bsd", torch.tanh(lora), p["wb"], {1: 2})
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
    # the five token-shift mixes one by one (the same arithmetic as one
    # (B, 5, S, D) tensor, which DTensor may split on its mix axis)
    dx = xx - x
    xr, xk, xv, xw, xg = (x + dx * p["mu"][i] for i in range(5))
    r, k, v, g = (product("bsd,de->bse", a, p[w], {1: 2})
                  for a, w in ((xr, "wr"), (xk, "wk"), (xv, "wv"),
                               (xg, "wg")))
    r, k, v, lw = (_split_heads(a, H, K)
                   for a in (r, k, v, _rwkv_decay(p, xw)))
    g = F.silu(g)
    u = _split_heads(p["u"], H, K)

    rt, kt, vt, wt = (a.transpose(1, 2) for a in (r, k, v, lw))
    if use_kernel:
        from repro_torch.kernels import ops as kops
        scan = kops.rwkv6_scan
    else:
        scan = rwkv_chunk_scan

    def wkv(r, k, v, w, u, S0=None):
        if S0 is None:
            S0 = torch.zeros(r.shape[:2] + (K, K), dtype=torch.float32,
                             device=r.device)
        return scan(r, k, v, w, u, S0)

    # under a sharding plan each rank scans its batch rows and heads
    lay = _scan_layout(rt, H)
    out, S_new = local_call(
        wkv, rt, kt, vt, wt, u,
        *(() if state is None else (state["wkv"],)), layout=lay,
        layouts=(None,) * 4 + (_heads_only(lay), None))
    out = out.transpose(1, 2)                            # (B, S, H, K)

    # per-head group norm (population variance), then gate and project
    mu_ = out.mean(-1, keepdim=True)
    var = out.var(-1, keepdim=True, correction=0)
    out = ((out - mu_) * torch.rsqrt(var + 64e-5)).reshape(B, S, D)
    out = out * p["ln_w"].to(out.dtype) + p["ln_b"].to(out.dtype)
    # the gate laid out as the heads are (whole where their split misses
    # whole heads: a gradient split there could not be viewed as heads)
    out = (out * like(g, out)).to(x.dtype)
    out = product("bsd,de->bse", out, p["wo"], {1: 2}, (2, 0))

    new_state = None
    if state is not None:
        new_state = dict(state)
        new_state["wkv"] = like(S_new, state["wkv"])
        new_state["shift_tm"] = like(x[:, -1], state["shift_tm"])
    return out.to(x.dtype), new_state


def _split_heads(t: torch.Tensor, H: int, K: int) -> torch.Tensor:
    """(..., H K) -> (..., H, K).  Under a sharding plan a split of the
    last dimension that does not fall on whole heads (rwkv6-3b's 40
    heads over 16 model ranks) is gathered first: DTensor cannot view
    it as heads."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard
        last = Shard(t.ndim - 1)
        pl = tuple(Replicate() if p in (last, Shard(-1)) and
                   H % t.device_mesh.size(i) else p
                   for i, p in enumerate(t.placements))
        if pl != tuple(t.placements):
            t = t.redistribute(t.device_mesh, pl)
    return t.reshape(t.shape[:-1] + (H, K))


def _scan_layout(r, n_heads: int):
    """Placements of the WKV scan's (B, H, T, K) inputs under a sharding
    plan: r's split of the batch, and of the heads where the ranks
    divide them; replicated otherwise.  None for a plain ``r``."""
    if not is_dtensor(r):
        return None
    from torch.distributed.tensor import Replicate, Shard
    return tuple(p if p == Shard(0) or (
        p == Shard(1) and n_heads % r.device_mesh.size(i) == 0)
        else Replicate() for i, p in enumerate(r.placements))


def _heads_only(lay):
    """The bonus ``u`` (H, K) laid out as the scan's heads."""
    if lay is None:
        return None
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(0) if p == Shard(1) else Replicate() for p in lay)


def rwkv_channel_mix(p: Params, x: torch.Tensor,
                     state: Optional[Params] = None
                     ) -> Tuple[torch.Tensor, Optional[Params]]:
    xx = _token_shift(x, None if state is None else state["shift_cm"])
    xk = x + (xx - x) * p["mu_ck"]
    xr = x + (xx - x) * p["mu_cr"]
    kk = torch.square(torch.relu(product("bsd,df->bsf", xk, p["wck"],
                                         {1: 2})))
    out = torch.sigmoid(product("bsd,de->bse", xr, p["wcr"], {1: 2})) * \
        product("bsf,fd->bsd", kk, p["wcv"], {1: 2}, (2, 0))
    new_state = None
    if state is not None:
        new_state = dict(state)
        new_state["shift_cm"] = like(x[:, -1], state["shift_cm"])
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


# ==========================================================================
# Mamba (S6) — used by the Hymba hybrid block
# ==========================================================================

def mamba_init(gen: torch.Generator, cfg: ModelConfig, device=None
               ) -> Params:
    """Drawn in the JAX package's key order: in_proj, conv_w, x_proj,
    dt_proj, out_proj."""
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dtr = max(16, d // 16)
    dt = dtype_of(cfg)
    in_proj = dense_init(gen, d, (d, 2 * di), dt, device)
    conv_w = _conv_init(gen, cfg.ssm_conv, di, dt, device)
    x_proj = dense_init(gen, di, (di, dtr + 2 * N), dt, device)
    dt_proj = dense_init(gen, dtr, (dtr, di), dt, device)
    out_proj = dense_init(gen, di, (di, d), dt, device)
    a = torch.arange(1, N + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros(di, dtype=dt, device=device),
        "x_proj": x_proj,
        "dt_proj": dt_proj,
        "dt_bias": torch.full((di,), -4.0, dtype=torch.float32,
                              device=device),    # softplus -> small dt
        "A_log": torch.log(a.repeat(di, 1)),
        "D_skip": torch.ones(di, dtype=torch.float32, device=device),
        "out_proj": out_proj,
    }


def mamba_axes(cfg: ModelConfig) -> Params:
    return {
        "in_proj": ("embed", "inner2"), "conv_w": (None, "inner"),
        "conv_b": ("inner",), "x_proj": ("inner", None),
        "dt_proj": (None, "inner"), "dt_bias": ("inner",),
        "A_log": ("inner", None), "D_skip": ("inner",),
        "out_proj": ("inner", "embed"),
    }


def _conv_init(gen: torch.Generator, width: int, di: int, dt,
               device=None) -> torch.Tensor:
    x = torch.randn((width, di), generator=gen, dtype=torch.float32,
                    device=gen.device) / math.sqrt(width)
    return x.to(device=device, dtype=dt)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Depthwise causal conv via K shifted adds. x: (B, S, di), w: (K, di);
    ``state``: the previous (B, K - 1, di) inputs, zeros when None.
    Returns (out, the last K - 1 inputs)."""
    Kw = w.shape[0]
    pad = torch.zeros_like(x[:, :Kw - 1]) if state is None \
        else state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(Kw))
    new_state = xp[:, -(Kw - 1):] if Kw > 1 else None
    return out + b, new_state


def mamba_scan(a: torch.Tensor, b: torch.Tensor, C: torch.Tensor,
               h0: torch.Tensor, chunk: int = 64
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked scan. a, b: (B, T, di, N); C: (B, T, N); h0: (B, di, N).

    h_t = a_t * h_{t-1} + b_t ;  y_t = sum_N h_t * C_t.  The chunk is the
    JAX package's (``min(chunk, T)``, lowered until it divides T), so a
    prime T runs chunks of one.  Inside a chunk, an inclusive scan of
    (a, b) under (al, bl) . (ar, br) = (al ar, bl ar + br): each doubling
    step combines every element with the one ``shift`` before it, written
    into the other of two buffers (no concatenation).  Where an input
    needs a gradient (training), each step is the same arithmetic built
    out of place by concatenation, which autograd can differentiate.
    Returns (y (B, T, di), h_T)."""
    B, T, di, N = a.shape
    chunk = min(chunk, T)
    while T % chunk:
        chunk -= 1
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (a, b, C, h0))
    bufs = None
    if chunk > 1 and not grad:
        bufs = [(torch.empty_like(a[:, :chunk]), torch.empty_like(
            b[:, :chunk])) for _ in range(2)]
    h, ys = h0, []
    for c0 in range(0, T, chunk):
        acum, bcum = a[:, c0:c0 + chunk], b[:, c0:c0 + chunk]
        shift, i = 1, 0
        while shift < chunk:
            if grad:
                acum, bcum = (
                    torch.cat([acum[:, :shift],
                               acum[:, :-shift] * acum[:, shift:]], 1),
                    torch.cat([bcum[:, :shift], torch.addcmul(
                        bcum[:, shift:], bcum[:, :-shift],
                        acum[:, shift:])], 1))
                shift *= 2
                continue
            da, db = bufs[i]
            da[:, :shift] = acum[:, :shift]
            db[:, :shift] = bcum[:, :shift]
            torch.mul(acum[:, :-shift], acum[:, shift:], out=da[:, shift:])
            torch.addcmul(bcum[:, shift:], bcum[:, :-shift],
                          acum[:, shift:], out=db[:, shift:])
            acum, bcum, shift, i = da, db, shift * 2, 1 - i
        hs = torch.addcmul(bcum, acum, h[:, None])           # (B,c,di,N)
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, C[:, c0:c0 + chunk]))
        h = hs[:, -1]
    return torch.cat(ys, dim=1), h


def mamba_block(p: Params, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[Params] = None
                ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Selective SSM. x: (B, S, D) -> (out (B, S, D), the new {"ssm",
    "conv"} state, or None without a state)."""
    B, S, D = x.shape
    di, N = cfg.d_inner, cfg.ssm_state
    dtr = p["dt_proj"].shape[0]
    xz = product("bsd,de->bse", x, p["in_proj"], {1: 2})
    xi, z = xz.chunk(2, dim=-1)
    xi, new_conv = _causal_conv(xi, p["conv_w"], p["conv_b"],
                                None if state is None else state["conv"])
    xi = F.silu(xi)

    # the small (dt_rank + 2N) projection whole on every rank where
    # d_inner is split: its partial sums reduced
    proj = summed(product("bsd,de->bse", xi, p["x_proj"], {}, (2, 0)))
    dt_lo, Bm, Cm = torch.split(proj, [dtr, N, N], dim=-1)
    dt = F.softplus(product("bsr,rd->bsd", dt_lo, p["dt_proj"], {1: 2})
                    .float() + p["dt_bias"])              # (B,S,di)
    A = -torch.exp(p["A_log"])                            # (di,N)
    a = torch.exp(dt[..., None] * A)                      # (B,S,di,N)
    b = (dt * xi.float())[..., None] * Bm.float()[..., None, :]

    def scan(a, b, C, h0=None):
        if h0 is None:
            h0 = torch.zeros((a.shape[0],) + a.shape[2:], dtype=torch.float32,
                             device=a.device)
        return mamba_scan(a, b, C, h0)

    # under a sharding plan each rank scans its batch rows and its slice
    # of d_inner (``mamba_axes``' "inner")
    lay = _inner_layout(a, p["conv_b"])
    st = None if lay is None else _dims(lay, {2: 1})
    y, h = local_call(scan, a, b, Cm.float(),
                      *(() if state is None else (state["ssm"],)),
                      layout=lay, layouts=(None, None, _dims(lay, {}), st),
                      out_layouts=(lay, st))
    del a, b
    y = y + p["D_skip"] * xi.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    out = product("bsd,de->bse", y, p["out_proj"], {1: 2}, (2, 0))
    new_state = None if state is None else {"ssm": h, "conv": new_conv}
    return out.to(x.dtype), new_state


def _inner_layout(a, conv_b):
    """Placements of the Mamba scan's (B, T, d_inner, N) inputs under a
    sharding plan: a's split of the batch, and d_inner split as the
    parameters' "inner" axis is; replicated otherwise.  None for a plain
    ``a``."""
    if not is_dtensor(a):
        return None
    from torch.distributed.tensor import Replicate, Shard
    inner = conv_b.placements if is_dtensor(conv_b) else ()
    return tuple(Shard(0) if p == Shard(0) else
                 Shard(2) if i < len(inner) and inner[i] == Shard(0)
                 else Replicate() for i, p in enumerate(a.placements))


def _dims(lay, moves):
    """``lay`` with the split of dimension d moved to ``moves[d]``
    (dropped where d is not in ``moves``; the batch's stays)."""
    if lay is None:
        return None
    from torch.distributed.tensor import Replicate, Shard
    return tuple(p if p == Shard(0) else
                 Shard(moves[p.dim]) if isinstance(p, Shard) and p.dim in moves
                 else Replicate() for p in lay)


def mamba_state_init(cfg: ModelConfig, batch: int, device=None) -> Params:
    return {
        "ssm": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                            dtype=dtype_of(cfg), device=device),
    }
