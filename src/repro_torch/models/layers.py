"""The neural layers of the ported models, in plain PyTorch.

The JAX package's ``models/layers.py`` (the RWKV-6 and Mamba blocks live
in ``ssm.py``): RMSNorm and LayerNorm, SiLU / GELU (tanh) / ReLU, rope
and sinusoidal positions, the masks (with the PaliGemma prefix-LM) and
the two plain attentions (``naive_attention`` and the chunked
online-softmax ``flash_attention_xla``), the attention block with its
contiguous and ring KV caches and cross-attention, the MLP with or
without its gate, and the mixture-of-experts block (sort-based capacity
routing per token group, the Switch aux loss).  Parameters are plain
dicts of tensors in the JAX package's layouts (``wq`` (d, H, hd), ``bq``
(H, hd), ``wo`` (H, hd, d), the experts' ``wi`` (E, d, f), ...), so
weights carry across with a tree map.  Initializers draw from an
explicit ``torch.Generator``.

Three things differ from the JAX package by design:

- **The cache is written in place.**  ``attention_block`` writes the new
  k / v rows (and a ring cache's positions) into the tensors it is given
  and returns them; nothing copies the cache.  The write position stays
  on the device (``index_copy_`` at ``len``, clamped as
  ``lax.dynamic_update_slice`` clamps), so a decode step never waits for
  the card.
- **One call goes to the decode-attention kernel.**  Under
  ``attn_impl="pallas"`` the single-token call on a contiguous cache (S
  == 1, no ``"pos"``, no softcap, no sliding window) runs
  ``ops.decode_attention(q[:, 0], k, v, kv_len=len + 1)``: one query at
  position ``len`` over keys ``0..len``, the function JAX's
  ``naive_attention`` computes there.  Under ``ctx.decode_shard`` (a
  mesh) JAX's routing holds instead: the call goes to
  ``distributed.serve_attention.sharded_decode_attention``, not to the
  kernel.  The condition is about the function: a CPU tensor reaches the
  plain version, and a shape the kernel does not take raises on the
  card.  Every other call follows JAX's ``_attend`` dispatch.

- **The MoE combine sums each token's slots in order.**  JAX adds the
  expert outputs into the tokens with a scatter-add; on the card an
  ``index_add_`` would accumulate in no fixed order.  ``apply_moe``
  instead sums each token's (at most K) kept slots in buffer order from
  zero, in the activation dtype: the order the CPU scatter takes, and
  the same bits on every run.  Routing uses fixed-shape ops only, so no
  layer waits for the card.

Under a sharding plan (``train/step.py``'s ``ShardPlan``) parameters,
activations and caches are DTensors: ``ctx.constrain`` lays activations
out split on the batch around each layer, after the embedding and on
the MoE token groups, as JAX does.  The products with weights are laid
out as JAX's partitioner lays them out (``product``: FSDP gathers, each
rank its batch rows and whole heads; contracted splits as partial
sums), and so is the embedding lookup (``lookup``: each rank its slice
of the vocabulary).  Attention, with or without a cache, runs on each
rank's chunk of the batch and of the heads (``local_call``), the heads
kept split where the split falls on whole KV groups; with a cache q /
k / v are constrained to the batch split only where DTensor cannot view
the heads' split as (KV, G).  MoE routing and its combine run on each
rank's token groups, the experts' MLPs on each rank's experts.  Cache
writes (a ring's positions too) and the kernels' wrappers also run on
each rank's local chunk (``_dyn_update``, ``local_call``).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import ctx
from repro_torch.models.config import Activation, ModelConfig

Params = Dict[str, Any]

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


# --------------------------------------------------------------------------
# dtype / init helpers
# --------------------------------------------------------------------------

def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _normal(gen: torch.Generator, shape, scale: float, dtype,
            device=None) -> torch.Tensor:
    """Normal init drawn on the generator's device, then moved, so one
    seed gives the same weights on every device.  On ``meta`` (shapes
    only) nothing is drawn and the generator does not advance."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device) * scale
    return x.to(device=device, dtype=dtype)


def dense_init(gen: torch.Generator, d_in: int, shape, dtype,
               device=None) -> torch.Tensor:
    """Fan-in scaled normal init (same shapes and scale as the JAX
    package's ``dense_init``)."""
    return _normal(gen, shape, 1.0 / math.sqrt(max(d_in, 1)), dtype, device)


def activation_fn(act: Activation):
    return {Activation.SILU: F.silu,
            Activation.GELU: functools.partial(F.gelu, approximate="tanh"),
            Activation.RELU: F.relu}[act]


# --------------------------------------------------------------------------
# Normalisation
# --------------------------------------------------------------------------

def norm_init(cfg: ModelConfig, device=None) -> Params:
    p = {"w": torch.ones(cfg.d_model, dtype=dtype_of(cfg), device=device)}
    if cfg.layernorm:
        p["b"] = torch.zeros(cfg.d_model, dtype=dtype_of(cfg), device=device)
    return p


def norm_axes(cfg: ModelConfig) -> Params:
    a = {"w": ("embed",)}
    if cfg.layernorm:
        a["b"] = ("embed",)
    return a


def apply_norm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm where ``p`` has a bias ``b``, else RMSNorm; in float32."""
    xf = x.float()
    if "b" in p:
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * p["w"].float() + p["b"].float()).to(x.dtype)
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * p["w"].float()).to(x.dtype)


# --------------------------------------------------------------------------
# Rotary / sinusoidal position embeddings
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of the rope angles at ``positions`` (..., S), float32,
    shaped (..., S, 1, hd/2) to broadcast over heads.  ``forward``
    computes them once and every layer's q and k share them."""
    ang = positions[..., :, None].float() * rope_freqs(head_dim, theta,
                                                       positions.device)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  Rotate
    half over the split halves, in float32, cast back."""
    return rotate_half(x, *rope_tables(positions, x.shape[-1], theta))


def rotate_half(x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
    """Rope by precomputed tables (``rope_tables``), in float32."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoid_pos(seq_len: int, d_model: int, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32,
                       device=device)[None, :]
    ang = pos / 10000.0 ** (dim / d_model)
    pe = torch.zeros((seq_len, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe.to(dtype)


# --------------------------------------------------------------------------
# Attention: masks, the naive and the chunked (flash) plain versions
# --------------------------------------------------------------------------

def _chunk_mask(q_pos, k_pos, *, causal, sliding_window, prefix_len,
                k_valid=None):
    """Boolean (Sq, Sk) mask: True = attend."""
    m = torch.ones(q_pos.shape + k_pos.shape, dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        c = q_pos[:, None] >= k_pos[None, :]
        if prefix_len:
            c = c | (k_pos[None, :] < prefix_len)      # PaliGemma prefix-LM
        m = m & c
    if sliding_window is not None:
        m = m & (q_pos[:, None] - k_pos[None, :] < sliding_window)
    if k_valid is not None:
        m = m & k_valid[None, :]
    return m


def flash_attention_xla(
    q: torch.Tensor,                # (B, Sq, H, hd)
    k: torch.Tensor,                # (B, Sk, KV, hd)
    v: torch.Tensor,                # (B, Sk, KV, hd)
    *,
    causal: bool = True,
    chunk: int = 512,
    n_macro: int = 8,
    sliding_window: Optional[int] = None,
    prefix_len: int = 0,
    q_offset=0,
    kv_len: Optional[torch.Tensor] = None,   # valid kv length (decode)
    kv_pos: Optional[torch.Tensor] = None,   # explicit kv positions (ring)
    softcap: float = 0.0,
) -> torch.Tensor:
    """Macro-blocked online-softmax attention, the JAX package's XLA path.

    ``n_macro`` q blocks, each scanning its kv in ``chunk``-row blocks
    with a running max, sum and accumulator (float32).  With an int
    ``q_offset`` each block skips the kv chunks that the causal mask and
    the sliding window leave wholly masked; with a tensor offset (a
    cached prefill) the caller passes one macro block.  ``chunk`` shrinks
    until it divides Sk, as in the JAX package, so both sum in the same
    blocks."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, KV, G, hd)

    n_macro = max(1, min(n_macro, Sq))
    while Sq % n_macro:
        n_macro -= 1
    mq = Sq // n_macro
    chunk = min(chunk, Sk)
    while Sk % chunk:
        chunk -= 1
    static_offset = q_offset if isinstance(q_offset, int) else None
    neg = torch.full((), NEG_INF, device=q.device)

    def one_macro(qi: int) -> torch.Tensor:
        qb = qg[:, qi * mq:(qi + 1) * mq].float()             # (B,mq,KV,G,hd)
        q_pos = q_offset + qi * mq + torch.arange(mq, device=q.device)
        if causal and kv_len is None and static_offset is not None:
            hi = min(Sk, ((static_offset + (qi + 1) * mq + chunk - 1)
                          // chunk) * chunk)
        else:
            hi = Sk
        lo = 0
        if sliding_window is not None and prefix_len == 0 and \
                static_offset is not None:
            lo = max(0, ((static_offset + qi * mq - sliding_window)
                         // chunk) * chunk)
        m = torch.full((B, KV, mq, G), NEG_INF, device=q.device)
        l = torch.zeros((B, KV, mq, G), device=q.device)
        acc = torch.zeros((B, KV, mq, G, hd), device=q.device)
        for c0 in range(lo, hi, chunk):
            kc, vc = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
            if kv_pos is not None:
                k_pos = kv_pos[c0:c0 + chunk]
                k_valid = k_pos >= 0
            else:
                k_pos = torch.arange(c0, c0 + chunk, device=q.device)
                k_valid = None
            s = torch.einsum("bqngd,bsnd->bnqgs", qb, kc.float()) * scale
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            mask = _chunk_mask(q_pos, k_pos, causal=causal,
                               sliding_window=sliding_window,
                               prefix_len=prefix_len, k_valid=k_valid)
            if kv_len is not None and kv_pos is None:
                mask = mask & (k_pos[None, :] < kv_len)
            # s: (B, KV, mq, G, chunk); the mask broadcasts over B, KV, G
            s = torch.where(mask[None, None, :, None, :], s, neg)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bnqgs,bsnd->bnqgd", p.to(vc.dtype).float(), vc.float())
            m = m_new
            del s, p
        out = acc / torch.clamp(l, min=1e-30)[..., None]       # (B,KV,mq,G,hd)
        return out.permute(0, 2, 1, 3, 4).reshape(B, mq, H, hd)

    outs = [one_macro(i) for i in range(n_macro)]
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out.to(q.dtype)


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sliding_window: Optional[int] = None,
                    prefix_len: int = 0, q_offset=0, kv_len=None,
                    kv_pos=None, softcap: float = 0.0) -> torch.Tensor:
    """Full-softmax attention as plain einsums.

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) -> (B, Sq, H, hd).  Scores
    and the softmax are float32; the probabilities are cast to ``v``'s
    dtype before the product with ``v``."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqngd,bsnd->bnqgs", qg.float(),
                     k.float()) / math.sqrt(hd)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    if causal or sliding_window is not None or kv_len is not None \
            or kv_pos is not None:       # else all True: skip the where
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        k_pos = torch.arange(Sk, device=q.device) if kv_pos is None \
            else kv_pos
        k_valid = None if kv_pos is None else kv_pos >= 0
        mask = _chunk_mask(q_pos, k_pos, causal=causal,
                           sliding_window=sliding_window,
                           prefix_len=prefix_len, k_valid=k_valid)
        if kv_len is not None and kv_pos is None:
            mask = mask & (k_pos[None, :] < kv_len)
        s = torch.where(mask[None, None, :, None, :], s,
                        torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    del s                                # (B, KV, Sq, G, Sk): the big one
    out = torch.einsum("bnqgs,bsnd->bnqgd", p, v)        # (B, KV, Sq, G, hd)
    out = out.permute(0, 2, 1, 3, 4).reshape(B, Sq, H, hd)
    return out.to(q.dtype)


# --------------------------------------------------------------------------
# Attention block (QKV proj + rope + attend + out proj), with KV cache
# --------------------------------------------------------------------------

def attn_init(gen: torch.Generator, cfg: ModelConfig, cross: bool = False,
              device=None) -> Params:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = dtype_of(cfg)
    p = {
        "wq": dense_init(gen, d, (d, H, hd), dt, device),
        "wk": dense_init(gen, d, (d, KV, hd), dt, device),
        "wv": dense_init(gen, d, (d, KV, hd), dt, device),
        "wo": dense_init(gen, H * hd, (H, hd, d), dt, device),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros((H, hd), dtype=dt, device=device)
        p["bk"] = torch.zeros((KV, hd), dtype=dt, device=device)
        p["bv"] = torch.zeros((KV, hd), dtype=dt, device=device)
    return p


def attn_axes(cfg: ModelConfig, cross: bool = False) -> Params:
    a = {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }
    if cfg.qkv_bias and not cross:
        a["bq"] = ("heads", "head_dim")
        a["bk"] = ("kv_heads", "head_dim")
        a["bv"] = ("kv_heads", "head_dim")
    return a


def attention_block(
    p: Params,
    x: torch.Tensor,                     # (B, S, D)
    cfg: ModelConfig,
    *,
    causal: bool = True,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[Params] = None,      # {"k","v","len"(,"pos")}, in place
    kv_source: Optional[torch.Tensor] = None,   # cross-attention memory
    use_rope: Optional[bool] = None,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    prefix_len: int = 0,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Returns (y, the cache with the new rows written in place and its
    ``len`` advanced by S, or None without a cache).  ``rope`` is
    ``rope_tables(positions, ...)`` where the caller has it (``forward``
    computes it once for every layer); else it is computed here.  The
    first ``prefix_len`` positions are seen by every query (PaliGemma's
    prefix-LM)."""
    B, S, D = x.shape
    use_rope = cfg.use_rope if use_rope is None else use_rope
    src = x if kv_source is None else kv_source
    q, kk, vv = (product("bsd,dhk->bshk", a, p[w], {1: 2, 2: 3})
                 for a, w in ((x, "wq"), (src, "wk"), (src, "wv")))
    if "bq" in p:
        q, kk, vv = q + p["bq"], kk + p["bk"], vv + p["bv"]
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if use_rope and kv_source is None:
        cos, sin = rope if rope is not None else \
            rope_tables(positions, q.shape[-1], cfg.rope_theta)
        q, kk = rotate_half(q, cos, sin), rotate_half(kk, cos, sin)

    cached = cache is not None and kv_source is None
    if cached and _heads_split_past_groups(q, kk.shape[2]):
        # DTensor cannot view heads split over more ranks than there are
        # KV groups as (KV, G): split on the batch, heads whole
        q, kk, vv = (ctx.constrain(t, "attn") for t in (q, kk, vv))
    q_offset = 0
    kv_len = None
    kv_pos = None
    sw = cfg.sliding_window
    ds = ctx.get_decode_shard()
    if (ds is not None and cache is not None and kv_source is None and
            S == 1 and "pos" not in cache and
            cache["k"].shape[1] % ds["mesh"].size(
                list(ds["mesh"].mesh_dim_names).index(ds["seq_axis"]))
            == 0):
        # serving over a mesh: shard-local cache write + the softmax
        # combine across the seq axis (JAX's routing: not the kernel)
        from repro_torch.distributed.serve_attention import \
            sharded_decode_attention
        idx = cache["len"]
        out, kc, vc = sharded_decode_attention(
            q, kk, vv, cache["k"], cache["v"], idx, **ds)
        cache = {"k": kc, "v": vc, "len": idx + 1}
        y = product("bshk,hkd->bsd", out, p["wo"], {2: 2}, (2, 0))
        return y.to(x.dtype), cache
    if cached:
        idx = cache["len"]
        kc, vc = cache["k"], cache["v"]
        cap = kc.shape[1]
        if "pos" in cache:
            # ring buffer (sliding-window archs): capacity << max positions
            pc = cache["pos"]
            pl, pos_l = _whole_local(pc), _whole_local(positions)
            if S == 1:
                slot = idx % cap
                _dyn_update((kc, vc), (kk, vv), slot)
                pl.index_copy_(0, _whole_local(slot).reshape(1).long(),
                               pos_l[:1, 0].to(pc.dtype))
            else:
                # fresh prefill into a ring cache: keep the last `cap` tokens
                keep = min(S, cap)
                _dyn_update((kc, vc), (kk[:, -keep:], vv[:, -keep:]), 0)
                pl[:keep] = pos_l[0, -keep:].to(pc.dtype)
            cache = {"k": kc, "v": vc, "pos": pc, "len": idx + S}
            kk, vv, kv_pos = kc, vc, pc
        else:
            _dyn_update((kc, vc), (kk, vv), idx)
            cache = {"k": kc, "v": vc, "len": idx + S}
            kk, vv = kc, vc
            kv_len = cache["len"]
        q_offset = idx

    if (cfg.attn_impl == "pallas" and kv_len is not None and S == 1
            and sw is None and cfg.logits_softcap == 0.0):
        # one query at position len over keys 0..len: the decode kernel
        from repro_torch.kernels import ops as kops
        out = local_call(lambda a, b, c, n: kops.decode_attention(
            a[:, 0], b, c, n)[:, None], q, kk, vv, kv_len)
    elif not cached:
        # each (batch row, head) attends on its own: under a sharding
        # plan every rank runs its chunk of both, with no collective
        out = local_call(functools.partial(
            _attend, cfg, causal=causal, sliding_window=sw,
            prefix_len=prefix_len), q, kk, vv,
            layout=_qkv_layout(q, kk.shape[2]))
    else:
        # each (batch row, head) attends on its own over the cache, which
        # a sharding plan splits on the sequence: every rank runs its
        # chunk of batch rows and heads over the whole cache rows
        def cached(q, k, v, kv_len, kv_pos, q_offset):
            return _attend(cfg, q, k, v, causal=causal, kv_len=kv_len,
                           kv_pos=kv_pos, q_offset=q_offset,
                           sliding_window=sw, prefix_len=prefix_len)
        out = local_call(cached, q, kk, vv, kv_len, kv_pos, q_offset,
                         layout=_qkv_layout(q, kk.shape[2]),
                         layouts=(None,) * 4 + (_replicated(q), None))
    y = product("bshk,hkd->bsd", out, p["wo"], {2: 2}, (2, 0))
    return y.to(x.dtype), cache


def product(eq: str, x: torch.Tensor, w: torch.Tensor, out_dims,
             contract=None) -> torch.Tensor:
    """``einsum(eq, x, w)`` of activations x (B, S, ...) and a weight.

    Under a sharding plan it is laid out as JAX's partitioner lays it
    out: each rank multiplies its own batch rows, the weight gathered on
    that axis (FSDP); x's split of a contracted dimension ``contract`` =
    (x's dim, w's dim) stays, the weight split alike (x is sliced where
    it is whole and the weight split), and the ranks' products are
    partial sums; the weight's other splits stay (weight dimension j to
    output dimension ``out_dims[j]``); anything else is gathered.  The
    rules split a dimension only where the ranks divide it, so each rank
    holds whole heads: 2 KV heads are whole on every one of 16 model
    ranks.  DTensor's own einsum may instead split the flattened heads x
    head_dim, which its view back to (heads, hd) refuses, or keep a split
    that makes a rank compute twice its share."""
    if not _is_dtensor(x):
        return torch.einsum(eq, x, w)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = x.device_mesh
    x_pl, w_pl, o_pl, xg_pl, wg_pl = [], [], [], [], []
    for xp, wp in zip(x.placements, w.placements):
        if xp == Shard(0):                   # batch rows: each rank its own
            x_pl.append(xp)
            w_pl.append(Replicate())
            o_pl.append(xp)
            xg_pl.append(xp)
            wg_pl.append(Partial())
        elif contract and (xp == Shard(contract[0]) or (
                xp == Replicate() and wp == Shard(contract[1]))):
            # the contracted dimension split alike: partial sums
            x_pl.append(Shard(contract[0]))
            w_pl.append(Shard(contract[1]))
            o_pl.append(Partial())
            xg_pl.append(Shard(contract[0]))
            wg_pl.append(Shard(contract[1]))
        elif isinstance(wp, Shard) and wp.dim in out_dims:   # its outputs
            x_pl.append(Replicate())
            w_pl.append(wp)
            o_pl.append(Shard(out_dims[wp.dim]))
            xg_pl.append(Partial())
            wg_pl.append(wp)
        else:
            x_pl.append(Replicate())
            w_pl.append(Replicate())
            o_pl.append(Replicate())
            xg_pl.append(Replicate())
            wg_pl.append(Replicate())
    xl = x.redistribute(mesh, x_pl).to_local(grad_placements=xg_pl)
    wl = w.redistribute(mesh, w_pl).to_local(grad_placements=wg_pl)
    return DTensor.from_local(torch.einsum(eq, xl, wl), mesh, o_pl,
                              run_check=False)


def _dyn_update(bufs, news, idx) -> None:
    """Write each ``new`` (B, S, ...) into its ``buf`` (B, cap, ...) at
    row ``idx`` (an int or a device scalar), in place; the buffers share
    one cap and the rows are computed once.  The start is clamped to
    [0, cap - S], as ``lax.dynamic_update_slice`` clamps it, on the
    device.  DTensor buffers (a cache placed by the sharding plan) are
    written rank by rank into their local chunks: DTensor has no rule
    for ``index_copy_``."""
    S, cap, dev = news[0].shape[1], bufs[0].shape[1], bufs[0].device
    if S > cap:
        raise ValueError(f"cannot write {S} rows into a cache of {cap}")
    if _is_dtensor(bufs[0]):
        _dyn_update_sharded(bufs, news, idx)
        return
    start = torch.clamp(torch.as_tensor(idx, device=dev), 0, cap - S)
    rows = start.reshape(()).long() + torch.arange(S, device=dev)
    for buf, new in zip(bufs, news):
        buf.index_copy_(1, rows, new.to(buf.dtype))


_is_dtensor = ctx.is_dtensor


def _replicated(t):
    """Whole placements on ``t``'s mesh (None for a plain ``t``)."""
    if not _is_dtensor(t):
        return None
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * t.device_mesh.ndim


def _whole_local(t):
    """A tensor every rank holds whole: a replicated DTensor's local
    tensor (written in place, a write is each rank's), else ``t``.  The
    ring cache's ``pos`` (its axes are ("layers", None)) and the
    positions are replicated under every rule table."""
    if not _is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    if any(p != Replicate() for p in t.placements):
        raise ValueError(f"expected a replicated DTensor, got "
                         f"{t.placements}")
    return t.to_local()


def _head_ranks(q) -> int:
    """The number of ranks DTensor ``q`` (B, S, H, hd) splits heads over."""
    from torch.distributed.tensor import Shard
    n = 1
    for i, pl in enumerate(q.placements):
        if isinstance(pl, Shard) and pl.dim == 2:
            n *= q.device_mesh.size(i)
    return n


def _heads_split_past_groups(q, n_kv: int) -> bool:
    """Whether ``q`` is a DTensor whose heads are split over a number of
    ranks that does not divide ``n_kv``, the KV groups."""
    return _is_dtensor(q) and n_kv % _head_ranks(q) != 0


def _qkv_layout(q, n_kv: int):
    """Placements under which attention's q, k and v (B, S, heads, hd)
    run on each rank's chunk (``local_call``): q's split of the batch,
    and of the heads where it falls on whole KV groups (each rank then
    holds its heads' own k / v heads); replicated otherwise.  None for
    a plain ``q``."""
    if not _is_dtensor(q):
        return None
    from torch.distributed.tensor import Replicate, Shard
    heads = n_kv % _head_ranks(q) == 0
    return tuple(p if p == Shard(0) or (heads and p == Shard(2))
                 else Replicate() for p in q.placements)


def _dyn_update_sharded(bufs, news, idx) -> None:
    """``_dyn_update`` of DTensor buffers: the new rows laid out as the
    buffer is but whole along the sequence, and each rank keeps the rows
    that fall in its sequence chunk (``serve_attention.write_rows``)."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.distributed.serve_attention import write_rows
    from repro_torch.distributed.sharding import local_offset
    buf = bufs[0]
    S, cap = news[0].shape[1], buf.shape[1]
    pl = tuple(Replicate() if p == Shard(1) else p for p in buf.placements)
    news_l = [n.redistribute(buf.device_mesh, pl).to_local()
              if _is_dtensor(n) else n for n in news]
    idx_l = idx.to_local() if _is_dtensor(idx) else idx
    start = torch.clamp(torch.as_tensor(idx_l, device=news_l[0].device),
                        0, cap - S)
    write_rows([b.to_local() for b in bufs], news_l,
               start - local_offset(buf, 1))


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: rows of an embedding table (V, d).  Under a
    sharding plan the table's d_model split is gathered (FSDP) and its
    vocabulary split stays: each rank looks its batch rows' ids up in
    its own slice of the vocabulary, zeros where an id lies outside it,
    and the ranks' rows sum (JAX's partitioner lays the gather out so;
    DTensor's own backward of the indexing fails on torch 2.11)."""
    if not _is_dtensor(table):
        return table[ids]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    t_pl, i_pl, o_pl, tg_pl = [], [], [], []
    lo, n = 0, table.shape[0]
    for i, (tp, ip) in enumerate(zip(table.placements, ids.placements)):
        if ip == Shard(0):                   # batch rows: each rank its own
            t_pl.append(Replicate())
            i_pl.append(ip)
            o_pl.append(ip)
            tg_pl.append(Partial())
        elif tp == Shard(0):                 # a slice of the vocabulary
            t_pl.append(tp)
            i_pl.append(Replicate())
            o_pl.append(Partial())
            tg_pl.append(tp)
            n //= mesh.size(i)
            lo = lo * mesh.size(i) + mesh.get_coordinate()[i]
        else:
            t_pl.append(Replicate())
            i_pl.append(Replicate())
            o_pl.append(Replicate())
            tg_pl.append(Replicate())
    tl = table.redistribute(mesh, t_pl).to_local(grad_placements=tg_pl)
    il = ids.redistribute(mesh, i_pl).to_local()
    if n == table.shape[0]:
        return DTensor.from_local(tl[il], mesh, o_pl, run_check=False)
    lo *= n
    inside = (il >= lo) & (il < lo + n)
    rows = tl[torch.where(inside, il - lo, 0)]
    rows = torch.where(inside[..., None], rows, rows.new_zeros(()))
    return DTensor.from_local(rows, mesh, o_pl, run_check=False)


def like(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """``new`` laid out as ``old`` is where ``old`` is a DTensor (a new
    cache or state leaf kept in the cache's placement)."""
    if _is_dtensor(old):
        return new.redistribute(old.device_mesh, old.placements)
    return new


def local_call(fn, *args, layout=None, layouts=None, out_layouts=None):
    """``fn(*args)`` for a kernel wrapper or a routine DTensor has no
    rules for, which takes plain tensors.  DTensor arguments are first
    laid out by ``layout`` (placements; by default split on the batch as
    the first's batch is split, and replicated otherwise; ``layouts``
    gives an argument's own where it is not None), ``fn`` runs on each
    rank's chunk, and each tensor it returns comes back as a DTensor of
    ``layout`` (``out_layouts``: one each; DTensor has no rule for a
    custom kernel).  Plain arguments pass straight through."""
    if not _is_dtensor(args[0]):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = args[0].device_mesh
    pl = layout or tuple(p if p == Shard(0) else Replicate()
                         for p in args[0].placements)
    lays = [None if not _is_dtensor(a) else lay or (
        pl if a.ndim else (Replicate(),) * mesh.ndim)
        for a, lay in zip(args, layouts or (None,) * len(args))]
    # a mesh axis that splits any argument splits the work: an argument
    # whole on it gets a partial gradient on each rank, summed over them
    split = {i for lay in lays if lay for i, p in enumerate(lay)
             if isinstance(p, Shard)}
    local = [a if lay is None else _ContiguousGrad.apply(
        summed(a).redistribute(mesh, lay).to_local(grad_placements=tuple(
            Partial() if i in split and p == Replicate() else p
            for i, p in enumerate(lay))))
        for a, lay in zip(args, lays)]
    out = fn(*local)
    if isinstance(out, tuple):
        outs = out_layouts or (pl,) * len(out)
        return tuple(DTensor.from_local(o, mesh, lay, run_check=False)
                     for o, lay in zip(out, outs))
    return DTensor.from_local(out, mesh, pl, run_check=False)


def summed(t):
    """A DTensor's partial sums reduced (made whole) before it is laid
    out otherwise: torch 2.11's DTensor cannot take a gradient back from
    a split to a partial placement."""
    if not _is_dtensor(t) or not any(p.is_partial() for p in t.placements):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, tuple(
        Replicate() if p.is_partial() else p for p in t.placements))


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous: the gradient of
    a chunk's input goes back into DTensor ops that view it, and a view
    of a permuted chunk fails."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _attend(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, *, causal: bool, q_offset=0, kv_len=None,
            kv_pos=None, sliding_window: Optional[int] = None,
            prefix_len: int = 0) -> torch.Tensor:
    """The JAX package's dispatch, line for line:

    - ``xla_naive``, or at most 256 x 256 scores: naive attention;
    - ``pallas`` without a cache, offset, prefix or softcap:
      ``ops.flash_attention`` (the kernel on the card, its plain version
      on the CPU);
    - everything else: ``flash_attention_xla``, with one macro block when
      the offset is a tensor (a cached prefill).
    """
    kw = dict(causal=causal, sliding_window=sliding_window, kv_len=kv_len,
              kv_pos=kv_pos, prefix_len=prefix_len)
    if cfg.attn_impl == "xla_naive" or q.shape[1] * k.shape[1] <= 256 * 256:
        return naive_attention(q, k, v, softcap=cfg.logits_softcap,
                               q_offset=q_offset, **kw)
    if cfg.attn_impl == "pallas":
        if kv_len is None and kv_pos is None and \
                isinstance(q_offset, int) and q_offset == 0 and \
                prefix_len == 0 and cfg.logits_softcap == 0.0:
            from repro_torch.kernels import ops as kops
            return local_call(functools.partial(
                kops.flash_attention, causal=causal,
                sliding_window=sliding_window), q, k, v)
        # fall through for cached paths
    n_macro = 8 if isinstance(q_offset, int) else 1
    return flash_attention_xla(q, k, v, chunk=cfg.attn_chunk,
                               n_macro=n_macro, q_offset=q_offset,
                               softcap=cfg.logits_softcap, **kw)


# --------------------------------------------------------------------------
# MLP (dense, gated or plain)
# --------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, cfg: ModelConfig,
             device=None) -> Params:
    d, f, dt = cfg.d_model, cfg.d_ff, dtype_of(cfg)
    p = {"wi": dense_init(gen, d, (d, f), dt, device),
         "wo": dense_init(gen, f, (f, d), dt, device)}
    if cfg.glu:
        p["wg"] = dense_init(gen, d, (d, f), dt, device)
    return p


def mlp_axes(cfg: ModelConfig) -> Params:
    a = {"wi": ("embed", "mlp"), "wo": ("mlp", "embed")}
    if cfg.glu:
        a["wg"] = ("embed", "mlp")
    return a


def apply_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """act(x wg) * (x wi) with the gate, act(x wi) without; then wo."""
    act = activation_fn(cfg.activation)
    h = product("bsd,df->bsf", x, p["wi"], {1: 2})
    if "wg" in p:
        h = act(product("bsd,df->bsf", x, p["wg"], {1: 2})) * h
    else:
        h = act(h)
    return product("bsf,fd->bsd", h, p["wo"], {1: 2}, (2, 0)).to(x.dtype)


# --------------------------------------------------------------------------
# Mixture-of-Experts (sort/gather capacity routing, grouped for locality)
# --------------------------------------------------------------------------

def moe_init(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    """The router in float32, the experts' ``wi`` / ``wo`` (/ ``wg``)
    (E, d, f) / (E, f, d) in the model's dtype, drawn in the JAX
    package's key order."""
    d, f, E, dt = cfg.d_model, cfg.d_ff, cfg.n_experts, dtype_of(cfg)
    p = {"router": dense_init(gen, d, (d, E), torch.float32, device),
         "wi": dense_init(gen, d, (E, d, f), dt, device),
         "wo": dense_init(gen, f, (E, f, d), dt, device)}
    if cfg.glu:
        p["wg"] = dense_init(gen, d, (E, d, f), dt, device)
    return p


def moe_axes(cfg: ModelConfig) -> Params:
    # expert weight d_model gets its own logical axis ("expert_embed"),
    # FSDP-sharded by default; overriding it to None replicates it
    a = {"router": ("embed", "experts_router"),
         "wi": ("experts", "expert_embed", "mlp"),
         "wo": ("experts", "mlp", "expert_embed")}
    if cfg.glu:
        a["wg"] = ("experts", "expert_embed", "mlp")
    return a


def moe_capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert of a group of ``tokens``: ceil(tokens K / E x
    capacity_factor), at least K, at most ``tokens`` (as in JAX)."""
    E, K = cfg.n_experts, cfg.experts_per_token
    capacity = max(int(math.ceil(tokens * K / E * cfg.capacity_factor)), K)
    return min(capacity, tokens)


def _dispatch(xt: torch.Tensor, router_logits: torch.Tensor,
              cfg: ModelConfig, capacity: int):
    """Route token groups side by side (``jax.vmap(_route_group)`` in
    JAX) into per-expert capacity buffers.  xt: (G, T, D); router_logits:
    (G, T, E).  Returns (xe (G, E, capacity, D), the buffers' gates
    (G, E capacity), each token's slots (G, T, K) in buffer order, the
    overflow slot E capacity for a dropped one, the Switch aux loss per
    group (G,))."""
    Gp, T, D = xt.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    dev = xt.device
    probs = torch.softmax(router_logits.float(), dim=-1)          # (G,T,E)
    # lax.top_k: descending, equal values in index order (bf16 router
    # logits tie often; torch.topk orders ties arbitrarily)
    gate, eidx = (t[..., :K] for t in torch.sort(
        probs, dim=-1, descending=True, stable=True))             # (G,T,K)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # ---- sort-based dispatch into per-expert capacity buffers ----------
    flat_e = eidx.reshape(Gp, T * K)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    se, order = torch.sort(flat_e, dim=-1, stable=True)
    st = flat_t[order]
    sg = gate.reshape(Gp, T * K).gather(1, order)
    # position within expert: rank among equal expert ids
    pos = torch.arange(T * K, device=dev) - torch.searchsorted(
        se, se, side="left")
    keep = pos < capacity
    slot = torch.where(keep, se * capacity + pos, E * capacity)  # overflow
    n_slots = E * capacity
    buf_tok = torch.full((Gp, n_slots + 1), T, dtype=torch.long,
                         device=dev).scatter_(1, slot,
                                              torch.where(keep, st, T))
    buf_gate = torch.zeros((Gp, n_slots + 1), device=dev).scatter_(
        1, slot, torch.where(keep, sg, 0.0))[:, :n_slots]
    buf_tok = buf_tok[:, :n_slots]

    xe = xt.gather(1, torch.clamp(buf_tok, max=T - 1)[..., None]
                   .expand(-1, -1, D))
    xe = torch.where((buf_tok < T)[..., None], xe, 0).reshape(
        Gp, E, capacity, D)
    slot_of = torch.empty_like(slot).scatter_(1, order, slot)
    token_slots = torch.sort(slot_of.reshape(Gp, T, K), dim=-1).values

    # load-balance aux loss (Switch): E * mean(frac_tokens * mean_prob);
    # the count per expert is a scatter_add_ of ones (bincount would wait
    # for the card to size its output)
    ones = torch.ones_like(flat_e, dtype=torch.float32)
    assign = torch.zeros((Gp, E), device=dev).scatter_add_(
        1, flat_e, ones) / (T * K)
    return xe, buf_gate, token_slots, E * (assign * probs.mean(1)).sum(-1)


def _expert_mlp(p: Params, xe: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    """Each expert's MLP on its capacity buffers: (G, E, c, D) ->
    (G, E, c, D)."""
    act = activation_fn(cfg.activation)
    h = torch.matmul(xe, p["wi"])                                 # (G,E,c,f)
    if "wg" in p:
        h = act(torch.matmul(xe, p["wg"])) * h
    else:
        h = act(h)
    return torch.matmul(h, p["wo"])


def _expert_products(p: Params, xe: torch.Tensor, cfg: ModelConfig
                     ) -> torch.Tensor:
    """``_expert_mlp`` under a sharding plan: on each mesh axis that
    splits the token groups the weights are gathered; on an axis that
    splits the experts (``moe_axes``) each rank runs its own experts on
    its slice of the buffers; elsewhere both are whole.  The weights'
    ``expert_embed`` / ``mlp`` splits are gathered (FSDP).  Returns the
    outputs laid out as the groups are (whole over the experts)."""
    if not _is_dtensor(xe):
        return _expert_mlp(p, xe, cfg)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = xe.device_mesh
    wpl = p["wi"].placements
    x_pl, w_pl, g_pl = [], [], []
    for i, xp in enumerate(xe.placements):
        if xp == Shard(0):                  # groups: each rank its own
            x_pl.append(xp)
            w_pl.append(Replicate())
            g_pl.append(Partial())          # a weight's gradient sums them
        elif wpl[i] == Shard(0) and mesh.size(i) > 1:     # experts
            x_pl.append(Shard(1))
            w_pl.append(Shard(0))
            g_pl.append(Shard(0))
        else:
            x_pl.append(Replicate())
            w_pl.append(Replicate())
            g_pl.append(Replicate())
    w = {k: p[k].redistribute(mesh, w_pl).to_local(grad_placements=g_pl)
         for k in ("wi", "wg", "wo") if k in p}
    oe = _expert_mlp(w, xe.redistribute(mesh, x_pl).to_local(), cfg)
    whole = tuple(pl if pl == Shard(0) else Replicate() for pl in x_pl)
    return DTensor.from_local(oe, mesh, x_pl, run_check=False
                              ).redistribute(mesh, whole)


def _combine(oe: torch.Tensor, buf_gate: torch.Tensor,
             token_slots: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Each token's gated expert outputs: oe (G, E, c, D) -> (G, T, D)."""
    Gp, E, c, D = oe.shape
    oe = oe.reshape(Gp, E * c, D) * buf_gate[..., None].to(oe.dtype)
    # combine in the activation dtype, each token's kept slots summed from
    # zero in buffer order (the CPU scatter-add's order), the overflow
    # slot reading a zero row; no atomics, so a repeated call is
    # bit-identical
    oe = torch.cat([oe.to(dtype), oe.new_zeros((Gp, 1, D), dtype=dtype)],
                   dim=1)
    T, K = token_slots.shape[1:]
    out = oe.new_zeros((Gp, T, D))
    for j in range(K):
        out = out + oe.gather(1, token_slots[..., j, None].expand(-1, -1, D))
    return out


def apply_moe(p: Params, x: torch.Tensor, cfg: ModelConfig,
              groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped sort-based MoE. x: (B, S, D) -> (out, aux_loss).

    Tokens are split into ``groups`` routing groups (the largest divisor
    of B S not above ``groups``); each group routes its tokens to
    ``moe_capacity`` slots per expert, and assignments past an expert's
    capacity are dropped."""
    B, S, D = x.shape
    T = B * S
    groups = max(1, min(groups, T))
    while T % groups:
        groups -= 1
    tg = T // groups
    xt = ctx.constrain(x.reshape(groups, tg, D))
    logits = torch.einsum("gtd,de->gte", xt, p["router"].to(x.dtype))
    # the routing and the combine run on each rank's own token groups
    xe, buf_gate, token_slots, aux = local_call(functools.partial(
        _dispatch, cfg=cfg, capacity=moe_capacity(tg, cfg)), xt, logits)
    oe = _expert_products(p, xe, cfg)
    out = local_call(functools.partial(_combine, dtype=xt.dtype), oe,
                     buf_gate, token_slots)
    return out.reshape(B, S, D), aux.mean()
