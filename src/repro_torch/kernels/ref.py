"""Plain PyTorch versions of the ported kernels.

``flash_attention_ref``, ``decode_attention_ref``, ``spatial_stats_ref``,
``cam_head_ref`` and ``rwkv6_scan_ref`` mirror the JAX package's
``kernels/ref.py`` oracles; ``spatial_stats_proj`` mirrors its
``ops._spatial_stats_proj``, the projection reduction that is the plain
version of both spatial-stats kernels here.  The CPU path of every
kernel wrapper runs these, and on the card they are what the kernels
are compared with.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        sliding_window: Optional[int] = None
                        ) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd). Full-softmax reference.

    Query head h reads kv head ``h // (H // KV)`` (GQA).  Scores and the
    softmax are float32; the probabilities are cast to ``v``'s dtype
    before the product with ``v``, as the kernel does."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqngd,bsnd->bnqgs", qg.float(),
                     k.float()) / math.sqrt(hd)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if sliding_window is not None:
        mask &= q_pos - k_pos < sliding_window
    s = torch.where(mask[None, None, :, None, :], s,
                    torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    del s
    out = torch.einsum("bnqgs,bsnd->bnqgd", p, v)
    return out.permute(0, 2, 1, 3, 4).reshape(B, Sq, H, hd).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len) -> torch.Tensor:
    """q: (B, H, hd) single step; k, v: (B, S, KV, hd); kv_len: int or a
    one-element tensor.  Keys at positions >= kv_len score NEG_INF; the
    softmax is float32 and the probabilities are cast to ``v``'s dtype
    before the product with ``v``."""
    B, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum("bngd,bsnd->bngs", qg.float(),
                     k.float()) / math.sqrt(hd)
    kv_len = torch.as_tensor(kv_len, device=q.device).reshape(())
    valid = torch.arange(Sk, device=q.device)[None, None, None, :] < kv_len
    s = torch.where(valid, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    del s
    out = torch.einsum("bngs,bsnd->bngd", p, v)
    return out.reshape(B, H, hd).to(q.dtype)


def cam_head_ref(feat: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paper Eq. 1 head. feat: (B, g, g, D); w: (D, C); b: (C,).

    counts = relu(GAP(feat) @ w + b);  cam[b,i,j,c] = sum_d feat*w."""
    cam = torch.einsum("bijd,dc->bijc", feat.float(), w.float())
    counts = torch.relu(cam.mean(dim=(1, 2)) + b.float())
    return counts, cam


def spatial_stats_ref(grid_logits: torch.Tensor,
                      tau: float = 0.2) -> torch.Tensor:
    """Per-class occupancy statistics from CAM logits.

    grid_logits: (B, g, g, C) -> stats (B, C, 5) float32:
      [min_row, max_row, min_col, max_col, n_cells]
    Empty classes: min=g, max=-1, n=0.
    """
    B, g, _, C = grid_logits.shape
    dev = grid_logits.device
    occ = grid_logits.float() > tau
    rows = torch.arange(g, device=dev)[None, :, None, None]
    cols = torch.arange(g, device=dev)[None, None, :, None]
    big = torch.full((), g, device=dev)
    neg = torch.full((), -1, device=dev)

    def ext(idx, fill, op):
        return op(op(torch.where(occ, idx, fill), 1).values, 1).values

    min_row = ext(rows, big, torch.min).float()
    max_row = ext(rows, neg, torch.max).float()
    min_col = ext(cols, big, torch.min).float()
    max_col = ext(cols, neg, torch.max).float()
    n = occ.sum(dim=(1, 2)).float()
    return torch.stack([min_row, max_row, min_col, max_col, n], dim=-1)


def spatial_stats_proj(grid_logits: torch.Tensor,
                       tau: float = 0.2) -> torch.Tensor:
    """Spatial stats via row/column occupancy projections.

    Extrema only need ``any`` along the opposite axis, so after one
    threshold pass the min/max reductions run on (B, g, C) projections.
    Bit-identical to ``spatial_stats_ref``."""
    B, g, _, C = grid_logits.shape
    occ = grid_logits.float() > tau
    prow = occ.any(2)                                # (B, g, C) row occupied
    pcol = occ.any(1)                                # (B, g, C) col occupied
    idx = torch.arange(g, dtype=torch.float32,
                       device=grid_logits.device)[None, :, None]
    big = torch.full((), float(g), device=grid_logits.device)
    neg = torch.full((), -1.0, device=grid_logits.device)
    min_row = torch.where(prow, idx, big).amin(1)
    max_row = torch.where(prow, idx, neg).amax(1)
    min_col = torch.where(pcol, idx, big).amin(1)
    max_col = torch.where(pcol, idx, neg).amax(1)
    n = occ.sum(dim=(1, 2)).float()
    return torch.stack([min_row, max_row, min_col, max_col, n], dim=-1)


def rwkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   lw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential (per-token) RWKV-6 recurrence.

    r, k, v, lw: (B, H, T, K); u: (H, K); s0: (B, H, K, V).
    S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T
    o_t = r_t S_{t-1} + (r_t . u . k_t) v_t
    Returns (out (B, H, T, V), S_T (B, H, K, V)), both float32: the
    caller casts ``out`` as the kernel does.
    """
    rf, kf, vf, wf = (a.float() for a in (r, k, v, lw))
    uf = u.float()
    S = s0.float()
    outs = []
    for t in range(r.shape[2]):
        rt, kt, vt = rf[:, :, t], kf[:, :, t], vf[:, :, t]
        o = torch.einsum("bhk,bhkv->bhv", rt, S)
        o = o + torch.einsum("bhk,hk,bhk->bh", rt, uf, kt)[..., None] * vt
        S = (S * torch.exp(wf[:, :, t])[..., None]
             + kt[..., None] * vt[..., None, :])
        outs.append(o)
    return torch.stack(outs, dim=2), S
