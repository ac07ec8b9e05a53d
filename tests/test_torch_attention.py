"""The port's flash attention (plain version, CPU) and the trunk's
attention dispatch against the JAX package's, with the same inputs made
by numpy from a seed.

JAX's ``ops.flash_attention`` runs its Pallas kernel (interpreted on the
CPU) when its 128-row tiles divide the lengths, and falls back to
``ref.flash_attention_ref`` otherwise; the port's function is the same
at every length, so both sides of the fallback are held.  Tolerances:
max abs err 1e-4 in float32 and 2e-2 in bfloat16 (one bf16 rounding of
outputs of magnitude ~1), as tests/test_kernels.py holds the Pallas
kernel; the filter forward at rtol 1e-4 / atol 1e-3, as the port's other
filter tests (float32 matmuls summed in another order).  A TF32
emulation on numpy's float32 bits pins the float32 kernel's numerical
premise: its 3xTF32 split holds 1e-4 where one TF32 pass does not; a
model of the tensor cores' truncating sums pins the float32 hd 256
body's order of sums, which holds 1e-4 where one accumulator chain does
not; and exact rational arithmetic pins the hd 256 bodies' epilogue:
their reciprocal-and-FMA quotient is the correctly rounded division.
"""
import dataclasses
import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.models import layers as RL
from repro.models.config import BranchSpec as RBranch
from repro.train import filter_train as RT
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.models import layers as TL
from repro_torch.models.config import BranchSpec as TBranch
from repro_torch.train import filter_train as TT
from torch_parity import assert_close, bf16, to_numpy_tree
from torch_parity import tc_step as _tc_step
from torch_parity import tf32 as _tf32


def _qkv(B, Sq, Sk, H, KV, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, s).astype(np.float32)
            for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))]


def _both(arrs, dtype):
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = getattr(torch, dtype)
    return ([jnp.asarray(a).astype(jd) for a in arrs],
            [torch.as_tensor(a).to(td) for a in arrs])


# (B, Sq, Sk, H, KV, hd, causal, sliding_window, dtype)
CASES = [
    (1, 256, 256, 4, 2, 32, True, None, "float32"),     # JAX: Pallas kernel
    (1, 256, 256, 4, 4, 16, False, None, "bfloat16"),   # JAX: Pallas kernel
    (1, 256, 256, 4, 2, 32, True, 32, "float32"),       # window, GQA
    (2, 300, 300, 4, 2, 32, False, None, "float32"),    # ragged: JAX ref
    (1, 300, 300, 4, 1, 16, True, 100, "float32"),      # ragged, window
    (1, 300, 300, 2, 2, 16, True, None, "bfloat16"),    # ragged, bf16
    # head dims the card runs through a padded body (96 -> 128) or its
    # own hd 256 body (paligemma's: MQA), against the Pallas kernel
    (1, 256, 256, 4, 2, 96, True, None, "float32"),
    (1, 256, 256, 2, 1, 256, True, None, "float32"),
    (1, 256, 256, 2, 1, 256, False, 64, "float32"),
    (1, 256, 256, 2, 1, 256, True, None, "bfloat16"),
    # above 256: the slab body's head dims on the card
    (1, 256, 256, 2, 1, 320, True, None, "float32"),
    (1, 256, 256, 2, 1, 320, False, 64, "bfloat16"),
]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_flash_attention_matches_jax(case):
    B, Sq, Sk, H, KV, hd, causal, sw, dtype = case
    (rq, rk, rv), (tq, tk, tv) = _both(_qkv(B, Sq, Sk, H, KV, hd), dtype)
    want = rops.flash_attention(rq, rk, rv, causal=causal, sliding_window=sw)
    got = ops.flash_attention(tq, tk, tv, causal=causal, sliding_window=sw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    atol = 1e-4 if dtype == "float32" else 2e-2
    assert_close(got.float(), want.astype(jnp.float32), rtol=0, atol=atol)


def test_flash_attention_refusals_on_cpu():
    q, k, v = (torch.as_tensor(a) for a in _qkv(1, 64, 64, 4, 2, 16))
    with pytest.raises(RuntimeError, match="backward"):
        ops.flash_attention(q.requires_grad_(), k, v)
    with pytest.raises(ValueError, match="sliding_window"):
        FA.flash_attention_bhsd(q.detach(), k, v, sliding_window=0)
    with pytest.raises(ValueError, match="H % KV"):
        FA.flash_attention_bhsd(q.detach(), k[:, :3], v[:, :3])
    # a meta tensor (shapes only, as the launch analyses run a step) goes
    # to the plain version, like a CPU one, and raises nothing
    out = FA.flash_attention_bhsd(*(torch.empty((1, 2, 8, 32), device="meta")
                                    for _ in range(3)))
    assert out.device.type == "meta" and out.shape == (1, 2, 8, 32)


@pytest.mark.parametrize("hd", [16, 80, 96, 200, 256, 300, 320])
def test_padded_head_dim_is_the_same_function(hd):
    """What the wrapper does on the card for a head dim between the
    kernel's bodies: q, k and v zero-padded along hd up to the body, the
    softmax scaled by the true hd, the output sliced back.  The plain
    version over the padded inputs (q scaled so that its 1/sqrt(body)
    becomes 1/sqrt(hd)) gives the unpadded function; the body is the
    least of ``HEAD_DIMS`` at or above hd, above 256 the next multiple of
    8 (the slab body's), so no head dim is refused."""
    body = FA.body_head_dim(hd)
    assert body == {16: 32, 80: 128, 96: 128, 200: 256, 256: 256, 300: 304,
                    320: 320}[hd]
    q, k, v = (torch.as_tensor(a).transpose(1, 2)
               for a in _qkv(2, 96, 96, 4, 2, hd, seed=hd))
    pad = [torch.nn.functional.pad(t, (0, body - hd)) for t in (q, k, v)]
    pad[0] = pad[0] * math.sqrt(body / hd)
    got = FA.flash_attention_plain(*pad, causal=True, sliding_window=40)
    want = FA.flash_attention_plain(q, k, v, causal=True, sliding_window=40)
    assert not got[..., hd:].any()
    assert_close(got[..., :hd], want, rtol=0, atol=1e-5)
    assert [FA.body_head_dim(n) for n in (1, 257, 264, 1021, 1024)] == [
        32, 264, 264, 1024, 1024]


def _matmul_tf32(a, b, passes):
    """a @ b from TF32 operands, products summed exactly, then float32:
    one pass (hi hi) or the 3xTF32 split (hi hi + hi lo + lo hi, with
    lo = tf32(x - hi)) of the flash kernel's float32 body."""
    ah, bh = _tf32(a), _tf32(b)
    out = ah.astype(np.float64) @ bh.astype(np.float64)
    if passes == 3:
        al, bl = _tf32(a - ah), _tf32(b - bh)
        out += ah.astype(np.float64) @ bl.astype(np.float64)
        out += al.astype(np.float64) @ bh.astype(np.float64)
    return out.astype(np.float32)


def _attention_tf32(q, k, v, passes):
    s = _matmul_tf32(q, k.T, passes) / np.float32(np.sqrt(q.shape[-1]))
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return _matmul_tf32(p, v, passes)


def test_tf32_split_holds_fp32_tolerance_where_one_pass_misses():
    """The float32 flash kernel's premise, on the CPU: at one head of the
    filter trunk's shape (S 3136, hd 32) with q and k scaled by 3, the
    3xTF32 products stay within the kernel's 1e-4 of the float32 plain
    version (~1.2e-5), and one TF32 pass misses it (~1.3e-2)."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(0, 1, (3136, 32)).astype(np.float32)
               for _ in range(3))
    q, k = q * np.float32(3), k * np.float32(3)
    want = FA.flash_attention_plain(
        *(torch.as_tensor(a)[None, None] for a in (q, k, v)),
        causal=False)[0, 0].numpy()
    three = float(np.abs(_attention_tf32(q, k, v, 3) - want).max())
    one = float(np.abs(_attention_tf32(q, k, v, 1) - want).max())
    assert three <= 1e-4, three
    assert one > 1e-4, one
    assert _tf32(np.float32(1 + 2 ** -11)) == np.float32(1 + 2 ** -10)


def _split_tf32(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _scores_tc(q, k, order):
    """q k^T in 32 k-steps over hd 256 on the model: "one pass" (hi hi),
    "one chain" (3xTF32, every product in one accumulator) or "boxes",
    the float32 hd 256 body's: the small terms (lo hi, hi lo) in one
    chain, the large one (hi hi) in a chain restarted at each 64-column
    box and added with rounded float32 adds."""
    (qh, ql), (kh, kl) = _split_tf32(q), _split_tf32(k)
    zero = np.zeros((q.shape[0], k.shape[0]), np.float32)
    steps = [slice(i, i + 8) for i in range(0, q.shape[1], 8)]
    if order == "one pass":
        d = zero
        for c in steps:
            d = _tc_step(d, qh[:, c], kh[:, c])
        return d
    if order == "one chain":
        d = zero
        for c in steps:
            for a, b in ((ql, kh), (qh, kl), (qh, kh)):
                d = _tc_step(d, a[:, c], b[:, c])
        return d
    small, s = zero, None
    for i in range(0, len(steps), 8):
        big = zero
        for c in steps[i:i + 8]:
            small = _tc_step(_tc_step(small, ql[:, c], kh[:, c]),
                             qh[:, c], kl[:, c])
            big = _tc_step(big, qh[:, c], kh[:, c])
        s = big if s is None else s + big
    return s + small


def _pv_tc(p, v):
    """p v in k-steps of 8 keys on the model, the body's order: lo hi,
    hi lo, then hi hi, in one chain over the keys."""
    (ph, pl), (vh, vl) = _split_tf32(p), _split_tf32(v.T)
    d = np.zeros((p.shape[0], v.shape[1]), np.float32)
    for i in range(0, p.shape[1], 8):
        c = slice(i, i + 8)
        for a, b in ((pl, vh), (ph, vl), (ph, vh)):
            d = _tc_step(d, a[:, c], b[:, c])
    return d


def test_hd256_fp32_order_of_sums_holds_where_one_chain_misses():
    """The float32 hd 256 body's premise, on the CPU: at hd 256 with q and
    k scaled by 8 (scores of standard deviation 64, a peaky softmax), on
    the model of truncating tensor-core sums, its order (small terms in
    one chain, large ones restarted at each 64-column box, rounded adds)
    stays within 1e-4 of float64 (~3.5e-5), where 3xTF32 summed in one
    accumulator chain misses it (~2.3e-4) and one TF32 pass by far
    (~2.4e-2).  64 query rows, 256 keys."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(0, 1, (n, 256)).astype(np.float32)
               for n in (64, 256, 256))
    q, k = q * np.float32(8), k * np.float32(8)
    s64 = q.astype(np.float64) @ k.T.astype(np.float64) / 16
    p64 = np.exp(s64 - s64.max(-1, keepdims=True))
    want = (p64 / p64.sum(-1, keepdims=True)) @ v
    err = {}
    for order in ("one pass", "one chain", "boxes"):
        s = _scores_tc(q, k, order) / np.float32(16)
        p = np.exp(s - s.max(-1, keepdims=True)).astype(np.float32)
        out = _pv_tc(p, v) / p.sum(-1, keepdims=True, dtype=np.float32)
        err[order] = float(np.abs(out - want).max())
    assert err["boxes"] <= 1e-4, err
    assert err["one chain"] > 1e-4, err
    assert err["one pass"] > 1e-2, err
    # the model truncates: eight products of 2^-25 are lost beside 1
    # (exactly 1 + 2^-22), kept beside 0
    a = np.full((1, 8), 2.0 ** -12, np.float32)
    b = np.full((1, 8), 2.0 ** -13, np.float32)
    assert _tc_step(np.ones((1, 1), np.float32), a, b)[0, 0] == 1
    assert _tc_step(np.zeros((1, 1), np.float32), a, b)[0, 0] == 2.0 ** -22


def _tf32_trunc(x):
    """TF32 truncation (the 19 bits the mma reads of a float32 operand)."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def _qk_step_dims(c0, kk):
    """Head dims of k-step kk of the 64-column chunk at c0, as the float32
    bodies map operand columns to dims (``qk_dim``: 8t + 4 ((kk >> 1) & 1)
    + 32 (kk >> 2) + 2 (kk & 1), and + 1, for t in 0..3)."""
    off = 4 * ((kk >> 1) & 1) + 32 * (kk >> 2) + 2 * (kk & 1)
    return np.array(sorted(c0 + 8 * t + off + e for t in range(4)
                           for e in (0, 1)))


NEG_INF = np.float32(-0.7 * 3.4028234663852886e38)


def _emulate_flash_slab_f32(q, k, v, causal):
    """numpy float32 in the order of arithmetic of the float32 slab body
    (hd above 256), one head, on the model of the tensor cores' truncating
    sums (``_tc_step``): 64-row query tiles and 64-key tiles; for each
    tile the scores over 64-column chunks of the head dim, chunk by chunk,
    each chunk's large terms (q_hi k_hi) in an accumulator of their own
    added to the tile's with rounded float32 adds, the small ones (lo hi,
    hi lo) in one chain over the whole head dim, added last; the base-2
    online softmax with the masked-weight rule; p split to TF32 (its low
    part truncated), acc += p v in k-steps of 8 keys (lo hi, hi lo, hi
    hi); o = acc / max(l, 1e-30)."""
    Sq, D = q.shape
    Sk = k.shape[0]
    scale_log2 = np.float32(1.0 / math.sqrt(D) * 1.4426950408889634)
    (qh, ql), (kh, kl) = _split_tf32(q), _split_tf32(k)
    vh, vl = _split_tf32(v)
    out = np.zeros((Sq, D), np.float32)
    for q0 in range(0, Sq, 64):
        rows = np.arange(q0, min(q0 + 64, Sq))
        q_hi = rows[-1]
        n_k = -(-Sk // 64)
        t_end = min(n_k, q_hi // 64 + 1) if causal else n_k
        m = np.full(len(rows), NEG_INF, np.float32)
        lsum = np.zeros(len(rows), np.float32)
        acc = np.zeros((len(rows), D), np.float32)
        for t in range(t_end):
            keys = np.arange(t * 64, min(t * 64 + 64, Sk))
            zero = np.zeros((len(rows), len(keys)), np.float32)
            s, small = zero, zero
            for c0 in range(0, D, 64):
                big = zero
                for kk in range(8):
                    d = _qk_step_dims(c0, kk)
                    d = d[d < D]
                    qa = lambda x: x[np.ix_(rows, d)]
                    kb = lambda x: x[np.ix_(keys, d)]
                    small = _tc_step(_tc_step(small, qa(ql), kb(kh)),
                                     qa(qh), kb(kl))
                    big = _tc_step(big, qa(qh), kb(kh))
                s = s + big
            s = s + small
            keep = np.ones_like(s, bool)
            if causal:
                keep = rows[:, None] >= keys[None, :]
            s = np.where(keep, s, NEG_INF)
            mx = s.max(1)
            m_new = np.maximum(m, np.where(mx == NEG_INF, NEG_INF,
                                           mx * scale_log2))
            corr = np.exp2(m - m_new).astype(np.float32)
            x = np.where(keep, s * scale_log2 - m_new[:, None],
                         NEG_INF - m_new[:, None])
            p = np.exp2(x).astype(np.float32)
            m = m_new
            lsum = lsum * corr + p.sum(1, dtype=np.float32)
            acc = acc * corr[:, None]
            ph = _tf32(p)
            pl = _tf32_trunc(p - ph)
            for j in range(0, len(keys), 8):
                c = slice(j, j + 8)
                kc = keys[c]
                for a, b in ((pl, vh), (ph, vl), (ph, vh)):
                    acc = _tc_step(acc, a[:, c], b[kc].T)
        out[rows] = acc / np.maximum(lsum, np.float32(1e-30))[:, None]
    return out


@pytest.mark.parametrize("D,causal", [(320, True), (320, False),
                                      (512, True)])
def test_flash_slab_f32_order_vs_pallas_interpreter(D, causal):
    """The float32 slab body's order of arithmetic
    (``_emulate_flash_slab_f32``: 64-column chunks of the scores, their
    large terms restarted a chunk, the small ones in one chain, the
    softmax and p v on the model of truncating tensor-core sums) against
    JAX's ``ops.flash_attention``, which interprets the Pallas kernel at
    these lengths, at 1e-4: one head of 128 rows and keys, q and k scaled
    by 2 (a peakier softmax than unit draws)."""
    rng = np.random.default_rng(D + causal)
    q, k, v = (rng.normal(0, 1, (128, D)).astype(np.float32)
               for _ in range(3))
    q, k = q * np.float32(2), k * np.float32(2)
    want = np.asarray(rops.flash_attention(
        *(jnp.asarray(a)[None, :, None] for a in (q, k, v)),
        causal=causal))[0, :, 0]
    got = _emulate_flash_slab_f32(q, k, v, causal)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _emulate_flash_wide_bf16(q, k, v, causal, window=None):
    """numpy float32 in the order of arithmetic of the bf16 wide body (hd
    257-512), one head of bf16 values, on the model of the tensor cores'
    truncating sums (``_tc_step``; bf16 products are exact): 64-row query
    tiles and 32-key tiles (the TPU kernel's skipping rules at those
    sizes); for each tile two partial scores, each warpgroup's over its NB
    64-column boxes of the head dim (NB 3 up to hd 384, else 4) in k-steps
    of 16, added in float32 (the same two terms in both warpgroups); the
    base-2 online softmax with the masked-weight rule; p rounded to bf16;
    acc += p v in k-steps of 16 keys, one chain over the tiles; o = acc /
    max(l, 1e-30) rounded to bf16."""
    Sq, D = q.shape
    Sk = k.shape[0]
    NB = 3 if D <= 384 else 4
    halves = [np.arange(0, min(64 * NB, D)), np.arange(64 * NB, D)]
    scale_log2 = np.float32(1.0 / math.sqrt(D) * 1.4426950408889634)
    out = np.zeros((Sq, D), np.float32)
    for q0 in range(0, Sq, 64):
        rows = np.arange(q0, min(q0 + 64, Sq))
        n_k = -(-Sk // 32)
        t_end = min(n_k, rows[-1] // 32 + 1) if causal else n_k
        t_begin = 0
        if window is not None and q0 - window - 30 > 0:
            t_begin = -(-(q0 - window - 30) // 32)
        m = np.full(len(rows), NEG_INF, np.float32)
        lsum = np.zeros(len(rows), np.float32)
        acc = np.zeros((len(rows), D), np.float32)
        for t in range(t_begin, t_end):
            keys = np.arange(t * 32, min(t * 32 + 32, Sk))
            part = []
            for cols in halves:
                d = np.zeros((len(rows), len(keys)), np.float32)
                for c0 in range(0, len(cols), 16):
                    c = cols[c0:c0 + 16]
                    d = _tc_step(d, q[np.ix_(rows, c)], k[np.ix_(keys, c)])
                part.append(d)
            s = part[0] + part[1]
            keep = np.ones_like(s, bool)
            if causal:
                keep &= rows[:, None] >= keys[None, :]
            if window is not None:
                keep &= rows[:, None] - keys[None, :] < window
            s = np.where(keep, s, NEG_INF)
            mx = s.max(1)
            m_new = np.maximum(m, np.where(mx == NEG_INF, NEG_INF,
                                           mx * scale_log2))
            corr = np.exp2(m - m_new).astype(np.float32)
            x = np.where(keep, s * scale_log2 - m_new[:, None],
                         NEG_INF - m_new[:, None])
            p = np.exp2(x).astype(np.float32)
            m = m_new
            lsum = lsum * corr + p.sum(1, dtype=np.float32)
            acc = acc * corr[:, None]
            pb = bf16(p)
            for j in range(0, len(keys), 16):
                kc = keys[j:j + 16]
                acc = _tc_step(acc, pb[:, j:j + 16], v[kc].T)
        out[rows] = acc / np.maximum(lsum, np.float32(1e-30))[:, None]
    return bf16(out)


@pytest.mark.parametrize("D,causal,window", [(320, True, None),
                                             (320, False, 16),
                                             (512, True, None),
                                             (512, True, 16)])
def test_flash_wide_bf16_order_vs_pallas_interpreter(D, causal, window):
    """The bf16 wide body's order of arithmetic (``_emulate_flash_wide_bf16``:
    two half-hd partial scores added in one order, 64-row and 32-key
    tiles, their skipping rules) against JAX's ``ops.flash_attention``,
    which interprets the Pallas kernel at these lengths, in bf16 at the
    bf16 flash cases' 2e-2 (p and o are rounded to bf16 in both, at other
    points): one head of 128 rows and keys, q and k scaled by 2."""
    rng = np.random.default_rng(D + causal + (window or 0))
    q, k, v = (bf16(rng.normal(0, 1, (128, D)) * s)
               for s in (2.0, 2.0, 1.0))
    want = np.asarray(rops.flash_attention(
        *(jnp.asarray(a, jnp.bfloat16)[None, :, None] for a in (q, k, v)),
        causal=causal, sliding_window=window)).astype(np.float32)[0, :, 0]
    got = _emulate_flash_wide_bf16(q, k, v, causal, window)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)


def _rn32(x):
    """An exact rational rounded to the nearest float32 (ties to even)."""
    f = np.float32(float(x))
    near = (np.nextafter(f, np.float32(-np.inf)), f,
            np.nextafter(f, np.float32(np.inf)))
    return min(near, key=lambda c: (abs(Fraction(float(c)) - x),
                                    int(c.view(np.uint32)) & 1))


def _fma32(a, b, c):
    return _rn32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def test_epilogue_quotient_is_correctly_rounded():
    """The bf16 hd 256 body divides its accumulator by the row sum l with
    l's rounded reciprocal r and one FMA correction, q = x r, then
    fma(fma(-q, l, x), r, q); this pins that it gives x / l rounded to
    nearest, the quotient of a float32 division, on the rows' range: l
    from 1 (a row's largest weight is 1) to 1e5 and the empty row's
    1e-30, x up to 10 l in size, zero, l a power of two and just below
    one.  Exact rational arithmetic stands in for the card's FMA."""
    rng = np.random.default_rng(3)
    l = np.float32(10.0 ** rng.uniform(0, 5, 3000))
    x = np.float32(l * rng.normal(0, 1, 3000)
                   * 10.0 ** rng.uniform(-3, 1, 3000))
    pairs = list(zip(x, l))
    for li in (1.0, 2.0, 3.0, 1e-30, np.nextafter(np.float32(2), 0)):
        li = np.float32(li)
        pairs += [(np.float32(0), li)] + [
            (xi, li) for xi in np.float32(rng.normal(0, 1, 200) * li)]
    for xi, li in pairs:
        r = _rn32(Fraction(1) / Fraction(float(li)))
        q = xi * r
        assert _fma32(_fma32(-q, li, xi), r, q) == xi / li, (xi, li)


@pytest.mark.parametrize("S,impl,to_flash", [
    (256, "pallas", False),          # 256 x 256 scores: naive on both
    (300, "pallas", True),
    (300, "xla_naive", False),
    (300, "xla_flash", False),       # both run flash_attention_xla
])
def test_attend_dispatch_matches_jax(S, impl, to_flash, monkeypatch):
    cfg = TT.default_trunk(d_model=64, n_layers=1, grid=8)
    calls = []
    real = ops.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    arrs = _qkv(2, S, S, 4, 4, 16, seed=S)
    rcfg = dataclasses.replace(RT.default_trunk(d_model=64, n_layers=1,
                                                grid=8), attn_impl=impl)
    want = RL._attend(rcfg, *(jnp.asarray(a) for a in arrs), causal=False,
                      q_offset=0)
    got = TL._attend(dataclasses.replace(cfg, attn_impl=impl),
                     *(torch.as_tensor(a) for a in arrs), causal=False)
    assert bool(calls) == to_flash
    assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("g", [32, 17])
def test_filter_forward_pallas_trunk_matches_jax(g):
    """g = 32: 1024 tokens, JAX runs its Pallas kernel; g = 17: 289
    tokens, JAX falls back to its reference.  The port's trunk goes to
    ``ops.flash_attention`` at both."""
    kw = dict(layer=1, grid=g, n_classes=3, kind="ic", head_dim=16)
    rtrunk = dataclasses.replace(RT.default_trunk(d_model=32, n_layers=1,
                                                  grid=g), attn_impl="pallas")
    ttrunk = dataclasses.replace(TT.default_trunk(d_model=32, n_layers=1,
                                                  grid=g), attn_impl="pallas")
    params = to_numpy_tree(RT.init_filter_model(jax.random.PRNGKey(g), rtrunk,
                                                RBranch(**kw), 24))
    e = np.random.default_rng(g).normal(0, 1, (1, g * g, 24)).astype(
        np.float32)
    want = RT.filter_forward(jax.tree.map(jnp.asarray, params), rtrunk,
                             RBranch(**kw), jnp.asarray(e))
    got = TT.filter_forward(params_from_numpy(params, device="cpu"), ttrunk,
                            TBranch(**kw), e, device="cpu")
    assert_close(got.counts, want.counts)
    assert_close(got.grid, want.grid)
