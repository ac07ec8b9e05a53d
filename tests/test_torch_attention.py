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
premise: its 3xTF32 split holds 1e-4 where one TF32 pass does not.
"""
import dataclasses
import math

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
from torch_parity import assert_close, to_numpy_tree


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


@pytest.mark.parametrize("hd", [16, 80, 96, 200, 256])
def test_padded_head_dim_is_the_same_function(hd):
    """What the wrapper does on the card for a head dim between the
    kernel's bodies: q, k and v zero-padded along hd up to the body, the
    softmax scaled by the true hd, the output sliced back.  The plain
    version over the padded inputs (q scaled so that its 1/sqrt(body)
    becomes 1/sqrt(hd)) gives the unpadded function; the body is the
    least of ``HEAD_DIMS`` at or above hd, and none is above 256."""
    body = FA.body_head_dim(hd)
    assert body == {16: 32, 80: 128, 96: 128, 200: 256, 256: 256}[hd]
    q, k, v = (torch.as_tensor(a).transpose(1, 2)
               for a in _qkv(2, 96, 96, 4, 2, hd, seed=hd))
    pad = [torch.nn.functional.pad(t, (0, body - hd)) for t in (q, k, v)]
    pad[0] = pad[0] * math.sqrt(body / hd)
    got = FA.flash_attention_plain(*pad, causal=True, sliding_window=40)
    want = FA.flash_attention_plain(q, k, v, causal=True, sliding_window=40)
    assert not got[..., hd:].any()
    assert_close(got[..., :hd], want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="head_dim up to 256"):
        FA.body_head_dim(257)


def _tf32(x):
    """TF32 rounding of float32 values (round to nearest, ties away from
    zero, at 10 mantissa bits), as ``cvt.rna.tf32.f32`` does."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


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
