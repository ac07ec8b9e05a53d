"""The rest of the port's model zoo against the JAX package, on the CPU:
mixture-of-experts (granite, grok), the Hymba hybrid with Mamba and
PaliGemma's prefix-LM.

The same numpy-seeded inputs and weights (moved by ``params_from_numpy``)
go through both packages; float32 paths are held at rtol 1e-4 / atol
1e-3 (``tests/torch_parity.py``: float32 products summed in another
order; the Mamba scan's doubling steps associate in another order than
``lax.associative_scan``).

- Layers: ``apply_moe`` twins of ``tests/test_layers.py``'s MoE cases
  (capacity 1.0 over two groups; no drops equal to the dense expert sum)
  and a bf16 case, out and aux; ``_causal_conv`` with and without its
  state; ``mamba_scan`` at T = 64, 50 and 67 (a prime: chunks of one)
  from a non-zero h0; ``mamba_block`` with and without a state;
  ``prefix_len`` through ``naive_attention``, ``flash_attention_xla``
  and ``attention_block``.
- Models: ``forward`` logits, tap and aux, ``prefill`` + 4
  ``decode_step``s (logits and every cache leaf, ``ssm`` / ``conv``
  included) and ``greedy_generate`` tokens at ``tests/test_models.py``'s
  moe, hybrid and vlm cases and the smoke configs of granite, grok,
  hymba and paligemma under ``pallas``, and hymba's also under
  ``xla_naive``; a hybrid ring (window 8, prompt 6) decoding across the
  wrap, equal to JAX and to the cache-less forward; a ring prefill
  longer than the window, equal to JAX (the reference's fault, pinned);
  one full-width float32 layer each of granite, hymba and paligemma; the
  Mamba states written in place.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import layers as RL
from repro.models import model as RM
from repro.models import serve as RSV
from repro.models import ssm as RS
from repro_torch import configs as TC
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import build
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import serve as TSV
from repro_torch.models import ssm as TS

import test_torch_zoo as zoo
from test_models import CASES as MODEL_CASES
from torch_parity import assert_close, to_numpy_tree

port_config = zoo.port_config
_np, _t = zoo._np, zoo._t

J_MOE = jax.jit(RL.apply_moe, static_argnums=(2, 3))
J_MAMBA = jax.jit(RS.mamba_block, static_argnums=2)
J_PREFIX_BLOCK = jax.jit(RL.attention_block, static_argnums=2,
                         static_argnames=("prefix_len",))


@functools.partial(jax.jit, static_argnums=1, static_argnames=("tap_layer",))
def j_forward(params, cfg, tokens, tap_layer=None, embeds=None):
    """The JAX forward's (logits, tap, aux), jitted."""
    out = RM.forward(params, cfg, tokens, tap_layer=tap_layer, embeds=embeds)
    return out.logits, out.tap, out.aux


# --------------------------------------------------------------------------
# mixture-of-experts
# --------------------------------------------------------------------------

TINY_MOE = dataclasses.replace(MODEL_CASES["moe"][0], n_layers=2,
                               max_seq_len=256)


def _moe_pair(rc, seed):
    rp = to_numpy_tree(RL.moe_init(jax.random.PRNGKey(seed), rc))
    return rp, params_from_numpy(rp, "cpu")


def _moe_dense_sum(tp, x, cfg):
    """Each token's top-K experts mixed by their normalised gates, one
    token at a time (``tests/test_layers.py``'s reference)."""
    xt = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(xt @ tp["router"], -1)
    gate, eidx = torch.topk(probs, cfg.experts_per_token, -1)
    gate = gate / gate.sum(-1, keepdim=True)
    act = TL.activation_fn(cfg.activation)
    out = torch.zeros_like(xt)
    for t in range(xt.shape[0]):
        for j in range(cfg.experts_per_token):
            e = int(eidx[t, j])
            h = act(xt[t] @ tp["wg"][e]) * (xt[t] @ tp["wi"][e])
            out[t] += gate[t, j] * (h @ tp["wo"][e])
    return out.reshape(x.shape)


@pytest.mark.parametrize("case", ["capacity_drops", "no_drop", "bf16"])
def test_apply_moe_matches_jax(case):
    rc = TINY_MOE
    groups, shape = 1, (1, 8, 64)
    if case == "capacity_drops":
        rc, groups, shape = dataclasses.replace(rc, capacity_factor=1.0), \
            2, (2, 16, 64)
    if case == "bf16":          # granite's top-8 of 40 at capacity 1.25
        rc = dataclasses.replace(rc, n_experts=40, experts_per_token=8,
                                 capacity_factor=1.25, dtype="bfloat16")
        shape = (2, 24, 64)
    tc = port_config(rc)
    rp, tp = _moe_pair(rc, len(case))
    x = _np(np.random.default_rng(len(case)), *shape)
    want, want_aux = J_MOE(rp, jnp.asarray(x, rc.dtype), rc, groups)
    got, aux = TL.apply_moe(tp, _t(x).to(TL.dtype_of(tc)), tc, groups=groups)
    assert got.dtype == TL.dtype_of(tc) and got.shape == x.shape
    if case == "bf16":
        # the same routing (ties of bf16 router logits broken by index, as
        # lax.top_k does); the outputs within two bf16 steps of the
        # largest: JAX's bf16 silu rounds its sigmoid before the product,
        # torch's rounds once
        w = np.asarray(want).astype(np.float32)
        step = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
        assert_close(got.float(), w, rtol=0, atol=2 * step)
    else:
        assert_close(got, want)
    assert_close(aux, want_aux, rtol=1e-5, atol=1e-6)
    if case == "capacity_drops":
        assert float(aux) >= 0.99          # >= 1 by Switch construction
        assert TL.moe_capacity(16, tc) == 8
    if case == "no_drop":
        assert_close(got, _moe_dense_sum(tp, _t(x), tc).numpy(), rtol=0,
                     atol=2e-4)


def test_apply_moe_repeats_bit_for_bit():
    tc = port_config(dataclasses.replace(TINY_MOE, capacity_factor=1.0))
    _, tp = _moe_pair(TINY_MOE, 3)
    x = _t(_np(np.random.default_rng(3), 2, 16, 64))
    a, b = TL.apply_moe(tp, x, tc, groups=2), TL.apply_moe(tp, x, tc,
                                                           groups=2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# --------------------------------------------------------------------------
# Mamba
# --------------------------------------------------------------------------

TINY_HY = dataclasses.replace(MODEL_CASES["hybrid"][0], n_layers=2,
                              max_seq_len=256)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(int(with_state))
    x, w, b = _np(rng, 2, 9, 12), _np(rng, 4, 12), _np(rng, 12)
    st = _np(rng, 2, 3, 12) if with_state else None
    want, want_st = RS._causal_conv(x, w, b, st)
    got, got_st = TS._causal_conv(_t(x), _t(w), _t(b),
                                  None if st is None else _t(st))
    assert_close(got, want)
    assert_close(got_st, want_st, rtol=0, atol=0)


@pytest.mark.parametrize("T", [64, 50, 67])
def test_mamba_scan_matches_jax(T):
    rng = np.random.default_rng(T)
    B, di, N = 2, 6, 4
    a = np.exp(-np.abs(_np(rng, B, T, di, N)) * 0.3)
    b, C, h0 = _np(rng, B, T, di, N), _np(rng, B, T, N), _np(rng, B, di, N)
    want_y, want_h = RS.mamba_scan(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(C), jnp.asarray(h0))
    got_y, got_h = TS.mamba_scan(_t(a), _t(b), _t(C), _t(h0))
    assert_close(got_y, want_y)
    assert_close(got_h, want_h)
    # the recurrence itself, step by step
    h, ys = _t(h0), []
    for t in range(T):
        h = _t(a)[:, t] * h + _t(b)[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, _t(C)[:, t]))
    assert_close(got_y, torch.stack(ys, 1).numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_block_matches_jax(with_state):
    tc = port_config(TINY_HY)
    rp = to_numpy_tree(RS.mamba_init(jax.random.PRNGKey(2), TINY_HY))
    tp = params_from_numpy(rp, "cpu")
    assert list(tp) == list(rp)
    rng = np.random.default_rng(5)
    x = _np(rng, 2, 12, 64)
    st = None
    if with_state:
        st = {"ssm": _np(rng, 2, TINY_HY.d_inner, TINY_HY.ssm_state),
              "conv": _np(rng, 2, TINY_HY.ssm_conv - 1, TINY_HY.d_inner)}
    want, want_st = J_MAMBA(rp, jnp.asarray(x), TINY_HY,
                            None if st is None else
                            jax.tree.map(jnp.asarray, st))
    got, got_st = TS.mamba_block(tp, _t(x), tc, None if st is None else
                                 {k: _t(a) for k, a in st.items()})
    assert_close(got, want)
    assert (got_st is None) == (want_st is None)
    if with_state:
        for k in ("ssm", "conv"):
            assert_close(got_st[k], want_st[k])
        init = TS.mamba_state_init(tc, 2)
        assert {k: (tuple(a.shape), a.dtype) for k, a in init.items()} == \
            {k: (tuple(a.shape), a.dtype) for k, a in got_st.items()}


# --------------------------------------------------------------------------
# the prefix-LM mask
# --------------------------------------------------------------------------

def _prefix_naive(rng):
    q, k, v = _np(rng, 2, 40, 4, 16), _np(rng, 2, 40, 2, 16), \
        _np(rng, 2, 40, 2, 16)
    got = TL.naive_attention(_t(q), _t(k), _t(v), prefix_len=12)
    assert_close(got, RL.naive_attention(q, k, v, prefix_len=12))
    # a prefix query sees the whole prefix: it differs from causal
    causal = TL.naive_attention(_t(q), _t(k), _t(v))
    assert float((got[:, :11] - causal[:, :11]).abs().max()) > 1e-2
    assert_close(got[:, 12:], causal[:, 12:].numpy(), rtol=0, atol=1e-6)


def _prefix_flash(rng):
    """The chunked path at a prefix inside the first macro block's causal
    reach (equal to naive attention), and at one past it, where JAX's
    ``flash_attention_xla`` skips key chunks that the prefix needs (its
    causal bound ignores the prefix) and the port follows it."""
    q, k, v = _np(rng, 2, 96, 4, 16), _np(rng, 2, 96, 1, 16), \
        _np(rng, 2, 96, 1, 16)
    for prefix, reached in ((16, True), (40, False)):
        kw = dict(prefix_len=prefix, chunk=32, n_macro=4)
        got = TL.flash_attention_xla(_t(q), _t(k), _t(v), **kw)
        assert_close(got, RL.flash_attention_xla(q, k, v, **kw))
        naive = TL.naive_attention(_t(q), _t(k), _t(v), prefix_len=prefix)
        err = float((got - naive).abs().max())
        assert err <= 2e-5 if reached else err > 0.1, (prefix, err)


def _prefix_block(rng):
    rc = dataclasses.replace(MODEL_CASES["vlm"][0], attn_impl="pallas")
    rp = to_numpy_tree(RL.attn_init(jax.random.PRNGKey(7), rc))
    tp = params_from_numpy(rp, "cpu")
    x = _np(rng, 2, 300, 64)              # 300^2 scores: past the naive cut
    want, _ = J_PREFIX_BLOCK(rp, jnp.asarray(x), rc, prefix_len=20)
    got, _ = TL.attention_block(tp, _t(x), port_config(rc), prefix_len=20)
    assert_close(got, want)


PREFIX_CASES = {"naive": _prefix_naive, "flash_xla": _prefix_flash,
                "attention_block": _prefix_block}


@pytest.mark.parametrize("name", list(PREFIX_CASES))
def test_prefix_lm_matches_jax(name):
    PREFIX_CASES[name](np.random.default_rng(len(name)))


def test_prefix_never_reaches_flash_kernel(monkeypatch):
    """``_attend`` sends a prefix-LM call to the chunked plain path, as
    JAX does; the same call without a prefix reaches the flash dispatch."""
    from repro_torch.kernels import ops
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    tc = port_config(dataclasses.replace(MODEL_CASES["vlm"][0],
                                         attn_impl="pallas"))
    q = k = v = torch.zeros(1, 300, 4, 16)
    TL._attend(tc, q, k[:, :, :1], v[:, :, :1], causal=True, prefix_len=8)
    assert not calls
    TL._attend(tc, q, k[:, :, :1], v[:, :, :1], causal=True)
    assert calls == [1]


# --------------------------------------------------------------------------
# models
# --------------------------------------------------------------------------

FAMILIES = ("granite_moe_3b_a800m", "grok_1_314b", "hymba_1p5b",
            "paligemma_3b")


def _config(name, impl, **over):
    rc = RC.get_smoke_config(name) if name in FAMILIES else \
        MODEL_CASES[name][0]
    rc = dataclasses.replace(rc, attn_impl=impl, **over)
    return rc, port_config(rc)


def _pair(name, impl, seed, **over):
    rc, tc = _config(name, impl, **over)
    rp = to_numpy_tree(zoo.J_INIT(jax.random.PRNGKey(seed), rc))
    return rc, tc, jax.tree.map(jnp.asarray, rp), \
        params_from_numpy(rp, "cpu")


def _embeds(rc, rng, B):
    return _np(rng, B, rc.vlm_prefix, rc.d_model) if rc.vlm_prefix else None


def _no_drops(rc):
    return rc.block.value != "moe" or \
        rc.capacity_factor >= rc.n_experts / rc.experts_per_token


MODEL_RUNS = ([(n, "pallas") for n in ("moe", "hybrid", "vlm") + FAMILIES]
              + [("hymba_1p5b", "xla_naive")])


@pytest.mark.parametrize("name,impl", MODEL_RUNS, ids=str)
def test_forward_prefill_and_decode_match_jax(name, impl):
    """A prompt (after the VLM's prefix) into a cache 4 rows longer, 4
    decode steps; the cache-less forward over everything with a tap after
    layer 1 and its aux loss.  The zoo configs' 260-token prompts reach
    the chunked plain path with a tensor offset (260 x 264 scores), the
    test_models cases' 36 the naive one.  Where no assignment can be
    dropped, decode equals the full forward."""
    rc, tc, rp, tp = _pair(name, impl, seed=len(name))
    rng = np.random.default_rng(9)
    B, P, n_dec = 2, 260 if name in FAMILIES else 36, 4
    toks = rng.integers(0, rc.vocab_size, (B, P + n_dec))
    emb = _embeds(rc, rng, B)
    ek = {} if emb is None else {"embeds": emb}
    tk = {k: _t(a) for k, a in ek.items()}
    want_logits, want_tap, want_aux = j_forward(rp, rc, jnp.asarray(toks),
                                                tap_layer=1, **ek)
    got = TM.forward(tp, tc, _t(toks), tap_layer=1, **tk)
    assert_close(got.logits, want_logits)
    assert_close(got.tap, want_tap)
    assert_close(got.aux, want_aux, rtol=1e-5, atol=1e-6)
    if rc.block.value != "moe":
        assert float(got.aux) == 0.0

    n_pre = rc.vlm_prefix + P
    rcache = RSV.init_cache(rc, B, n_pre + n_dec)
    tcache = TSV.init_cache(tc, B, n_pre + n_dec, device="cpu")
    assert jax.tree.map(np.shape, rcache["layers"]) == \
        {k: tuple(a.shape) for k, a in tcache["layers"].items()}
    ptrs = {k: a.data_ptr() for k, a in tcache["layers"].items()}
    rl, rcache, _ = zoo.J_PREFILL(rp, rc, jnp.asarray(toks[:, :P]),
                                  cache=rcache, **ek)
    before = dict(build.LAUNCHES)
    tl, tcache, _ = TSV.prefill(tp, tc, _t(toks[:, :P]), cache=tcache, **tk)
    assert_close(tl, rl)
    for t in range(P, P + n_dec):
        rl, rcache = zoo.J_DECODE(rp, rc, jnp.asarray(toks[:, t:t + 1]),
                                  cache=rcache)
        tl, tcache = TSV.decode_step(tp, tc, _t(toks[:, t:t + 1]),
                                     cache=tcache)
        assert_close(tl, rl)
        assert {k: a.data_ptr() for k, a in tcache["layers"].items()} == ptrs
    assert build.LAUNCHES == before             # CPU tensors: plain versions
    assert sorted(tcache["layers"]) == sorted(rcache["layers"])
    for key, a in rcache["layers"].items():
        assert tcache["layers"][key].dtype == getattr(torch, str(a.dtype))
        assert_close(tcache["layers"][key], a)
    assert int(tcache["len"]) == int(rcache["len"]) == n_pre + n_dec
    if _no_drops(rc):                           # decode == full forward
        assert_close(tl, got.logits[:, n_pre + n_dec - 1].numpy())


@pytest.mark.parametrize("name,impl", MODEL_RUNS, ids=str)
def test_greedy_generate_same_tokens(name, impl):
    rc, tc, rp, tp = _pair(name, impl, seed=len(name) + 1)
    prompt = np.random.default_rng(10).integers(0, rc.vocab_size, (2, 12))
    want = zoo.J_GREEDY(rp, rc, jnp.asarray(prompt), 6, 24)
    got = TSV.greedy_generate(tp, tc, _t(prompt), 6, 24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _ring_run(prompt_len, n_dec, window=8):
    """The hybrid case with a ``window``-row ring cache: prefill then
    ``n_dec`` steps in both packages, and the cache-less forward."""
    rc, tc, rp, tp = _pair("hybrid", "xla_naive", seed=11,
                           sliding_window=window)
    rng = np.random.default_rng(12)
    n = prompt_len + n_dec
    toks = rng.integers(0, rc.vocab_size, (2, n))
    rcache = RSV.init_cache(rc, 2, n + 8)
    tcache = TSV.init_cache(tc, 2, n + 8, device="cpu")
    assert tuple(tcache["layers"]["k"].shape[2:3]) == (window,)
    rl, rcache, _ = zoo.J_PREFILL(rp, rc, jnp.asarray(toks[:, :prompt_len]),
                                  cache=rcache)
    tl, tcache, _ = TSV.prefill(tp, tc, _t(toks[:, :prompt_len]),
                                cache=tcache)
    steps = [(tl, rl)]
    for t in range(prompt_len, n):
        rl, rcache = zoo.J_DECODE(rp, rc, jnp.asarray(toks[:, t:t + 1]),
                                  cache=rcache)
        tl, tcache = TSV.decode_step(tp, tc, _t(toks[:, t:t + 1]),
                                     cache=tcache)
        steps.append((tl, rl))
    for key, a in rcache["layers"].items():
        assert_close(tcache["layers"][key], a)
    full = TM.forward(tp, tc, _t(toks)).logits[:, prompt_len - 1:]
    return steps, full


def test_hybrid_ring_decodes_across_the_wrap():
    """Window 8, a 6-token prompt and 6 steps: the ring wraps at step 3.
    The port equals JAX at every step, and both equal the cache-less
    forward (the prompt fits the window)."""
    steps, full = _ring_run(6, 6)
    for i, (tl, rl) in enumerate(steps):
        assert_close(tl, rl)
        assert_close(tl, full[:, i].numpy())
        np.testing.assert_allclose(np.asarray(rl), full[:, i].numpy(),
                                   rtol=1e-4, atol=1e-3)


def test_ring_prefill_longer_than_the_window_follows_jax():
    """The reference's fault, pinned: a prompt longer than the ring keeps
    only its last ``window`` rows and attends the whole prompt over them,
    so the last prefill logits differ from the cache-less forward.  The
    port follows JAX there."""
    steps, full = _ring_run(16, 2)
    tl, rl = steps[0]
    assert_close(tl, rl)
    assert float((tl - full[:, 0]).abs().max()) > 0.1
    for tl, rl in steps[1:]:
        assert_close(tl, rl)


@pytest.mark.parametrize("name", ["granite_moe_3b_a800m", "hymba_1p5b",
                                  "paligemma_3b"])
def test_full_width_layer_matches_jax(name):
    """One layer at the published widths (granite: d 1536, 24 heads over
    8, 40 experts top-8 of d_ff 512; hymba: d 1600, 25 heads over 5,
    d_inner 3200, N 16, its 1024 window; paligemma: d 2048, 8 heads over
    1 of 256, GeGLU d_ff 16384, 16 prefix embeddings), vocab cut to 512,
    float32; a 40-token prefill then one decode step."""
    over = dict(n_layers=1, vocab_size=512, dtype="float32",
                attn_impl="pallas", max_seq_len=128)
    if name == "granite_moe_3b_a800m":
        over["capacity_factor"] = 5.0             # E / K: nothing drops
    if name == "paligemma_3b":
        over["vlm_prefix"] = 16
    rc = RC.get_config(name, **over)
    tc = port_config(rc)
    rp = to_numpy_tree(zoo.J_INIT(jax.random.PRNGKey(13), rc))
    tp = params_from_numpy(rp, "cpu")
    rp = jax.tree.map(jnp.asarray, rp)
    rng = np.random.default_rng(14)
    toks = rng.integers(0, 512, (2, 41))
    emb = _embeds(rc, rng, 2)
    ek = {} if emb is None else {"embeds": emb}
    cap = rc.vlm_prefix + 48
    rcache = RSV.init_cache(rc, 2, cap)
    tcache = TSV.init_cache(tc, 2, cap, device="cpu")
    rl, rcache, _ = zoo.J_PREFILL(rp, rc, jnp.asarray(toks[:, :40]),
                                  cache=rcache, **ek)
    tl, tcache, _ = TSV.prefill(tp, tc, _t(toks[:, :40]), cache=tcache,
                                **{k: _t(a) for k, a in ek.items()})
    assert_close(tl, rl)
    rl, rcache = zoo.J_DECODE(rp, rc, jnp.asarray(toks[:, 40:]), cache=rcache)
    tl, tcache = TSV.decode_step(tp, tc, _t(toks[:, 40:]), cache=tcache)
    assert_close(tl, rl)
    for key, a in rcache["layers"].items():
        assert_close(tcache["layers"][key], a)


def test_paligemma_tokens_only_forward_at_hd_256_matches_jax():
    """A narrow paligemma (2 layers, d 128, 2 heads over 1 kv head of
    256, GeGLU) under ``pallas``, tokens only: 384 tokens, past 256 x 256
    scores and a multiple of the JAX wrapper's 128-row tiles, so the
    reference runs its Pallas kernel (interpreted) at hd 256 in each
    layer, and the port's ``_attend`` reaches ``ops.flash_attention``
    once a layer (its plain version on the CPU)."""
    from repro_torch.kernels import ops
    rc = RC.get_config("paligemma_3b", n_layers=2, d_model=128, n_heads=2,
                       n_kv_heads=1, head_dim=256, d_ff=256, vocab_size=512,
                       dtype="float32", attn_impl="pallas", max_seq_len=512)
    tc = port_config(rc)
    rp = to_numpy_tree(zoo.J_INIT(jax.random.PRNGKey(15), rc))
    tp = params_from_numpy(rp, "cpu")
    toks = np.random.default_rng(16).integers(0, 512, (1, 384))
    want, _, _ = j_forward(jax.tree.map(jnp.asarray, rp), rc,
                           jnp.asarray(toks))
    ops.reset_plain_counts()
    got = TM.forward(tp, tc, _t(toks)).logits
    assert ops.plain_counts()["flash_attention_bhsd"] == rc.n_layers
    assert_close(got, want)


def test_mamba_states_written_in_place():
    """A hybrid cache's ``ssm`` and ``conv`` keep their tensors through
    prefill and decode, and their values change each call: decode reads
    the state the previous call wrote."""
    rc, tc, _, tp = _pair("hybrid", "pallas", seed=15)
    toks = _t(np.random.default_rng(16).integers(0, rc.vocab_size, (2, 10)))
    cache = TSV.init_cache(tc, 2, 12, device="cpu")
    ptrs = {k: a.data_ptr() for k, a in cache["layers"].items()}
    assert {"ssm", "conv"} <= set(ptrs)
    _, cache, _ = TSV.prefill(tp, tc, toks[:, :8], cache=cache)
    seen = [{k: cache["layers"][k].clone() for k in ("ssm", "conv")}]
    for t in (8, 9):
        _, cache = TSV.decode_step(tp, tc, toks[:, t:t + 1], cache=cache)
        seen.append({k: cache["layers"][k].clone() for k in ("ssm", "conv")})
    assert {k: a.data_ptr() for k, a in cache["layers"].items()} == ptrs
    assert float(seen[0]["ssm"].abs().max()) > 0
    for a, b in zip(seen, seen[1:]):
        for k in ("ssm", "conv"):
            assert not torch.equal(a[k], b[k])
    # the conv state holds the last ssm_conv - 1 inputs of the Mamba branch
    assert cache["layers"]["conv"].shape[2] == rc.ssm_conv - 1


@pytest.mark.parametrize("name", FAMILIES)
def test_smoke_configs_serve_on_the_cpu(name):
    """``init_params``, ``init_cache``, ``prefill`` and ``decode_step`` at
    the smoke configs in bf16, on the CPU: finite logits, the cache's
    leaves in their declared dtypes, ``len`` advanced."""
    cfg = dataclasses.replace(TC.get_smoke_config(name), dtype="bfloat16")
    p = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    cache = TSV.init_cache(cfg, 2, 24 + cfg.vlm_prefix, device="cpu")
    kw = {}
    if cfg.vlm_prefix:
        kw["embeds"] = torch.randn(2, cfg.vlm_prefix, cfg.d_model,
                                   generator=torch.Generator().manual_seed(1))
    toks = torch.randint(0, cfg.vocab_size, (2, 20),
                         generator=torch.Generator().manual_seed(2))
    logits, cache, _ = TSV.prefill(p, cfg, toks, cache=cache, **kw)
    for _ in range(3):
        logits, cache = TSV.decode_step(p, cfg, logits.argmax(-1)[:, None],
                                        cache=cache)
    assert logits.dtype == torch.bfloat16 and bool(torch.isfinite(
        logits).all())
    assert int(cache["len"]) == cfg.vlm_prefix + 23
    if cfg.block.value == "hybrid":
        assert cache["layers"]["ssm"].dtype == torch.float32
        assert cache["layers"]["conv"].dtype == torch.bfloat16
    assert math.isfinite(float(TM.forward(p, cfg, toks, **kw).aux))
