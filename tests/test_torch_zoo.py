"""The port's dense attention family and encoder-decoder against the JAX
package, on the CPU.

The same numpy-seeded inputs and weights (moved by ``params_from_numpy``)
go through both packages; float paths are held at rtol 1e-4 / atol 1e-3
(``tests/torch_parity.py``: float32 products summed in another order).

- Layers: twins of ``tests/test_layers.py``'s non-MoE cases, each also
  against the JAX function; activations, sinusoidal positions;
  ``flash_attention_xla`` over ``kv_len``, ``kv_pos``, an int and a
  tensor ``q_offset``, ``prefix_len``, ``softcap`` and a chunk that does
  not divide Sk; ``attention_block`` with a contiguous cache, a ring
  cache and ``kv_source``, its cache written in place.
- Models: ``forward`` logits and tap, ``prefill`` + 4 ``decode_step``s
  (logits and every cache leaf) and ``greedy_generate`` tokens at the
  smoke configs of qwen2-0.5b, qwen2-72b, deepseek-coder-33b,
  starcoder2-3b and whisper-base and ``tests/test_models.py``'s dense,
  dense-bias, encdec and sliding cases (plus softcap and scaled
  embeddings), all under ``attn_impl="pallas"`` and qwen2-0.5b's under
  all three; a whisper case with 300 frames reaches
  ``ops.flash_attention``'s plain version; one full-width float32 layer
  each of qwen2-0.5b and whisper-base.

Under ``pallas`` the port's single-token decode call goes to
``ops.decode_attention`` (its plain version here) where JAX runs
``naive_attention``: the same function, held by these comparisons.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import layers as RL
from repro.models import model as RM
from repro.models import serve as RSV
from repro.models.config import Activation as RAct
from repro.models.config import ModelConfig as RConfig
from repro_torch import configs as TC
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import build, ops
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import serve as TSV
from repro_torch.models.config import (Activation as TAct,
                                       BlockKind as TBlock,
                                       BranchSpec as TBranch,
                                       ModelConfig as TConfig)

from test_models import CASES as MODEL_CASES
from torch_parity import assert_close, to_numpy_tree


def port_config(rc: RConfig) -> TConfig:
    """A JAX-package config as the port's, field by field."""
    kw = {f.name: getattr(rc, f.name) for f in dataclasses.fields(rc)}
    kw["block"] = TBlock(rc.block.value)
    kw["activation"] = TAct(rc.activation.value)
    if rc.branch is not None:
        kw["branch"] = TBranch(**dataclasses.asdict(rc.branch))
    return TConfig(**kw)


# the JAX package's entry points, jitted whole (one compile a config
# instead of one per op); the config is static
J_INIT = jax.jit(RM.init_params, static_argnums=1)
J_PREFILL = jax.jit(RSV.prefill, static_argnums=1)
J_DECODE = jax.jit(RSV.decode_step, static_argnums=1)
J_GREEDY = jax.jit(RSV.greedy_generate, static_argnums=(1, 3, 4))
J_BLOCK = jax.jit(RL.attention_block, static_argnums=2,
                  static_argnames=("causal", "use_rope"))


@functools.partial(jax.jit, static_argnums=1, static_argnames=("tap_layer",))
def j_forward(params, cfg, tokens, tap_layer=None, frames=None):
    """The JAX forward's (logits, tap), jitted."""
    out = RM.forward(params, cfg, tokens, tap_layer=tap_layer, frames=frames)
    return out.logits, out.tap


def _np(rng, *shape, scale=1.0):
    return (rng.normal(0, 1, shape) * scale).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

TINY = RConfig(name="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
               head_dim=16, d_ff=128, vocab_size=128, dtype="float32",
               max_seq_len=256, attn_impl="xla_naive")


def _flash_causal(rng):
    q, k, v = _np(rng, 2, 256, 8, 32), _np(rng, 2, 256, 2, 32), \
        _np(rng, 2, 256, 2, 32)
    got = TL.flash_attention_xla(_t(q), _t(k), _t(v), causal=True, chunk=64,
                                 n_macro=4)
    assert_close(got, TL.naive_attention(_t(q), _t(k), _t(v)).numpy(),
                 rtol=0, atol=2e-5)
    assert_close(got, RL.flash_attention_xla(q, k, v, causal=True, chunk=64,
                                             n_macro=4))


def _flash_window(sw):
    def case(rng):
        q, k, v = (_np(rng, 1, 128, 4, 16) for _ in range(3))
        got = TL.flash_attention_xla(_t(q), _t(k), _t(v), chunk=32,
                                     n_macro=4, sliding_window=sw)
        assert_close(got, TL.naive_attention(_t(q), _t(k), _t(v),
                                             sliding_window=sw).numpy(),
                     rtol=0, atol=2e-5)
        assert_close(got, RL.naive_attention(q, k, v, sliding_window=sw))
    return case


def _causality(rng):
    tc = port_config(TINY)
    rp = to_numpy_tree(RL.attn_init(jax.random.PRNGKey(0), TINY))
    tp = params_from_numpy(rp, "cpu")
    x = _np(rng, 1, 16, 64)
    full, _ = TL.attention_block(tp, _t(x), tc)
    half, _ = TL.attention_block(tp, _t(x[:, :8]), tc)
    assert_close(full[:, :8], half.numpy(), rtol=0, atol=1e-5)
    assert_close(full, J_BLOCK(rp, x, TINY)[0])


def _gqa(rng):
    q, k, v = _np(rng, 1, 32, 4, 16), _np(rng, 1, 32, 2, 16), \
        _np(rng, 1, 32, 2, 16)
    got = TL.naive_attention(_t(q), _t(k), _t(v))
    rep = TL.naive_attention(_t(q), _t(k).repeat_interleave(2, 2),
                             _t(v).repeat_interleave(2, 2))
    assert_close(got, rep.numpy(), rtol=0, atol=1e-5)
    assert_close(got, RL.naive_attention(q, k, v))


def _rope_shift(rng):
    q, k = _np(rng, 1, 4, 1, 16), _np(rng, 1, 4, 1, 16)

    def scores(offset):
        pos = torch.arange(4)[None, :] + offset
        qr = TL.apply_rope(_t(q), pos, 10000.0)
        kr = TL.apply_rope(_t(k), pos, 10000.0)
        return torch.einsum("bqhd,bkhd->bqk", qr, kr)
    assert_close(scores(0), scores(37).numpy(), rtol=0, atol=1e-3)
    pos = np.arange(4)[None, :] + 30000
    assert_close(TL.apply_rope(_t(q), _t(pos), 1e6),
                 RL.apply_rope(q, pos, 1e6))


def _norms(rng):
    x = _np(rng, 2, 4, 64) * 10 + 3
    for layernorm in (False, True):
        rc = dataclasses.replace(TINY, layernorm=layernorm)
        rp = to_numpy_tree(RL.norm_init(rc))
        tp = TL.norm_init(port_config(rc))
        assert sorted(tp) == sorted(rp)
        y = TL.apply_norm(tp, _t(x), 1e-6)
        if layernorm:
            assert_close(y.mean(-1), np.zeros((2, 4)), rtol=0, atol=1e-4)
        else:
            assert_close(y.square().mean(-1), np.ones((2, 4)), rtol=0.2)
        assert_close(y, RL.apply_norm(rp, x, 1e-6))


def _activations(rng):
    x = _np(rng, 3, 50, scale=3.0)
    for act in TAct:
        assert_close(TL.activation_fn(act)(_t(x)),
                     RL.activation_fn(RAct(act.value))(x), rtol=1e-5,
                     atol=1e-6)


def _sinusoid(rng):
    assert_close(TL.sinusoid_pos(300, 64), RL.sinusoid_pos(300, 64),
                 rtol=1e-5, atol=1e-5)


LAYER_CASES = {"flash_causal": _flash_causal, "flash_window16":
               _flash_window(16), "flash_window64": _flash_window(64),
               "causality": _causality, "gqa": _gqa,
               "rope_shift": _rope_shift, "norms": _norms,
               "activations": _activations, "sinusoid": _sinusoid}


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_layer_twins_match_jax(name):
    LAYER_CASES[name](np.random.default_rng(len(name)))


# (Sq, Sk, H, KV, kwargs): cached prefill (tensor offset + kv_len), a ring
# cache's kv_pos with a window, int offsets with causal and window block
# skipping, the prefix-LM mask, softcap, and chunks that do not divide Sk
FLASH_XLA = [
    (16, 96, 4, 2, dict(q_offset="t40", kv_len="t56", n_macro=1, chunk=32)),
    (1, 96, 4, 2, dict(q_offset="t70", kv_len="t71", n_macro=1, chunk=32)),
    (24, 48, 4, 4, dict(q_offset="t60", kv_pos="ring", n_macro=1, chunk=16,
                        sliding_window=24)),
    (64, 128, 4, 2, dict(q_offset=64, n_macro=4, chunk=32)),
    (128, 128, 4, 2, dict(n_macro=8, chunk=16, sliding_window=20)),
    (64, 64, 4, 2, dict(prefix_len=8, n_macro=4, chunk=16)),
    (64, 64, 4, 1, dict(softcap=5.0, n_macro=2, chunk=32)),
    (48, 96, 2, 2, dict(causal=False, n_macro=3, chunk=64)),     # -> 48
    (4, 1056, 4, 2, dict(q_offset="t900", kv_len="t904", n_macro=1)),  # 352
]


def _flash_args(kw, Sk, rng):
    rk, tk = {}, {}
    for key, val in kw.items():
        if key == "kv_pos":                # slots hold shuffled positions
            pos = rng.permutation(np.arange(36, 36 + Sk)).astype(np.int32)
            pos[rng.choice(Sk, 5, replace=False)] = -1
            rk[key], tk[key] = jnp.asarray(pos), torch.as_tensor(pos)
        elif isinstance(val, str):
            rk[key] = jnp.asarray(int(val[1:]), jnp.int32)
            tk[key] = torch.tensor(int(val[1:]), dtype=torch.int32)
        else:
            rk[key] = tk[key] = val
    return rk, tk


@pytest.mark.parametrize("case", FLASH_XLA, ids=str)
def test_flash_attention_xla_matches_jax(case):
    Sq, Sk, H, KV, kw = case
    rng = np.random.default_rng(Sq * Sk)
    scale = 3.0 if "softcap" in kw else 1.0
    q, k, v = _np(rng, 2, Sq, H, 16, scale=scale), \
        _np(rng, 2, Sk, KV, 16, scale=scale), _np(rng, 2, Sk, KV, 16)
    rk, tk = _flash_args(kw, Sk, rng)
    got = TL.flash_attention_xla(_t(q), _t(k), _t(v), **tk)
    assert got.shape == q.shape
    assert_close(got, RL.flash_attention_xla(q, k, v, **rk))
    naive = {key: val for key, val in tk.items()
             if key not in ("n_macro", "chunk")}
    assert_close(TL.naive_attention(_t(q), _t(k), _t(v), **naive),
                 RL.naive_attention(q, k, v, **{
                     key: val for key, val in rk.items()
                     if key not in ("n_macro", "chunk")}))
    assert_close(got, TL.naive_attention(_t(q), _t(k), _t(v),
                                         **naive).numpy())


def _block_pair(rc, seed, cross=False):
    rp = to_numpy_tree(RL.attn_init(jax.random.PRNGKey(seed), rc,
                                    cross=cross))
    if "bq" in rp:                         # non-zero biases
        rng = np.random.default_rng(seed)
        rp = {k: (_np(rng, *a.shape, scale=0.1) if k.startswith("b") else a)
              for k, a in rp.items()}
    return rp, params_from_numpy(rp, "cpu")


@pytest.mark.parametrize("kind,impl", [("contiguous", "xla_naive"),
                                       ("contiguous", "pallas"),
                                       ("ring", "pallas"),
                                       ("cross", "pallas")])
def test_attention_block_with_caches_matches_jax(kind, impl):
    rc = dataclasses.replace(TINY, qkv_bias=True, attn_impl=impl,
                             sliding_window=8 if kind == "ring" else None)
    tc = port_config(rc)
    rp, tp = _block_pair(rc, 3, cross=kind == "cross")
    rng = np.random.default_rng(4)
    B, cap = 2, 8 if kind == "ring" else 32
    x = _np(rng, B, 15, 64)
    if kind == "cross":
        mem = _np(rng, B, 20, 64)
        want, _ = J_BLOCK(rp, x, rc, causal=False, kv_source=mem,
                          use_rope=False)
        got, none = TL.attention_block(tp, _t(x), tc, causal=False,
                                       kv_source=_t(mem), use_rope=False)
        assert none is None
        assert_close(got, want)
        return
    rcache = {"k": jnp.zeros((B, cap, 2, 16)), "v": jnp.zeros((B, cap, 2, 16)),
              "len": jnp.zeros((), jnp.int32)}
    tcache = {"k": torch.zeros((B, cap, 2, 16)),
              "v": torch.zeros((B, cap, 2, 16)),
              "len": torch.zeros((), dtype=torch.int32)}
    if kind == "ring":
        rcache["pos"] = jnp.full((cap,), -1, jnp.int32)
        tcache["pos"] = torch.full((cap,), -1, dtype=torch.int32)
    ptrs = {k: a.data_ptr() for k, a in tcache.items() if k != "len"}
    for lo, hi in ((0, 12), (12, 13), (13, 14), (14, 15)):
        pos = np.arange(lo, hi)[None, :]
        want, rcache = J_BLOCK(rp, x[:, lo:hi], rc,
                               positions=jnp.asarray(pos), cache=rcache)
        got, tcache = TL.attention_block(tp, _t(x[:, lo:hi]), tc,
                                         positions=_t(pos), cache=tcache)
        assert_close(got, want)
        for key, a in rcache.items():
            assert_close(tcache[key], a)
        assert {k: a.data_ptr() for k, a in tcache.items() if k != "len"} \
            == ptrs
    assert int(tcache["len"]) == 15


def test_decode_route_goes_to_decode_attention(monkeypatch):
    """Under ``pallas`` the single-token call on a contiguous cache goes to
    ``ops.decode_attention`` with the cache and ``len + 1``; a prefill,
    another attn_impl, a window or softcap do not."""
    calls = []
    real = ops.decode_attention

    def spy(q, k, v, kv_len, **kw):
        calls.append((tuple(q.shape), k.data_ptr(), int(kv_len)))
        return real(q, k, v, kv_len, **kw)

    monkeypatch.setattr(ops, "decode_attention", spy)
    rng = np.random.default_rng(5)
    x = _t(_np(rng, 2, 6, 64))
    for over, want in ((dict(attn_impl="pallas"), 1),
                       (dict(attn_impl="xla_flash"), 0),
                       (dict(attn_impl="pallas", logits_softcap=5.0), 0),
                       (dict(attn_impl="pallas", sliding_window=64), 0)):
        calls.clear()
        tc = port_config(dataclasses.replace(TINY, **over))
        _, tp = _block_pair(TINY, 6)
        cache = {"k": torch.zeros((2, 16, 2, 16)),
                 "v": torch.zeros((2, 16, 2, 16)),
                 "len": torch.zeros((), dtype=torch.int32)}
        _, cache = TL.attention_block(tp, x[:, :5], tc,
                                      positions=torch.arange(5)[None],
                                      cache=cache)
        assert not calls
        TL.attention_block(tp, x[:, 5:], tc, positions=_t([[5]]),
                           cache=cache)
        assert len(calls) == want
        if want:
            assert calls[0] == ((2, 4, 16), cache["k"].data_ptr(), 6)


# --------------------------------------------------------------------------
# models
# --------------------------------------------------------------------------

ZOO = ("qwen2_0p5b", "qwen2_72b", "deepseek_coder_33b", "starcoder2_3b",
       "whisper_base")


def _config(name, impl, **over):
    if name in ZOO:
        rc = RC.get_smoke_config(name)
    elif name == "dense-softcap":
        rc = dataclasses.replace(MODEL_CASES["dense"][0], name="dsc",
                                 logits_softcap=5.0, scale_embed=True,
                                 activation=RAct.GELU)
    else:
        rc = MODEL_CASES[name][0]
    rc = dataclasses.replace(rc, attn_impl=impl, **over)
    return rc, port_config(rc)


def _pair(name, impl, seed, **over):
    rc, tc = _config(name, impl, **over)
    rp = to_numpy_tree(J_INIT(jax.random.PRNGKey(seed), rc))
    rng = np.random.default_rng(seed)
    for tree in (rp["layers"], rp.get("enc_layers", {})):
        for blk in ("attn", "xattn"):       # non-zero biases and norms
            for key in ("bq", "bk", "bv"):
                if key in tree.get(blk, {}):
                    tree[blk][key] = _np(rng, *tree[blk][key].shape,
                                         scale=0.1)
        if "ln1" in tree and "b" in tree["ln1"]:
            tree["ln1"]["b"] = _np(rng, *tree["ln1"]["b"].shape, scale=0.1)
    return rc, tc, jax.tree.map(jnp.asarray, rp), params_from_numpy(rp, "cpu")


def _frames(rc, rng, B):
    return _np(rng, B, rc.enc_len, rc.d_model) if rc.enc_dec else None


MODEL_RUNS = ([(n, "pallas") for n in ZOO + ("dense", "dense-bias",
                                              "encdec", "sliding",
                                              "dense-softcap")]
              + [("qwen2_0p5b", "xla_naive"), ("qwen2_0p5b", "xla_flash")])


@pytest.mark.parametrize("name,impl", MODEL_RUNS, ids=str)
def test_forward_prefill_and_decode_match_jax(name, impl):
    """A 260-token prompt into a 264-row cache (260 x 264 scores reach the
    chunked plain path with a tensor offset), 4 decode steps; the
    cache-less forward over all 264 tokens (264^2 scores: the flash
    dispatch) with a tap after layer 1."""
    rc, tc, rp, tp = _pair(name, impl, seed=len(name))
    rng = np.random.default_rng(7)
    B, P, n_dec = 2, 260, 4
    toks = rng.integers(0, rc.vocab_size, (B, P + n_dec))
    frames = _frames(rc, rng, B)
    fk = {} if frames is None else {"frames": frames}
    want_logits, want_tap = j_forward(rp, rc, jnp.asarray(toks), tap_layer=1,
                                      **fk)
    got = TM.forward(tp, tc, _t(toks), tap_layer=1,
                     **{k: _t(a) for k, a in fk.items()})
    assert_close(got.logits, want_logits)
    assert_close(got.tap, want_tap)

    rcache = RSV.init_cache(rc, B, P + n_dec)
    tcache = TSV.init_cache(tc, B, P + n_dec, device="cpu")
    assert jax.tree.map(np.shape, rcache) == \
        {k: (jax.tree.map(lambda a: tuple(a.shape), v) if isinstance(v, dict)
             else tuple(v.shape)) for k, v in tcache.items()}
    ptrs = {k: a.data_ptr() for k, a in tcache["layers"].items()}
    rl, rcache, _ = J_PREFILL(rp, rc, jnp.asarray(toks[:, :P]),
                              cache=rcache, **fk)
    before = dict(build.LAUNCHES)
    tl, tcache, _ = TSV.prefill(tp, tc, _t(toks[:, :P]), cache=tcache,
                                **{k: _t(a) for k, a in fk.items()})
    assert_close(tl, rl)
    for t in range(P, P + n_dec):
        rl, rcache = J_DECODE(rp, rc, jnp.asarray(toks[:, t:t + 1]),
                              cache=rcache)
        tl, tcache = TSV.decode_step(tp, tc, _t(toks[:, t:t + 1]),
                                     cache=tcache)
        assert_close(tl, rl)
        assert {k: a.data_ptr() for k, a in tcache["layers"].items()} == ptrs
    assert build.LAUNCHES == before             # CPU tensors: plain versions
    assert sorted(tcache["layers"]) == sorted(rcache["layers"])
    for key, a in rcache["layers"].items():
        assert tuple(tcache["layers"][key].shape) == a.shape
        assert_close(tcache["layers"][key], a)
    if rc.enc_dec:
        assert_close(tcache["enc_out"], rcache["enc_out"])
    assert int(tcache["len"]) == int(rcache["len"]) == P + n_dec
    if rc.sliding_window is None:               # decode == full forward
        assert_close(tl, got.logits[:, P + n_dec - 1].numpy())


@pytest.mark.parametrize("name,impl", MODEL_RUNS, ids=str)
def test_greedy_generate_same_tokens(name, impl):
    rc, tc, rp, tp = _pair(name, impl, seed=len(name) + 1)
    prompt = np.random.default_rng(8).integers(0, rc.vocab_size, (2, 12))
    want = J_GREEDY(rp, rc, jnp.asarray(prompt), 6, 24)
    got = TSV.greedy_generate(tp, tc, _t(prompt), 6, 24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_whisper_300_frames_reach_flash_attention(monkeypatch):
    """300 frames: the encoder's 300 x 300 scores go to
    ``ops.flash_attention`` (its plain version here; JAX's falls back to
    its reference at 300 rows), once per encoder layer."""
    calls = []
    real = ops.flash_attention

    def spy(*a, **kw):
        calls.append((tuple(a[0].shape), kw.get("causal")))
        return real(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    rc, tc, rp, tp = _pair("whisper_base", "pallas", seed=9, enc_len=300)
    rng = np.random.default_rng(10)
    toks = rng.integers(0, rc.vocab_size, (2, 9))
    frames = _frames(rc, rng, 2)
    rcache = RSV.init_cache(rc, 2, 16)
    tcache = TSV.init_cache(tc, 2, 16, device="cpu")
    rl, rcache, _ = J_PREFILL(rp, rc, jnp.asarray(toks[:, :8]),
                              cache=rcache, frames=jnp.asarray(frames))
    tl, tcache, _ = TSV.prefill(tp, tc, _t(toks[:, :8]), cache=tcache,
                                frames=_t(frames))
    assert calls == [((2, 300, 4, 16), False)] * rc.n_enc_layers
    assert_close(tl, rl)
    assert_close(tcache["enc_out"], rcache["enc_out"])
    rl, _ = J_DECODE(rp, rc, jnp.asarray(toks[:, 8:]), cache=rcache)
    tl, _ = TSV.decode_step(tp, tc, _t(toks[:, 8:]), cache=tcache)
    assert_close(tl, rl)
    assert len(calls) == rc.n_enc_layers


@pytest.mark.parametrize("name", ["qwen2_0p5b", "whisper_base"])
def test_full_width_layer_matches_jax(name):
    """One layer at the published widths (qwen2-0.5b: d 896, 14 heads over
    2, hd 64, d_ff 4864, qkv bias; whisper-base: d 512, 8 heads, d_ff
    2048, LayerNorm, GELU, cross-attention to 40 frames), vocab cut to
    512, float32; a 40-token prefill then one decode step."""
    over = dict(n_layers=1, vocab_size=512, dtype="float32",
                attn_impl="pallas", max_seq_len=64)
    if name == "whisper_base":
        over.update(n_enc_layers=1, enc_len=40)
    rc = RC.get_config(name, **over)
    tc = port_config(rc)
    rp = to_numpy_tree(J_INIT(jax.random.PRNGKey(11), rc))
    tp = params_from_numpy(rp, "cpu")
    rp = jax.tree.map(jnp.asarray, rp)
    rng = np.random.default_rng(12)
    toks = rng.integers(0, 512, (2, 41))
    fk = {}
    if rc.enc_dec:
        fk["frames"] = _np(rng, 2, 40, rc.d_model)
    rcache, tcache = RSV.init_cache(rc, 2, 48), TSV.init_cache(tc, 2, 48,
                                                                device="cpu")
    rl, rcache, _ = J_PREFILL(rp, rc, jnp.asarray(toks[:, :40]),
                              cache=rcache, **fk)
    tl, tcache, _ = TSV.prefill(tp, tc, _t(toks[:, :40]), cache=tcache,
                                **{k: _t(a) for k, a in fk.items()})
    assert_close(tl, rl)
    rl, rcache = J_DECODE(rp, rc, jnp.asarray(toks[:, 40:]), cache=rcache)
    tl, tcache = TSV.decode_step(tp, tc, _t(toks[:, 40:]), cache=tcache)
    assert_close(tl, rl)
    assert_close(tcache["layers"]["k"], rcache["layers"]["k"])


def _example():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "torch_serve_stream.py")
    spec = importlib.util.spec_from_file_location("torch_serve_stream", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_stream_example_twin_runs_on_the_cpu(capsys):
    st = _example().main(["--batch", "2", "--prompt-len", "8", "--steps",
                          "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "cache len 11" in out and st.frames_processed + \
        st.frames_dropped == st.frames_seen == 40


def test_serve_stream_example_twin_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        _example().main(["--steps", "1"])
