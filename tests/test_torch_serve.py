"""The port's RWKV-6 serving path against the JAX package, on the CPU.

At ``get_smoke_config("rwkv6_3b")`` (float32) under both ``attn_impl``s:
``forward`` logits, and ``prefill`` + 4 ``decode_step``s (logits and
every cache leaf), at rtol/atol 1e-4 on ``xla_flash``, where both run the
same chunked function (the float-path tolerance of tests/test_kernels.py:
XLA and torch sum the products and take exp in another order and way,
and two layers carry it to ~2e-5 on logits of ~1), and 5e-3 on
``pallas``, where JAX's chunked Pallas kernel (interpreted) meets the
port's sequential plain version (the JAX kernel test's tolerance).
``greedy_generate`` gives the same tokens.  One full-width layer
(d_model 2560, 40 heads of 64, d_ff 8960) runs at atol 1e-4.  The port's config registry equals the JAX package's,
and bfloat16 weights carry across bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import model as RM
from repro.models import serve as RSV
from repro_torch import configs as TC
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import build
from repro_torch.models import model as TM
from repro_torch.models import serve as TSV

from torch_parity import to_numpy_tree

TOL = {"xla_flash": 1e-4, "pallas": 5e-3}


def _pair(attn_impl, seed=0, **overrides):
    rc = dataclasses.replace(RC.get_smoke_config("rwkv6_3b"),
                             attn_impl=attn_impl, **overrides)
    tc = dataclasses.replace(TC.get_smoke_config("rwkv6_3b"),
                             attn_impl=attn_impl, **overrides)
    rp = RM.init_params(jax.random.PRNGKey(seed), rc)
    return rc, tc, rp, params_from_numpy(to_numpy_tree(rp), "cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("attn_impl", ["xla_flash", "pallas"])
def test_forward_prefill_and_decode_match_jax(attn_impl):
    rc, tc, rp, tp = _pair(attn_impl)
    tol = TOL[attn_impl]
    toks = np.random.default_rng(1).integers(0, rc.vocab_size, (2, 36))
    want = RM.forward(rp, rc, jnp.asarray(toks), tap_layer=1)
    got = TM.forward(tp, tc, torch.as_tensor(toks), tap_layer=1)
    _close(got.logits, want.logits, tol)
    _close(got.tap, want.tap, tol)

    rcache = RSV.init_cache(rc, 2, 64)
    tcache = TSV.init_cache(tc, 2, 64, device="cpu")
    rl, rcache, _ = RSV.prefill(rp, rc, jnp.asarray(toks[:, :32]),
                                cache=rcache)
    before = dict(build.LAUNCHES)
    tl, tcache, _ = TSV.prefill(tp, tc, torch.as_tensor(toks[:, :32]),
                                cache=tcache)
    _close(tl, rl, tol)
    for t in range(32, 36):
        rl, rcache = RSV.decode_step(rp, rc, jnp.asarray(toks[:, t:t + 1]),
                                     cache=rcache)
        tl, tcache = TSV.decode_step(tp, tc,
                                     torch.as_tensor(toks[:, t:t + 1]),
                                     cache=tcache)
        _close(tl, rl, tol)
        # decode equals the full forward at the same position
        _close(tl, got.logits[:, t].numpy(), tol)
    assert build.LAUNCHES == before             # CPU tensors: plain versions
    assert sorted(tcache["layers"]) == sorted(rcache["layers"])
    for name, a in rcache["layers"].items():
        assert tuple(tcache["layers"][name].shape) == a.shape
        _close(tcache["layers"][name], a, tol)
    assert int(tcache["len"]) == int(rcache["len"]) == 36


@pytest.mark.parametrize("attn_impl", ["xla_flash", "pallas"])
def test_greedy_generate_same_tokens(attn_impl):
    rc, tc, rp, tp = _pair(attn_impl, seed=2)
    prompt = np.random.default_rng(3).integers(0, rc.vocab_size, (2, 16))
    want = RSV.greedy_generate(rp, rc, jnp.asarray(prompt), 6, 64)
    got = TSV.greedy_generate(tp, tc, torch.as_tensor(prompt), 6, 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_full_width_layer_matches_jax():
    """One rwkv6-3b layer at its published widths (H = 40, K = 64), vocab
    cut to 512; prefill of 64 tokens then one decode step."""
    cfg = dict(n_layers=1, vocab_size=512, dtype="float32")
    rc = RC.get_config("rwkv6_3b", **cfg)
    tc = TC.get_config("rwkv6_3b", **cfg)
    assert rc.n_rwkv_heads == tc.n_rwkv_heads == 40
    rp = RM.init_params(jax.random.PRNGKey(4), rc)
    tp = params_from_numpy(to_numpy_tree(rp), "cpu")
    toks = np.random.default_rng(5).integers(0, 512, (2, 65))
    rcache = RSV.init_cache(rc, 2, 128)
    tcache = TSV.init_cache(tc, 2, 128, device="cpu")
    rl, rcache, _ = RSV.prefill(rp, rc, jnp.asarray(toks[:, :64]),
                                cache=rcache)
    tl, tcache, _ = TSV.prefill(tp, tc, torch.as_tensor(toks[:, :64]),
                                cache=tcache)
    _close(tl, rl, 1e-4)
    rl, rcache = RSV.decode_step(rp, rc, jnp.asarray(toks[:, 64:]),
                                 cache=rcache)
    tl, tcache = TSV.decode_step(tp, tc, torch.as_tensor(toks[:, 64:]),
                                 cache=tcache)
    _close(tl, rl, 1e-4)
    _close(tcache["layers"]["wkv"], rcache["layers"]["wkv"], 1e-4)


def _fields(cfg):
    """A config as plain values (enums by value, nested dataclasses as
    dicts), so the two packages' configs compare field by field."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = dataclasses.asdict(v)
        out[f.name] = getattr(v, "value", v)
    return out


@pytest.mark.parametrize("name", RC.ARCHS)
def test_config_registry_matches_jax(name):
    assert _fields(TC.get_config(name)) == _fields(RC.get_config(name))
    assert _fields(TC.get_smoke_config(name)) == \
        _fields(RC.get_smoke_config(name))
    assert TC.get_config(name).param_count() == \
        RC.get_config(name).param_count()


def test_config_registry_names_and_aliases():
    assert TC.ARCHS == RC.ARCHS and TC.ALIASES == RC.ALIASES
    assert _fields(TC.get_config("rwkv6-3b", attn_impl="pallas")) == \
        _fields(RC.get_config("rwkv6-3b", attn_impl="pallas"))
    assert sorted(TC.all_configs()) == sorted(RC.all_configs())


def test_bfloat16_params_carry_across_bit_for_bit():
    cfg = dataclasses.replace(RC.get_smoke_config("rwkv6_3b"),
                              dtype="bfloat16")
    rp = to_numpy_tree(RM.init_params(jax.random.PRNGKey(6), cfg))
    tp = params_from_numpy(rp, "cpu")
    n_bf16 = 0

    def walk(r, t):
        nonlocal n_bf16
        if isinstance(r, dict):
            assert sorted(r) == sorted(t)
            for k in r:
                walk(r[k], t[k])
            return
        assert tuple(t.shape) == r.shape
        if r.dtype.name == "bfloat16":
            n_bf16 += 1
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          r.view(np.int16))
        else:
            assert r.dtype == np.float32 and t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), r)

    walk(rp, tp)
    assert n_bf16 > 10


def test_other_block_kinds_raise_until_ported():
    for name in ("qwen2_0p5b", "hymba_1p5b", "granite_moe_3b_a800m",
                 "whisper_base"):
        cfg = TC.get_smoke_config(name)
        with pytest.raises(NotImplementedError):
            TM.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
        with pytest.raises(NotImplementedError):
            TSV.init_cache(cfg, 1, 8, device="cpu")


def test_serving_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    cfg = TC.get_smoke_config("rwkv6_3b")
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TSV.init_cache(cfg, 1, 8)
    p = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert p["embed"].device.type == "cpu"
    assert p["layers"]["rwkv"]["w0"].dtype == torch.float32
    assert p["layers"]["rwkv"]["wr"].shape == (2, 64, 64)
