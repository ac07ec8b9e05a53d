"""The port's RWKV-6 pieces against the JAX package, on the CPU.

- The WKV recurrence: the port's sequential ``ref.rwkv6_scan_ref``
  against JAX's at rtol/atol 1e-5 (the same per-token function in fp32;
  outputs reach ~15 at T = 128, where one rounding is ~1e-6), and the
  port's ``ops.rwkv6_scan`` (its plain version on a CPU tensor) against
  JAX's ``ops.rwkv6_scan``, which runs the Pallas kernel in the
  interpreter, at the JAX kernel test's 5e-3 (the chunked kernel scales
  by exp(+-cumsum(lw)) up to e^64 and loses precision to it).
- The model modules (``rwkv_time_mix`` with and without state,
  ``rwkv_channel_mix``) at rtol/atol 1e-5: both packages run the same
  chunked function, summed in another order.  ``rwkv_chunk_scan`` alone,
  on the kernel test's raw inputs (decays down to -2 per token, so the
  chunk's exp(+-cumsum(lw)) factors reach e^60), at rtol/atol 1e-4, the
  float-path tolerance of tests/test_kernels.py: XLA's exp and torch's
  differ by an ulp or two and those factors carry it (measured: 3.3e-5).

Inputs are numpy arrays from a seed; weights come from the JAX package's
``rwkv_init`` and move across as numpy arrays.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.models import ssm as RS
from repro_torch.configs import get_smoke_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import rwkv6_scan as RK
from repro_torch.models import ssm as TS

from torch_parity import to_numpy_tree


def _scan_inputs(seed, B, H, T, K, V=None):
    """The JAX kernel test's distributions: normal r, k, v, decays in
    [-2, -1e-6], a small bonus u and initial state s0."""
    V = K if V is None else V
    rng = np.random.default_rng(seed)
    r, k = (rng.normal(0, 1, (B, H, T, K)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(0, 1, (B, H, T, V)).astype(np.float32)
    lw = np.clip(-np.exp(rng.normal(0, 1, (B, H, T, K)) * 0.3), -2.0,
                 -1e-6).astype(np.float32)
    u = (rng.normal(0, 1, (H, K)) * 0.1).astype(np.float32)
    s0 = (rng.normal(0, 1, (B, H, K, V)) * 0.1).astype(np.float32)
    return r, k, v, lw, u, s0


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.as_tensor(a) for a in arrays])


# the JAX kernel test's three shapes, and a T that no chunk of 32 divides
# (there the JAX wrapper falls back to its sequential reference)
SCAN_SHAPES = [(64, 16), (128, 64), (96, 32), (50, 16)]


@pytest.mark.parametrize("K", [48, 192])
def test_rwkv6_scan_other_key_widths_match_jax_kernel(K):
    """Key widths the card runs on a padded instantiation (48 on 64) and in
    slabs of 128 state rows (192): ``ops.rwkv6_scan`` (the plain version on
    a CPU tensor) against JAX's ``ops.rwkv6_scan``, which interprets the
    Pallas kernel, at the kernel test's 5e-3."""
    jx, tt = _both(_scan_inputs(K, 2, 3, 64, K, V=40))
    ko, ks = ops.rwkv6_scan(*tt)
    jo, js = rops.rwkv6_scan(*jx)
    assert ko.shape == (2, 3, 64, 40) and ks.shape == (2, 3, K, 40)
    np.testing.assert_allclose(ko.numpy(), np.asarray(jo), atol=5e-3)
    np.testing.assert_allclose(ks.numpy(), np.asarray(js), atol=5e-3)



@pytest.mark.parametrize("T,K", SCAN_SHAPES)
def test_rwkv6_scan_matches_jax(T, K):
    jx, tt = _both(_scan_inputs(T + K, 2, 3, T, K))
    want_o, want_s = rref.rwkv6_scan_ref(*jx)
    got_o, got_s = ref.rwkv6_scan_ref(*tt)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5,
                               atol=1e-5)
    before = dict(build.LAUNCHES)
    ko, ks = ops.rwkv6_scan(*tt)
    assert build.LAUNCHES == before            # a CPU tensor: plain version
    jo, js = rops.rwkv6_scan(*jx)
    np.testing.assert_allclose(ko.numpy(), np.asarray(jo), atol=5e-3)
    np.testing.assert_allclose(ks.numpy(), np.asarray(js), atol=5e-3)
    assert ko.dtype == torch.float32 and ks.dtype == torch.float32


def test_rwkv6_scan_state_continuation():
    """Two halves with the state carried == the whole sequence, in the
    port and against the JAX kernel."""
    r, k, v, lw, u, s0 = _scan_inputs(6, 1, 2, 64, 16)
    whole_o, whole_s = ops.rwkv6_scan(*(torch.as_tensor(a) for a in
                                        (r, k, v, lw, u, s0)))
    h = 32
    halves = [torch.as_tensor(a) for a in (r, k, v, lw)]
    o1, s1 = ops.rwkv6_scan(*(a[:, :, :h] for a in halves),
                            torch.as_tensor(u), torch.as_tensor(s0))
    o2, s2 = ops.rwkv6_scan(*(a[:, :, h:] for a in halves),
                            torch.as_tensor(u), s1)
    np.testing.assert_allclose(torch.cat([o1, o2], 2).numpy(),
                               whole_o.numpy(), atol=1e-5)
    np.testing.assert_allclose(s2.numpy(), whole_s.numpy(), atol=1e-5)
    jo, js = rops.rwkv6_scan(*(jnp.asarray(a) for a in (r, k, v, lw, u, s0)))
    np.testing.assert_allclose(whole_o.numpy(), np.asarray(jo), atol=5e-3)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js), atol=5e-3)


def test_rwkv6_scan_casts_output_to_input_dtype_and_checks_shapes():
    r, k, v, lw, u, s0 = (torch.as_tensor(a) for a in
                          _scan_inputs(3, 1, 2, 5, 16))
    o, s = ops.rwkv6_scan(r.bfloat16(), k.bfloat16(), v.bfloat16(), lw, u,
                          s0)
    assert o.dtype == torch.bfloat16 and s.dtype == torch.float32
    want, _ = RK.rwkv6_scan_plain(r.bfloat16(), k.bfloat16(), v.bfloat16(),
                                  lw, u, s0)
    assert torch.equal(o, want)
    with pytest.raises(ValueError, match="shapes"):
        RK.rwkv6_scan_bhtk(r, k, v, lw, u[:1], s0)
    with pytest.raises(RuntimeError, match="backward"):
        RK.rwkv6_scan_bhtk(r.clone().requires_grad_(), k, v, lw, u, s0)


@pytest.mark.parametrize("T", [64, 50, 1])
def test_rwkv_chunk_scan_matches_jax(T):
    jx, tt = _both(_scan_inputs(T, 2, 3, T, 16))
    want_o, want_s = RS.rwkv_chunk_scan(*jx)
    got_o, got_s = TS.rwkv_chunk_scan(*tt)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-4,
                               atol=1e-4)


def _rwkv_params(seed):
    """JAX ``rwkv_init`` at the rwkv6-3b smoke config, with the constant
    initializers (token-shift mixes, decay bias, bonus) randomised so that
    every parameter matters."""
    cfg = ref_smoke("rwkv6_3b")
    p = to_numpy_tree(RS.rwkv_init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    for name in ("mu", "mu_ck", "mu_cr"):
        p[name] = rng.uniform(0, 1, p[name].shape).astype(np.float32)
    p["w0"] = rng.normal(-0.6, 0.5, p["w0"].shape).astype(np.float32)
    p["u"] = rng.normal(0, 0.3, p["u"].shape).astype(np.float32)
    p["ln_w"] = rng.normal(1, 0.1, p["ln_w"].shape).astype(np.float32)
    p["ln_b"] = rng.normal(0, 0.1, p["ln_b"].shape).astype(np.float32)
    return cfg, p


def _state(rng, B, cfg):
    H, K = cfg.n_rwkv_heads, cfg.rwkv_head_dim
    return {"wkv": (rng.normal(0, 0.3, (B, H, K, K))).astype(np.float32),
            "shift_tm": rng.normal(0, 1, (B, cfg.d_model)).astype(np.float32),
            "shift_cm": rng.normal(0, 1, (B, cfg.d_model)).astype(np.float32)}


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("attn_impl", ["xla_flash", "pallas"])
def test_rwkv_time_mix_matches_jax(with_state, attn_impl):
    cfg, p = _rwkv_params(1)
    tcfg = dataclasses.replace(get_smoke_config("rwkv6_3b"),
                               attn_impl=attn_impl)
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 40, cfg.d_model)).astype(np.float32)
    st = _state(rng, 2, cfg) if with_state else None
    use_kernel = attn_impl == "pallas"
    want, want_st = RS.rwkv_time_mix(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), cfg,
        state=None if st is None else jax.tree.map(jnp.asarray, st),
        use_kernel=use_kernel)
    got, got_st = TS.rwkv_time_mix(
        params_from_numpy(p, "cpu"), torch.as_tensor(x), tcfg,
        state=None if st is None else params_from_numpy(st, "cpu"),
        use_kernel=use_kernel)
    # the plain path runs the same chunked function in both packages; the
    # kernel path meets JAX's chunked Pallas kernel with the port's
    # sequential plain version (the kernel test's tolerance)
    tol = 1e-5 if not use_kernel else 5e-3
    _close(got, want, tol)
    assert (got_st is None) == (not with_state)
    if with_state:
        for name in ("wkv", "shift_tm", "shift_cm"):
            _close(got_st[name], want_st[name], tol)


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_channel_mix_matches_jax(with_state):
    cfg, p = _rwkv_params(3)
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 24, cfg.d_model)).astype(np.float32)
    st = _state(rng, 2, cfg) if with_state else None
    want, want_st = RS.rwkv_channel_mix(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        state=None if st is None else jax.tree.map(jnp.asarray, st))
    got, got_st = TS.rwkv_channel_mix(
        params_from_numpy(p, "cpu"), torch.as_tensor(x),
        state=None if st is None else params_from_numpy(st, "cpu"))
    _close(got, want)
    if with_state:
        _close(got_st["shift_cm"], want_st["shift_cm"])
        _close(got_st["wkv"], want_st["wkv"])


def test_rwkv_state_init_matches_jax_shapes_and_dtypes():
    cfg = ref_smoke("rwkv6_3b")
    want = RS.rwkv_state_init(dataclasses.replace(cfg, dtype="bfloat16"), 3)
    got = TS.rwkv_state_init(dataclasses.replace(
        get_smoke_config("rwkv6_3b"), dtype="bfloat16"), 3, device="cpu")
    assert sorted(got) == sorted(want)
    for name, a in want.items():
        assert tuple(got[name].shape) == a.shape
        assert str(got[name].dtype).split(".")[-1] == str(a.dtype)
        assert not got[name].any()


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_time_mix_hands_the_scan_views(with_state, monkeypatch):
    """The kernel path hands the scan the time-mix's (B, T, H, K) tensors
    seen as (B, H, T, K), never copies, with the strides the kernel reads
    them through; the scan's result from those views equals its result
    from contiguous copies."""
    cfg, p = _rwkv_params(1)
    tcfg = dataclasses.replace(get_smoke_config("rwkv6_3b"),
                               attn_impl="pallas")
    rng = np.random.default_rng(5)
    B, S = 2, 24
    x = rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)
    st = _state(rng, B, cfg) if with_state else None
    seen = []

    def spy(*args):
        seen.append(args)
        return RK.rwkv6_scan_bhtk(*args)

    monkeypatch.setattr(ops, "rwkv6_scan_bhtk", spy)
    TS.rwkv_time_mix(params_from_numpy(p, "cpu"), torch.as_tensor(x), tcfg,
                     state=None if st is None else params_from_numpy(st,
                                                                     "cpu"),
                     use_kernel=True)
    (args,) = seen
    H, K = tcfg.n_rwkv_heads, tcfg.rwkv_head_dim
    D = H * K
    for t in args[:4]:
        assert t.shape == (B, H, S, K) and not t.is_contiguous()
        assert t._base is not None                  # a view, not a copy
        assert RK.scan_strides(t) == (S * D, K, D)
    got = RK.rwkv6_scan_bhtk(*args)
    want = RK.rwkv6_scan_bhtk(*(a.contiguous() for a in args))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_rwkv6_scan_strides_refuse_what_the_kernel_cannot_read():
    x = torch.zeros(2, 5, 3, 16)
    assert RK.scan_strides(x.transpose(1, 2)) == (240, 16, 48)
    assert RK.scan_strides(x[1:].transpose(1, 2)) == (240, 16, 48)
    assert RK.scan_strides(x[..., 1:].transpose(1, 2)) == (240, 16, 48)
    with pytest.raises(ValueError, match="contiguous last"):
        RK.scan_strides(x.transpose(1, 3))          # last dim not contiguous
