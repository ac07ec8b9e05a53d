"""The port's filter model (trunk prefix + IC/OD/OD-COF heads + CAM)
against the JAX package's, at a small size, with the same weights.

Weights are made by the JAX package's init and carried across as numpy
through ``repro_torch.interop.params_from_numpy``.  Float paths hold at
rtol 1e-4 / atol 1e-3 (matmuls summed in another order); the occupancy
dilation and the synthetic data are held bit-for-bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cam as RCAM
from repro.core import filters as RF
from repro.data import synthetic as RS
from repro.models import model as RM
from repro.models.config import BranchSpec as RBranch
from repro.train import filter_train as RT
from repro_torch.core import cam as TCAM
from repro_torch.core import filters as TF
from repro_torch.data import synthetic as TS
from repro_torch.interop import params_from_numpy
from repro_torch.models import model as TM
from repro_torch.models.config import BranchSpec as TBranch
from repro_torch.train import filter_train as TT
from torch_parity import assert_close, to_numpy_tree

G, C, D_IN, B = 8, 3, 24, 6


def _specs(kind, layer=2):
    kw = dict(layer=layer, grid=G, n_classes=C, kind=kind, head_dim=16)
    return RBranch(**kw), TBranch(**kw)


def _trunks():
    return (RT.default_trunk(d_model=32, n_layers=2, grid=G),
            TT.default_trunk(d_model=32, n_layers=2, grid=G))


def _embeds(seed=0, S=G * G):
    return np.random.default_rng(seed).normal(
        0, 1, (B, S, D_IN)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(RS.PRESETS))
def test_synthetic_collect_identical(name):
    r = RS.collect(RS.VideoStream(RS.PRESETS[name], dynamics_seed=3), 24)
    t = TS.collect(TS.VideoStream(TS.PRESETS[name], dynamics_seed=3), 24)
    for k in ("embeds", "counts", "occupancy"):
        np.testing.assert_array_equal(r[k], t[k])
    for a, b in zip(r["objects"], t["objects"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("S", [G * G, G * G + 13, 40])
def test_cam_functions(S):
    rng = np.random.default_rng(S)
    tap = rng.normal(0, 1, (2, S, 5)).astype(np.float32)
    assert_close(TCAM.spatialize(torch.as_tensor(tap), G),
                 RCAM.spatialize(jnp.asarray(tap), G), rtol=1e-6, atol=1e-6)
    cam = rng.normal(0, 0.5, (2, G, G, C)).astype(np.float32)
    w = rng.normal(0, 1, (5, C)).astype(np.float32)
    feat = TCAM.spatialize(torch.as_tensor(tap), G)
    assert_close(TCAM.class_activation_map(feat, torch.as_tensor(w)),
                 RCAM.class_activation_map(jnp.asarray(feat.numpy()),
                                           jnp.asarray(w)))
    np.testing.assert_array_equal(
        TCAM.upscale_map(torch.as_tensor(cam), 13).numpy(),
        np.asarray(RCAM.upscale_map(jnp.asarray(cam), 13)))
    for logits in (False, True):
        np.testing.assert_array_equal(
            TCAM.threshold_map(torch.as_tensor(cam), 0.2, logits).numpy(),
            np.asarray(RCAM.threshold_map(jnp.asarray(cam), 0.2, logits)))


@pytest.mark.parametrize("radius", [0, 1, 2, 3])
def test_dilate_manhattan_bit_exact(radius):
    occ = np.random.default_rng(radius).random((3, G, G + 2, C)) < 0.06
    np.testing.assert_array_equal(
        TCAM.dilate_manhattan(torch.as_tensor(occ), radius).numpy(),
        np.asarray(RCAM.dilate_manhattan(jnp.asarray(occ), radius)))


def _ref_params(kind, seed=0):
    rspec, tspec = _specs(kind)
    rtrunk, ttrunk = _trunks()
    rp = RT.init_filter_model(jax.random.PRNGKey(seed), rtrunk, rspec, D_IN)
    tp = params_from_numpy(to_numpy_tree(rp), device="cpu")
    return rp, tp, (rspec, tspec), (rtrunk, ttrunk)


def test_trunk_tap_matches():
    rp, tp, _, (rtrunk, ttrunk) = _ref_params("ic")
    x = np.random.default_rng(2).normal(0, 1, (B, G * G, 32)).astype(
        np.float32)
    for k in (1, 2):
        r = RM.forward(rp["trunk"], rtrunk, embeds=jnp.asarray(x),
                       tap_layer=k, stop_at_tap=True, causal=False).tap
        t = TM.forward(tp["trunk"], ttrunk, embeds=torch.as_tensor(x),
                       tap_layer=k, stop_at_tap=True, causal=False).tap
        assert_close(t, r)
    assert TM.forward(tp["trunk"], ttrunk, embeds=torch.as_tensor(x),
                      tap_layer=3, stop_at_tap=True, causal=False).tap is None


@pytest.mark.parametrize("kind,use_kernel", [("ic", False), ("ic", True),
                                             ("od", False), ("cof", False)])
def test_heads_match(kind, use_kernel):
    rp, tp, (rspec, tspec), _ = _ref_params(kind, seed=1)
    rng = np.random.default_rng(5)
    tap = rng.normal(0, 1, (B, G * G, 32)).astype(np.float32)
    kw = {"use_kernel": use_kernel} if kind == "ic" else {}
    r = RF.branch_apply(rp["branch"], jnp.asarray(tap), rspec, **kw)
    t = TF.branch_apply(tp["branch"], torch.as_tensor(tap), tspec, **kw)
    assert_close(t.counts, r.counts)
    if kind == "cof":
        assert t.grid is None and r.grid is None
    else:
        assert t.grid.shape == (B, G, G, C)
        assert_close(t.grid, r.grid)


@pytest.mark.parametrize("kind,use_kernel", [("ic", False), ("ic", True),
                                             ("od", False), ("cof", False)])
def test_filter_forward_matches(kind, use_kernel):
    rp, tp, (rspec, tspec), (rtrunk, ttrunk) = _ref_params(kind, seed=2)
    e = _embeds(3)
    r = RT.filter_forward(rp, rtrunk, rspec, jnp.asarray(e),
                          use_kernel=use_kernel)
    t = TT.filter_forward(tp, ttrunk, tspec, e, use_kernel=use_kernel,
                          device="cpu")
    assert_close(t.counts, r.counts)
    if r.grid is not None:
        assert_close(t.grid, r.grid)


def test_trained_filter_apply_rescales_like_reference():
    rp, tp, (rspec, tspec), (rtrunk, ttrunk) = _ref_params("ic", seed=4)
    scale = np.array([2.0, 0.5, 3.0], np.float32)
    r = RT.TrainedFilter(rp, rtrunk, rspec, [], scale).apply(
        jnp.asarray(_embeds(4)))
    t = TT.TrainedFilter(tp, ttrunk, tspec, [], scale).apply(
        _embeds(4), device="cpu")
    assert_close(t.counts, r.counts)


def test_port_init_has_reference_tree_and_shapes():
    rspec, tspec = _specs("ic")
    rtrunk, ttrunk = _trunks()
    rp = to_numpy_tree(RT.init_filter_model(jax.random.PRNGKey(0), rtrunk,
                                            rspec, D_IN))
    tp = TT.init_filter_model(torch.Generator().manual_seed(0), ttrunk,
                              tspec, D_IN, device="cpu")
    tp2 = TT.init_filter_model(torch.Generator().manual_seed(0), ttrunk,
                               tspec, D_IN, device="cpu")

    def walk(a, b, c, path=""):
        assert isinstance(b, dict) == isinstance(a, dict), path
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], c[k], f"{path}/{k}")
        else:
            assert tuple(b.shape) == a.shape, path
            assert b.dtype == torch.float32, path
            assert torch.equal(b, c), path      # seeded: reproducible
    walk(rp, tp, tp2)
    out = TT.filter_forward(tp, ttrunk, dataclasses.replace(tspec),
                            _embeds(0), device="cpu")
    assert out.counts.shape == (B, C) and torch.isfinite(out.grid).all()
