"""The port's filter training (losses, optimizers, the train step, the
paper metrics) against the JAX package's, at a small size, on the CPU.

Weights, gradients and batches are made with numpy from a seed and
handed to both packages.  Tolerances, each with its reason:

- losses, schedules, optimizer updates from given gradients: rtol 1e-6 /
  atol 1e-7 — the same float32 elementwise arithmetic in the same order;
  only transcendental functions and reductions may round differently;
- the train step: loss rtol 1e-5, params atol 1e-5 after three steps —
  the forward and backward are float32 matmuls summed in another order
  than XLA's, which moves gradients by ~1e-6 relative; Adam normalises
  each update to about lr = 1e-3 per element, so the parameters move by
  ~1e-3 per step and keep the gradients' small relative differences;
- metrics: identical (integer counting on the same arrays).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import filters as RF
from repro.data.synthetic import JACKSON_LIKE
from repro.models.config import BranchSpec as RBranch
from repro.optim import adamw as r_adamw
from repro.optim import clip_by_global_norm as r_clip
from repro.optim import exponential_decay as r_exp
from repro.optim import schedules as RSch
from repro.optim import sgd_momentum as r_sgd
from repro.optim.optimizers import apply_updates as r_apply
from repro.train import filter_train as RT
from repro_torch import optim as TO
from repro_torch.core import filters as TF
from repro_torch.interop import params_from_numpy
from repro_torch.models.config import BranchSpec as TBranch
from repro_torch.optim import schedules as TSch
from repro_torch.train import filter_train as TT
from torch_parity import assert_close, to_numpy_tree

G, C, D_IN, B = 8, 3, 24, 4
EXACT = dict(rtol=1e-6, atol=1e-7)


def _outputs(seed, with_grid=True):
    rng = np.random.default_rng(seed)
    counts = rng.normal(1, 1.5, (B, C)).astype(np.float32)
    grid = rng.normal(0, 0.7, (B, G, G, C)).astype(np.float32)
    c_true = rng.integers(0, 4, (B, C)).astype(np.float32)
    occ = (rng.random((B, G, G, C)) < 0.1).astype(np.float32)
    w_c = rng.uniform(0.5, 2, C).astype(np.float32)
    r = RF.FilterOutputs(counts=jnp.asarray(counts),
                         grid=jnp.asarray(grid) if with_grid else None)
    t = TF.FilterOutputs(counts=torch.as_tensor(counts),
                         grid=torch.as_tensor(grid) if with_grid else None)
    return r, t, c_true, occ, w_c


@pytest.mark.parametrize("seed", range(2))
def test_losses_match(seed):
    r, t, c, o, w = _outputs(seed)
    x = np.linspace(-3, 3, 41, dtype=np.float32)
    assert_close(TF.smooth_l1(torch.as_tensor(x), torch.zeros(41)),
                 RF.smooth_l1(jnp.asarray(x), 0.0), **EXACT)
    for beta in (0.0, 2.5):
        assert_close(TF.ic_loss(t, torch.as_tensor(c), torch.as_tensor(o),
                                torch.as_tensor(w), alpha=1.0, beta=beta),
                     RF.ic_loss(r, jnp.asarray(c), jnp.asarray(o),
                                jnp.asarray(w), alpha=1.0, beta=beta),
                     **EXACT)
    assert_close(TF.od_loss(t, torch.as_tensor(c), torch.as_tensor(o),
                            lambda_grid=7.0),
                 RF.od_loss(r, jnp.asarray(c), jnp.asarray(o),
                            lambda_grid=7.0), **EXACT)
    assert_close(TF.cof_loss(t, torch.as_tensor(c)),
                 RF.cof_loss(r, jnp.asarray(c)), **EXACT)


def test_schedules_match():
    steps = [0, 1, 7, 50, 299, 1000]
    pairs = [(TSch.exponential_decay(1e-3, 5e-4),
              RSch.exponential_decay(1e-3, 5e-4)),
             (TSch.constant(3e-4), RSch.constant(3e-4)),
             (TSch.linear_warmup(1e-3, 10), RSch.linear_warmup(1e-3, 10)),
             (TSch.cosine_decay(1e-3, 300), RSch.cosine_decay(1e-3, 300)),
             (TSch.warmup_cosine(1e-3, 10, 300),
              RSch.warmup_cosine(1e-3, 10, 300))]
    for t_sched, r_sched in pairs:
        for s in steps:
            assert_close(t_sched(torch.tensor(s, dtype=torch.int32)),
                         r_sched(jnp.int32(s)), **EXACT)


def _tree(rng):
    return {"a": rng.normal(0, 1, (5, 3)).astype(np.float32),
            "b": {"w": rng.normal(0, 1, (7,)).astype(np.float32),
                  "c": rng.normal(0, 0.01, (2, 2)).astype(np.float32)}}


@pytest.mark.parametrize("name", ["adamw", "adamw_wd", "sgd", "sgd_wd"])
def test_optimizers_three_steps_match(name):
    rng = np.random.default_rng(7)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    grads[1] = {"a": grads[1]["a"] * 40, "b": grads[1]["b"]}  # gets clipped
    make = {"adamw": (TO.adamw, r_adamw, {}),
            "adamw_wd": (TO.adamw, r_adamw, {"weight_decay": 0.1}),
            "sgd": (TO.sgd_momentum, r_sgd, {}),
            "sgd_wd": (TO.sgd_momentum, r_sgd, {"weight_decay": 0.1})}
    t_make, r_make, kw = make[name]
    t_opt = t_make(TO.exponential_decay(1e-2, 5e-4), **kw)
    r_opt = r_make(r_exp(1e-2, 5e-4), **kw)
    t_clip, r_clipf = TO.clip_by_global_norm(1.0), r_clip(1.0)
    tp = params_from_numpy(params, device="cpu")
    rp = jax.tree.map(jnp.asarray, params)
    ts, rs = t_opt.init(tp), r_opt.init(rp)
    for i, g in enumerate(grads):
        tg, tn = t_clip(params_from_numpy(g, device="cpu"))
        rg, rn = r_clipf(jax.tree.map(jnp.asarray, g))
        assert_close(tn, rn, **EXACT)
        tu, ts = t_opt.update(tg, ts, tp, torch.tensor(i))
        ru, rs = r_opt.update(rg, rs, rp, jnp.int32(i))
        tp, rp = TO.apply_updates(tp, tu), r_apply(rp, ru)
        for a, b in zip(TO.optimizers.tree_leaves(tp), jax.tree.leaves(rp)):
            assert_close(a, b, **EXACT)
    for a, b in zip(TO.optimizers.tree_leaves(ts), jax.tree.leaves(rs)):
        assert_close(a, b, **EXACT)


def _jax_train_step(trunk, spec, w_c, lam_grid):
    """The JAX package's train step, composed from its public pieces
    exactly as ``repro.train.filter_train.train_filter`` builds it."""
    opt = r_adamw(r_exp(1e-3 if spec.kind == "ic" else 2e-3, 5e-4))
    clip = r_clip(1.0)
    w_c = jnp.asarray(w_c)

    def loss_fn(p, e, c, o, beta):
        out = RT.filter_forward(p, trunk, spec, e)
        if spec.kind == "ic":
            return RF.ic_loss(out, c, o, w_c, alpha=1.0,
                              beta=beta * lam_grid / 20.0)
        if spec.kind == "od":
            return RF.od_loss(out, c, o, lambda_grid=lam_grid)
        return RF.cof_loss(out, c)

    @jax.jit
    def train_step(p, st, step, e, c, o, beta):
        loss, g = jax.value_and_grad(loss_fn)(p, e, c, o, beta)
        g, _ = clip(g)
        upd, st = opt.update(g, st, p, step)
        return r_apply(p, upd), st, loss

    return opt, train_step


@pytest.mark.parametrize("kind", ["ic", "od"])
def test_train_steps_match_jax(kind):
    kw = dict(layer=1, grid=G, n_classes=C, kind=kind, head_dim=16)
    rspec, tspec = RBranch(**kw), TBranch(**kw)
    rtrunk = RT.default_trunk(d_model=32, n_layers=1, grid=G)
    ttrunk = TT.default_trunk(d_model=32, n_layers=1, grid=G)
    params = to_numpy_tree(RT.init_filter_model(jax.random.PRNGKey(1),
                                                rtrunk, rspec, D_IN))
    rng = np.random.default_rng(11)
    w_c = rng.uniform(0.5, 2, C).astype(np.float32)
    lam_grid = 13.0
    r_opt, r_step = _jax_train_step(rtrunk, rspec, w_c, lam_grid)
    t_opt = TO.adamw(TO.exponential_decay(1e-3 if kind == "ic" else 2e-3,
                                          5e-4))
    t_step = TT.make_train_step(ttrunk, tspec, t_opt,
                                TO.clip_by_global_norm(1.0), w_c, lam_grid,
                                device="cpu")
    rp = jax.tree.map(jnp.asarray, params)
    tp = params_from_numpy(params, device="cpu")
    rs, ts = r_opt.init(rp), t_opt.init(tp)
    for i, beta in enumerate((0.0, 0.0, 9.5)):
        e = rng.normal(0, 1, (B, G * G, D_IN)).astype(np.float32)
        c = rng.uniform(0, 3, (B, C)).astype(np.float32)
        o = (rng.random((B, G, G, C)) < 0.1).astype(np.float32)
        rp, rs, rl = r_step(rp, rs, jnp.int32(i), jnp.asarray(e),
                            jnp.asarray(c), jnp.asarray(o),
                            jnp.float32(beta))
        tp, ts, tl = t_step(tp, ts, i, torch.as_tensor(e),
                            torch.as_tensor(c), torch.as_tensor(o),
                            np.float32(beta))
        assert_close(tl, rl, rtol=1e-5, atol=0)
        for a, b in zip(TO.optimizers.tree_leaves(tp), jax.tree.leaves(rp)):
            assert not a.requires_grad
            assert_close(a, b, rtol=0, atol=1e-5)


def test_metrics_identical():
    rng = np.random.default_rng(3)
    pred = rng.normal(2, 1.5, (64, C)).astype(np.float32)
    true = rng.integers(0, 5, (64, C))
    for tol in (0, 1, 2):
        assert TT.count_accuracy(torch.as_tensor(pred), true, tol) == \
            RT.count_accuracy(pred, true, tol)
        np.testing.assert_array_equal(
            TT.count_accuracy(pred, true, tol, per_class=True),
            RT.count_accuracy(pred, true, tol, per_class=True))
    grid = rng.normal(0, 0.4, (16, G, G, C)).astype(np.float32)
    occ = rng.random((16, G, G, C)) < 0.08
    for r in (0, 1, 2):
        np.testing.assert_array_equal(
            TT.clf_f1(torch.as_tensor(grid), occ, radius=r),
            RT.clf_f1(grid, occ, radius=r))


def test_train_filter_on_cpu_loss_falls():
    spec = TBranch(layer=1, grid=8, n_classes=2, kind="ic", head_dim=16)
    trunk = TT.default_trunk(d_model=32, n_layers=1, grid=8)
    tf = TT.train_filter(JACKSON_LIKE, spec, trunk_cfg=trunk, steps=36,
                         batch=16, n_frames=128, device="cpu")
    assert len(tf.losses) == 36 and np.isfinite(tf.losses).all()
    # the grid term joins after steps // 6 = 6 count-only steps (Eq. 2's
    # β warm-up), so the loss jumps there; from there on it falls
    assert np.mean(tf.losses[-5:]) < 0.5 * np.mean(tf.losses[6:11])
    assert all(not t.requires_grad
               for t in TO.optimizers.tree_leaves(tf.params))
    res = TT.evaluate_filter(tf, JACKSON_LIKE, n_frames=48, device="cpu")
    assert 0.0 <= res["cf_acc_0"] <= res["cf_acc_1"] <= res["cf_acc_2"]
    assert res["clf_f1_0"].shape == (2,)
    assert res["outputs"].grid.shape == (48, 8, 8, 2)
