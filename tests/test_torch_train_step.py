"""The port's training step against the JAX package, on the CPU.

The same numpy-seeded batches and one train state go through both
packages: the port's ``init_state`` on the CPU, handed to the reference
as numpy arrays (drawing the reference's own would compile its
initialiser op by op for every config; ``tests/test_torch_checkpoint.py``
carries a reference state the other way, through
``interop.state_from_numpy``).  Each package's own loss function is taken from its
``build_train_step`` closure, so the comparison holds the step's real
loss: the JAX one under ``jax.value_and_grad``, the port's under
``train.step.value_and_grad``.

- ``softmax_cross_entropy`` (masked labels, an explicit mask) and
  ``z_loss`` against ``repro.train.losses``;
- at ``tiny_dense``, ``tiny_moe``, ``tiny_rwkv`` (the plain path) and
  the smoke configs of hymba-1.5b (Mamba, ``remat="selective"``),
  whisper-base (``frames``) and paligemma-3b (``embeds``, the loss on
  the text suffix): the loss and every gradient leaf, then one
  ``build_train_step`` step (AdamW + clipping): new parameters and
  moments, ``loss``, ``aux`` and ``grad_norm``;
- ``grad_accum=2`` against the reference's ``grad_accum=2`` and, under
  SGD, against the full batch (the reference's own probe); ``zloss_coef``;
- ``remat`` ``none`` / ``full`` / ``selective``: the same gradients, and
  fewer bytes kept for the backward pass under the two remat modes;
- ``mamba_scan``'s gradients against ``jax.grad`` at T = 64, 50, 67;
- the twin of ``tests/test_train_serve.py::test_loss_decreases``.

Tolerances: the loss at rtol 1e-5; gradients and parameters at the
1e-4 / 1e-3 allclose of ``tests/test_kernels.py`` where nothing tighter
is stated (float32 products summed in another order than XLA's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import ssm as RS
from repro.optim import adamw as r_adamw
from repro.optim import sgd_momentum as r_sgd
from repro.train import losses as RLS
from repro.train import step as RTS
from repro_torch import configs as TC
from repro_torch.models import model as TM
from repro_torch.models import ssm as TSS
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim import sgd_momentum as t_sgd
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.train import losses as TLS
from repro_torch.train import step as TTS

from test_torch_zoo import port_config
from torch_parity import assert_close, to_numpy_tree


def closure_var(fn, name):
    """A variable of ``fn``'s closure (a step's ``loss_fn``)."""
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))[name]


def make_batch(cfg, B, S, seed, extras=()):
    """Tokens and labels (B, S) from one numpy draw, with the stub
    ``frames`` / ``embeds`` an extras tuple names."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if "frames" in extras:
        b["frames"] = rng.normal(0, 1, (B, cfg.enc_len, cfg.d_model)
                                 ).astype(np.float32)
    if "embeds" in extras:
        b["embeds"] = rng.normal(0, 1, (B, cfg.vlm_prefix, cfg.d_model)
                                 ).astype(np.float32)
    return b


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch):
    return {k: torch.as_tensor(np.ascontiguousarray(v))
            for k, v in batch.items()}


def state_pair(tc, topt, seed):
    """One train state for both packages: (the reference's, the port's)."""
    tstate = TTS.init_state(torch.Generator().manual_seed(seed), tc, topt,
                            device="cpu")
    rstate = jax.tree.map(jnp.asarray, to_numpy_tree(tstate))
    return rstate, tstate


def assert_tree_close(port, ref, rtol=1e-4, atol=1e-3, what=""):
    ref = to_numpy_tree(ref)
    flat_p = tree_leaves(port)
    flat_r = jax.tree.leaves(ref)
    assert len(flat_p) == len(flat_r), what
    for got, want in zip(flat_p, flat_r):
        assert_close(got, want, rtol=rtol, atol=atol)


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

@pytest.mark.parametrize("masking", ["none", "negative_labels", "explicit",
                                     "outside_vocab"])
def test_losses_match_jax(masking):
    rng = np.random.default_rng(3)
    logits = (rng.normal(0, 3, (2, 7, 33))).astype(np.float32)
    labels = rng.integers(0, 33, (2, 7)).astype(np.int32)
    mask = None
    if masking == "negative_labels":
        labels[0, :3] = -1
        labels[1, 5] = -5
    if masking == "outside_vocab":       # -100 + V < 0: NaN in both
        labels[1, 5] = -100
    if masking == "explicit":
        mask = rng.random((2, 7)) < 0.5
    want, want_n = RLS.softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    got, n = TLS.softmax_cross_entropy(
        torch.as_tensor(logits), torch.as_tensor(labels),
        None if mask is None else torch.as_tensor(mask))
    assert float(n) == float(want_n)
    if masking == "outside_vocab":
        assert np.isnan(float(want)) and np.isnan(float(got))
        return
    assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert_close(TLS.z_loss(torch.as_tensor(logits), 1e-3),
                 RLS.z_loss(jnp.asarray(logits), 1e-3), rtol=1e-6, atol=0)
    # bf16 logits are widened first, in both
    lb = jnp.asarray(logits).astype(jnp.bfloat16)
    assert_close(TLS.softmax_cross_entropy(
        torch.as_tensor(logits).to(torch.bfloat16),
        torch.as_tensor(labels))[0],
        RLS.softmax_cross_entropy(lb, jnp.asarray(labels))[0],
        rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# loss, gradients and one step, per family
# --------------------------------------------------------------------------

def _smoke(name):
    return lambda request: RC.get_smoke_config(name)


def _fixture(name):
    return lambda request: request.getfixturevalue(name)


FAMILIES = {
    "dense": (_fixture("tiny_dense"), ()),
    "moe": (_fixture("tiny_moe"), ()),
    "rwkv": (_fixture("tiny_rwkv"), ()),
    "hymba": (_smoke("hymba_1p5b"), ()),
    "whisper": (_smoke("whisper_base"), ("frames",)),
    "paligemma": (_smoke("paligemma_3b"), ("embeds",)),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_grads_and_step_match_jax(family, request):
    get, extras = FAMILIES[family]
    rc = get(request)
    tc = port_config(rc)
    assert tc.remat == rc.remat
    # eps large beside float noise: Adam's first step divides by sqrt(v),
    # which turns a sum-order difference of a near-zero gradient into a
    # full-size update
    ropt, topt = r_adamw(1e-2, eps=1e-4, weight_decay=0.01), \
        t_adamw(1e-2, eps=1e-4, weight_decay=0.01)
    rstate, tstate = state_pair(tc, topt, seed=len(family))
    batch = make_batch(rc, 2, 16, seed=len(family), extras=extras)

    r_step = RTS.build_train_step(rc, ropt)
    t_step = TTS.build_train_step(tc, topt)
    r_vag = jax.value_and_grad(closure_var(r_step, "loss_fn"), has_aux=True)
    # one compile for both: the gradients and the step
    ((r_tot, (r_loss, r_aux)), r_g), (r_new, r_m) = jax.jit(
        lambda st, b: (r_vag(st["params"], b), r_step(st, b)))(
            rstate, as_jax(batch))
    (t_tot, (t_loss, t_aux)), t_g = TTS.value_and_grad(
        closure_var(t_step, "loss_fn"), tstate["params"], as_torch(batch))
    assert_close(t_tot, r_tot, rtol=1e-5, atol=0)
    assert_close(t_loss, r_loss, rtol=1e-5, atol=0)
    assert_close(t_aux, r_aux, rtol=1e-5, atol=1e-7)
    assert sorted(t_g) == sorted(r_g)
    # gradients: 1e-5 of the largest gradient leaf's scale
    scale = max(float(np.abs(np.asarray(g)).max())
                for g in jax.tree.leaves(r_g))
    assert_tree_close(t_g, r_g, rtol=1e-4, atol=1e-5 * scale)

    t_new, t_m = t_step(tstate, as_torch(batch))
    for k in ("loss", "aux", "grad_norm"):
        assert_close(t_m[k], r_m[k], rtol=1e-5, atol=1e-7)
    assert int(t_new["step"]) == int(r_new["step"]) == 1
    assert_tree_close(t_new["params"], r_new["params"])
    assert_tree_close(t_new["opt"], r_new["opt"], rtol=1e-4,
                      atol=1e-6 * scale ** 2 + 1e-7 * scale)
    # the given state is not modified
    assert_tree_close(tstate["params"], rstate["params"], rtol=0, atol=0)


def test_grad_accum_matches_jax_and_full_batch(tiny_dense):
    rc, tc = tiny_dense, port_config(tiny_dense)
    batch = make_batch(rc, 8, 16, seed=1)
    ropt, topt = r_adamw(1e-3), t_adamw(1e-3)
    rstate, tstate = state_pair(tc, topt, seed=1)
    r_new, r_m = jax.jit(RTS.build_train_step(rc, ropt, grad_accum=2))(
        rstate, as_jax(batch))
    t_new, t_m = TTS.build_train_step(tc, topt, grad_accum=2)(
        tstate, as_torch(batch))
    assert_close(t_m["loss"], r_m["loss"], rtol=1e-5, atol=0)
    assert float(t_m["aux"]) == float(r_m["aux"]) == 0.0
    assert_close(t_m["grad_norm"], r_m["grad_norm"], rtol=1e-5, atol=0)
    assert_tree_close(t_new["params"], r_new["params"])

    # accumulated micro-gradients == the full batch's under SGD (the
    # reference's own probe: Adam's first step amplifies sum-order noise)
    opt = t_sgd(1e-2, momentum=0.0)
    st = {"params": tstate["params"], "opt": opt.init(tstate["params"]),
          "step": tstate["step"]}
    s1, m1 = TTS.build_train_step(tc, opt)(st, as_torch(batch))
    s2, m2 = TTS.build_train_step(tc, opt, grad_accum=4)(st, as_torch(batch))
    assert_close(m1["loss"], m2["loss"].numpy(), rtol=1e-4, atol=0)
    for a, b in zip(tree_leaves(s1["params"]), tree_leaves(s2["params"])):
        assert_close(a, b.numpy(), rtol=0, atol=1e-5)


def test_zloss_matches_jax(tiny_moe):
    rc, tc = tiny_moe, port_config(tiny_moe)
    batch = make_batch(rc, 2, 16, seed=4)
    ropt, topt = r_sgd(1e-2), t_sgd(1e-2)
    rstate, tstate = state_pair(tc, topt, seed=4)
    kw = dict(zloss_coef=1e-2, aux_coef=0.1, clip_norm=0.5)
    r_new, r_m = jax.jit(RTS.build_train_step(rc, ropt, **kw))(
        rstate, as_jax(batch))
    t_new, t_m = TTS.build_train_step(tc, topt, **kw)(tstate,
                                                      as_torch(batch))
    for k in ("loss", "aux", "grad_norm"):
        assert_close(t_m[k], r_m[k], rtol=1e-5, atol=1e-7)
    assert_tree_close(t_new["params"], r_new["params"], rtol=1e-5,
                      atol=1e-6)
    # the z-loss enters the gradient: without it the step differs
    t_plain, _ = TTS.build_train_step(tc, topt, aux_coef=0.1,
                                      clip_norm=0.5)(tstate, as_torch(batch))
    diff = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(t_new["params"]), tree_leaves(t_plain["params"])))
    assert diff > 1e-6


# --------------------------------------------------------------------------
# remat
# --------------------------------------------------------------------------

class PolicyCount:
    """Wraps ``model._selective_policy`` to add up the bytes of the
    outputs it keeps (from the product's operand shapes)."""

    def __init__(self):
        self.kept, self.ops = 0, set()

    def __call__(self, ctx, op, *args, **kw):
        from torch.utils.checkpoint import CheckpointPolicy
        pol = self.inner(ctx, op, *args, **kw)
        if pol == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            self.ops.add(str(op))
            a, b = args[-2], args[-1]
            n = a.shape[-2] * b.shape[-1] * (
                a.shape[0] if a.dim() == 3 else 1)
            self.kept += n * a.element_size()
        return pol


@pytest.mark.parametrize("name", ["hymba_1p5b", "granite_moe_3b_a800m",
                                  "whisper_base"])
def test_remat_same_gradients_fewer_saved_bytes(name, monkeypatch):
    base = TC.get_smoke_config(name)
    params = TM.init_params(torch.Generator().manual_seed(0), base,
                            device="cpu")
    batch = as_torch(make_batch(base, 2, 16, seed=5, extras=(
        ("frames",) if base.enc_dec else ())))
    count = PolicyCount()
    count.inner = TM._selective_policy
    monkeypatch.setattr(TM, "_selective_policy", count)
    res = {}
    for remat in ("none", "full", "selective"):
        cfg = dataclasses.replace(base, remat=remat)
        loss_fn = closure_var(TTS.build_train_step(cfg, t_sgd(1e-2)),
                              "loss_fn")
        saved = [0]

        def pack(t):
            saved[0] += t.numel() * t.element_size()
            return t

        count.kept = 0
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            (tot, (loss, aux)), g = TTS.value_and_grad(loss_fn, params,
                                                       batch)
        res[remat] = (tot, aux, g, saved[0] + count.kept)
    tot0, aux0, g0, bytes0 = res["none"]
    for remat in ("full", "selective"):
        tot, aux, g, nbytes = res[remat]
        assert float(tot) == float(tot0)
        assert float(aux) == float(aux0)      # MoE aux out of a remat layer
        for a, b in zip(tree_leaves(g), tree_leaves(g0)):
            assert_close(a, b.numpy(), rtol=0, atol=1e-6)
        assert nbytes < bytes0, (remat, nbytes, bytes0)
    # selective keeps the weight products on top of what full keeps
    assert res["full"][3] < res["selective"][3]
    assert count.ops == {"aten.bmm.default"}


def test_remat_never_wraps_serving(monkeypatch):
    """Serving (caches, or no autograd) does not go through checkpoint."""
    from repro_torch.models import serve as TSV
    cfg = dataclasses.replace(TC.get_smoke_config("hymba_1p5b"),
                              remat="full")
    params = TM.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    calls = []
    real = TM._remat_wrap
    monkeypatch.setattr(TM, "_remat_wrap",
                        lambda fn, c: calls.append(1) or real(fn, c))
    toks = torch.randint(0, cfg.vocab_size, (2, 8))
    cache = TSV.init_cache(cfg, 2, 16, device="cpu")
    TSV.prefill(params, cfg, toks, cache=cache)
    with torch.no_grad():
        TM.forward(params, cfg, toks)
    assert calls == []
    TM.forward(params, cfg, toks)
    assert calls == [1]


# --------------------------------------------------------------------------
# Mamba scan gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("T", [64, 50, 67])
def test_mamba_scan_grads_match_jax(T):
    rng = np.random.default_rng(T)
    B, di, N = 2, 6, 4
    a = np.exp(-np.abs(rng.normal(0, 1, (B, T, di, N))) * 0.3
               ).astype(np.float32)
    b, C, h0 = (rng.normal(0, 1, s).astype(np.float32)
                for s in ((B, T, di, N), (B, T, N), (B, di, N)))
    wy, wh = (rng.normal(0, 1, s).astype(np.float32)
              for s in ((B, T, di), (B, di, N)))

    def r_obj(a, b, C, h0):
        y, h = RS.mamba_scan(a, b, C, h0)
        return jnp.sum(y * wy) + jnp.sum(h * wh)

    want = jax.grad(r_obj, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x) for x in (a, b, C, h0)))
    ins = [torch.tensor(x, requires_grad=True) for x in (a, b, C, h0)]
    y, h = TSS.mamba_scan(*ins)
    got = torch.autograd.grad((y * torch.as_tensor(wy)).sum()
                              + (h * torch.as_tensor(wh)).sum(), ins)
    for g, w in zip(got, want):
        assert_close(g, w)
    # the training path computes what the serving path computes
    with torch.no_grad():
        ys, hs = TSS.mamba_scan(*(torch.as_tensor(x) for x in (a, b, C, h0)))
    assert torch.equal(ys, y.detach()) and torch.equal(hs, h.detach())


# --------------------------------------------------------------------------
# training learns
# --------------------------------------------------------------------------

def test_loss_decreases(tiny_dense):
    """The twin of tests/test_train_serve.py::test_loss_decreases."""
    cfg = port_config(tiny_dense)
    opt = t_adamw(3e-3)
    state = TTS.init_state(torch.Generator().manual_seed(0), cfg, opt,
                           device="cpu")
    step_fn = TTS.build_train_step(cfg, opt)
    batch = as_torch(make_batch(cfg, 4, 32, seed=0))   # memorise one batch
    losses = []
    for _ in range(30):
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.7, losses[::10]


def test_step_for_cell_kinds(tiny_dense):
    from repro_torch.models import serve as TSV
    from repro_torch.models.config import ShapeCell
    cfg = port_config(tiny_dense)
    opt = t_adamw(1e-3)
    state = TTS.init_state(torch.Generator().manual_seed(0), cfg, opt,
                           device="cpu")
    train = TTS.step_for_cell(cfg, ShapeCell("t", 32, 4, "train"), opt)
    _, m = train(state, as_torch(make_batch(cfg, 4, 32, seed=2)))
    assert bool(torch.isfinite(m["loss"]))
    with pytest.raises(ValueError):
        TTS.step_for_cell(cfg, ShapeCell("t", 32, 4, "train"))
    toks = torch.randint(0, cfg.vocab_size, (4, 32))
    pre = TTS.step_for_cell(cfg, ShapeCell("p", 32, 4, "prefill"))
    logits, cache = pre(state["params"], {
        "tokens": toks, "cache": TSV.init_cache(cfg, 4, 40, device="cpu")})
    dec = TTS.step_for_cell(cfg, ShapeCell("d", 40, 4, "decode"))
    lg2, cache = dec(state["params"], {"tokens": toks[:, :1],
                                       "cache": cache})
    assert logits.shape == lg2.shape == (4, cfg.vocab_size)
    assert int(cache["len"]) == 33
    # the meta device gives the structure without memory
    meta = TTS.init_state(torch.Generator().manual_seed(0), cfg, opt,
                          device="meta")
    assert all(t.is_meta for t in tree_leaves(meta))
    assert [t.shape for t in tree_leaves(meta)] == \
        [t.shape for t in tree_leaves(state)]
