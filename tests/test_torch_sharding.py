"""The port's sharding rules and logical-axes trees against the JAX
package's, in process (no process group, no devices): specs are pure
functions of the rule table, the axis names and sizes, and the shapes.

Meshes are stand-ins with ``axis_names`` and ``devices.shape`` (the
reference's own ``_FakeMesh``); JAX's specs are ``PartitionSpec``s,
tuples of the same entries as the port's specs.  Shapes come from
``jax.eval_shape`` on the reference's side and from ``meta`` tensors on
the port's.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS, get_config
from repro.distributed import sharding as RSH
from repro.launch import specs as RSPECS
from repro.models import model as RM
from repro.models import serve as RSV
from repro.models.config import ShapeCell, shape_cell
from repro.optim import adamw as r_adamw
from repro.train import step as RTS
from repro_torch.configs import get_config as t_get_config
from repro_torch.distributed import sharding as TSH
from repro_torch.launch import specs as TSPECS
from repro_torch.models import model as TM
from repro_torch.models import serve as TSV
from repro_torch.optim import adamw as t_adamw
from repro_torch.train import step as TTS


class _FakeMesh:
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


MESHES = {"1x1": ((1, 1), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _mesh(name):
    return _FakeMesh(*MESHES[name])


def _p(spec) -> tuple:
    return tuple(spec)


# ---------------------------------------------------------------------------
# The rule logic: the reference's cases (tests/test_distributed.py)
# ---------------------------------------------------------------------------

def test_default_rules_and_overrides_equal_the_reference():
    assert TSH.DEFAULT_RULES == RSH.DEFAULT_RULES
    r = TSH.make_rules({"embed": None})
    assert r == RSH.make_rules({"embed": None})
    assert r["embed"] is None and TSH.DEFAULT_RULES["embed"] == "data"


RESOLVE_CASES = [(None, 128), ("model", 64), ("model", 10),
                 (("pod", "data"), 64), (("pod", "data"), 2),
                 (("pod", "data"), 1), (("ghost", "data"), 32),
                 (("ghost",), 32), ("data", 48), (("data", "model"), 8)]


@pytest.mark.parametrize("ax,dim", RESOLVE_CASES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_resolve_axis(mesh, ax, dim):
    ma = TSH.mesh_axes(_mesh(mesh))
    assert ma == dict(zip(*reversed(MESHES[mesh])))
    assert TSH._resolve_axis(ax, dim, ma) == RSH._resolve_axis(ax, dim, ma)


# (logical axes, shape, rule overrides): the reference's spec cases and
# their neighbours
SPEC_CASES = [
    (("embed", "kv_heads", "head_dim"), (8192, 8, 128), None),
    (("embed", "heads", "head_dim"), (8192, 64, 128), None),
    (("batch", None), (256, 10), None),
    (("batch", None), (2, 10), None),
    (("batch", None), (1, 10), None),
    (("a", "b"), (16, 16), {"a": "model", "b": "model"}),
    (("a", "b", "c"), (32, 16, 2),
     {"a": ("pod", "data"), "b": "data", "c": "pod"}),
    (("b", "a"), (16, 32), {"a": ("pod", "data"), "b": "data", "c": "pod"}),
    (("layers", "cache_batch", "cache_seq", "cache_kv", None),
     (24, 128, 32768, 2, 64), None),
    (("vocab", "embed"), (151936, 896), None),
    (("experts", "expert_embed", "mlp"), (8, 6144, 32768), None),
    ((None, "embed"), (7, 6), None),
]


@pytest.mark.parametrize("case", range(len(SPEC_CASES)))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_spec_for(mesh, case):
    logical, shape, over = SPEC_CASES[case]
    m = _mesh(mesh)
    got = TSH.spec_for(logical, shape, m, TSH.make_rules(over))
    assert got == _p(RSH.spec_for(logical, shape, m, RSH.make_rules(over)))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_specs(mesh):
    m = _mesh(mesh)
    for batch in (0, 1, 2, 4, 32, 256):
        assert TSH.batch_specs("x", m, batch=batch) == \
            _p(RSH.batch_specs("x", m, batch=batch))


def test_tree_specs_nested_and_shape_tuples():
    m = _mesh("2x16x16")
    axes = {"a": ("batch", None), "b": {"c": ("embed", "mlp")}}
    shapes = {"a": (64, 3), "b": {"c": (512, 1024)}}
    want = jax.tree.map(_p, RSH.tree_specs(axes, shapes, m),
                        is_leaf=lambda x: isinstance(x, P))
    assert TSH.tree_specs(axes, shapes, m) == want


# ---------------------------------------------------------------------------
# The axes trees, leaf for leaf, and their specs at published shapes
# ---------------------------------------------------------------------------

def _shapes(tree):
    """{path: shape} of a tree of arrays / tensors."""
    if isinstance(tree, dict):
        return {f"{k}/{p}" if p else k: s for k, v in tree.items()
                for p, s in _shapes(v).items()}
    return {"": tuple(tree.shape)}


def _flat(tree, leaf=lambda x: isinstance(x, tuple)):
    if isinstance(tree, dict) and not leaf(tree):
        return {f"{k}/{p}" if p else k: s for k, v in tree.items()
                for p, s in _flat(v, leaf).items()}
    return {"": tree}


def _ref_specs(axes, shapes, mesh):
    specs = RSH.tree_specs(axes, shapes, mesh)
    return {k: _p(v) for k, v in _flat(
        specs, leaf=lambda x: isinstance(x, P)).items()}


@pytest.fixture(scope="module")
def trees():
    """Per arch: (reference, port) x (params + axes, train state + axes,
    decode_32k cache + axes), shapes only."""
    out = {}
    cell = shape_cell("decode_32k")
    for arch in ARCHS:
        rcfg, tcfg = get_config(arch), t_get_config(arch)
        rst = jax.eval_shape(lambda: RTS.init_state(
            jax.random.PRNGKey(0), rcfg, r_adamw(1e-3)))
        rc = jax.eval_shape(lambda: RSV.init_cache(
            rcfg, cell.global_batch, cell.seq_len))
        tst = TTS.init_state(torch.Generator(), tcfg, t_adamw(1e-3),
                             device="meta")
        tc = TSV.init_cache(tcfg, cell.global_batch, cell.seq_len,
                            device="meta")
        out[arch] = dict(
            ref=dict(params=(rst["params"], RM.param_axes(rcfg)),
                     state=(rst, RTS.state_axes(rcfg, rst["opt"])),
                     cache=(rc, RSV.cache_axes(rcfg))),
            port=dict(params=(tst["params"], TM.param_axes(tcfg)),
                      state=(tst, TTS.state_axes(tcfg, tst["opt"])),
                      cache=(tc, TSV.cache_axes(tcfg))))
    return out


@pytest.mark.parametrize("tree", ["params", "state", "cache"])
@pytest.mark.parametrize("arch", ARCHS)
def test_axes_trees_mirror_init_leaf_for_leaf(trees, arch, tree):
    (rv, rax), (tv, tax) = trees[arch]["ref"][tree], \
        trees[arch]["port"][tree]
    assert _flat(tax) == _flat(rax)
    shapes = _shapes(tv)
    assert shapes == _shapes(rv)
    flat_ax = _flat(tax)
    assert set(flat_ax) == set(shapes)
    for k, ax in flat_ax.items():
        assert len(ax) == len(shapes[k]), (k, ax, shapes[k])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_tree_specs_equal_the_reference(trees, arch, mesh):
    m = _mesh(mesh)
    for tree in ("params", "state", "cache"):
        rv, rax = trees[arch]["ref"][tree]
        tv, tax = trees[arch]["port"][tree]
        got = _flat(TSH.tree_specs(tax, tv, m))
        assert got == _ref_specs(rax, rv, m), (arch, mesh, tree)


@pytest.mark.parametrize("cell", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["qwen2_0p5b", "whisper_base",
                                  "paligemma_3b", "hymba_1p5b"])
def test_input_shardings_equal_the_reference(arch, cell):
    """``specs.input_shardings``' specs against the reference's input
    specs through its own ``spec_for`` / ``tree_specs``, at the
    production meshes."""
    c = shape_cell(cell)
    rcfg, tcfg = get_config(arch), t_get_config(arch)
    rin = RSPECS.input_specs(rcfg, c)
    for mesh in ("16x16", "2x16x16"):
        m = _mesh(mesh)
        got = TSPECS.input_shardings(tcfg, c, m)
        assert set(got) == set(rin)
        for k, v in rin.items():
            if k == "cache":
                want = _ref_specs(RSV.cache_axes(rcfg), v, m)
                assert _flat(got[k]) == want
            else:
                want = _p(RSH.spec_for(("batch",) + (None,) * (v.ndim - 1),
                                       v.shape, m, RSH.DEFAULT_RULES))
                assert got[k] == want, (k, got[k], want)


def _ref_moe_groups(cell, mesh, rules):
    """JAX's ``make_plan`` formula for ``moe_groups``."""
    ma = dict(zip(mesh.axis_names, mesh.devices.shape))
    bax = RSH._resolve_axis(rules["batch"], cell.global_batch, ma)
    if bax is None:
        return 1
    n = 1
    for a in ((bax,) if isinstance(bax, str) else bax):
        n *= ma[a]
    return n


@pytest.mark.parametrize("over", [None, {"batch": ("pod", "data", "model")},
                                  {"batch": "model"}, {"batch": None}])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_make_plan_moe_groups(mesh, over):
    m = _mesh(mesh)
    cfg = t_get_config("granite_moe_3b_a800m")
    rules = TSH.make_rules(over)
    for cell in (ShapeCell("t", 64, 256, "train"),
                 ShapeCell("d", 64, 2, "decode"),
                 ShapeCell("d1", 64, 1, "decode")):
        plan = TTS.make_plan(cfg, cell, m, t_adamw(1e-3), rules)
        assert plan.moe_groups == _ref_moe_groups(cell, m, rules)
        assert plan.rules == rules


def test_make_plan_specs_are_the_trees_specs():
    m = _mesh("2x16x16")
    cfg = t_get_config("qwen2_0p5b")
    plan = TTS.make_plan(cfg, shape_cell("train_4k"), m, t_adamw(1e-3))
    assert plan.param_shardings == plan.state_shardings["params"]
    assert plan.state_shardings["opt"]["m"] == plan.param_shardings
    assert plan.param_shardings["embed"] == ("model", "data")
    assert plan.input_shardings["tokens"] == (("pod", "data"),)
    assert plan.abstract_state["params"]["embed"].device.type == "meta"
    dplan = TTS.make_plan(cfg, shape_cell("decode_32k"), m)
    assert dplan.input_shardings["cache"]["layers"]["k"] == \
        (None, ("pod", "data"), "model")


# ---------------------------------------------------------------------------
# The filter heads' axes trees (IC, OD, OD-COF)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("kind", ["ic", "od", "cof"])
def test_filter_head_axes_equal_the_reference(kind, mesh):
    """``branch_axes`` (and the head table's axes entry) leaf for leaf
    against the reference's, mirroring the head's parameters, and their
    specs at each mesh shape, for a trunk width of 256 (``embed`` splits
    over ``data`` where it divides) and of 6 (where it does not)."""
    from repro.core import filters as RF
    from repro.models.config import BranchSpec as RBranchSpec
    from repro_torch.core import filters as TF
    from repro_torch.models.config import BranchSpec as TBranchSpec
    rspec = RBranchSpec(layer=2, grid=8, n_classes=3, head_dim=16, kind=kind)
    tspec = TBranchSpec(layer=2, grid=8, n_classes=3, head_dim=16, kind=kind)
    tax = TF.branch_axes(tspec)
    assert tax == RF.branch_axes(rspec) == TF.HEADS[kind][2](tspec)
    m = _mesh(mesh)
    for d_model in (256, 6):
        rp = jax.eval_shape(lambda: RF.branch_init(jax.random.PRNGKey(0),
                                                   rspec, d_model))
        tp = TF.branch_init(torch.Generator(), tspec, d_model, "meta")
        shapes = _shapes(tp)
        assert shapes == _shapes(rp)
        flat_ax = _flat(tax)
        assert set(flat_ax) == set(shapes)
        for k, ax in flat_ax.items():
            assert len(ax) == len(shapes[k]), (k, ax, shapes[k])
        got = _flat(TSH.tree_specs(tax, tp, m))
        assert got == _ref_specs(RF.branch_axes(rspec), rp, m), \
            (kind, mesh, d_model)
