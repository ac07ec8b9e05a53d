"""The port's serving slice end to end against the JAX package's:
synthetic stream -> filter outputs -> shared staged plan -> one
union-mask oracle pass -> hopping-window stream executor, with queries
registered and retired mid-stream.

Both packages get the same filter-output arrays (ground-truth heads, as
in examples/multi_query_monitor.py, or one JAX filter forward handed to
both), so window hits, per-query attribution, oracle calls and rebuild
counts must be identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cascade as RC
from repro.core import query as RQ
from repro.core import streaming as RSm
from repro.core.filters import FilterOutputs as RF
from repro.data.synthetic import JACKSON_LIKE, VideoStream, collect
from repro.models.config import BranchSpec as RBranch
from repro.train import filter_train as RT
from repro_torch.core import cascade as TC
from repro_torch.core import streaming as TSm
from repro_torch.core.filters import FilterOutputs as TF
from repro_torch.models.config import BranchSpec as TBranch
from repro_torch.train import filter_train as TT
from torch_parity import to_port

QUERIES = [RQ.Count(RQ.Op.GE, 2),
           RQ.ClassCount(0, RQ.Op.GE, 1),
           RQ.And((RQ.ClassCount(0, RQ.Op.GE, 1),
                   RQ.Spatial(0, RQ.Rel.LEFT, 1, radius=1))),
           RQ.Or((RQ.Region(1, (0, 0, 4, 4), 1),
                  RQ.Not(RQ.ClassCount(1, RQ.Op.LE, 0))))]
LATE = RQ.Not(RQ.ClassCount(1, RQ.Op.GE, 1))
N_FRAMES, WINDOW, BATCH = 128, 64, 16


def _run(pkg, counts, grid, objects, scene):
    """Drive one package's stream executor; returns what must agree."""
    if pkg == "ref":
        CS, Sm, FO = RC, RSm, RF
        conv = (lambda q: q)
        arr = jnp.asarray
        kw = {}
    else:
        CS, Sm, FO = TC, TSm, TF
        conv = to_port
        arr = torch.as_tensor
        kw = {"device": "cpu"}
    counts, grid = arr(counts), arr(grid)
    registry = Sm.QueryRegistry()
    qids = [registry.register(conv(q)) for q in QUERIES]
    engines = []

    def factory(queries, slot_stats, leaf_table, step_cache):
        mqc = CS.MultiQueryCascade(queries, adaptive=True,
                                   slot_stats=slot_stats, restage_every=2,
                                   leaf_table=leaf_table,
                                   step_cache=step_cache)

        def filter_fn(idx):
            return FO(counts=counts[idx], grid=grid[idx])

        def oracle_fn(idx, sel):
            return [[tuple(o) for o in objects[idx[j]]] for j in sel]

        ex = CS.MultiQueryExecutor(mqc, filter_fn, oracle_fn,
                                   scene.n_classes, scene.grid,
                                   oracle_bucket=8, **kw)
        engines.append(ex)
        return lambda idx: ex.run_batch(idx).answers

    executor = Sm.MultiQueryStreamExecutor(
        registry, factory, Sm.HoppingWindow(size=WINDOW, advance=WINDOW),
        BATCH, **kw)

    def on_window(res):
        if res.span[0] == 0:
            registry.register(conv(LATE))
            registry.retire(qids[0])

    results = executor.run(N_FRAMES, on_window)
    stats = [(e.stats.frames_in, e.stats.filter_pass, e.stats.oracle_calls,
              e.stats.oracle_positives, tuple(e.stats.per_query_pass))
             for e in engines]
    modes = [e.cascade.mode for e in engines]
    return ([(r.span, r.hits, r.frames) for r in results], stats, modes,
            executor.rebuilds, registry.step_cache.snapshot()["puts"])


def _scene_data():
    scene = JACKSON_LIKE
    data = collect(VideoStream(scene, dynamics_seed=5), N_FRAMES)
    return scene, data


def test_stream_executor_identical_on_ground_truth_heads():
    scene, data = _scene_data()
    counts = data["counts"].astype(np.float32)
    grid = np.where(data["occupancy"], 1.0, 0.0).astype(np.float32)
    ref = _run("ref", counts, grid, data["objects"], scene)
    port = _run("port", counts, grid, data["objects"], scene)
    assert port == ref
    windows = ref[0]
    assert len(windows) == 2 and ref[3] == 2          # one rebuild each
    assert sum(windows[0][1].values()) > 0


def test_stream_executor_identical_on_filter_outputs():
    """The same filter-output arrays (one small IC filter forward through
    the JAX package) drive both packages' executors."""
    scene, data = _scene_data()
    spec = RBranch(layer=1, grid=scene.grid, n_classes=scene.n_classes,
                   head_dim=16)
    trunk = RT.default_trunk(d_model=32, n_layers=1, grid=scene.grid)
    p = RT.init_filter_model(jax.random.PRNGKey(3), trunk, spec,
                             scene.d_embed)
    out = RT.filter_forward(p, trunk, spec, jnp.asarray(data["embeds"]))
    counts = np.array(out.counts) * 3.0            # spread the counts
    grid = np.array(out.grid)
    ref = _run("ref", counts, grid, data["objects"], scene)
    port = _run("port", counts, grid, data["objects"], scene)
    assert port == ref


def test_port_slice_runs_its_own_filter_on_cpu():
    """The port end to end with its own filter (kernel route -> plain
    versions on the CPU): answers are a subset of the oracle-evaluated
    frames, and the kernel and plain heads agree at the float level."""
    scene, data = _scene_data()
    spec = TBranch(layer=1, grid=scene.grid, n_classes=scene.n_classes,
                   head_dim=16)
    trunk = TT.default_trunk(d_model=32, n_layers=1, grid=scene.grid)
    p = TT.init_filter_model(torch.Generator().manual_seed(0), trunk, spec,
                             scene.d_embed, device="cpu")
    embeds = data["embeds"]
    k_out = TT.filter_forward(p, trunk, spec, embeds[:16], use_kernel=True,
                              device="cpu")
    p_out = TT.filter_forward(p, trunk, spec, embeds[:16], use_kernel=False,
                              device="cpu")
    torch.testing.assert_close(k_out.counts, p_out.counts, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(k_out.grid, p_out.grid, rtol=1e-4, atol=1e-4)
    mqc = TC.MultiQueryCascade([to_port(q) for q in QUERIES], adaptive=True)
    ex = TC.MultiQueryExecutor(
        mqc, lambda idx: TT.filter_forward(p, trunk, spec, embeds[idx],
                                           use_kernel=True, device="cpu"),
        lambda idx, sel: [data["objects"][idx[j]] for j in sel],
        scene.n_classes, scene.grid, device="cpu")
    for b0 in range(0, 64, 16):
        res = ex.run_batch(np.arange(b0, b0 + 16))
    assert res.stats.frames_in == 64
    assert res.stats.oracle_positives <= res.stats.filter_pass


def test_single_query_cascade_executor_identical():
    scene, data = _scene_data()
    counts = data["counts"].astype(np.float32)
    grid = np.where(data["occupancy"], 1.0, 0.0).astype(np.float32)
    q = QUERIES[2]
    outs = []
    for CS, FO, arr, conv, kw in (
            (RC, RF, jnp.asarray, lambda x: x, {}),
            (TC, TF, torch.as_tensor, to_port, {"device": "cpu"})):
        c, g = arr(counts), arr(grid)
        ex = CS.CascadeExecutor(
            CS.FilterCascade(conv(q), adaptive=True),
            lambda idx: FO(counts=c[idx], grid=g[idx]),
            lambda idx, sel: [data["objects"][idx[j]] for j in sel],
            scene.n_classes, scene.grid, oracle_bucket=4, **kw)
        answers = [ex.run_batch(np.arange(b0, b0 + 16)).answers
                   for b0 in range(0, N_FRAMES, 16)]
        st = ex.stats
        outs.append((np.concatenate(answers).tolist(), st.frames_in,
                     st.filter_pass, st.oracle_calls, st.oracle_positives))
    assert outs[0] == outs[1]


def test_executors_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the no-card behaviour")
    with pytest.raises(RuntimeError, match="CUDA"):
        TSm.MultiQueryStreamExecutor(TSm.QueryRegistry(), lambda q: None,
                                     TSm.HoppingWindow(4, 4), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        TC.MultiQueryExecutor(TC.MultiQueryCascade([to_port(QUERIES[0])]),
                              None, None, 2, 8)
    with pytest.raises(ValueError, match="filter outputs"):
        ex = TC.MultiQueryExecutor(
            TC.MultiQueryCascade([to_port(QUERIES[0])]),
            lambda idx: TF(counts=torch.zeros((2, 2), device="meta")),
            None, 2, 8, device="cpu")
        ex.run_batch(np.arange(2))
