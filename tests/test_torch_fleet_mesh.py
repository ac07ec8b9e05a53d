"""The port's fleet over a ``("stream",)`` mesh on four gloo ranks against
the JAX package's sharded fleet engine on four host CPU devices: the
twin of ``tests/test_multistream.py``'s two forced-device tests.

One JAX subprocess (``--xla_force_host_platform_device_count=4``,
``sharding.stream_mesh()``) and four port processes (a gloo group from a
file store, ``sharding.stream_mesh(device="cpu")``, each rank serving
its contiguous block of the streams) run side by side on the same
``FilterOutputs``, drawn with numpy from each stream's ``stream_seed``,
and write npz files:

- S = 16 (``shard_wrap`` set, 4 streams a rank): two chunks through
  ``ShardedPlanGroupEngine``, the second prefetched during the first;
  the ``SlotStats`` after both and the stage order after the restage
  that follows the second (``restage_every=2``);
- S = 6 over 4 ranks: ``spec_for`` falls back to replication, every rank
  serving all six streams;
- the temporal fleet through ``MultiStreamExecutor`` under mid-window
  register / retire (the reference's ``TEMPORAL_SHARDED_SCRIPT``
  queries and triggers): per-frame answers and window hits;
- ``distributed_reduce`` of one accumulator a rank: the reference's
  three ``psum``s inside ``shard_map`` (float32, as the reference runs
  without x64) and the merge of the four accumulators.

Tolerances: answers, hits, pass counts and stage orders exactly;
``distributed_reduce`` within 1e-5 of the reference's float32 form and
within 1e-12 of the float64 merge.  Every subprocess has its own 300 s
timeout, so a hang fails this file's tests alone.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.abspath(os.path.join(ROOT, "src"))
TIMEOUT = 300
WORLD = 4

COMMON = r'''
import json
import numpy as np

B, C, G = 16, 6, 8
N_FRAMES = 96
TW, TB = 32, 8                 # the temporal fleet's window and batch
# per-stream Poisson rates (base, step per stack position): sparse at
# S = 16, so the count tier leaves under half of every stream's rows and
# the spatial tier runs compacted (the row kernel); denser at S = 6, where
# it runs on the full batch
RATES = {16: (0.2, 0.05), 6: (2.5, 0.3)}


def queries(Q):
    return (Q.And((Q.ClassCount(0, Q.Op.GE, 3), Q.Spatial(0, Q.Rel.LEFT, 1))),
            Q.ClassCount(1, Q.Op.LE, 1),
            Q.And((Q.ClassCount(2, Q.Op.GE, 2),
                   Q.Spatial(2, Q.Rel.ABOVE, 3))))


def tqueries(Q):
    return (Q.Duration(Q.ClassCount(0, Q.Op.GE, 1), 3),
            Q.Or((Q.SlidingCount(Q.ClassCount(1, Q.Op.GE, 1), 5, Q.Op.GE, 2),
                  Q.Not(Q.Count(Q.Op.GE, 9)))),
            Q.SlidingCount(Q.Count(Q.Op.GE, 1), 30, Q.Op.GE, 8))


def tnew(Q):
    return Q.Sequence(Q.ClassCount(0, Q.Op.GE, 1),
                      Q.ClassCount(2, Q.Op.GE, 1), 4)


def stream_data(ctx, rate, step):
    r = np.random.default_rng(ctx.seed % 2**32)
    counts = r.poisson(rate + step * ctx.position,
                       (N_FRAMES, C)).astype(np.float32)
    grid = (r.random((N_FRAMES, G, G, C)) < 0.05).astype(np.float32)
    return counts, grid


def acc_data(rank):
    """(y, z) of one rank's accumulator."""
    r = np.random.default_rng(500 + rank)
    n = 40 + 13 * rank
    z = r.normal(1.0 + 0.5 * rank, 1.0, (n, 2))
    y = 3.0 * z[:, 0] - z[:, 1] + r.normal(0.0, 1.0, n)
    return y, z


def stats_view(stats, tmp):
    """The ledger's slot counts and stage ledgers, as saved."""
    stats.save(tmp)
    with open(tmp) as f:
        d = json.load(f)
    return json.dumps({"slots": sorted(json.dumps(s, sort_keys=True)
                                       for s in d["slots"]),
                       "stages": d["stages"]}, sort_keys=True)


def hits_view(results):
    return json.dumps([[list(r.span), {str(sid): {str(q): int(n)
                                                  for q, n in h.items()}
                                       for sid, h in r.hits.items()}]
                       for r in results], sort_keys=True)


class Recorder:
    """Wraps an engine factory: logs every chunk's (S, B, N) answers with
    the active query ids (the executor's opt-in by name unchanged)."""

    def __init__(self, factory, registry):
        import functools
        self.log = []
        log = self.log

        @functools.wraps(factory)
        def build(queries, streams, **stores):
            eng = factory(queries, streams, **stores)
            qids = [int(q) for q, _ in registry.active()]
            run = eng.run_chunk

            def run_chunk(idx, *a, **k):
                ans = run(idx, *a, **k)
                log.append((int(np.asarray(idx)[0]), qids,
                            np.asarray(ans).astype(np.uint8).tolist()))
                return ans
            eng.run_chunk = run_chunk
            return eng
        self.factory = build
'''

JAX_SIDE = COMMON + r'''
import os, sys, tempfile
os.environ["REPRO_CALIBRATION"] = "off"
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core import query as Q
from repro.core.aggregates import CVAccumulator, distributed_reduce
from repro.core.costmodel import static_cost_model
from repro.core.filters import FilterOutputs
from repro.core.stats import SlotStats
from repro.core.streaming import HoppingWindow, QueryRegistry
from repro.distributed import sharding as SH
from repro.distributed.multistream import (MultiStreamExecutor,
                                           ShardedPlanGroupEngine,
                                           plan_group_engine_factory,
                                           route_streams)

assert jax.device_count() == 4
mesh = SH.stream_mesh()
cm = static_cost_model()
tmp = tempfile.mkdtemp()
out = {}


def fetch_of(data):
    def fetch(ctx, idx):
        c, g = data[ctx.stream_id]
        return FilterOutputs(counts=jnp.asarray(c[idx]),
                             grid=jnp.asarray(g[idx]))
    return fetch


for S in (16, 6):
    streams = route_streams([f"cam{i}" for i in range(S)], 4)
    data = {c.stream_id: stream_data(c, *RATES[S]) for c in streams}
    stats = SlotStats()
    eng = ShardedPlanGroupEngine(queries(Q), streams, fetch_of(data),
                                 slot_stats=stats, mesh=mesh, cost_model=cm,
                                 restage_every=2)
    out[f"s{S}/wrapped"] = eng.shard_wrap is not None
    out[f"s{S}/order0"] = json.dumps(eng.stage_order())
    out[f"s{S}/ans0"] = eng.run_chunk(np.arange(B), np.arange(B, 2 * B))
    out[f"s{S}/staged"] = eng._next is not None
    out[f"s{S}/ans1"] = eng.run_chunk(np.arange(B, 2 * B))
    out[f"s{S}/stats"] = stats_view(stats, os.path.join(tmp, f"{S}.json"))
    out[f"s{S}/order"] = json.dumps(eng.stage_order())
    out[f"s{S}/positions"] = json.dumps([c.stream_id for c in streams])

# the temporal fleet, mid-window register and retire
S = 16
ids = [f"cam{i}" for i in range(S)]
streams = route_streams(ids, 4)
data = {c.stream_id: stream_data(c, 0.8, 0.1) for c in streams}
registry = QueryRegistry()
qids = [registry.register(q) for q in tqueries(Q)]
fired = set()
base = fetch_of(data)


def fetch(ctx, idx):
    t0 = int(np.asarray(idx)[0])
    if t0 == 48 and "reg" not in fired:          # staged during 40
        fired.add("reg"); qids.append(registry.register(tnew(Q)))
    if t0 == 80 and "ret" not in fired:          # staged during 72
        fired.add("ret"); registry.retire(qids[1])
    return base(ctx, idx)


rec = Recorder(plan_group_engine_factory(fetch, mesh=mesh, cost_model=cm),
               registry)
ex = MultiStreamExecutor(registry, rec.factory,
                         HoppingWindow(size=TW, advance=TW), TB, ids,
                         n_slots=4)
res = ex.run(N_FRAMES)
assert fired == {"reg", "ret"} and ex.rebuilds >= 3
assert ex._engine.shard_wrap is not None
out["t/hits"] = hits_view(res)
out["t/log"] = json.dumps(rec.log)
out["t/rebuilds"] = ex.rebuilds

# distributed_reduce: three psums inside shard_map, one accumulator a device
accs = []
for r in range(4):
    y, z = acc_data(r)
    accs.append(CVAccumulator.init(2).update(jnp.asarray(y), jnp.asarray(z)))
stacked = [jnp.stack([getattr(a, f) for a in accs])
           for f in ("n", "mean", "M2")]


def body(n, mean, M2):
    a = distributed_reduce(CVAccumulator(n=n[0], mean=mean[0], M2=M2[0]),
                           "stream")
    return a.n[None], a.mean[None], a.M2[None]


red = SH.shard_map(body, mesh=mesh, in_specs=P("stream"),
                   out_specs=P("stream"), check_vma=False)(*stacked)
for f, v in zip(("n", "mean", "M2"), red):
    out[f"reduce/{f}"] = np.asarray(v)
np.savez(sys.argv[1], **out)
print("JAX_SIDE_OK", flush=True)
'''

PORT_SIDE = COMMON + r'''
import functools, os, sys, time
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.core import query as Q
from repro_torch.core.aggregates import CVAccumulator, distributed_reduce
from repro_torch.core.costmodel import static_cost_model
from repro_torch.core.filters import FilterOutputs
from repro_torch.core.stats import SlotStats
from repro_torch.core.streaming import HoppingWindow, QueryRegistry
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.multistream import (MultiStreamExecutor,
                                                 ShardedPlanGroupEngine,
                                                 plan_group_engine_factory,
                                                 route_streams)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import init_distributed

store, rank, path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
CPU = "cpu"
t_start = time.perf_counter()
init_distributed(CPU, init_file=store, rank=rank, world_size=4)
mesh = SH.stream_mesh(device=CPU)
cm = static_cost_model()
out = {}

# the stats kernels' entry points, as the plan calls them: the frames of
# each full-batch call and the largest row id of each compacted call
seen = {"full": [], "rows": []}
full, rows_fn = ops.spatial_stats_inline, ops.spatial_stats_rows_inline


def full_spy(grid, *a, **k):
    seen["full"].append(int(grid.shape[0]))
    return full(grid, *a, **k)


def rows_spy(grid, rows, *a, **k):
    seen["rows"].append((int(grid.shape[0]), int(rows.max())))
    return rows_fn(grid, rows, *a, **k)


ops.spatial_stats_inline, ops.spatial_stats_rows_inline = full_spy, rows_spy


def fetch_of(data, calls):
    def fetch(ctx, idx):
        calls.append(ctx.stream_id)
        c, g = data[ctx.stream_id]
        return FilterOutputs(counts=torch.from_numpy(c[idx]),
                             grid=torch.from_numpy(g[idx]))
    return fetch


for S in (16, 6):
    streams = route_streams([f"cam{i}" for i in range(S)], 4)
    data = {c.stream_id: stream_data(c, *RATES[S]) for c in streams}
    stats, calls = SlotStats(), []
    eng = ShardedPlanGroupEngine(queries(Q), streams, fetch_of(data, calls),
                                 slot_stats=stats, mesh=mesh, cost_model=cm,
                                 restage_every=2, device=CPU)
    out[f"s{S}/wrapped"] = eng.shard_wrap is not None
    out[f"s{S}/local"] = json.dumps([c.stream_id for c in eng.local_streams])
    out[f"s{S}/order0"] = json.dumps(eng.stage_order())
    seen["full"].clear(); seen["rows"].clear()
    out[f"s{S}/ans0"] = eng.run_chunk(np.arange(B), np.arange(B, 2 * B))
    out[f"s{S}/staged"] = eng._next is not None and \
        eng._next[0] == (B, 2 * B - 1, B)
    out[f"s{S}/ans1"] = eng.run_chunk(np.arange(B, 2 * B))
    out[f"s{S}/consumed"] = eng._next is None
    out[f"s{S}/fetches"] = len(calls)
    out[f"s{S}/stats_frames"] = np.array(seen["full"], np.int64)
    out[f"s{S}/rows_calls"] = np.array(seen["rows"], np.int64).reshape(-1, 2)
    out[f"s{S}/stats"] = stats_view(stats,
                                    os.path.join(os.path.dirname(path),
                                                 f"stats{rank}_{S}.json"))
    out[f"s{S}/order"] = json.dumps(eng.stage_order())
    out[f"s{S}/positions"] = json.dumps([c.stream_id for c in streams])

# the temporal fleet, mid-window register and retire
S = 16
ids = [f"cam{i}" for i in range(S)]
data = {c.stream_id: stream_data(c, 0.8, 0.1) for c in route_streams(ids, 4)}
registry = QueryRegistry()
qids = [registry.register(q) for q in tqueries(Q)]
fired = set()
base = fetch_of(data, [])


def fetch(ctx, idx):
    t0 = int(np.asarray(idx)[0])
    if t0 == 48 and "reg" not in fired:          # staged during 40
        fired.add("reg"); qids.append(registry.register(tnew(Q)))
    if t0 == 80 and "ret" not in fired:          # staged during 72
        fired.add("ret"); registry.retire(qids[1])
    return base(ctx, idx)


rec = Recorder(plan_group_engine_factory(fetch, mesh=mesh, cost_model=cm),
               registry)
ex = MultiStreamExecutor(registry, rec.factory,
                         HoppingWindow(size=TW, advance=TW), TB, ids,
                         device=CPU)
res = ex.run(N_FRAMES)
assert fired == {"reg", "ret"} and ex.rebuilds >= 3
assert ex._engine.shard_wrap is not None
out["t/slots"] = json.dumps([c.slot for c in ex.streams])
out["t/local"] = len(ex._engine.temporal)
out["t/hits"] = hits_view(res)
out["t/log"] = json.dumps(rec.log)
out["t/rebuilds"] = ex.rebuilds

# distributed_reduce over the mesh, against the merge of the four
accs = []
for r in range(4):
    y, z = acc_data(r)
    accs.append(CVAccumulator.init(2, device=CPU).update(
        torch.from_numpy(y), torch.from_numpy(z)))
red = distributed_reduce(accs[rank], mesh=mesh)
merged = functools.reduce(CVAccumulator.merge, accs)
for f in ("n", "mean", "M2"):
    out[f"reduce/{f}"] = getattr(red, f).numpy()
    out[f"merge/{f}"] = getattr(merged, f).numpy()
out["seconds"] = time.perf_counter() - t_start
dist.barrier()
np.savez(path, **out)
dist.destroy_process_group()
print("PORT_SIDE_OK", rank, flush=True)
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides, run side by side: ({reference}, [{port rank r}])."""
    d = tmp_path_factory.mktemp("fleet_mesh")
    jscript, pscript = d / "jax_side.py", d / "port_side.py"
    jscript.write_text(JAX_SIDE)
    pscript.write_text(PORT_SIDE)
    ref, store = d / "ref.npz", d / "store"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(jscript), str(ref)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)]
    procs += [subprocess.Popen([sys.executable, str(pscript), str(store),
                                str(r), str(d / f"port{r}.npz")], env=env,
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
              for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            left = TIMEOUT - (time.perf_counter() - t0)
            outs.append(p.communicate(timeout=max(left, 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-4000:]
    assert "JAX_SIDE_OK" in outs[0], outs[0][-4000:]
    return (dict(np.load(ref)),
            [dict(np.load(d / f"port{r}.npz")) for r in range(WORLD)])


@pytest.mark.parametrize("S", [16, 6])
def test_answers_equal_the_reference_bit_for_bit(runs, S):
    ref, ports = runs
    assert bool(ref[f"s{S}/wrapped"]) == (S == 16)
    for r, port in enumerate(ports):
        assert bool(port[f"s{S}/wrapped"]) == (S == 16), r
        assert str(port[f"s{S}/positions"]) == str(ref[f"s{S}/positions"])
        for k in (0, 1):
            np.testing.assert_array_equal(port[f"s{S}/ans{k}"],
                                          ref[f"s{S}/ans{k}"],
                                          err_msg=f"rank {r} chunk {k}")
            assert port[f"s{S}/ans{k}"].shape == (S, 16, 3)


@pytest.mark.parametrize("S", [16, 6])
def test_each_rank_serves_its_block(runs, S):
    """S = 16: rank r's block is positions 4r..4r+3, fetched once a chunk
    (the second chunk's fetch was the prefetch), and the row kernel's
    entry point saw 4 x 16 frames and local flat ids; S = 6: every rank
    fetches and evaluates all six streams, the stats kernel over 6 x 16
    frames."""
    ref, ports = runs
    order = json.loads(str(ref[f"s{S}/positions"]))
    for r, port in enumerate(ports):
        local = json.loads(str(port[f"s{S}/local"]))
        n_local = 4 if S == 16 else 6
        assert local == (order[4 * r:4 * r + 4] if S == 16 else order)
        assert bool(port[f"s{S}/staged"]) and bool(port[f"s{S}/consumed"])
        assert int(port[f"s{S}/fetches"]) == 2 * n_local
        frames, rows = port[f"s{S}/stats_frames"], port[f"s{S}/rows_calls"]
        assert (frames == n_local * 16).all(), frames
        assert (rows[:, 0] == n_local * 16).all(), rows
        assert (rows[:, 1] < n_local * 16).all(), rows
        assert len(rows if S == 16 else frames) > 0


@pytest.mark.parametrize("S", [16, 6])
def test_slot_stats_and_restaged_order_equal_everywhere(runs, S):
    ref, ports = runs
    for r, port in enumerate(ports):
        assert str(port[f"s{S}/order0"]) == str(ref[f"s{S}/order0"]), r
        assert str(port[f"s{S}/stats"]) == str(ref[f"s{S}/stats"]), r
        assert str(port[f"s{S}/order"]) == str(ref[f"s{S}/order"]), r
    # full-batch tiers only, each seeing the whole group's S x 16 frames
    seen = json.loads(str(ports[0][f"s{S}/stats"]))["slots"]
    assert seen and all(json.loads(s)["seen"] in (S * 16, 2 * S * 16)
                        for s in seen)


def test_temporal_fleet_with_churn_equals_the_reference(runs):
    ref, ports = runs
    want_log = json.loads(str(ref["t/log"]))
    assert int(ref["t/rebuilds"]) >= 3
    for r, port in enumerate(ports):
        assert json.loads(str(port["t/slots"])) == \
            [i // 4 for i in range(16)]
        assert int(port["t/local"]) == 4
        assert int(port["t/rebuilds"]) == int(ref["t/rebuilds"])
        assert str(port["t/hits"]) == str(ref["t/hits"]), r
        got_log = json.loads(str(port["t/log"]))
        assert len(got_log) == len(want_log) == 96 // 8
        for got, want in zip(got_log, want_log):
            assert got == want, f"rank {r} chunk {got[0]}"


def test_distributed_reduce_matches_psum_and_merge(runs):
    ref, ports = runs
    for r, port in enumerate(ports):
        for f in ("n", "mean", "M2"):
            got = port[f"reduce/{f}"]
            assert got.dtype == np.float64
            merged = port[f"merge/{f}"]
            np.testing.assert_allclose(got, merged, rtol=1e-12,
                                       atol=1e-12 * np.abs(merged).max(),
                                       err_msg=f"rank {r} {f}")
            want = ref[f"reduce/{f}"][r]
            np.testing.assert_allclose(got, want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=f"rank {r} {f} vs psum")
    assert float(ports[0]["reduce/n"]) == sum(40 + 13 * r for r in range(4))
