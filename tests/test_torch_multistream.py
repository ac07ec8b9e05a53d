"""Fleet serving in the port (repro_torch.distributed.multistream) on the
CPU, against the JAX package: the twin of tests/test_multistream.py.

The load-bearing pin: per-stream answers equal running each stream alone
through the single-stream executor, bit for bit — group-uniform staging
and stream-axis stacking may change *work*, never *answers* — including
under mid-stream register/retire and mixed per-stream skew, and equal
the JAX package's group plan and fleet executor on the same arrays.
The reference's two 8-device subprocess tests have no twin: the port
runs on one card and has no stream mesh to shard over.
"""
import functools

import numpy as np
import pytest
import torch

from repro.core import query as RQ
from repro.core import streaming as RS
from repro.core.filters import FilterOutputs as RF
from repro.core.plan import QueryPlan as RPlan
from repro.core.stats import SlotStats as RSlotStats
from repro.distributed import multistream as RM
from repro_torch.core import query as Q
from repro_torch.core.filters import FilterOutputs
from repro_torch.core.plan import QueryPlan
from repro_torch.core.stats import SlotStats
from repro_torch.core.streaming import (HoppingWindow,
                                        MultiQueryStreamExecutor,
                                        QueryRegistry, StragglerPolicy,
                                        StreamExecutor)
from repro_torch.core.temporal import TemporalProgram
from repro_torch.distributed.multistream import (MultiStreamExecutor,
                                                 ShardedPlanGroupEngine,
                                                 plan_group_engine_factory,
                                                 route_streams)
from torch_parity import to_port

CPU = "cpu"
REF_QUERIES = (
    RQ.And((RQ.ClassCount(0, RQ.Op.GE, 3), RQ.Spatial(0, RQ.Rel.LEFT, 1))),
    RQ.ClassCount(1, RQ.Op.LE, 1),
    RQ.Or((RQ.Count(RQ.Op.GE, 10), RQ.Region(2, (0, 0, 4, 4), 1))),
    RQ.Not(RQ.ClassCount(2, RQ.Op.GE, 2)),
)
QUERIES = tuple(to_port(q) for q in REF_QUERIES)
C, G = 6, 8


def _stream_data(seed, n_frames, rate, class0=None):
    """Per-stream synthetic filter outputs (numpy) with controllable
    skew; ``class0`` sets class 0's rate apart from the others'."""
    r = np.random.default_rng(seed)
    rates = np.full(C, rate)
    if class0 is not None:
        rates[0] = class0
    counts = r.poisson(rates, (n_frames, C)).astype(np.float32)
    grid = (r.random((n_frames, G, G, C)) < 0.05).astype(np.float32)
    return counts, grid


def _port_outs(counts, grid):
    return FilterOutputs(counts=torch.as_tensor(counts),
                         grid=None if grid is None
                         else torch.as_tensor(grid))


def _make_fetch(data):
    def fetch(ctx, idx):
        c, g = data[ctx.stream_id]
        return _port_outs(c[idx], g[idx])
    return fetch


def _ref_fetch(data):
    import jax.numpy as jnp

    def fetch(ctx, idx):
        c, g = data[ctx.stream_id]
        return RF(counts=jnp.asarray(c[idx]), grid=jnp.asarray(g[idx]))
    return fetch


# ---------------------------------------------------------------------------
# Plan level: evaluate_group == per-stream evaluate == the reference's
# evaluate_group, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("spatial_body", ["auto", "rows", "full"])
@pytest.mark.parametrize("presumed", [False, True])
def test_evaluate_group_bit_identical_per_stream(seed, spatial_body,
                                                 presumed):
    import jax.numpy as jnp
    S, B = 4, 32
    # mixed skew: class 0 rare on stream 0 and common on stream 3, the
    # rest busy, so the count tier decides very different row fractions
    # per stream and the later tiers run compacted at the worst stream's
    # bucket
    streams = [_stream_data(100 + 10 * seed + s, B, 2.5,
                            class0=0.3 + 0.5 * s) for s in range(S)]
    counts = np.stack([c for c, _ in streams])
    grid = np.stack([g for _, g in streams])
    mask = (np.random.default_rng(seed).random((S, len(QUERIES))) < 0.4
            if presumed else None)
    grp_plan = QueryPlan(QUERIES).build_staged(SlotStats(),
                                               spatial_body=spatial_body)
    grp = grp_plan.evaluate_group(_port_outs(counts, grid),
                                  presumed_decided=mask).numpy()
    ref_plan = RPlan(REF_QUERIES).build_staged(RSlotStats(),
                                               spatial_body=spatial_body)
    ref = np.asarray(ref_plan.evaluate_group(
        RF(counts=jnp.asarray(counts), grid=jnp.asarray(grid)),
        presumed_decided=mask))
    for s in range(S):
        keep = np.ones(len(QUERIES), bool) if mask is None else ~mask[s]
        serial = QueryPlan(QUERIES).build_staged(
            SlotStats(), spatial_body=spatial_body).evaluate(
                _port_outs(*streams[s]),
                presumed_decided=None if mask is None else mask[s]).numpy()
        np.testing.assert_array_equal(grp[s][:, keep], serial[:, keep])
        np.testing.assert_array_equal(grp[s][:, keep], ref[s][:, keep])
    a, b = grp_plan.last_report, ref_plan.last_report
    for field in ("order", "ran", "skipped", "bodies", "rows_evaluated",
                  "undecided_rows_in", "undecided_after", "batch",
                  "skipped_presumed", "steps_compiled"):
        assert getattr(a, field) == getattr(b, field), field
    for field in ("cost_run", "cost_total", "cost_presumed_saved"):
        assert getattr(a, field) == pytest.approx(getattr(b, field))
    assert a.ran and a.batch == S * B
    if not presumed:
        # the group walked a compacted tier, and the ledger feedback
        # equals the reference's
        assert a.rows_evaluated != [S * B] * len(a.ran)
        st, rst = SlotStats(), RSlotStats()
        grp_plan.flush_stats(st)
        ref_plan.flush_stats(rst)
        keys = [QueryPlan(QUERIES).slot_keys[s]
                for s in QueryPlan(QUERIES).live_slots]
        np.testing.assert_array_equal(
            st.pass_rates(keys, canonical=True),
            rst.pass_rates([RPlan(REF_QUERIES).slot_keys[s]
                            for s in RPlan(REF_QUERIES).live_slots],
                           canonical=True))


def test_evaluate_group_all_presumed_is_one_skip():
    S, B = 2, 8
    counts = np.stack([_stream_data(s, B, 1.0)[0] for s in range(S)])
    staged = QueryPlan(QUERIES).build_staged(SlotStats())
    out = staged.evaluate_group(
        FilterOutputs(counts=torch.as_tensor(counts)),
        presumed_decided=np.ones((S, len(QUERIES)), bool))
    assert out.shape == (S, B, len(QUERIES)) and not out.any()
    rep = staged.last_report
    assert not rep.ran and rep.skipped_presumed == rep.skipped
    assert rep.cost_presumed_saved > 0
    with pytest.raises(ValueError, match="presumed_decided"):
        staged.evaluate_group(FilterOutputs(counts=torch.as_tensor(counts)),
                              presumed_decided=np.ones((S, 1), bool))


def test_evaluate_group_extreme_skew_zero_undecided_stream():
    """A stream whose first tier decides every row still rides the
    group's later compacted steps (padded rows) without corruption."""
    S, B = 3, 32
    streams = [_stream_data(7 + s, B, 1.0) for s in range(S)]
    streams[0] = (np.zeros((B, C), np.float32), streams[0][1])
    grp = QueryPlan(QUERIES).build_staged(SlotStats()).evaluate_group(
        _port_outs(np.stack([c for c, _ in streams]),
                   np.stack([g for _, g in streams]))).numpy()
    for s in range(S):
        ref = QueryPlan(QUERIES).build_staged(SlotStats()).evaluate(
            _port_outs(*streams[s])).numpy()
        np.testing.assert_array_equal(grp[s], ref)


def test_evaluate_group_count_only_heads():
    """OD-COF streams (no grid): count-only queries evaluate; a
    grid-needing stage for an undecided query raises, same as serial."""
    S, B = 2, 16
    counts = np.stack([_stream_data(s, B, 2.0)[0] for s in range(S)])
    qs = (Q.Count(Q.Op.GE, 8), Q.ClassCount(0, Q.Op.GE, 1))
    grp = QueryPlan(qs).build_staged(SlotStats()).evaluate_group(
        _port_outs(counts, None)).numpy()
    for s in range(S):
        ref = QueryPlan(qs).build_staged(SlotStats()).evaluate(
            _port_outs(counts[s], None)).numpy()
        np.testing.assert_array_equal(grp[s], ref)
    with pytest.raises(ValueError, match="no grid"):
        QueryPlan(QUERIES).build_staged(SlotStats()).evaluate_group(
            _port_outs(counts, None))


def test_group_steps_ride_the_step_cache():
    """Group steps are keyed by the stream count and a None mesh slot,
    and a rebuilt plan re-hits them."""
    from repro_torch.core.stepcache import StepCache
    S, B = 3, 16
    counts = np.stack([_stream_data(s, B, 1.0)[0] for s in range(S)])
    grid = np.stack([_stream_data(s, B, 1.0)[1] for s in range(S)])
    cache = StepCache()
    first = QueryPlan(QUERIES).build_staged(SlotStats(), step_cache=cache)
    a = first.evaluate_group(_port_outs(counts, grid))
    assert first.last_report.steps_compiled > 0
    assert all(k[0] == "gstep" and k[6] == S and k[7] is None
               for k in cache.keys())
    again = QueryPlan(QUERIES).build_staged(SlotStats(), step_cache=cache)
    b = again.evaluate_group(_port_outs(counts, grid))
    assert again.last_report.steps_compiled == 0
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Executor level: MultiStreamExecutor == serial MultiQueryStreamExecutor
# == the reference's fleet executor, with mid-stream register/retire
# ---------------------------------------------------------------------------

def _serial_reference(stream_ids, data, n_frames, window, batch, schedule):
    out = {}
    for sid in stream_ids:
        registry = QueryRegistry()
        qids = [registry.register(q) for q in QUERIES[:3]]

        def factory(queries, slot_stats=None, sid=sid):
            staged = QueryPlan(tuple(queries)).build_staged(slot_stats)
            c, g = data[sid]

            def engine(idx):
                val = staged.evaluate(_port_outs(c[idx], g[idx]))
                staged.flush_stats(slot_stats)
                return val.numpy()
            return engine

        ex = MultiQueryStreamExecutor(registry, factory, window, batch,
                                      device=CPU)
        out[sid] = ex.run(n_frames, lambda res, registry=registry,
                          qids=qids: schedule(res.span, registry, qids,
                                              QUERIES))
    return out


def test_multistream_equals_serial_and_reference_with_churn():
    S, n_frames, batch = 4, 96, 16
    window = HoppingWindow(size=32, advance=32)
    stream_ids = [f"cam{i}" for i in range(S)]
    ctxs = route_streams(stream_ids, 2)
    data = {c.stream_id: _stream_data(c.seed % 2**32, n_frames,
                                      0.3 + 0.7 * c.position)
            for c in ctxs}

    def schedule(span, registry, qids, queries):
        lo, _ = span
        if lo == 0:                          # mid-stream registration
            qids.append(registry.register(queries[3]))
        if lo == 32:                         # mid-stream retirement
            registry.retire(qids[1])

    serial = _serial_reference(stream_ids, data, n_frames, window, batch,
                               schedule)
    registry = QueryRegistry()
    qids = [registry.register(q) for q in QUERIES[:3]]
    ex = MultiStreamExecutor(
        registry, plan_group_engine_factory(_make_fetch(data)),
        window, batch, stream_ids, device=CPU)
    results = ex.run(n_frames, lambda res: schedule(res.span, registry,
                                                    qids, QUERIES))
    r_registry = RS.QueryRegistry()
    r_qids = [r_registry.register(q) for q in REF_QUERIES[:3]]
    r_ex = RM.MultiStreamExecutor(
        r_registry, RM.plan_group_engine_factory(_ref_fetch(data)),
        RS.HoppingWindow(size=32, advance=32), batch, stream_ids,
        n_slots=2)
    r_results = r_ex.run(n_frames, lambda res: schedule(
        res.span, r_registry, r_qids, REF_QUERIES))

    assert len(results) == 3 and ex.rebuilds >= 3
    for sid in stream_ids:
        for w, res in enumerate(results):
            assert res.span == serial[sid][w].span
            assert res.hits[sid] == serial[sid][w].hits, \
                f"stream {sid} window {w}"
            assert res.hits[sid] == r_results[w].hits[sid]
        st = ex.stats[sid]
        assert st.frames_seen == st.frames_processed == 96
        assert st.frames_dropped == 0 and st.windows == 3
    assert len(ex.chunk_latencies_s) == 6
    assert ex.latency_percentile(95) >= ex.latency_percentile(50) > 0
    assert ex.aggregate_fps > 0


def test_multistream_empty_registry_serves_nothing():
    stream_ids = ["a", "b"]
    ctxs = route_streams(stream_ids, 1)
    data = {c.stream_id: _stream_data(1, 32, 1.0) for c in ctxs}
    ex = MultiStreamExecutor(
        QueryRegistry(), plan_group_engine_factory(_make_fetch(data)),
        HoppingWindow(size=32, advance=32), 16, stream_ids, device=CPU)
    assert ex.run(32)[0].hits == {"a": {}, "b": {}}


def test_prefetch_stages_the_next_chunk():
    ctxs = route_streams(["x", "y"], 1)
    data = {c.stream_id: _stream_data(3, 32, 1.0) for c in ctxs}
    calls = []
    base = _make_fetch(data)

    def fetch(ctx, idx):
        calls.append(int(idx[0]))
        return base(ctx, idx)

    eng = ShardedPlanGroupEngine(QUERIES, ctxs, fetch,
                                 slot_stats=SlotStats(), device=CPU)
    first = eng.run_chunk(np.arange(0, 8), np.arange(8, 16))
    assert eng._next is not None and calls == [0, 0, 8, 8]
    second = eng.run_chunk(np.arange(8, 16))     # consumes the prefetch
    assert eng._next is None and calls == [0, 0, 8, 8]
    plan = QueryPlan(QUERIES)
    for ans, lo in ((first, 0), (second, 8)):
        for c in ctxs:
            ref = plan.build_staged(SlotStats()).evaluate(
                fetch(c, np.arange(lo, lo + 8))).numpy()
            np.testing.assert_array_equal(ans[c.position], ref)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    ctxs = route_streams(["a"], 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedPlanGroupEngine(QUERIES, ctxs, None)
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiStreamExecutor(QueryRegistry(), None,
                            HoppingWindow(size=8, advance=8), 8, ["a"])


# ---------------------------------------------------------------------------
# Routing, per-stream seeds, straggler dropping, gossip warm start
# ---------------------------------------------------------------------------

def test_route_streams_equal_reference_stable_balanced():
    ids = [f"cam{i}" for i in range(16)]
    for n_slots in (1, 3, 8):
        ctxs = route_streams(ids, n_slots, base_seed=5)
        ref = RM.route_streams(ids, n_slots, base_seed=5)
        assert [(c.stream_id, c.position, c.slot, c.seed) for c in ctxs] \
            == [(c.stream_id, c.position, c.slot, c.seed) for c in ref]
    ctxs = route_streams(ids, 8)
    slots = [c.slot for c in sorted(ctxs, key=lambda c: c.position)]
    assert slots == sorted(slots)
    assert all(slots.count(s) == 2 for s in range(8))
    assert [c.stream_id for c in sorted(ctxs, key=lambda c: c.position)] \
        != ids
    with pytest.raises(ValueError, match="duplicate"):
        route_streams(["x", "x"], 2)


@pytest.mark.parametrize("n_slots", [None, 1, 2, 3, 4, 8])
def test_executor_routing_equals_reference(n_slots):
    """``MultiStreamExecutor(n_slots=)`` routes slot for slot as the
    reference's; by default one slot a rank of the process group, and
    one without a group (the reference: one a device, one here)."""
    ids = [f"cam{i}" for i in range(16)]
    kw = {} if n_slots is None else {"n_slots": n_slots}
    ex = MultiStreamExecutor(QueryRegistry(), None,
                             HoppingWindow(size=8, advance=8), 8, ids,
                             base_seed=3, device=CPU, **kw)
    ref = RM.MultiStreamExecutor(RS.QueryRegistry(), None,
                                 RS.HoppingWindow(size=8, advance=8), 8,
                                 ids, base_seed=3, **kw)
    assert [(c.stream_id, c.position, c.slot, c.seed) for c in ex.streams] \
        == [(c.stream_id, c.position, c.slot, c.seed) for c in ref.streams]
    if n_slots is None:
        assert {c.slot for c in ex.streams} == {0}


@pytest.mark.parametrize("fps,slack,factor", [(50.0, 1.0, 1.0),
                                              (50.0, 1.0, 1.5),
                                              (50.0, 1.0, 1.7),
                                              (1000.0, 1.2, 3.0)])
def test_stream_executor_drops_equal_reference(fps, slack, factor):
    """Deterministic ``simulate_slow`` traces drop exactly the batches
    the reference drops."""
    runs = []
    for mod in (RS, None):
        policy = (RS.StragglerPolicy if mod else StragglerPolicy)(
            fps=fps, slack=slack)
        processed = []
        ex = (RS.StreamExecutor if mod else StreamExecutor)(
            lambda idx, processed=processed: processed.append(int(idx[0])),
            batch=10, policy=policy)
        per_batch = 10 / fps * factor
        stats = ex.run(100, simulate_slow=lambda lo: per_batch)
        runs.append((stats.frames_seen, stats.frames_processed,
                     stats.frames_dropped, processed))
    assert runs[0] == runs[1]
    seen, done, dropped, _ = runs[1]
    assert seen == done + dropped == 100
    assert (dropped > 0) == (factor > 1.0)
    assert StragglerPolicy(fps=50.0).deadline_s(50) == pytest.approx(1.0)


def test_multistream_policy_drops_behind_streams():
    stream_ids = ["a", "b"]
    ctxs = route_streams(stream_ids, 1)
    data = {c.stream_id: _stream_data(2, 64, 1.0) for c in ctxs}
    registry = QueryRegistry()
    registry.register(QUERIES[1])
    ex = MultiStreamExecutor(
        registry, plan_group_engine_factory(_make_fetch(data)),
        HoppingWindow(size=64, advance=64), 8, stream_ids, device=CPU,
        policy=StragglerPolicy(fps=1e9, slack=1.0))
    ex.run(64)
    for sid in stream_ids:
        st = ex.stats[sid]
        assert st.frames_dropped > 0
        assert st.frames_processed + st.frames_dropped == st.frames_seen
        assert 0 < st.drop_rate < 1


def test_load_merged_roundtrip_and_partial_corruption(tmp_path):
    a, b = SlotStats(), SlotStats()
    a.observe(QUERIES[1], 10, 40)
    a.observe_stage_rows("counts", 8, 64)
    b.observe(QUERIES[1], 30, 60)
    b.observe(Q.Count(Q.Op.GE, 5), 1, 50)
    pa, pb = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    a.save(pa)
    b.save(pb)
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        f.write("{not json")
    with pytest.warns(UserWarning, match="bad.json"):
        merged = SlotStats.load_merged([pa, bad, pb])
    assert merged.seen(QUERIES[1]) == 100.0
    assert merged.pass_rate(QUERIES[1]) == pytest.approx((40 + 1) / (100 + 2))
    assert merged.seen(Q.Count(Q.Op.GE, 5)) == 50.0
    assert merged.stage_row_frac("counts") == a.stage_row_frac("counts")
    with pytest.warns(UserWarning):
        cold = SlotStats.load_merged([bad, str(tmp_path / "missing.json")])
    assert len(cold) == 0


def test_registry_gossip_warm_start(tmp_path):
    peers = []
    for i in range(2):
        st = SlotStats()
        st.observe(QUERIES[1], 5 + 10 * i, 50)
        p = str(tmp_path / f"peer{i}.json")
        st.save(p)
        peers.append(p)
    reg = QueryRegistry(gossip_paths=peers)
    assert reg.slot_stats.seen(QUERIES[1]) == 100.0
    own = SlotStats()
    own.observe(Q.Count(Q.Op.GE, 5), 1, 10)
    own_p = str(tmp_path / "own.json")
    own.save(own_p)
    reg2 = QueryRegistry(stats_path=own_p, gossip_paths=peers)
    assert reg2.slot_stats.seen(QUERIES[1]) == 100.0
    assert reg2.slot_stats.seen(Q.Count(Q.Op.GE, 5)) == 10.0
    # the reference registry reads the same peer files to the same store
    r_reg = RS.QueryRegistry(gossip_paths=peers)
    assert r_reg.slot_stats.seen(REF_QUERIES[1]) == 100.0


def test_gossip_warm_start_changes_stage_order(tmp_path):
    peer = SlotStats()
    peer.observe(Q.Spatial(0, Q.Rel.LEFT, 1), 990, 1000)
    peer.observe(Q.Region(2, (0, 0, 4, 4), 1), 5, 1000)
    p = str(tmp_path / "peer.json")
    peer.save(p)
    ctxs = route_streams(["cam0", "cam1"], 1)
    data = {c.stream_id: _stream_data(3, 32, 1.0) for c in ctxs}
    cold = ShardedPlanGroupEngine(QUERIES, ctxs, _make_fetch(data),
                                  slot_stats=SlotStats(), device=CPU)
    warm = ShardedPlanGroupEngine(QUERIES, ctxs, _make_fetch(data),
                                  slot_stats=SlotStats.load_merged([p]),
                                  device=CPU)
    assert cold.stage_order() != warm.stage_order()
    r_cold = RM.ShardedPlanGroupEngine(REF_QUERIES, ctxs, None,
                                       slot_stats=RSlotStats())
    r_warm = RM.ShardedPlanGroupEngine(
        REF_QUERIES, ctxs, None, slot_stats=RSlotStats.load_merged([p]))
    assert cold.stage_order() == r_cold.stage_order()
    assert warm.stage_order() == r_warm.stage_order()


# ---------------------------------------------------------------------------
# Fleet-wide temporal short-circuiting == serial, with mid-window churn
# ---------------------------------------------------------------------------

REF_TQUERIES = (
    RQ.Duration(RQ.ClassCount(0, RQ.Op.GE, 1), 3),
    RQ.Or((RQ.SlidingCount(RQ.ClassCount(1, RQ.Op.GE, 1), 5, RQ.Op.GE, 2),
           RQ.Not(RQ.Count(RQ.Op.GE, 9)))),
    # completes no earlier than relative frame 29 of a 32-frame window,
    # so every stream stays undecided through the churn chunks and the
    # all-decided skip never swallows a fetch-side trigger
    RQ.SlidingCount(RQ.Count(RQ.Op.GE, 1), 30, RQ.Op.GE, 8),
)
REF_TNEW = RQ.Sequence(RQ.ClassCount(0, RQ.Op.GE, 1),
                       RQ.ClassCount(2, RQ.Op.GE, 1), 4)
TQUERIES = tuple(to_port(q) for q in REF_TQUERIES)
TNEW = to_port(REF_TNEW)


class _SerialTemporalEngine:
    """Masks-as-answers serial reference: the fleet temporal path has no
    oracle tier, so the per-stream reference evaluates the deduped frame
    signals with the exhaustive plan and advances a numpy-backend
    ``TemporalProgram`` — suppressed columns zeroed as the fleet does."""

    def __init__(self, queries, data):
        self.prog = TemporalProgram(tuple(queries), backend="numpy")
        self.masks = QueryPlan(tuple(self.prog.frame_queries)).evaluate(
            _port_outs(*data)).numpy()

    def on_window_start(self, lo, hi):
        self.prog.start_window(hi - lo)

    def __call__(self, idx):
        sup = self.prog.suppressed_signals()
        return self.prog.advance(self.masks[np.asarray(idx)]
                                 & ~sup[None, :])


def _recording(factory, registry, log):
    """Wrap a fleet engine factory so every chunk's (S, B, N) answers are
    logged as (chunk start, the engine's query ids, answers); the
    wrapper keeps the factory's signature, so the executor's opt-in by
    parameter name is unchanged."""
    @functools.wraps(factory)
    def build(queries, streams, **stores):
        eng = factory(queries, streams, **stores)
        qids = tuple(qid for qid, _ in registry.active())
        run = eng.run_chunk

        def run_chunk(idx, *args, **kw):
            ans = run(idx, *args, **kw)
            log.append((int(np.asarray(idx)[0]), qids, np.asarray(ans)))
            return ans

        eng.run_chunk = run_chunk
        return eng
    return build


def _per_frame(log, pos=None):
    """{(chunk start, qid): (B,) answers} of a chunk log; ``pos`` picks
    one stream of a fleet log."""
    frames = {}
    for lo, qids, ans in log:
        a = ans if pos is None else ans[pos]
        for j, qid in enumerate(qids):
            frames[(lo, qid)] = a[:, j]
    return frames


def test_fleet_temporal_equals_serial_and_reference_with_midwindow_churn():
    """Fleet-temporal answers == serial per-stream runs == the JAX
    package's fleet, frame by frame and in every window's hit counts,
    with a query REGISTERED mid-window 2 and one RETIRED mid-window 3
    (the serial trigger fires one chunk before the fleet's fetch-side
    one, because the fleet stages chunk t+1 during chunk t; both rebuild
    at the same chunk boundary)."""
    S, n_frames, batch = 4, 96, 8
    window = HoppingWindow(size=32, advance=32)
    stream_ids = [f"tcam{i}" for i in range(S)]
    ctxs = route_streams(stream_ids, 1)
    data = {c.stream_id: _stream_data(c.seed % 2**32, n_frames,
                                      0.8 + 0.4 * c.position)
            for c in ctxs}

    serial, serial_log = {}, {}
    for sid in stream_ids:
        registry = QueryRegistry()
        qids = [registry.register(q) for q in TQUERIES]
        fired = set()
        log = serial_log[sid] = []

        class _Engine(_SerialTemporalEngine):
            def __init__(self, queries, data, registry=registry, log=log):
                super().__init__(queries, data)
                self.qids = tuple(qid for qid, _ in registry.active())
                self.log = log

            def __call__(self, idx, registry=registry, qids=qids,
                         fired=fired):
                t0 = int(np.asarray(idx)[0])
                if t0 == 40 and "reg" not in fired:
                    fired.add("reg")
                    qids.append(registry.register(TNEW))
                if t0 == 72 and "ret" not in fired:
                    fired.add("ret")
                    registry.retire(qids[1])
                ans = super().__call__(idx)
                self.log.append((t0, self.qids, ans))
                return ans

        serial[sid] = MultiQueryStreamExecutor(
            registry, lambda queries, sid=sid, cls=_Engine:
            cls(queries, data[sid]), window, batch, device=CPU
        ).run(n_frames)

    def fleet(mod, queries, new, fetch_of, log, **kw):
        registry = mod.QueryRegistry()
        qids = [registry.register(q) for q in queries]
        fired = set()
        base = fetch_of(data)

        def fetch(ctx, idx):
            t0 = int(np.asarray(idx)[0])
            if t0 == 48 and "reg" not in fired:      # staged during 40
                fired.add("reg")
                qids.append(registry.register(new))
            if t0 == 80 and "ret" not in fired:      # staged during 72
                fired.add("ret")
                registry.retire(qids[1])
            return base(ctx, idx)

        ex = (MultiStreamExecutor if mod is not RS else
              RM.MultiStreamExecutor)(
            registry, _recording((plan_group_engine_factory if mod is not RS
                                  else RM.plan_group_engine_factory)(fetch),
                                 registry, log),
            mod.HoppingWindow(size=32, advance=32), batch, stream_ids, **kw)
        res = ex.run(n_frames)
        assert fired == {"reg", "ret"} and ex.rebuilds >= 3
        assert ex._engine is not None and ex._engine.temporal is not None
        return res

    import repro_torch.core.streaming as TSmod
    log, r_log = [], []
    results = fleet(TSmod, TQUERIES, TNEW, _make_fetch, log, device=CPU)
    r_results = fleet(RS, REF_TQUERIES, REF_TNEW, _ref_fetch, r_log)
    assert len(log) == len(r_log) == n_frames // batch
    for c in ctxs:
        sid = c.stream_id
        for w, res in enumerate(results):
            assert res.span == serial[sid][w].span
            assert res.hits[sid] == serial[sid][w].hits, \
                f"stream {sid} window {w}"
            assert res.hits[sid] == r_results[w].hits[sid]
        want = _per_frame(serial_log[sid])
        got = _per_frame(log, c.position)
        ref = _per_frame(r_log, c.position)
        assert got.keys() == want.keys() == ref.keys()
        assert len(want) > len(TQUERIES) * n_frames // batch
        for key in want:
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=f"{sid} {key}")
            np.testing.assert_array_equal(got[key], ref[key],
                                          err_msg=f"{sid} {key}")


def test_group_engine_temporal_skip_and_stats():
    """Queries that latch on frame 0 window-decide every stream after
    chunk 0: later chunks skip fetch, stacking and the plan outright,
    with the answers the latched constants and the stats the
    reference's."""
    S, B, W = 3, 8, 32
    ctxs = route_streams([f"s{i}" for i in range(S)], 1)
    data = {c.stream_id: _stream_data(5 + c.position, W, 1.0)
            for c in ctxs}
    queries = (RQ.SlidingCount(RQ.Count(RQ.Op.GE, 0), 1, RQ.Op.GE, 0),
               RQ.Duration(RQ.Not(RQ.Count(RQ.Op.GE, 10 ** 6)), 1))
    engines = {}
    for name, cls, qs, fetch_of, kw in (
            ("port", ShardedPlanGroupEngine, [to_port(q) for q in queries],
             _make_fetch, dict(slot_stats=SlotStats(), device=CPU)),
            ("ref", RM.ShardedPlanGroupEngine, queries, _ref_fetch,
             dict(slot_stats=RSlotStats()))):
        calls = []
        base = fetch_of(data)

        def fetch(ctx, idx, calls=calls, base=base):
            calls.append(int(idx[0]))
            return base(ctx, idx)

        eng = cls(qs, ctxs, fetch, **kw)
        assert eng.temporal is not None
        eng.on_window_start(0, W)
        ans = np.concatenate([np.asarray(eng.run_chunk(
            np.arange(b0, b0 + B))) for b0 in range(0, W, B)], axis=1)
        assert ans.all()
        assert calls == [0] * S              # chunks 1..3 skipped
        engines[name] = eng.temporal_stats
    p, r = engines["port"], engines["ref"]
    assert p.frames_in == S * W and p.frames_skipped == S * (W - B)
    assert p.windows == 1 and p.cost_saved_model > 0
    for field in ("frames_in", "frames_skipped", "signal_evals_skipped",
                  "windows"):
        assert getattr(p, field) == getattr(r, field), field
    for field in ("cost_saved_model", "cost_temporal_model"):
        assert getattr(p, field) == pytest.approx(getattr(r, field))


def test_fleet_engine_epoch_rebuild_reuses_temporal_steps():
    """An engine rebuilt over an unchanged temporal query set (the
    registry-epoch path) re-hits both the group plan steps and the
    group temporal step."""
    from repro_torch.core.costmodel import static_cost_model
    from repro_torch.core.plan import CanonicalLeafTable
    from repro_torch.core.stepcache import StepCache
    S, B = 2, 8
    rng = np.random.default_rng(17)
    ctxs = route_streams([f"cam{i}" for i in range(S)], 1)
    data = {c.stream_id: rng.poisson(1.0, (32, C)).astype(np.float32)
            for c in ctxs}

    def fetch(ctx, idx):
        return FilterOutputs(counts=torch.as_tensor(data[ctx.stream_id][idx]))

    table, cache = CanonicalLeafTable(), StepCache()
    qs = (Q.Duration(Q.ClassCount(0, Q.Op.GE, 1), 3),
          Q.Sequence(Q.ClassCount(0, Q.Op.GE, 1),
                     Q.ClassCount(1, Q.Op.GE, 1), 4),
          Q.SlidingCount(Q.ClassCount(1, Q.Op.GE, 1), 5, Q.Op.GE, 2))

    def build():
        return ShardedPlanGroupEngine(qs, ctxs, fetch,
                                      slot_stats=SlotStats(),
                                      cost_model=static_cost_model(),
                                      leaf_table=table, step_cache=cache,
                                      device=CPU)

    answers = []
    for rebuild in range(2):
        eng = build()
        eng.on_window_start(0, 2 * B)
        answers.append(np.concatenate(
            [eng.run_chunk(np.arange(b0, b0 + B)) for b0 in (0, B)], 1))
        traces = sum(p.scan_traces for p in eng.temporal)
        assert (traces > 0) == (rebuild == 0)
        assert (eng.staged._trace_count > 0) == (rebuild == 0)
    np.testing.assert_array_equal(*answers)
