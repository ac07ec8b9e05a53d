"""The port's shared query plan against the JAX package's.

Both plans get the SAME filter-output arrays (a 1e-6 difference near
tau could otherwise flip a threshold), so masks, staged masks and the
StageReport fields must be identical, not close.  A port-internal sweep
pins staged ≡ exhaustive under any stage order, bucket floor and
spatial body.
"""
import numpy as np
import pytest
import torch

from repro.core import cascade as RC
from repro.core import query as RQ
from repro.core.plan import QueryPlan as RPlan
from repro.core.stats import SlotStats as RStats
from repro_torch.core import cascade as TC
from repro_torch.core import query as TQ
from repro_torch.core.plan import QueryPlan as TPlan
from repro_torch.core.stats import SlotStats as TStats
from torch_parity import (outputs_pair, rand_query, report_fields,
                          to_port)

G, C, B = 8, 3, 16


def _outputs(rng, B=B, sparse=False):
    counts = rng.normal(2, 2, (B, C)).astype(np.float32)
    if sparse:     # skewed traffic: most frames empty -> row compaction
        counts[rng.random(B) < 0.7] = 0.0
    grid = rng.normal(0, 0.5, (B, G, G, C)).astype(np.float32)
    return counts, grid


def _queries(seed, n=6):
    rng = np.random.default_rng(1000 + seed)
    rq = [rand_query(rng, C, G) for _ in range(n)]
    return rq, [to_port(q) for q in rq]


@pytest.mark.parametrize("seed", range(3))
def test_query_plan_masks_identical(seed):
    rq, tq = _queries(seed, n=4)
    rng = np.random.default_rng(seed)
    ro, to = outputs_pair(*_outputs(rng))
    rp, tp = RPlan(rq), TPlan(tq)
    assert rp.plan_sig == tp.plan_sig
    np.testing.assert_array_equal(tp.evaluate(to).numpy(),
                                  np.asarray(rp.evaluate(ro)))
    m, counts = tp.evaluate_with_counts(to)
    rm, rcounts = rp.evaluate_with_counts(ro)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rcounts))
    # and each query alone through eval_filters
    for q_r, q_t, col in zip(rq, tq, m.T):
        np.testing.assert_array_equal(TQ.eval_filters(q_t, to).numpy(),
                                      np.asarray(RQ.eval_filters(q_r, ro)))
        np.testing.assert_array_equal(col.numpy(),
                                      np.asarray(RQ.eval_filters(q_r, ro)))


@pytest.mark.parametrize("seed", range(3))
def test_staged_plan_masks_and_reports_identical(seed):
    """Several batches with stats feedback and restaging: masks and every
    StageReport field equal the reference's, batch by batch."""
    rq, tq = _queries(seed, n=5)
    rstats, tstats = RStats(), TStats()
    rs = RPlan(rq).build_staged(rstats, min_bucket=2)
    ts = TPlan(tq).build_staged(tstats, min_bucket=2)
    rng = np.random.default_rng(50 + seed)
    for b in range(3):
        ro, to = outputs_pair(*_outputs(rng, sparse=b % 2 == 1))
        np.testing.assert_array_equal(ts.evaluate(to).numpy(),
                                      np.asarray(rs.evaluate(ro)))
        assert report_fields(ts.last_report) == \
            report_fields(rs.last_report)
        rs.flush_stats(rstats)
        ts.flush_stats(tstats)
        assert rs.restage(rstats) == ts.restage(tstats)
        assert ts.order == rs.order
        assert ts.predicted_batch_cost(tstats) == \
            rs.predicted_batch_cost(rstats)
        assert ts.describe() == rs.describe()


def test_staged_reports_rows_body_on_skewed_traffic():
    """A count-guarded spatial query on traffic where the count tier
    decides most rows: the compacted spatial stage runs the row body in
    both packages, with the same row counts."""
    rq = [RQ.And((RQ.ClassCount(2, RQ.Op.GE, 1),
                  RQ.Spatial(2, RQ.Rel.LEFT, 0))),
          RQ.ClassCount(0, RQ.Op.GE, 1)]
    tq = [to_port(q) for q in rq]
    rng = np.random.default_rng(9)
    counts, grid = _outputs(rng)
    counts[:, 2] = 0.0
    counts[[3, 11], 2] = 2.0
    ro, to = outputs_pair(counts, grid)
    rs = RPlan(rq).build_staged(None)
    ts = TPlan(tq).build_staged(None)
    np.testing.assert_array_equal(ts.evaluate(to).numpy(),
                                  np.asarray(rs.evaluate(ro)))
    assert "rows" in ts.last_report.bodies
    assert report_fields(ts.last_report) == report_fields(rs.last_report)


# (a, b) class pairs of two Spatial leaves over a C = 5 grid: the stage
# reads 2-4 of the 5 planes, listed unsorted
SLICED_PAIRS = [((4, 1), (1, 4)), ((3, 0), (2, 3)), ((2, 2), (0, 4))]


@pytest.mark.parametrize("body", ["rows", "full", "auto"])
@pytest.mark.parametrize("pairs", SLICED_PAIRS, ids=str)
def test_staged_spatial_tier_passes_classes_identical(pairs, body,
                                                      monkeypatch):
    """A spatial tier that reads fewer planes than the grid holds hands
    the full grid and the class list to the stats kernel (no gather);
    its staged masks equal the exhaustive plan's and the JAX package's
    bit for bit, under count-guard compaction too."""
    C5 = 5
    rq = [RQ.And((RQ.ClassCount(a, RQ.Op.GE, 1),
                  RQ.Spatial(a, RQ.Rel.LEFT, b, radius=1)))
          for a, b in pairs] + [RQ.Spatial(pairs[0][1], RQ.Rel.ABOVE,
                                           pairs[0][0])]
    tq = [to_port(q) for q in rq]
    rng = np.random.default_rng(sum(sum(p) for p in pairs))
    counts = rng.normal(1, 1.5, (B, C5)).astype(np.float32)
    counts[rng.random(B) < 0.6] = 0.0            # compaction
    grid = rng.normal(0, 0.5, (B, G, G, C5)).astype(np.float32)
    ro, to = outputs_pair(counts, grid)
    calls = []
    from repro_torch.kernels import ops as kops
    for name in ("spatial_stats_inline", "spatial_stats_rows_inline"):
        real = getattr(kops, name)

        def spy(grid_logits, *args, _real=real, **kw):
            calls.append((grid_logits.shape[-1], kw.get("classes")))
            return _real(grid_logits, *args, **kw)

        monkeypatch.setattr(kops, name, spy)
    want = TPlan(tq).evaluate(to)
    np.testing.assert_array_equal(want.numpy(),
                                  np.asarray(RPlan(rq).evaluate(ro)))
    rs = RPlan(rq).build_staged(None, min_bucket=2)
    for mb in (1, 2, B):
        staged = TPlan(tq).build_staged(None, min_bucket=mb,
                                        spatial_body=body)
        got = staged.evaluate(to)
        assert torch.equal(got, want)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(rs.evaluate(ro)))
    n_read = len({c for p in pairs for c in p} | set(pairs[0]))
    sliced = [(c, cls) for c, cls in calls if cls is not None]
    assert sliced and all(c == C5 and len(cls) == n_read
                          for c, cls in sliced)


@pytest.mark.parametrize("seed", range(6))
def test_port_staged_identical_to_exhaustive(seed):
    """Port-internal: every stage order, bucket floor, spatial body and
    statistics state gives the exhaustive masks bit for bit."""
    rng = np.random.default_rng(seed)
    _, tq = _queries(seed, n=int(rng.integers(2, 8)))
    plan = TPlan(tq)
    _, to = outputs_pair(*_outputs(rng, sparse=seed % 2 == 0))
    want = plan.evaluate(to)
    n_st = len(plan.stage_descriptors())
    stats = TStats()
    for _ in range(3):
        order = list(rng.permutation(n_st))
        for body in ("auto", "rows", "full"):
            for mb in (1, 4, B):
                staged = plan.build_staged(stats, order=order,
                                           min_bucket=mb, spatial_body=body)
                assert torch.equal(staged.evaluate(to), want)
                staged.flush_stats(stats)
    # presumed-decided columns: the others keep their exact answers
    presumed = rng.random(len(tq)) < 0.5
    got = plan.build_staged(stats).evaluate(to, presumed_decided=presumed)
    assert torch.equal(got[:, ~presumed], want[:, ~presumed])


def test_propagate_bounds_identical():
    rq, tq = _queries(3, n=5)
    rp, tp = RPlan(rq), TPlan(tq)
    rng = np.random.default_rng(4)
    leaf = rng.random((B, rp.n_slot_cols)) < 0.5
    known = rng.random(rp.n_slot_cols) < 0.6
    import jax.numpy as jnp
    rv, rd = rp.propagate_bounds(jnp.asarray(leaf), jnp.asarray(known))
    tv, td = tp.propagate_bounds(torch.as_tensor(leaf), known)
    np.testing.assert_array_equal(td.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(tv.numpy()[td.numpy()],
                                  np.asarray(rv)[np.asarray(rd)])


def test_adaptive_cascade_modes_and_masks_identical():
    """MultiQueryCascade(adaptive=True) with a short restage period: the
    park/un-park decisions, restage counts and masks match."""
    rq, tq = _queries(7, n=6)
    rc = RC.MultiQueryCascade(rq, adaptive=True, restage_every=2)
    tc = TC.MultiQueryCascade(tq, adaptive=True, restage_every=2)
    rng = np.random.default_rng(70)
    for b in range(6):
        ro, to = outputs_pair(*_outputs(rng, sparse=b >= 3))
        np.testing.assert_array_equal(tc.masks(to).numpy(),
                                      np.asarray(rc.masks(ro)))
        assert tc.mode == rc.mode and tc.restages == rc.restages


def test_leaf_table_churn_identical():
    """Register/retire churn through a shared leaf table and step cache:
    slot layouts, plan signatures and step reuse match."""
    from repro.core.plan import CanonicalLeafTable as RT
    from repro.core.stepcache import StepCache as RSC
    from repro_torch.core.plan import CanonicalLeafTable as TT
    from repro_torch.core.stepcache import StepCache as TSC
    rq, tq = _queries(11, n=8)
    rt, tt, rsc, tsc = RT(), TT(), RSC(), TSC()
    rng = np.random.default_rng(12)
    ro, to = outputs_pair(*_outputs(rng))
    for sel in ([0, 1, 2], [1, 2, 3, 4], [0, 1, 2], [5, 6, 7, 0]):
        rp = RPlan([rq[i] for i in sel], leaf_table=rt)
        tp = TPlan([tq[i] for i in sel], leaf_table=tt)
        assert rp.plan_sig == tp.plan_sig
        assert rt.snapshot() == tt.snapshot()
        rs = rp.build_staged(None, step_cache=rsc)
        ts = tp.build_staged(None, step_cache=tsc)
        np.testing.assert_array_equal(ts.evaluate(to).numpy(),
                                      np.asarray(rs.evaluate(ro)))
        assert report_fields(ts.last_report) == report_fields(rs.last_report)
    assert (tsc.hits, tsc.misses) == (rsc.hits, rsc.misses)


def test_region_rect_past_grid_edge_identical():
    """A rectangle reaching past the grid reads the edge, as the JAX
    package's clamping gather does (and as the exact semantics say)."""
    rq = [RQ.Region(1, (2, 0, 3 * G, G + 5), 2),
          RQ.Or((RQ.Region(0, (0, 0, 100, 100), 3, radius=1),
                 RQ.Count(RQ.Op.EQ, 4)))]
    tq = [to_port(q) for q in rq]
    rng = np.random.default_rng(21)
    ro, to = outputs_pair(*_outputs(rng))
    want = np.asarray(RPlan(rq).evaluate(ro))
    np.testing.assert_array_equal(TPlan(tq).evaluate(to).numpy(), want)
    np.testing.assert_array_equal(
        TPlan(tq).build_staged(None).evaluate(to).numpy(), want)
    for q_r, q_t in zip(rq, tq):
        np.testing.assert_array_equal(TQ.eval_filters(q_t, to).numpy(),
                                      np.asarray(RQ.eval_filters(q_r, ro)))
