"""Port-internal properties of the serving slice, mirroring the JAX
package's tests/test_query_properties.py and tests/test_plan_lifecycle.py:
strict filters equal the exact semantics on perfect outputs, a plan
built by delta registration equals one built from scratch, rebuilt
plans reuse every step whose signature recurs, and the host-side
helpers (compaction, bucketing, statistics persistence, the registry)
behave as the reference's.
"""
import numpy as np
import pytest
import torch

from repro.core import cascade as RC
from repro_torch.core import cascade as TC
from repro_torch.core import query as Q
from repro_torch.core.filters import FilterOutputs
from repro_torch.core.plan import CanonicalLeafTable, QueryPlan
from repro_torch.core.stats import SlotStats
from repro_torch.core.stepcache import StepCache
from repro_torch.core.streaming import QueryRegistry
from torch_parity import rand_query, to_port

G, C = 6, 3


def _objects(rng):
    cells = {}
    for _ in range(int(rng.integers(0, 9))):
        r, c = int(rng.integers(0, G)), int(rng.integers(0, G))
        cells[(r, c)] = (int(rng.integers(0, C)), r, c)
    return list(cells.values())


def _perfect(objs):
    occ = Q.objects_to_grid(np.asarray(objs, np.int64).reshape(-1, 3), C, G)
    counts = np.zeros((1, C), np.float32)
    for c, _, _ in objs:
        counts[0, c] += 1
    return FilterOutputs(counts=torch.as_tensor(counts),
                         grid=torch.as_tensor(occ[None]).float())


@pytest.mark.parametrize("seed", range(4))
def test_strict_filters_match_exact_semantics(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        q = to_port(rand_query(rng, C, G, relaxed=False))
        objs = _objects(rng)
        fo = _perfect(objs)
        assert bool(Q.eval_filters(q, fo)[0]) == \
            Q.eval_objects(q, objs, C, G), (q, objs)
        assert bool(QueryPlan([q]).evaluate(fo)[0, 0]) == \
            Q.eval_objects(q, objs, C, G)


def _outputs(rng, B=12):
    counts = rng.normal(2, 2, (B, C)).astype(np.float32)
    counts[rng.random(B) < 0.5] = 0.0
    return FilterOutputs(
        counts=torch.as_tensor(counts),
        grid=torch.as_tensor(rng.normal(0, 0.5, (B, G, G, C)).astype(
            np.float32)))


@pytest.mark.parametrize("seed", range(3))
def test_delta_built_plan_identical_to_from_scratch(seed):
    """Register/retire/resurrect/duplicate churn through a shared leaf
    table and step cache: every epoch's masks and staging equal a plan
    built from scratch, and a recurring query set builds no step."""
    rng = np.random.default_rng(seed)
    pool = [to_port(rand_query(rng, C, G)) for _ in range(6)]
    table, cache = CanonicalLeafTable(), StepCache(capacity=256)
    out = _outputs(rng)
    for _ in range(6):
        k = int(rng.integers(1, 5))
        sel = tuple(int(i) for i in rng.integers(0, len(pool), k))
        qs = [pool[i] for i in sel]
        fresh = QueryPlan(qs)
        delta = QueryPlan(qs, leaf_table=table)
        want = fresh.evaluate(out)
        assert torch.equal(delta.evaluate(out), want)
        staged = delta.build_staged(None, step_cache=cache)
        assert torch.equal(staged.evaluate(out), want)
        ref_staged = fresh.build_staged(None)
        assert torch.equal(ref_staged.evaluate(out), want)
        assert staged.last_report.ran == ref_staged.last_report.ran
    # the same query set again: every step signature recurs, none built
    again = QueryPlan(qs, leaf_table=table).build_staged(None,
                                                         step_cache=cache)
    assert torch.equal(again.evaluate(out), want)
    assert again.last_report.steps_compiled == 0


def test_compaction_and_bucketing_match_reference():
    rng = np.random.default_rng(3)
    for _ in range(20):
        mask = rng.random(int(rng.integers(1, 40))) < rng.random()
        for mb in (1, 8):
            a = TC.compact_indices(mask, min_bucket=mb)
            b = RC.compact_indices(mask, min_bucket=mb)
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1] == b[1]
        n, (g,), idx = TC.compact_survivors(torch.as_tensor(mask),
                                            torch.arange(mask.size))
        assert n == mask.sum()
        assert torch.equal(g[:n], torch.as_tensor(np.nonzero(mask)[0]))
        sel = np.nonzero(mask)[0]
        for bucket in (None, 4):
            calls = []
            got = TC.bucketed_oracle(
                lambda b_, i: calls.append(len(i)) or list(i), None, sel,
                bucket)
            assert list(got) == list(sel)
            assert sum(calls) == TC.oracle_frames_evaluated(sel.size,
                                                            bucket) \
                == RC.oracle_frames_evaluated(sel.size, bucket)
    with pytest.raises(ValueError):
        TC.compact_survivors(torch.ones(8, dtype=torch.bool),
                             torch.arange(8), bucket=4)


def test_slot_stats_round_trip(tmp_path):
    st = SlotStats()
    q = Q.Spatial(1, Q.Rel.RIGHT, 0, 1)
    st.observe(q, 3, 10)
    st.observe_stage_rows("spatial", 8, 32)
    st.observe_stage_survival("spatial", 8, 2)
    path = st.save(str(tmp_path / "s.json"))
    back = SlotStats.load(path)
    assert back.pass_rate(Q.Spatial(0, Q.Rel.LEFT, 1, 1)) == st.pass_rate(q)
    assert back.stage_row_frac("spatial") == st.stage_row_frac("spatial")
    reg = QueryRegistry(stats_path=path)
    assert len(reg.slot_stats) == 1


def test_registry_batches_and_rejects_unknown_retire():
    reg = QueryRegistry()
    with reg.batch():
        a = reg.register(Q.Count(Q.Op.GE, 1))
        reg.register(Q.Count(Q.Op.GE, 2))
        reg.retire(a)
    assert reg.epoch == 1 and len(reg) == 1
    with pytest.raises(ValueError):
        reg.retire(a)
