"""The port's streaming additions on the CPU: per-stream seeds and the
frame sampler (equal to the JAX package's draws), the registry's shared
drift monitor and budget ledger, window-boundary auto-recalibration with
a stub re-measure, and one ledger charged by both halves of the engine
(a ``MultiQueryStreamExecutor`` and an ``AggregateStreamSession`` on one
``QueryRegistry``)."""
import time

import numpy as np
import pytest
import torch

from repro.core import streaming as RS
from repro_torch.core import cascade as CS
from repro_torch.core import costmodel as CM
from repro_torch.core import query as Q
from repro_torch.core import streaming as TS
from repro_torch.core.aggregates import BudgetLedger
from repro_torch.core.contracts import AggregateQuery
from repro_torch.core.filters import FilterOutputs

C, GRID = 3, 8


def rand_outputs(rng, B):
    return FilterOutputs(
        counts=torch.as_tensor(rng.normal(2, 2, (B, C)).astype(np.float32)),
        grid=torch.as_tensor(rng.normal(0, 0.5, (B, GRID, GRID, C))
                             .astype(np.float32)))


def measured_model():
    return CM.CostModel(
        source="measured", backend="torch-cpu",
        coeffs={k: CM.StageCoeff(per_row=1.0, overhead=1.0)
                for k in CM.STAGE_COEFF_KEYS},
        step_overhead_cost=2.0, fingerprint=CM.fingerprint_backend("cpu"),
        calibrated_at=time.time())


@pytest.mark.parametrize("base", [0, 7, 2 ** 40])
def test_stream_seed_and_sampler_equal_reference(base):
    for sid in (None, 0, 3, "cam-17"):
        if sid is not None:
            assert TS.stream_seed(base, sid) == RS.stream_seed(base, sid)
        t = TS.FrameSampler(seed=base, stream_id=sid)
        r = RS.FrameSampler(seed=base, stream_id=sid)
        for lo, hi, n in [(0, 100, 10), (50, 60, 20), (5, 5, 3), (9, 4, 2),
                          (0, 1000, 64)]:
            np.testing.assert_array_equal(t.sample(lo, hi, n),
                                          r.sample(lo, hi, n))
    assert TS.FrameSampler(base, 0).sample(0, 10, 0).size == 0


def test_registry_owns_ledger_and_monitor():
    reg = TS.QueryRegistry()
    assert isinstance(reg.budget_ledger, BudgetLedger)
    assert reg.calibration_monitor is None
    led, mon = BudgetLedger(), CM.CalibrationMonitor(measured_model())
    reg = TS.QueryRegistry(budget_ledger=led, calibration_monitor=mon)
    assert reg.budget_ledger is led and reg.calibration_monitor is mon


def _drifted_monitor():
    # a threshold no real jitter reaches, so only this synthetic drift
    # fires (a reset monitor must not re-fire on wall-clock noise)
    mon = CM.CalibrationMonitor(measured_model(), rel_threshold=1e8,
                                min_weight=2.0)
    for _ in range(8):
        mon.observe(1.0, 1e10)
    assert mon.should_recalibrate()
    return mon


def _factory(rng, built, monitor_model=True):
    def factory(queries, slot_stats=None, calibration_monitor=None):
        built.append(calibration_monitor)
        kw = (dict(cost_model=calibration_monitor.model,
                   calibration_monitor=calibration_monitor)
              if monitor_model else {})
        mqc = CS.MultiQueryCascade(queries, adaptive=True,
                                   slot_stats=slot_stats, **kw)
        return lambda idx: mqc.masks(rand_outputs(rng, len(idx))).numpy()
    return factory


def test_auto_recalibrate_with_stub_re_measure(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)   # the executor saves the fresh model
    rng = np.random.default_rng(33)
    mon = _drifted_monitor()
    fresh = measured_model()
    calls = []

    def stub():
        calls.append(1)
        return fresh

    reg = TS.QueryRegistry(calibration_monitor=mon)
    reg.register(Q.Count(Q.Op.GE, 2))
    built = []
    ex = TS.MultiQueryStreamExecutor(
        reg, _factory(rng, built), TS.HoppingWindow(size=8, advance=8),
        batch=8, auto_recalibrate=True, recalibrate_fn=stub, device="cpu")
    epoch = reg.epoch
    ex.run(40)
    assert len(calls) == 1                    # fired once, then reset
    assert ex.recalibrations == mon.recalibrations == 1
    assert mon.model is fresh and not mon.should_recalibrate()
    assert mon.generation == 1
    assert built and built[0] is mon          # opt-in by parameter name
    assert reg.epoch == epoch + 1 and ex.rebuilds == 2
    with pytest.raises(ValueError, match="auto_recalibrate"):
        TS.MultiQueryStreamExecutor(TS.QueryRegistry(), _factory(rng, []),
                                    TS.HoppingWindow(size=8, advance=8),
                                    batch=8, auto_recalibrate=True,
                                    device="cpu")


def test_auto_recalibrate_none_and_failing_fns():
    rng = np.random.default_rng(44)
    # a fn that saves to disk and returns nothing: the executor reloads
    # through default_cost_model (static here: the suite pins
    # REPRO_CALIBRATION=off), which clears the flag without looping
    mon = _drifted_monitor()
    reg = TS.QueryRegistry(calibration_monitor=mon)
    reg.register(Q.Count(Q.Op.GE, 2))
    calls = []
    ex = TS.MultiQueryStreamExecutor(
        reg, _factory(rng, [], monitor_model=False),
        TS.HoppingWindow(size=8, advance=8), batch=8, auto_recalibrate=True,
        recalibrate_fn=lambda: calls.append(1), device="cpu")
    ex.run(40)
    assert len(calls) == 1 and mon.model.source == "static"
    assert not mon.should_recalibrate()
    # a failing re-measure warns and keeps the drifted model serving
    mon = _drifted_monitor()
    reg = TS.QueryRegistry(calibration_monitor=mon)
    reg.register(Q.Count(Q.Op.GE, 2))

    def broken():
        raise RuntimeError("no card")

    ex = TS.MultiQueryStreamExecutor(
        reg, _factory(rng, [], monitor_model=False),
        TS.HoppingWindow(size=8, advance=8), batch=8, auto_recalibrate=True,
        recalibrate_fn=broken, device="cpu")
    with pytest.warns(UserWarning, match="auto-recalibration failed"):
        ex.run(16)
    assert ex.recalibrations == 0 and mon.should_recalibrate()


def test_auto_recalibrate_persists_monitor_counters(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)   # the default calibration dir is relative
    rng = np.random.default_rng(45)
    mon = _drifted_monitor()
    fresh = measured_model()
    reg = TS.QueryRegistry(calibration_monitor=mon)
    reg.register(Q.Count(Q.Op.GE, 2))
    ex = TS.MultiQueryStreamExecutor(
        reg, _factory(rng, [], monitor_model=False),
        TS.HoppingWindow(size=8, advance=8), batch=8, auto_recalibrate=True,
        recalibrate_fn=lambda: fresh, device="cpu")
    ex.run(24)
    assert ex.recalibrations == 1
    path = CM.calibration_path(fresh.backend)
    assert path.endswith("torch-cpu.json")
    restored = CM.CalibrationMonitor.restore(
        CM.load_calibration(path, device="cpu"),
        CM.load_monitor_state(path))
    assert restored.recalibrations == 1
    assert restored.generation == mon.generation


def _scene(n, seed=21):
    rng = np.random.default_rng(seed)
    has = rng.random(n) < 0.3
    objs = [[(0, 2, 2), (1, 2, 5)] if h else [(1, 4, 4)] for h in has]
    counts = np.zeros((n, C), np.float32)
    counts[:, 1] = 1.0
    counts[has, 0] = 1.0
    grid = np.full((n, GRID, GRID, C), -10.0, np.float32)
    grid[has, 2, 2, 0] = 10.0
    grid[has, 2, 5, 1] = 10.0
    grid[~has, 4, 4, 1] = 10.0
    return has, objs, counts, grid


def test_filter_and_aggregate_halves_charge_one_ledger():
    n = 256
    has, objs, counts, grid = _scene(n)

    def outputs(idx):
        i = np.asarray(idx)
        return FilterOutputs(counts=torch.as_tensor(counts[i]),
                             grid=torch.as_tensor(grid[i]))

    reg = TS.QueryRegistry()
    reg.register(Q.And((Q.ClassCount(0, Q.Op.GE, 1),
                        Q.Spatial(0, Q.Rel.LEFT, 1))))
    executors = []

    def factory(queries, slot_stats, leaf_table, step_cache, budget_ledger,
                device):
        mqc = CS.MultiQueryCascade(queries, adaptive=True,
                                   slot_stats=slot_stats,
                                   leaf_table=leaf_table,
                                   step_cache=step_cache)
        ex = CS.MultiQueryExecutor(
            mqc, outputs, lambda idx, sel: [objs[idx[j]] for j in sel],
            C, GRID, oracle_bucket=16, budget_ledger=budget_ledger,
            device=device)
        executors.append(ex)
        return lambda idx: ex.run_batch(idx).answers

    stream = TS.MultiQueryStreamExecutor(
        reg, factory, TS.HoppingWindow(size=128, advance=128), 32,
        device="cpu")
    results = stream.run(n)
    assert sum(r.hits[0] for r in results) == int(has.sum())
    led = reg.budget_ledger
    filt = executors[0].stats
    assert led.filter_frames == n == filt.frames_in
    assert led.oracle_calls == filt.oracle_calls > 0
    before = (led.oracle_calls, led.filter_frames)

    q = AggregateQuery(pred=Q.ClassCount(0, Q.Op.GE, 1), agg="count",
                       eps=0.25)
    with TS.AggregateStreamSession(
            reg, q, filter_fn=outputs,
            oracle_fn=lambda idx: [objs[int(i)] for i in idx],
            n_frames=n, n_classes=C, grid=GRID, n_chunks=4, seed=3,
            device="cpu") as sess:
        assert sess.qid in dict(reg.active())
        res = sess.run()
    assert sess.qid not in dict(reg.active())
    assert res.ledger is led
    assert led.oracle_calls == before[0] + res.oracle_calls
    assert led.filter_frames > before[1]
    assert res.ci[0] - 1e-9 <= float(has.sum()) <= res.ci[1] + 1e-9


def test_session_checks_the_filter_device():
    n = 64
    _, objs, counts, grid = _scene(n)
    reg = TS.QueryRegistry()
    q = AggregateQuery(pred=Q.ClassCount(0, Q.Op.GE, 1), agg="count",
                       eps=0.25)
    sess = TS.AggregateStreamSession(
        reg, q, filter_fn=lambda idx: FilterOutputs(
            counts=torch.as_tensor(counts[np.asarray(idx)]).to("meta")),
        oracle_fn=lambda idx: [objs[int(i)] for i in idx], n_frames=n,
        n_classes=C, grid=GRID, n_chunks=2, device="cpu", cv="eager")
    with sess, pytest.raises(ValueError, match="filter outputs"):
        sess.run()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TS.AggregateStreamSession(
                TS.QueryRegistry(), q, filter_fn=None, oracle_fn=None,
                n_frames=n, n_classes=C, grid=GRID)
