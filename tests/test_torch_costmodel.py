"""The port's measured cost model (``repro_torch.core.costmodel``) and its
consumers on the CPU, against the JAX package's where both can run.

- Persistence: a save / load round trip; every untrustworthy file (a
  foreign fingerprint, a JAX-package calibration, a stale, corrupt or
  wrong-schema file, missing or negative coefficients) degrades to the
  static model; the backend keys of the two packages never collide.
- ``calibrate(device="cpu")`` at a tiny size fits finite, non-negative
  coefficients from the port's own stage bodies; ``calibrate_oracle``
  adds the oracle's price.
- ``CalibrationMonitor``: drift, decay, staleness, the latch, and
  ``state_dict`` / ``restore`` equal the reference's on the same
  observation sequence (``==``: the same float arithmetic).
- The adaptive cascade feeds the monitor and latches
  ``recalibration_due`` as the reference's does.
"""
import json
import time

import numpy as np
import pytest
import torch

from repro.core import costmodel as RCM
from repro_torch.core import cascade as CS
from repro_torch.core import costmodel as CM
from repro_torch.core import query as Q
from repro_torch.core.filters import FilterOutputs

C, GRID = 3, 8


def rand_outputs(rng, B):
    return FilterOutputs(
        counts=torch.as_tensor(rng.normal(2, 2, (B, C)).astype(np.float32)),
        grid=torch.as_tensor(rng.normal(0, 0.5, (B, GRID, GRID, C))
                             .astype(np.float32)))


def measured_model(mod, per_row=1.0, overhead=10.0, step=5.0,
                   calibrated_at=None):
    return mod.CostModel(
        source="measured", backend="testbox",
        coeffs={k: mod.StageCoeff(per_row=per_row, overhead=overhead)
                for k in mod.STAGE_COEFF_KEYS},
        step_overhead_cost=step, calibrated_at=calibrated_at)


def _valid_payload() -> dict:
    return {
        "version": CM.CALIBRATION_VERSION,
        "backend": "torch-cpu",
        "fingerprint": CM.fingerprint_backend("cpu"),
        "calibrated_at": time.time(),
        "step_overhead_us": 50.0,
        "coeffs": {k: {"per_row": 1.0, "overhead": 10.0}
                   for k in CM.STAGE_COEFF_KEYS},
    }


# ---------------------------------------------------------------------------
# persistence and identity
# ---------------------------------------------------------------------------

def test_backend_keys_and_fingerprint():
    assert CM.backend_key("cpu") == "torch-cpu"
    assert CM.backend_key("cuda") == "torch-cuda"
    assert CM.calibration_path(device="cpu").endswith("torch-cpu.json")
    assert CM.calibration_path("x", "d") == "d/x.json"
    fp = CM.fingerprint_backend("cpu")
    assert fp["platform"] == "cpu" and fp["torch"] == torch.__version__
    assert {"host_arch", "cpu_count", "device_kind"} <= set(fp)
    assert not any("jax" in k for k in fp)
    # never the JAX package's key for the same device
    assert CM.calibration_path(device="cpu") != RCM.calibration_path("cpu")


def test_save_load_round_trip(tmp_path):
    model = CM.CostModel(
        source="measured", backend="torch-cpu",
        coeffs={**{k: CM.StageCoeff(per_row=0.5 + i, overhead=3.0 * i)
                   for i, k in enumerate(CM.STAGE_COEFF_KEYS)},
                "oracle": CM.StageCoeff(per_row=40.0, overhead=2.0)},
        step_overhead_cost=17.5, fingerprint=CM.fingerprint_backend("cpu"),
        calibrated_at=time.time(), samples={"count": [[4, 1.5]]})
    p = str(tmp_path / "cal.json")
    assert CM.save_calibration(model, p) == p
    got = CM.load_calibration(p, device="cpu")
    assert got is not None and got.source == "measured"
    assert got.coeffs == model.coeffs
    assert got.step_overhead() == 17.5
    assert got.calibrated_at == model.calibrated_at
    assert got.samples == model.samples
    assert got.oracle_cost(4) == pytest.approx(162.0)
    assert CM.default_cost_model(p, device="cpu").source == "measured"
    with pytest.raises(ValueError, match="measured"):
        CM.save_calibration(CM.static_cost_model(), p)


@pytest.mark.parametrize("mutate,desc", [
    (None, "missing file"),
    (lambda d: "{ this is not json", "corrupt json"),
    (lambda d: json.dumps([1, 2, 3]), "wrong shape"),
    (lambda d: json.dumps({**d, "version": 999}), "wrong schema version"),
    (lambda d: json.dumps({**d, "coeffs": {}}), "missing coeffs"),
    (lambda d: json.dumps({**d, "coeffs": {
        **d["coeffs"], "spatial": {"per_row": -1.0}}}), "negative coeff"),
    (lambda d: json.dumps({**d, "step_overhead_us": "fast"}),
     "non-numeric step overhead"),
    (lambda d: json.dumps({**d, "calibrated_at":
                           time.time() - 365 * 86400}), "stale"),
    (lambda d: json.dumps({**d, "fingerprint": {
        **d["fingerprint"], "cpu_count": "4096"}}), "foreign fingerprint"),
    (lambda d: json.dumps({**d, "fingerprint": {
        **d["fingerprint"], "torch": "0.0.1"}}), "other torch version"),
    (lambda d: json.dumps({**d, "fingerprint":
                           RCM.fingerprint_backend()}), "JAX fingerprint"),
])
def test_load_calibration_rejects_untrustworthy(tmp_path, mutate, desc):
    p = tmp_path / "cal.json"
    if mutate is not None:
        p.write_text(mutate(_valid_payload()))
    assert CM.load_calibration(str(p), device="cpu") is None, desc
    assert CM.default_cost_model(str(p), device="cpu").source == "static"


def test_calibrations_never_cross_packages(tmp_path):
    """A JAX-package calibration does not load into the port, nor the
    port's into the JAX package, even when handed the other's path."""
    rmodel = RCM.CostModel(
        source="measured", backend="cpu",
        coeffs={k: RCM.StageCoeff(per_row=1.0)
                for k in RCM.STAGE_COEFF_KEYS},
        fingerprint=RCM.fingerprint_backend(), calibrated_at=time.time())
    rpath = RCM.save_calibration(rmodel, str(tmp_path / "cpu.json"))
    assert RCM.load_calibration(rpath) is not None
    assert CM.load_calibration(rpath, device="cpu") is None
    tpath = str(tmp_path / "torch-cpu.json")
    tfile = _valid_payload()
    (tmp_path / "torch-cpu.json").write_text(json.dumps(tfile))
    assert CM.load_calibration(tpath, device="cpu") is not None
    assert RCM.load_calibration(tpath) is None


def test_stale_acceptable_when_age_check_disabled(tmp_path):
    d = _valid_payload()
    d["calibrated_at"] = time.time() - 365 * 86400
    p = tmp_path / "cal.json"
    p.write_text(json.dumps(d))
    assert CM.load_calibration(str(p), device="cpu") is None
    assert CM.load_calibration(str(p), max_age_s=None,
                               device="cpu") is not None


def test_env_var_selects_or_disables_loading(tmp_path, monkeypatch):
    p = tmp_path / "cal.json"
    p.write_text(json.dumps(_valid_payload()))
    monkeypatch.setenv("REPRO_CALIBRATION", str(p))
    assert CM.default_cost_model(device="cpu").source == "measured"
    for off in ("off", "0", "none"):
        monkeypatch.setenv("REPRO_CALIBRATION", off)
        assert CM.default_cost_model(device="cpu").source == "static"


def test_static_model_prices_like_reference():
    t, r = CM.static_cost_model(), RCM.static_cost_model()
    assert t.oracle_cost(3.0) == r.oracle_cost(3.0) == 300.0
    assert CM.STATIC_COST_ORACLE == RCM.STATIC_COST_ORACLE
    tm, rm = measured_model(CM), measured_model(RCM)
    assert tm.oracle_cost(1.0) is None and rm.oracle_cost(1.0) is None
    for kind in ("count", "spatial", "region"):
        for rows, batch in ((4, 32), (32, 32)):
            for m_t, m_r in ((t, r), (tm, rm)):
                assert m_t.stage_cost(kind, rows=rows, batch=batch,
                                      radius=1) == \
                    m_r.stage_cost(kind, rows=rows, batch=batch, radius=1)
    td, rd = tm.describe(), rm.describe()
    assert td == rd


# ---------------------------------------------------------------------------
# calibration harness on the CPU
# ---------------------------------------------------------------------------

def test_calibrate_cpu_tiny_fits_finite_coefficients(tmp_path):
    p = str(tmp_path / "cal.json")
    m = CM.calibrate(batch=16, grid=8, classes=3, repeat=1, path=p,
                     device="cpu")
    assert m.source == "measured" and m.backend == "torch-cpu"
    assert m.fingerprint == CM.fingerprint_backend("cpu")
    # every stage body, and the temporal tier's automaton step
    assert set(m.coeffs) == set(CM.STAGE_COEFF_KEYS) | {"temporal"}
    for c in m.coeffs.values():
        assert np.isfinite(c.per_row) and c.per_row > 0
        assert np.isfinite(c.overhead) and c.overhead >= 0
    assert np.isfinite(m.step_overhead()) and m.step_overhead() > 0
    assert all(len(v) == 4 for v in m.samples.values())   # 4 row points
    loaded = CM.load_calibration(p, device="cpu")
    assert loaded is not None and loaded.coeffs == m.coeffs
    with_oracle = CM.calibrate_oracle(
        loaded, lambda idx: np.square(idx), lambda r: np.arange(r),
        repeat=1, device="cpu")
    assert with_oracle.oracle_cost(1.0) > 0
    assert "oracle" not in loaded.coeffs                  # not mutated
    with pytest.raises(ValueError, match="measured"):
        CM.calibrate_oracle(CM.static_cost_model(), len, lambda r: [0] * r,
                            device="cpu")


def test_calibrate_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        CM.calibrate(batch=4, grid=4, classes=2, save=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CM.calibrate_oracle(measured_model(CM), len, lambda r: [0] * r)


# ---------------------------------------------------------------------------
# the drift monitor against the reference's
# ---------------------------------------------------------------------------

OBSERVATIONS = ([(100.0, 400.0)] * 12 + [(400.0, 100.0)] * 3
                + [(0.0, 50.0), (50.0, float("nan")), (-3.0, 50.0)]
                + [(100.0, 101.0)] * 30)


@pytest.mark.parametrize("kw", [dict(), dict(rel_threshold=0.5,
                                             min_weight=1.9, decay=0.5)])
def test_monitor_matches_reference_on_the_same_observations(kw):
    now = time.time()
    mons = [mod.CalibrationMonitor(measured_model(mod, calibrated_at=now),
                                   clock=lambda: now, **kw)
            for mod in (CM, RCM)]
    trace = []
    for pred, obs in OBSERVATIONS:
        for m in mons:
            m.observe(pred, obs)
        trace.append([(m.drift, m.weight, m.should_recalibrate())
                      for m in mons])
    assert all(t[0] == t[1] for t in trace)
    assert any(t[0][2] for t in trace)            # the drift did fire
    assert mons[0].describe() == mons[1].describe()
    assert mons[0].state_dict() == mons[1].state_dict()
    for m in mons:
        m.reset()
    assert [m.generation for m in mons] == [1, 1]
    assert mons[0].state_dict() == mons[1].state_dict()
    for mod in (CM, RCM):
        with pytest.raises(ValueError, match="unreachable"):
            mod.CalibrationMonitor(measured_model(mod), min_weight=4.0,
                                   decay=0.5)


def test_monitor_staleness_and_static_match_reference():
    t0 = time.time()
    now = [t0]
    mons = [mod.CalibrationMonitor(measured_model(mod, calibrated_at=t0),
                                   clock=lambda: now[0])
            for mod in (CM, RCM)]
    assert [m.stale() for m in mons] == [False, False]
    now[0] += CM.DEFAULT_MAX_AGE_S + 1.0
    assert [m.should_recalibrate() for m in mons] == [True, True]
    smon = CM.CalibrationMonitor(CM.static_cost_model())
    smon.observe(100.0, 1e9)
    assert not smon.active and smon.drift == 0.0
    assert not smon.should_recalibrate()


@pytest.mark.parametrize("mutate,desc", [
    (lambda s: s, "valid"),
    (lambda s: {**s, "err_acc": float("nan")}, "nan accumulator"),
    (lambda s: {**s, "err_acc": -1.0}, "negative accumulator"),
    (lambda s: {**s, "weight": 1e9}, "weight impossible under decay"),
    (lambda s: {**s, "generation": -2}, "negative generation"),
    (lambda s: {**s, "calibrated_at": 12345.0}, "foreign evidence"),
    (lambda s: {k: v for k, v in s.items() if k != "weight"},
     "missing key"),
    (lambda s: "not a dict", "wrong type"),
    (lambda s: None, "absent block"),
])
def test_monitor_restore_matches_reference(mutate, desc):
    now = time.time()
    got = []
    for mod in (CM, RCM):
        model = measured_model(mod, calibrated_at=now)
        mon = mod.CalibrationMonitor(model)
        mon.observe(10.0, 30.0)
        mon.observe(10.0, 22.0)
        mon.recalibrations = 2
        r = mod.CalibrationMonitor.restore(model, mutate(mon.state_dict()))
        got.append((r.drift, r.weight, r.generation, r.recalibrations))
    assert got[0] == got[1], desc
    assert (got[0][1] > 0) == (desc == "valid"), desc


def test_monitor_state_rides_calibration_file(tmp_path):
    model = CM.CostModel(
        source="measured", backend="torch-cpu",
        coeffs={k: CM.StageCoeff(per_row=1.0) for k in CM.STAGE_COEFF_KEYS},
        fingerprint=CM.fingerprint_backend("cpu"), calibrated_at=time.time())
    mon = CM.CalibrationMonitor(model)
    mon.observe(10.0, 30.0)
    mon.generation = 3
    p = str(tmp_path / "cal.json")
    CM.save_calibration(model, p, monitor=mon)
    loaded = CM.load_calibration(p, device="cpu")
    r = CM.CalibrationMonitor.restore(loaded, CM.load_monitor_state(p))
    assert (r.drift, r.weight, r.generation) == \
        (mon.drift, mon.weight, 3)
    (tmp_path / "bad.json").write_text("{ not json")
    assert CM.load_monitor_state(str(tmp_path / "bad.json")) is None
    assert CM.load_monitor_state(str(tmp_path / "none.json")) is None


# ---------------------------------------------------------------------------
# the adaptive cascade feeds the monitor and latches
# ---------------------------------------------------------------------------

QUERIES = [Q.And((Q.Count(Q.Op.GE, 2), Q.Spatial(0, Q.Rel.LEFT, 1))),
           Q.Or((Q.ClassCount(1, Q.Op.GE, 1),
                 Q.Region(2, (0, 0, 4, 4), 1))),
           Q.ClassCount(0, Q.Op.LE, 3)]


def test_adaptive_cascade_feeds_monitor_and_latches_due():
    rng = np.random.default_rng(21)
    # predictions ~1000x too cheap: a huge, sustained relative error
    tiny = measured_model(CM, per_row=1e-7, overhead=1e-7, step=1e-7,
                          calibrated_at=time.time())
    mqc = CS.MultiQueryCascade(QUERIES, adaptive=True, restage_every=1,
                               cost_model=tiny)
    assert mqc.calibration_monitor is not None          # default-on
    assert not mqc.recalibration_due
    mqc.masks(rand_outputs(rng, 16))                    # builds: skipped
    assert mqc.calibration_monitor.weight == 0.0
    for _ in range(25):
        mqc.masks(rand_outputs(rng, 16))
    assert mqc.calibration_monitor.weight > 0
    assert mqc.recalibration_due                        # latched
    mqc.calibration_monitor.reset()
    mqc.masks(rand_outputs(rng, 16))
    assert not mqc.recalibration_due                    # cleared
    static = CS.MultiQueryCascade(QUERIES, adaptive=True)
    assert static.calibration_monitor is None
    with pytest.raises(ValueError, match="adaptive"):
        CS.MultiQueryCascade(QUERIES, calibration_monitor=CM.
                             CalibrationMonitor(tiny))


def test_monitor_static_pricing_mismatch_warns_and_is_not_fed():
    mon = CM.CalibrationMonitor(measured_model(CM,
                                               calibrated_at=time.time()))
    with pytest.warns(UserWarning, match="static model"):
        mqc = CS.MultiQueryCascade(QUERIES, adaptive=True,
                                   calibration_monitor=mon)
    rng = np.random.default_rng(10)
    for _ in range(4):
        mqc.masks(rand_outputs(rng, 16))
    assert mon.weight == 0.0
