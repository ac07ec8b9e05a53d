"""The port's temporal tier against the JAX package's, on the CPU.

The same seeded cases (``temporal_harness.gen_case``) go through both
packages: the port's ``TemporalProgram`` under its batched torch step
(``backend="scan"``) and its numpy loop, the reference's under its
``lax.scan`` step and its numpy loop.  Outputs and decidedness after
every batch are held bit for bit, and all of them equal the replay
oracle ``replay_reference``.  Then ``advance_group`` against S
single-stream advances, ``TemporalEngine`` fed the same filter-output
arrays in both packages, the step cache's keys and build counts (the
mirror of tests/test_temporal_stepcache.py), and the temporal cost.
"""
import time

import numpy as np
import pytest
import torch

import temporal_harness as H
from repro.core import query as RQ
from repro.core import temporal as RT
from repro.core.filters import FilterOutputs as RF
from repro.core.stats import SlotStats as RSlotStats
from repro_torch.core import costmodel as CM
from repro_torch.core import query as TQ
from repro_torch.core import temporal as TT
from repro_torch.core.filters import FilterOutputs as TF
from repro_torch.core.stats import SlotStats as TSlotStats
from repro_torch.core.stepcache import StepCache
from torch_parity import to_port

CPU = "cpu"
QUERIES = (RQ.Duration(RQ.ClassCount(0, RQ.Op.GE, 1), 3),
           RQ.Sequence(RQ.ClassCount(0, RQ.Op.GE, 1),
                       RQ.ClassCount(1, RQ.Op.GE, 1), 4),
           RQ.SlidingCount(RQ.ClassCount(1, RQ.Op.GE, 1), 5, RQ.Op.GE, 2))
PORT_QUERIES = tuple(to_port(q) for q in QUERIES)


def port_frame_value(trace):
    """``temporal_harness.frame_value_fn`` over the port's query AST."""
    keys = tuple(TQ.canonicalize(to_port(a)) for a in H.ATOMS)

    def fv(pred, t):
        key = TQ.canonicalize(pred)
        if key in keys:
            return bool(trace[t, keys.index(key)])
        if isinstance(pred, TQ.And):
            return all(fv(x, t) for x in pred.terms)
        if isinstance(pred, TQ.Or):
            return any(fv(x, t) for x in pred.terms)
        if isinstance(pred, TQ.Not):
            return not fv(pred.term, t)
        raise AssertionError(f"unexpected frame predicate {pred!r}")
    return fv


def _signals(prog, fv, t0, b):
    return np.array([[fv(fq, t0 + f) for fq in prog.frame_queries]
                     for f in range(b)], bool).reshape(b, -1)


def run_port(case, stream, backend):
    """One stream through the port's program over the case's split:
    (window outputs, decidedness after every batch)."""
    prog = TT.TemporalProgram([to_port(q) for q in case.queries],
                              backend=backend, device=CPU)
    prog.start_window(case.window)
    fv = port_frame_value(case.traces[stream])
    outs, decs, t = [], [], 0
    for b in case.splits:
        outs.append(prog.advance(_signals(prog, fv, t, b)))
        decs.append(prog.query_decided)
        t += b
    return np.concatenate(outs, 0), decs


def run_port_group(case):
    progs = [TT.TemporalProgram([to_port(q) for q in case.queries],
                                device=CPU)
             for _ in range(case.n_streams)]
    fvs = [port_frame_value(case.traces[s]) for s in range(case.n_streams)]
    for p in progs:
        p.start_window(case.window)
    outs, decs, t = [], [], 0
    for b in case.splits:
        sig = np.stack([_signals(progs[s], fvs[s], t, b)
                        for s in range(case.n_streams)])
        outs.append(TT.advance_group(progs, torch.as_tensor(sig)))
        decs.append(np.stack([p.query_decided for p in progs]))
        t += b
    return np.concatenate(outs, 1), decs


# ---------------------------------------------------------------------------
# the differential battery: port scan == port numpy == reference scan ==
# reference numpy == replay, outputs and decidedness after every batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(30))
def test_battery_equals_reference_and_replay(seed):
    case = H.gen_case(7907 * seed + 1, n_streams=1,
                      force_all_kinds=(seed % 3 == 0))
    expect = H.replay_outputs(case)[0]
    # the port's program strips to the same signals, in the same order
    ref_prog = RT.TemporalProgram(case.queries, backend="numpy")
    port_prog = TT.TemporalProgram([to_port(q) for q in case.queries],
                                   backend="numpy")
    assert [to_port(q) for q in ref_prog.frame_queries] == \
        port_prog.frame_queries
    assert port_prog.n_automata == ref_prog.n_automata
    runs = {("ref", b): H.run_single(case, 0, b)[:2]
            for b in ("scan", "numpy")}
    runs.update({("port", b): run_port(case, 0, b)
                 for b in ("scan", "numpy")})
    for name, (out, decs) in runs.items():
        np.testing.assert_array_equal(out, expect,
                                      err_msg=f"{name} != replay")
        for bi, (a, r) in enumerate(zip(decs, runs[("ref", "numpy")][1])):
            np.testing.assert_array_equal(
                a, r, err_msg=f"{name} decidedness, batch {bi}")


def test_battery_covers_all_operator_kinds():
    kinds = set()
    for seed in range(30):
        case = H.gen_case(7907 * seed + 1, n_streams=1,
                          force_all_kinds=(seed % 3 == 0))
        kinds |= H.operator_kinds(case.queries)
    assert kinds == {"duration", "sequence", "sliding"}


@pytest.mark.parametrize("n_streams,seed", [(1, 0), (1, 1), (3, 2), (3, 3),
                                            (3, 4), (3, 5)])
def test_advance_group_equals_single_stream_advances(n_streams, seed):
    case = H.gen_case(31 * seed + n_streams, n_streams=n_streams,
                      force_all_kinds=True, max_window=16)
    g_out, g_decs = run_port_group(case)
    np.testing.assert_array_equal(g_out, H.replay_outputs(case))
    for s in range(n_streams):
        out, decs = run_port(case, s, "scan")
        np.testing.assert_array_equal(g_out[s], out)
        for bi, d in enumerate(decs):
            np.testing.assert_array_equal(g_decs[bi][s], d)
    # the reference's vmapped group path agrees too
    r_out, r_decs, _ = H.run_group(case)
    np.testing.assert_array_equal(g_out, r_out)
    for a, b in zip(g_decs, r_decs):
        np.testing.assert_array_equal(a, b)


def test_advance_group_validates_inputs():
    progs = [TT.TemporalProgram(PORT_QUERIES, device=CPU) for _ in range(2)]
    for p in progs:
        p.start_window(8)
    M = progs[0].n_signals
    with pytest.raises(ValueError, match="signals must be"):
        TT.advance_group(progs, np.zeros((3, 4, M), bool))
    with pytest.raises(ValueError, match="past window end"):
        TT.advance_group(progs, np.zeros((2, 9, M), bool))
    progs[1].start_window(16)
    with pytest.raises(ValueError, match="aligned windows"):
        TT.advance_group(progs, np.zeros((2, 4, M), bool))
    other = TT.TemporalProgram(PORT_QUERIES[:1], device=CPU)
    other.start_window(8)
    with pytest.raises(ValueError, match="digest"):
        TT.advance_group([progs[0], other], np.zeros((2, 4, M), bool))
    with pytest.raises(ValueError):
        TT.advance_group([], np.zeros((0, 4, M), bool))


def test_numpy_backend_env_flag_and_defaults(monkeypatch):
    # the backend is an explicit argument only: the JAX package's
    # environment flag does not change what the port runs
    monkeypatch.setenv("REPRO_TEMPORAL_BACKEND", "numpy")
    assert TT.TemporalProgram(PORT_QUERIES, device=CPU).backend == "scan"
    assert TT.TemporalProgram(PORT_QUERIES,
                              backend="numpy").backend == "numpy"
    with pytest.raises(ValueError, match="backend"):
        TT.TemporalProgram(PORT_QUERIES, backend="lax")
    with pytest.raises(ValueError, match="at least one"):
        TT.TemporalProgram([])
    prog = TT.TemporalProgram(PORT_QUERIES, device=CPU)
    assert prog.backend == "scan" and prog.device.type == "cpu"
    if not torch.cuda.is_available():
        # the scan backend runs on the card by default, never falling
        # back to the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            TT.TemporalProgram(PORT_QUERIES)
        with pytest.raises(RuntimeError, match="CUDA"):
            TT.TemporalEngine(PORT_QUERIES, None, None, 2, 4)


def test_scan_step_takes_signals_on_the_device_and_no_other():
    prog = TT.TemporalProgram(PORT_QUERIES, device=CPU)
    ref = TT.TemporalProgram(PORT_QUERIES, backend="numpy")
    sig = np.random.default_rng(4).random((6, prog.n_signals)) < 0.5
    for p in (prog, ref):
        p.start_window(12)
    np.testing.assert_array_equal(prog.advance(torch.as_tensor(sig)),
                                  ref.advance(sig))
    np.testing.assert_array_equal(prog.advance(sig), ref.advance(sig))
    np.testing.assert_array_equal(prog.query_decided, ref.query_decided)
    np.testing.assert_array_equal(prog.suppressed_signals(),
                                  ref.suppressed_signals())


# ---------------------------------------------------------------------------
# TemporalEngine: the same filter-output arrays through both packages
# ---------------------------------------------------------------------------

def _engine_stream(seed, n_frames, C=3, G=6):
    r = np.random.default_rng(seed)
    counts = r.poisson(0.8, (n_frames, C)).astype(np.float32)
    grid = (r.random((n_frames, G, G, C)) < 0.06).astype(np.float32)
    objects = [np.stack([r.integers(0, C, k), r.integers(0, G, k),
                         r.integers(0, G, k)], 1)
               for k in r.poisson(2.0, n_frames)]
    return counts, grid, objects


ENGINE_QUERIES = (
    RQ.Duration(RQ.ClassCount(0, RQ.Op.GE, 1), 3),
    RQ.Or((RQ.SlidingCount(RQ.ClassCount(1, RQ.Op.GE, 1), 4, RQ.Op.GE, 2),
           RQ.Not(RQ.Count(RQ.Op.GE, 4)))),
    RQ.Sequence(RQ.ClassCount(0, RQ.Op.GE, 1),
                RQ.Spatial(1, RQ.Rel.LEFT, 2), 3),
    RQ.SlidingCount(RQ.Count(RQ.Op.GE, 0), 1, RQ.Op.GE, 0),
    RQ.Region(2, (0, 0, 3, 3), 1),
)


@pytest.mark.parametrize("adaptive", [False, True])
def test_temporal_engine_equals_reference(adaptive):
    import jax.numpy as jnp
    n, W, B, C, G = 64, 32, 8, 3, 6
    counts, grid, objects = _engine_stream(11, n, C, G)

    def oracle(idx, sel):
        return [objects[int(idx[s])] for s in sel]

    r_kw = dict(adaptive=True, slot_stats=RSlotStats()) if adaptive else {}
    t_kw = dict(adaptive=True, slot_stats=TSlotStats()) if adaptive else {}
    ref = RT.TemporalEngine(
        ENGINE_QUERIES,
        lambda idx: RF(counts=jnp.asarray(counts[idx]),
                       grid=jnp.asarray(grid[idx])),
        oracle, C, G, oracle_bucket=4, **r_kw)
    port = TT.TemporalEngine(
        [to_port(q) for q in ENGINE_QUERIES],
        lambda idx: TF(counts=torch.as_tensor(counts[idx]),
                       grid=torch.as_tensor(grid[idx])),
        oracle, C, G, oracle_bucket=4, device=CPU, **t_kw)
    for lo in range(0, n, W):
        for e in (ref, port):
            e.on_window_start(lo, lo + W)
        for b0 in range(lo, lo + W, B):
            idx = np.arange(b0, b0 + B)
            np.testing.assert_array_equal(port(idx), ref(idx),
                                          err_msg=f"batch at {b0}")
    for field in ("frames_in", "frames_skipped", "signal_evals_skipped",
                  "oracle_frames", "windows"):
        assert getattr(port.stats, field) == getattr(ref.stats, field), field
    for field in ("cost_saved_model", "cost_temporal_model"):
        assert getattr(port.stats, field) == pytest.approx(
            getattr(ref.stats, field), rel=1e-12), field
    assert port.stats.signal_evals_skipped > 0
    assert port.stats.frames_skipped == 0      # a frame-level query lives


def test_temporal_engine_skips_decided_batches():
    """Queries that latch on frame 0 decide the window after the first
    batch: the rest is skipped without a filter call."""
    calls = []
    B, W = 4, 16

    def filter_fn(idx):
        calls.append(int(idx[0]))
        return TF(counts=torch.ones((len(idx), 2)))

    eng = TT.TemporalEngine(
        (TQ.SlidingCount(TQ.Count(TQ.Op.GE, 0), 1, TQ.Op.GE, 0),
         TQ.Duration(TQ.Not(TQ.Count(TQ.Op.GE, 10 ** 6)), 1)),
        filter_fn, lambda idx, sel: [np.zeros((0, 3), int)] * len(sel),
        2, 4, device=CPU)
    eng.on_window_start(0, W)
    out = np.concatenate([eng(np.arange(b, b + B)) for b in range(0, W, B)])
    assert out.all() and calls == [0]
    assert eng.stats.frames_skipped == W - B
    assert eng.stats.cost_saved_model > 0 and eng.stats.windows == 1


# ---------------------------------------------------------------------------
# step cache: keys and build counts (tests/test_temporal_stepcache.py)
# ---------------------------------------------------------------------------

def _rand_signals(seed, B, M):
    return np.random.default_rng(seed).random((B, M)) < 0.5


def _drive(prog, seed, splits):
    prog.start_window(sum(splits))
    outs, t = [], 0
    for b in splits:
        outs.append(prog.advance(_rand_signals(seed + t, b,
                                               prog.n_signals)))
        t += b
    return np.concatenate(outs, 0)


def test_scan_step_cross_epoch_zero_rebuild():
    cache = StepCache()
    p1 = TT.TemporalProgram(PORT_QUERIES, step_cache=cache, device=CPU)
    out1 = _drive(p1, 11, (5, 3, 5, 3))
    assert p1.scan_traces == 2                 # one per distinct batch
    assert ("tstep", p1.program_sig, 5) in cache
    misses_cold = cache.misses
    p2 = TT.TemporalProgram(PORT_QUERIES, step_cache=cache, device=CPU)
    assert p2.program_sig == p1.program_sig
    out2 = _drive(p2, 11, (5, 3, 5, 3))
    assert p2.scan_traces == 0
    assert cache.misses == misses_cold and cache.hits >= 4
    np.testing.assert_array_equal(out1, out2)
    ref = RT.TemporalProgram(QUERIES)
    np.testing.assert_array_equal(out1, _drive(ref, 11, (5, 3, 5, 3)))


def test_scan_step_signature_separates_programs():
    cache = StepCache()
    p1 = TT.TemporalProgram([TQ.Duration(TQ.ClassCount(0, TQ.Op.GE, 1), 3)],
                            step_cache=cache, device=CPU)
    _drive(p1, 3, (4,))
    p2 = TT.TemporalProgram([TQ.Duration(TQ.ClassCount(0, TQ.Op.GE, 1), 4)],
                            step_cache=cache, device=CPU)
    assert p2.program_sig != p1.program_sig
    _drive(p2, 3, (4,))
    assert p2.scan_traces == 1


def test_scan_step_eviction_churn_answers_invariant():
    cache = StepCache(capacity=1)
    prog = TT.TemporalProgram(PORT_QUERIES, step_cache=cache, device=CPU)
    ref = TT.TemporalProgram(PORT_QUERIES, backend="numpy")
    for round_ in range(3):
        for splits in ((4, 4), (8,)):
            np.testing.assert_array_equal(
                _drive(prog, 100 * round_, splits),
                _drive(ref, 100 * round_, splits))
    assert cache.evictions > 0 and len(cache) == 1
    assert prog.scan_traces > 2


def test_group_scan_step_cross_epoch_zero_rebuild():
    S, B = 4, 6
    cache = StepCache()

    def epoch(seed):
        progs = [TT.TemporalProgram(PORT_QUERIES, step_cache=cache,
                                    device=CPU) for _ in range(S)]
        for p in progs:
            p.start_window(2 * B)
        outs = [TT.advance_group(
            progs, np.stack([_rand_signals(seed + 31 * s + t, B,
                                           progs[0].n_signals)
                             for s in range(S)]), step_cache=cache)
            for t in range(2)]
        return np.concatenate(outs, 1), progs[0]

    out1, p = epoch(7)
    assert p.scan_traces == 1
    assert ("tgstep", p.program_sig, B, S, None) in cache
    misses_cold = cache.misses
    out2, p = epoch(7)
    assert p.scan_traces == 0 and cache.misses == misses_cold
    np.testing.assert_array_equal(out1, out2)
    progs = [TT.TemporalProgram(PORT_QUERIES, step_cache=cache, device=CPU)
             for _ in range(2)]
    for q in progs:
        q.start_window(B)
    TT.advance_group(progs, np.stack([_rand_signals(1, B,
                                                    progs[0].n_signals)
                                      for _ in range(2)]), step_cache=cache)
    assert progs[0].scan_traces == 1           # another S, another key


# ---------------------------------------------------------------------------
# the temporal cost
# ---------------------------------------------------------------------------

def test_temporal_cost_static_and_measured(tmp_path):
    from repro.core import costmodel as RCM
    static = CM.static_cost_model()
    for frames, batch in ((32, 32), (8, 32), (5, None)):
        assert static.temporal_cost(frames=frames, batch=batch) == \
            RCM.static_cost_model().temporal_cost(frames=frames,
                                                  batch=batch)
    assert static.temporal_cost(frames=32, batch=32) == \
        CM.STATIC_COST_TEMPORAL
    coeffs = {k: CM.StageCoeff(per_row=1.0, overhead=1.0)
              for k in CM.STAGE_COEFF_KEYS}
    measured = CM.CostModel(
        source="measured", backend="torch-cpu", coeffs=coeffs,
        step_overhead_cost=2.0, fingerprint=CM.fingerprint_backend(CPU),
        calibrated_at=time.time())
    assert measured.temporal_cost(frames=32, batch=32) is None
    with_t = CM.CostModel(
        source="measured", backend="torch-cpu",
        coeffs=dict(coeffs, temporal=CM.StageCoeff(per_row=0.5,
                                                   overhead=3.0)),
        step_overhead_cost=2.0, fingerprint=CM.fingerprint_backend(CPU),
        calibrated_at=time.time())
    assert with_t.temporal_cost(frames=32, batch=32) == 3.0 + 0.5 * 32
    # the optional coefficient survives a save/load round trip; a
    # malformed one drops the entry, not the file
    path = str(tmp_path / "cal.json")
    CM.save_calibration(with_t, path)
    assert CM.load_calibration(path, device=CPU).coeffs["temporal"] == \
        with_t.coeffs["temporal"]
    import json
    with open(path) as f:
        payload = json.load(f)
    payload["coeffs"]["temporal"] = {"per_row": "nan?"}
    with open(path, "w") as f:
        json.dump(payload, f)
    loaded = CM.load_calibration(path, device=CPU)
    assert loaded is not None and "temporal" not in loaded.coeffs


def test_calibrate_fits_the_temporal_step(tmp_path):
    model = CM.calibrate(batch=16, grid=6, classes=3, repeat=1,
                         save=False, device=CPU)
    assert "temporal" in model.coeffs
    assert model.temporal_cost(frames=16, batch=16) > 0
    assert [r for r, _ in model.samples["temporal"]] == [1, 4, 8, 16]
