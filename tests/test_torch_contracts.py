"""The port's error-bounded aggregate engine (``repro_torch.core.
contracts``) on the CPU: the JAX package's contract and executor cases
(tests/test_contracts.py) run against the port, plus cross-package cases
that hold the two packages' results equal field by field.

The statistical harness is the reference's: seeded trials per contract
shape, realized coverage required to clear the nominal level minus a
binomial tolerance band (the cheap 60-trial profile; the reference's
``slow`` 250-trial variants are not mirrored), early-termination
soundness, unbiasedness against the uniform baseline, and the oracle
accounting (charged exactly once, no spend after termination, budget
cap, census, LIMIT-k).  Those cases price chunks as the reference's do,
by measured wall-clock microseconds.

The cross-package cases give both packages the same ``value_fn``,
``verdict_fn``, seed and explicit ``chunk_oracle_cost`` with
``cv="eager"``, so no wall-clock price enters a decision: the two
``ContractResult``s must then agree exactly in every field that is not a
measured microsecond.
"""
import functools
import math

import numpy as np
import pytest
import torch

from repro.core import contracts as RK
from repro.core import query as RQ
from repro_torch.core import aggregates as TA
from repro_torch.core import query as Q
from repro_torch.core.aggregates import BudgetLedger
from repro_torch.core.contracts import AggregateQuery, make_value_fn
from repro_torch.core import contracts as TK

# every executor of this file runs its accumulators on the CPU
ContractExecutor = functools.partial(TK.ContractExecutor, device="cpu")

PRED = Q.ClassCount(0, Q.Op.GE, 1)


def _bernoulli_stream(seed, n, rates):
    """Per-chunk Bernoulli frame values + noisy verdict proxy."""
    rng = np.random.default_rng(seed)
    k = len(rates)
    bounds = np.linspace(0, n, k + 1).astype(int)
    y = np.zeros(n)
    for j in range(k):
        m = bounds[j + 1] - bounds[j]
        y[bounds[j]:bounds[j + 1]] = (rng.random(m) < rates[j])
    z = np.clip(y + rng.normal(0.0, 0.3, n), 0.0, 1.0)
    return y, z


def _run_one(seed, n, rates, allocation, cv, eps=0.1, **knobs):
    y, z = _bernoulli_stream(seed, n, rates)
    q = AggregateQuery(pred=PRED, agg="count", eps=eps)
    ex = ContractExecutor(
        q, lambda f: y[np.asarray(f)], n,
        verdict_fn=(lambda f: z[np.asarray(f)].reshape(-1, 1)) if cv else None,
        n_chunks=len(rates), allocation=allocation,
        cv="auto" if cv else "off", seed=seed + 7919, **knobs)
    return ex.run(), float(y.sum())


SKEW6 = (0.01, 0.01, 0.01, 0.45, 0.02, 0.02)
UNIF6 = (0.08,) * 6
SKEW8 = (0.01, 0.01, 0.01, 0.01, 0.01, 0.45, 0.02, 0.02)
UNIF8 = (0.08,) * 8

SHAPES = [
    ("skew-thompson-cv", SKEW6, "thompson", True),
    ("unif-thompson-cv", UNIF6, "thompson", True),
    ("skew-thompson-nocv", SKEW6, "thompson", False),
    ("skew-uniform-alloc", SKEW6, "uniform", False),
]


def _coverage_sweep(trials, n, rates, allocation, cv, confidence=0.95):
    covered = met = sound = 0
    spend = []
    for s in range(trials):
        res, truth = _run_one(s, n, rates, allocation, cv)
        covered += res.ci[0] - 1e-9 <= truth <= res.ci[1] + 1e-9
        met += res.terminated in ("contract", "census")
        # early-termination soundness: claiming "contract" with a CI
        # wider than the contract allows is never acceptable
        if res.terminated != "contract" or \
                res.half_width <= res.query.eps * abs(res.estimate) + 1e-9:
            sound += 1
        spend.append(res.oracle_calls)
    tol = 2.6 * math.sqrt(confidence * (1 - confidence) / trials)
    return covered / trials, met / trials, sound, np.mean(spend), tol


@pytest.mark.parametrize("name,rates,allocation,cv", SHAPES,
                         ids=[s[0] for s in SHAPES])
def test_contract_coverage_cheap(name, rates, allocation, cv):
    trials = 60
    cover, met, sound, _, tol = _coverage_sweep(trials, 1200, rates,
                                                allocation, cv)
    assert sound == trials, f"{trials - sound} unsound terminations"
    assert cover >= 0.95 - tol, f"coverage {cover:.3f} < {0.95 - tol:.3f}"
    assert met >= 0.95 - tol, f"contract-met {met:.3f} < {0.95 - tol:.3f}"


def _trial_means(trials, n, rates, allocation, cv):
    # chunks priced by an explicit uniform vector: the reference's
    # wall-clock per-chunk prices let its 60-trial case flip under load
    ests = []
    for s in range(trials):
        res, truth = _run_one(s, n, rates, allocation, cv,
                              chunk_oracle_cost=np.ones(len(rates)))
        ests.append(res.estimate - truth)          # per-trial error
    e = np.asarray(ests)
    return float(e.mean()), float(e.std(ddof=1) / math.sqrt(trials))


@pytest.mark.parametrize("trials", [60])
def test_adaptive_estimate_unbiased(trials):
    """The adaptive (Thompson + CV) estimator's error has mean zero —
    matching truth AND the uniform-sampling baseline within Monte-Carlo
    CIs.  This is the pin on the honest decision/estimation sample
    split: a coupled adaptive design fails it by starving all-zero
    chunks (optional stopping)."""
    ad_mean, ad_sem = _trial_means(trials, 1200, SKEW6, "thompson", True)
    un_mean, un_sem = _trial_means(trials, 1200, SKEW6, "uniform", False)
    assert abs(ad_mean) <= 3.5 * ad_sem, \
        f"adaptive bias {ad_mean:+.2f} (sem {ad_sem:.2f})"
    assert abs(ad_mean - un_mean) <= \
        3.5 * math.sqrt(ad_sem ** 2 + un_sem ** 2)


def test_adaptive_beats_uniform_on_skewed_stream():
    """The engine's reason to exist: on a skewed-rate stream the
    adaptive allocator must meet the same contract with fewer oracle
    calls than uniform sampling (averaged over seeds — per-seed noise
    can flip individual trials)."""
    trials = 25
    ad = [_run_one(s, 2000, SKEW8, "thompson", True)[0].oracle_calls
          for s in range(trials)]
    un = [_run_one(s, 2000, SKEW8, "uniform", False)[0].oracle_calls
          for s in range(trials)]
    assert np.mean(ad) < np.mean(un), \
        f"adaptive {np.mean(ad):.0f} >= uniform {np.mean(un):.0f}"


# ---------------------------------------------------------------------------
# Oracle accounting: exactly-once charging, no post-termination spend
# ---------------------------------------------------------------------------

def _instrumented(y):
    seen = []

    def value_fn(frames):
        seen.extend(int(f) for f in np.asarray(frames))
        return y[np.asarray(frames)]
    return value_fn, seen


def test_oracle_frames_charged_exactly_once():
    y, _ = _bernoulli_stream(3, 1500, SKEW6)
    value_fn, seen = _instrumented(y)
    ledger = BudgetLedger()
    q = AggregateQuery(pred=PRED, agg="count", eps=0.1)
    res = ContractExecutor(q, value_fn, 1500, n_chunks=6,
                           ledger=ledger, seed=5).run()
    assert len(seen) == len(set(seen)), "a frame was decoded twice"
    assert res.oracle_calls == len(seen)
    assert ledger.oracle_calls == len(seen)
    assert int(res.decision_calls.sum() + res.allocation.sum()) == len(seen)


def test_no_oracle_spend_after_termination():
    y, _ = _bernoulli_stream(4, 2000, UNIF8)
    value_fn, seen = _instrumented(y)
    q = AggregateQuery(pred=PRED, agg="count", eps=0.25)   # loose: early stop
    res = ContractExecutor(q, value_fn, 2000, n_chunks=8, seed=6).run()
    assert res.terminated == "contract"
    spent = len(seen)
    assert spent < 2000, "early termination decoded the whole stream"
    # touching the result does not decode anything further
    _ = (res.estimate, res.half_width, res.ledger.describe())
    assert len(seen) == spent
    assert res.oracle_calls == spent


def test_budget_cap_respected():
    y, _ = _bernoulli_stream(5, 2000, SKEW8)
    q = AggregateQuery(pred=PRED, agg="count", eps=0.001)  # unmeetable
    res = ContractExecutor(q, lambda f: y[np.asarray(f)], 2000, n_chunks=8,
                           max_oracle=64, seed=7).run()
    assert res.terminated == "budget"
    assert res.oracle_calls <= 64
    assert not res.satisfied


def test_filter_frames_charged_once_via_ledger():
    y, z = _bernoulli_stream(6, 1500, SKEW6)
    fseen = []

    def verdict_fn(frames):
        fseen.extend(int(f) for f in np.asarray(frames))
        return z[np.asarray(frames)].reshape(-1, 1)
    ledger = BudgetLedger()
    q = AggregateQuery(pred=PRED, agg="count", eps=0.1)
    ContractExecutor(q, lambda f: y[np.asarray(f)], 1500, n_chunks=6,
                     verdict_fn=verdict_fn, cv="eager", ledger=ledger,
                     seed=8).run()
    assert len(fseen) == len(set(fseen)), "a frame was filtered twice"
    assert ledger.filter_frames == len(fseen)


def test_census_is_exact_and_charges_every_frame_once():
    n = 160
    y, _ = _bernoulli_stream(7, n, (0.02, 0.02, 0.02, 0.02))
    value_fn, seen = _instrumented(y)
    # +-0.4 frames absolute: only the exact answer clears it
    q = AggregateQuery(pred=PRED, agg="count", eps=0.4, relative=False)
    res = ContractExecutor(q, value_fn, n, n_chunks=4, seed=9).run()
    # the contract is only satisfiable once every chunk is censused —
    # whether the loop notices via the contract check (zero-width CI)
    # or via pool exhaustion, the answer must be exact
    assert res.terminated in ("contract", "census")
    assert res.satisfied
    assert res.estimate == pytest.approx(float(y.sum()))
    assert res.half_width <= 0.4
    assert sorted(set(seen)) == list(range(n))
    assert len(seen) == n                                  # exactly once


def test_all_zero_stream_never_claims_contract():
    """A relative contract on an all-zero stream can only be discharged
    by census — an empirical CI can never prove a rate is exactly 0."""
    n = 400
    y = np.zeros(n)
    q = AggregateQuery(pred=PRED, agg="count", eps=0.1)
    res = ContractExecutor(q, lambda f: y[np.asarray(f)], n,
                           n_chunks=4, seed=10).run()
    assert res.terminated == "census"
    assert res.estimate == 0.0


# ---------------------------------------------------------------------------
# LIMIT-k: exactly k confirmations, stop on the k-th
# ---------------------------------------------------------------------------

def _limit_stream(n, match_at):
    y = np.zeros(n)
    y[list(match_at)] = 1.0
    return y


@pytest.mark.parametrize("placement", ["front", "back", "spread", "cluster"])
def test_limit_k_stops_at_exactly_k(placement):
    n, k = 1000, 5
    match_at = {
        "front": range(0, 40, 4),
        "back": range(n - 40, n, 4),
        "spread": range(0, n, 37),
        "cluster": range(600, 625),
    }[placement]
    y = _limit_stream(n, match_at)
    value_fn, seen = _instrumented(y)
    q = AggregateQuery(pred=PRED, agg="count", limit=k)
    res = ContractExecutor(q, value_fn, n, n_chunks=8, seed=11).run()
    assert res.terminated == "limit"
    assert res.satisfied
    assert len(res.confirmations) == k                     # exactly k
    assert all(y[f] > 0 for f in res.confirmations)
    # the k-th confirmation is the LAST decoded frame: nothing is
    # decoded after the executor has what it needs
    assert seen[-1] == res.confirmations[-1]
    assert len(seen) == len(set(seen)) == res.oracle_calls


def test_limit_k_exhausts_to_census_when_matches_scarce():
    n, k = 400, 5
    y = _limit_stream(n, [50, 300])                        # only 2 matches
    value_fn, seen = _instrumented(y)
    q = AggregateQuery(pred=PRED, agg="count", limit=k)
    res = ContractExecutor(q, value_fn, n, n_chunks=4, seed=12).run()
    assert res.terminated == "census"
    assert not res.satisfied
    assert sorted(res.confirmations) == [50, 300]
    assert len(seen) == len(set(seen))                     # still exactly-once


# ---------------------------------------------------------------------------
# Declarative API validation
# ---------------------------------------------------------------------------

def test_query_rejects_bad_agg():
    with pytest.raises(ValueError, match="agg"):
        AggregateQuery(pred=PRED, agg="median")


def test_query_sum_requires_cls():
    with pytest.raises(ValueError, match="cls"):
        AggregateQuery(pred=PRED, agg="sum")


def test_query_rejects_temporal_pred():
    with pytest.raises(TypeError, match="frame-level"):
        AggregateQuery(pred=Q.Duration(PRED, min_frames=3), agg="count")


@pytest.mark.parametrize("kw", [dict(eps=0.0), dict(eps=-0.1),
                                dict(confidence=0.3), dict(confidence=1.0),
                                dict(limit=0)])
def test_query_rejects_bad_contract_params(kw):
    with pytest.raises(ValueError):
        AggregateQuery(pred=PRED, agg="count", **kw)


def test_make_value_fn_count_sum_mean():
    frames = {0: [(0, 1, 1), (0, 2, 2), (1, 3, 3)],   # 2x cls0 + 1x cls1
              1: [(1, 4, 4)],                         # no cls0
              2: []}

    def oracle_fn(idx):
        return [frames[int(i)] for i in idx]
    qc = AggregateQuery(pred=PRED, agg="count")
    qs = AggregateQuery(pred=PRED, agg="sum", cls=0)
    qm = AggregateQuery(pred=PRED, agg="mean", cls=0)
    idx = np.array([0, 1, 2])
    np.testing.assert_allclose(
        make_value_fn(qc, oracle_fn, 4, 8)(idx), [1.0, 0.0, 0.0])
    np.testing.assert_allclose(
        make_value_fn(qs, oracle_fn, 4, 8)(idx), [2.0, 0.0, 0.0])
    np.testing.assert_allclose(
        make_value_fn(qm, oracle_fn, 4, 8)(idx), [2.0, 0.0, 0.0])


# ---------------------------------------------------------------------------
# Fleet hooks: per-chunk accumulators merge to the pooled state
# ---------------------------------------------------------------------------

def test_chunk_accumulators_merge_matches_pooled():
    y, z = _bernoulli_stream(8, 1200, SKEW6)
    q = AggregateQuery(pred=PRED, agg="count", eps=0.1)
    ex = ContractExecutor(q, lambda f: y[np.asarray(f)], 1200,
                          verdict_fn=lambda f: z[np.asarray(f)]
                          .reshape(-1, 1),
                          n_chunks=6, cv="eager", seed=13)
    ex.run()
    accs = [a for a in ex.chunk_accumulators() if int(a.n) > 0]
    fwd = functools.reduce(lambda a, b: a.merge(b), accs)
    rev = functools.reduce(lambda a, b: a.merge(b), accs[::-1])
    pooled = ex.pooled_accumulator()
    reduced = TA.distributed_reduce(ex.chunk_accumulators())
    assert int(fwd.n) == int(rev.n) == int(pooled.n) == int(reduced.n)
    # float64 accumulator state (the reference's float32 one is held at
    # 1e-5): merge order changes roundoff only
    for acc in (rev, pooled, reduced):
        assert acc.mean.dtype == torch.float64
        np.testing.assert_allclose(acc.mean.numpy(), fwd.mean.numpy(),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(acc.M2.numpy(), fwd.M2.numpy(),
                                   rtol=1e-10, atol=1e-9)
    # and the pooled moments are the numpy fit of the estimation samples
    ys = np.concatenate([np.concatenate(c) for c in ex._y if c])
    zs = np.concatenate([np.concatenate(c, 0) for c in ex._z if c], 0)
    want = TA.mcv_estimate(ys, zs)
    got = pooled.estimate()
    np.testing.assert_allclose([got.mean, got.var, got.naive_var],
                               [want.mean, want.var, want.naive_var],
                               rtol=1e-10, atol=0)


# ---------------------------------------------------------------------------
# Registry-wired session: shared ledger, shared leaf table, clean retire
# ---------------------------------------------------------------------------

def test_aggregate_stream_session_shares_registry_ledger():
    from repro_torch.core.filters import FilterOutputs
    from repro_torch.core.streaming import (AggregateStreamSession,
                                            QueryRegistry)

    n, n_classes, grid = 600, 4, 8
    rng = np.random.default_rng(21)
    has = rng.random(n) < 0.15
    objs = [[(0, 2, 2)] if h else [] for h in has]
    counts = np.zeros((n, n_classes), np.float32)
    counts[has, 0] = 1.0
    gridmap = np.full((n, grid, grid, n_classes), -10.0, np.float32)
    gridmap[has, 2, 2, 0] = 10.0

    def filter_fn(idx):
        i = np.asarray(idx)
        return FilterOutputs(counts=torch.as_tensor(counts[i]),
                             grid=torch.as_tensor(gridmap[i]))

    def oracle_fn(idx):
        return [objs[int(i)] for i in idx]

    reg = QueryRegistry()
    q = AggregateQuery(pred=PRED, agg="count", eps=0.25)
    with AggregateStreamSession(reg, q, filter_fn=filter_fn,
                                oracle_fn=oracle_fn, n_frames=n,
                                n_classes=n_classes, grid=grid,
                                n_chunks=4, seed=3, device="cpu") as sess:
        assert sess.qid in dict(reg.active())
        res = sess.run()
    assert sess.qid not in dict(reg.active())                      # retired on exit
    truth = float(has.sum())
    assert res.ci[0] - 1e-9 <= truth <= res.ci[1] + 1e-9
    # one ledger, both halves: the session charged the registry account
    assert reg.budget_ledger.oracle_calls == res.oracle_calls > 0
    assert reg.budget_ledger is res.ledger


# ---------------------------------------------------------------------------
# Pricing provenance: measured CostModel -> realized ledger -> static
# ---------------------------------------------------------------------------

def test_pricing_provenance_prefers_measured_oracle_coeff():
    from repro_torch.core import costmodel as CM
    y, _ = _bernoulli_stream(9, 800, (0.05,) * 4)
    q = AggregateQuery(pred=PRED, agg="count", eps=0.2)
    base = CM.CostModel(
        source="measured", backend="test",
        coeffs={k: CM.StageCoeff(per_row=1.0)
                for k in CM.STAGE_COEFF_KEYS})
    measured = CM.calibrate_oracle(
        base, lambda f: y[np.asarray(f)], lambda r: np.arange(r), repeat=1,
        device="cpu")
    res = ContractExecutor(q, lambda f: y[np.asarray(f)], 800, n_chunks=4,
                           cost_model=measured, seed=14).run()
    assert res.pricing["oracle_price_source"] == "measured"
    assert res.pricing["oracle_us_per_frame"] > 0

    # without a measured coefficient, the realized ledger spend prices it
    res2 = ContractExecutor(q, lambda f: y[np.asarray(f)], 800, n_chunks=4,
                            seed=14).run()
    assert res2.pricing["oracle_price_source"] in ("realized", "static")


# ---------------------------------------------------------------------------
# Per-chunk oracle pricing: the allocator pays chunk-local prices
# ---------------------------------------------------------------------------

def test_explicit_chunk_prices_shift_allocation_toward_cheap_chunks():
    """Equal posteriors (uniform rates everywhere), skewed explicit
    chunk prices: the Thompson allocator must buy proportionally more
    estimation frames in the cheap chunks than the uniformly-priced
    baseline does — variance shrink per COST, not per frame."""
    rng = np.random.default_rng(0)
    n = 4096
    y = (rng.random(n) < 0.2).astype(float)
    q = AggregateQuery(pred=PRED, agg="count", eps=0.05)

    def run(chunk_oracle_cost):
        return ContractExecutor(q, lambda f: y[np.asarray(f)], n,
                                n_chunks=8, seed=11,
                                chunk_oracle_cost=chunk_oracle_cost).run()

    base = run(None)
    skew = run(np.array([1.0] * 4 + [100.0] * 4))
    assert skew.pricing["chunk_price_source"] == "explicit"
    cheap_base = base.allocation[:4].sum() / max(base.allocation.sum(), 1)
    cheap_skew = skew.allocation[:4].sum() / max(skew.allocation.sum(), 1)
    assert cheap_skew > cheap_base
    # estimates stay unbiased-ish under the shifted allocation: both
    # contracts still cover the truth
    truth = float(y.sum())
    for res in (base, skew):
        assert res.ci[0] - 1e-9 <= truth <= res.ci[1] + 1e-9


def test_chunk_price_vector_provenance_and_validation():
    y, _ = _bernoulli_stream(5, 1200, (0.1,) * 6)
    q = AggregateQuery(pred=PRED, agg="count", eps=0.1)
    # explicit knob: returned verbatim
    ex = ContractExecutor(q, lambda f: y[np.asarray(f)], 1200, n_chunks=6,
                          seed=2,
                          chunk_oracle_cost=[1, 2, 3, 4, 5, 6])
    prices, src = ex._chunk_prices()
    assert src == "explicit"
    np.testing.assert_array_equal(prices, np.arange(1.0, 7.0))
    # no knob, no spend yet: uniform broadcast of the scalar price
    ex2 = ContractExecutor(q, lambda f: y[np.asarray(f)], 1200, n_chunks=6,
                           seed=2)
    prices2, src2 = ex2._chunk_prices()
    assert src2 in ("static", "realized", "measured")
    assert np.all(prices2 == prices2[0])
    # after a run every chunk has bought frames: realized per-chunk
    # wall-time pricing takes over and the result records the source
    res = ex2.run()
    prices3, src3 = ex2._chunk_prices()
    assert src3 == "realized-chunk"
    assert np.all(np.isfinite(prices3)) and np.all(prices3 > 0)
    assert res.pricing["chunk_price_source"] == "realized-chunk"
    # validation: wrong length / non-positive entries refused
    with pytest.raises(ValueError, match="chunk_oracle_cost"):
        ContractExecutor(q, lambda f: y[np.asarray(f)], 1200, n_chunks=6,
                         chunk_oracle_cost=[1.0, 2.0])
    with pytest.raises(ValueError, match="positive"):
        ContractExecutor(q, lambda f: y[np.asarray(f)], 1200, n_chunks=6,
                         chunk_oracle_cost=[1.0] * 5 + [-1.0])


# ---------------------------------------------------------------------------
# Cross-package: the same run gives the same ContractResult
# ---------------------------------------------------------------------------

def _values_stream(seed, n, k):
    """Per-chunk small-integer frame values (a sum-style aggregate) and
    a two-column verdict proxy."""
    rng = np.random.default_rng(seed)
    lam = rng.uniform(0.2, 3.0, k)
    bounds = np.linspace(0, n, k + 1).astype(int)
    y = np.concatenate([rng.poisson(lam[j], bounds[j + 1] - bounds[j])
                        for j in range(k)]).astype(np.float64)
    z = np.stack([(y > 0) ^ (rng.random(n) < 0.1),
                  y + rng.normal(0, 0.7, n)], axis=1).astype(np.float64)
    return y, z


CROSS = [
    # name, n, n_chunks, stream, query kwargs, executor kwargs
    ("count-thompson-eager", 1200, 6, "skew", dict(agg="count", eps=0.1),
     dict(cv="eager")),
    ("count-thompson-nocv", 1200, 6, "skew", dict(agg="count", eps=0.1),
     dict(cv="off")),
    ("count-uniform", 1200, 6, "unif", dict(agg="count", eps=0.15),
     dict(cv="off", allocation="uniform")),
    ("sum-thompson-eager", 1600, 8, "values",
     dict(agg="sum", cls=0, eps=0.05), dict(cv="eager")),
    ("mean-absolute", 900, 4, "values",
     dict(agg="mean", cls=0, eps=0.08, relative=False), dict(cv="eager")),
    ("census", 160, 4, "sparse", dict(agg="count", eps=0.4, relative=False),
     dict(cv="off")),
    ("budget-cap", 2000, 8, "skew", dict(agg="count", eps=0.001),
     dict(cv="eager", max_oracle=64)),
    ("limit-5", 1000, 8, "sparse", dict(agg="count", limit=5),
     dict(cv="off")),
]


def _cross_stream(kind, seed, n, k):
    if kind == "values":
        return _values_stream(seed, n, k)
    rates = {"skew": SKEW6 if k == 6 else SKEW8, "unif": UNIF6,
             "sparse": (0.02,) * k}[kind]
    y, z = _bernoulli_stream(seed, n, rates)
    return y, z.reshape(-1, 1)


def _result_fields(res):
    """Every ContractResult field that is not a measured microsecond."""
    return dict(
        estimate=res.estimate, ci=tuple(res.ci), mean=res.mean,
        n_sampled=res.n_sampled, oracle_calls=res.oracle_calls,
        satisfied=res.satisfied, terminated=res.terminated,
        rounds=res.rounds, confirmations=list(res.confirmations),
        allocation=res.allocation.tolist(),
        decision_calls=res.decision_calls.tolist(),
        cv_chunks=res.cv_chunks,
        variance_reduction=res.variance_reduction,
        chunk_price_source=res.pricing["chunk_price_source"],
        cost_model=res.pricing["cost_model"],
        ledger=(res.ledger.oracle_calls, res.ledger.filter_frames,
                res.ledger.rounds))


@pytest.mark.parametrize("name,n,k,stream,qkw,xkw", CROSS,
                         ids=[c[0] for c in CROSS])
@pytest.mark.parametrize("seed", [0, 1])
def test_contract_result_identical_to_reference(name, n, k, stream, qkw,
                                                xkw, seed):
    y, z = _cross_stream(stream, seed, n, k)
    prices = np.linspace(1.0, 2.0, k)
    results = []
    for mod, query_mod, kw in ((TK, Q, dict(device="cpu")), (RK, RQ, {})):
        q = mod.AggregateQuery(pred=query_mod.ClassCount(0, query_mod.Op.GE,
                                                         1), **qkw)
        ex = mod.ContractExecutor(
            q, lambda f: y[np.asarray(f)], n,
            verdict_fn=lambda f: z[np.asarray(f)], n_chunks=k,
            seed=seed + 31, chunk_oracle_cost=prices, **xkw, **kw)
        results.append(ex.run())
    got, want = (_result_fields(r) for r in results)
    assert got == want
    assert got["chunk_price_source"] == "explicit"


def test_session_result_identical_to_reference():
    """The same registry-wired session in both packages: the verdict tap
    (the shared plan's mask column and the count head's class column)
    over the same filter outputs feeds the same contract run."""
    import jax.numpy as jnp
    from repro.core.filters import FilterOutputs as RF
    from repro.core.streaming import AggregateStreamSession as RS
    from repro.core.streaming import QueryRegistry as RR
    from repro_torch.core.filters import FilterOutputs as TF
    from repro_torch.core.streaming import AggregateStreamSession as TS
    from repro_torch.core.streaming import QueryRegistry as TR

    n, n_classes, grid, k = 800, 3, 8, 4
    rng = np.random.default_rng(5)
    objs = []
    for _ in range(n):
        m = int(rng.poisson(1.5))
        objs.append([(int(rng.integers(0, n_classes)),
                      int(rng.integers(0, grid)), int(rng.integers(0, grid)))
                     for _ in range(m)])
    counts = np.zeros((n, n_classes), np.float32)
    gridmap = np.full((n, grid, grid, n_classes), -1.0, np.float32)
    for f, ob in enumerate(objs):
        for c, r, col in ob:
            counts[f, c] += 1
            gridmap[f, r, col, c] = 1.0
    counts += rng.normal(0, 0.4, counts.shape).astype(np.float32)
    gridmap += rng.normal(0, 0.5, gridmap.shape).astype(np.float32)

    def run(reg, session, fo, to_arr, query_mod, query_cls, **kw):
        q = query_cls(pred=query_mod.And((
            query_mod.ClassCount(0, query_mod.Op.GE, 1),
            query_mod.Spatial(0, query_mod.Rel.LEFT, 1))),
            agg="sum", cls=0, eps=0.1)

        def filter_fn(idx):
            i = np.asarray(idx)
            return fo(counts=to_arr(counts[i]), grid=to_arr(gridmap[i]))

        with session(reg, q, filter_fn=filter_fn,
                     oracle_fn=lambda idx: [objs[int(i)] for i in idx],
                     n_frames=n, n_classes=n_classes, grid=grid,
                     n_chunks=k, seed=3, cv="eager",
                     chunk_oracle_cost=np.ones(k), **kw) as sess:
            return sess.run()

    got = run(TR(), TS, TF, torch.as_tensor, Q, AggregateQuery,
              device="cpu")
    want = run(RR(), RS, RF, jnp.asarray, RQ, RK.AggregateQuery)
    assert _result_fields(got) == _result_fields(want)
    assert got.cv_chunks == k and got.ledger.filter_frames == n


def test_executor_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    q = AggregateQuery(pred=PRED, agg="count", eps=0.1)
    with pytest.raises(RuntimeError, match="CUDA"):
        TK.ContractExecutor(q, lambda f: np.zeros(len(f)), 100)
