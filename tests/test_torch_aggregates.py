"""The port's control-variate aggregates against the JAX package's, on
the CPU.

Both packages get the same numpy inputs made from a seed.  What is held,
and how tightly:

- the numpy half (``cv_estimate``, ``mcv_estimate``, ``CVEstimate`` with
  its Student-t ``ci95``, ``ChunkPosteriors`` draws, ``BudgetLedger``) is
  the same code in both packages, so it is held bit for bit (``==``);
- the port's float64 ``CVAccumulator`` (update / merge /
  ``distributed_reduce`` / estimate) is held against numpy
  ``mcv_estimate`` on the same samples at 1e-10 relative — not against
  the JAX package's accumulator, whose float64 path runs only under
  ``jax_enable_x64`` and whose own x64 tests cannot run on this jax.
"""
import functools

import numpy as np
import pytest
import torch

from repro.core import aggregates as RA
from repro_torch.core import aggregates as TA

REL = 1e-10


def _samples(seed, n, d, offset=0.0):
    rng = np.random.default_rng(seed)
    y = rng.normal(offset + 3.0, 2.0, n)
    Z = y[:, None] * rng.uniform(0.5, 1.5, d) + rng.normal(0, 1.0, (n, d))
    return y, Z


def _same_estimate(a, b):
    assert a.mean == b.mean and a.var == b.var
    assert a.naive_var == b.naive_var and a.n == b.n
    np.testing.assert_array_equal(a.beta, b.beta)
    assert a.variance_reduction == b.variance_reduction
    assert a.ci95() == b.ci95()


@pytest.mark.parametrize("seed,n,d", [(0, 3, 1), (1, 50, 1), (2, 400, 2),
                                      (3, 1000, 3), (4, 20, 0)])
def test_estimators_identical_to_reference(seed, n, d):
    y, Z = _samples(seed, n, d)
    _same_estimate(TA.mcv_estimate(y, Z), RA.mcv_estimate(y, Z))
    mu = Z.mean(0) + 0.1
    _same_estimate(TA.mcv_estimate(y, Z, mu_z=mu),
                   RA.mcv_estimate(y, Z, mu_z=mu))
    if d:
        _same_estimate(TA.cv_estimate(y, Z[:, 0]),
                       RA.cv_estimate(y, Z[:, 0]))
        _same_estimate(TA.cv_estimate(y, Z[:, 0], mu_x=0.5),
                       RA.cv_estimate(y, Z[:, 0], mu_x=0.5))


def test_estimator_errors_identical_to_reference():
    y, Z = _samples(5, 2, 1)
    for mod in (TA, RA):
        with pytest.raises(mod.DegenerateSampleError) as e:
            mod.mcv_estimate(y, Z)
        assert (e.value.n, e.value.needed) == (2, 3)
        assert isinstance(e.value, ValueError)
        with pytest.raises(ValueError, match="samples"):
            mod.mcv_estimate(y[:1], Z)
    assert str(TA.DegenerateSampleError(2)) == \
        str(RA.DegenerateSampleError(2))


@pytest.mark.parametrize("seed", range(3))
def test_chunk_posteriors_draws_identical_to_reference(seed):
    rng = np.random.default_rng(seed)
    k = 6
    post = (TA.ChunkPosteriors(k, prior_strength=1.5),
            RA.ChunkPosteriors(k, prior_strength=1.5))
    for _ in range(20):
        j = int(rng.integers(0, k))
        y = (rng.random(int(rng.integers(1, 9))) < rng.random()) \
            * rng.integers(1, 5)
        hits = rng.random(y.size) < 0.3 if rng.random() < 0.5 else None
        for p in post:
            p.update(j, y, hits)
    t, r = post
    np.testing.assert_array_equal(t.means(), r.means())
    np.testing.assert_array_equal(t.variances(), r.variances())
    assert t.describe() == r.describe()
    gt, gr = (np.random.default_rng(seed + 100) for _ in range(2))
    for _ in range(5):
        np.testing.assert_array_equal(t.draw_rates(gt), r.draw_rates(gr))
        np.testing.assert_array_equal(t.draw_vars(gt), r.draw_vars(gr))
    for mod in (TA, RA):
        with pytest.raises(ValueError, match="n_chunks"):
            mod.ChunkPosteriors(0)
        with pytest.raises(ValueError, match="prior_strength"):
            mod.ChunkPosteriors(2, prior_strength=0.0)


def test_budget_ledger_identical_to_reference():
    led = (TA.BudgetLedger(), RA.BudgetLedger())
    for m in led:
        assert m.oracle_us_per_frame() is None
    for frames, us, f_frames, f_us in [(8, 120.5, 32, 40.25), (3, 0.0, 0, 0),
                                       (16, 77.0, 256, 300.0)]:
        for m in led:
            m.charge_oracle(frames, us)
            m.charge_filter(f_frames, f_us)
            m.rounds += 1
    assert led[0].describe() == led[1].describe()
    assert led[0].oracle_us_per_frame() == led[1].oracle_us_per_frame()


# ---------------------------------------------------------------------------
# the float64 accumulator against numpy mcv_estimate
# ---------------------------------------------------------------------------

def _rel_close(got, want):
    np.testing.assert_allclose(got, want, rtol=REL, atol=0)


def _check_estimate(acc, y, Z):
    got = acc.estimate()
    want = TA.mcv_estimate(y, Z)
    assert got.n == want.n == y.size
    _rel_close(got.mean, want.mean)
    _rel_close(got.var, want.var)
    _rel_close(got.naive_var, want.naive_var)
    _rel_close(got.beta, want.beta)


def test_accumulator_is_float64_on_its_device():
    acc = TA.CVAccumulator.init(3, device="cpu")
    for t, shape in ((acc.n, ()), (acc.mean, (4,)), (acc.M2, (4, 4))):
        assert t.dtype == torch.float64 and t.device.type == "cpu"
        assert tuple(t.shape) == shape
    # float32 samples are promoted: the state stays float64
    acc = acc.update(np.ones(5, np.float32), np.zeros((5, 3), np.float32))
    assert {acc.n.dtype, acc.mean.dtype, acc.M2.dtype} == {torch.float64}
    assert float(acc.n) == 5.0


@pytest.mark.parametrize("seed,n,d,splits", [(0, 300, 1, 1), (1, 300, 2, 4),
                                             (2, 1001, 3, 7), (3, 64, 2, 64)])
def test_accumulator_update_merge_reduce_match_mcv(seed, n, d, splits):
    y, Z = _samples(seed, n, d)
    parts = [TA.CVAccumulator.init(d, device="cpu").update(
        torch.as_tensor(y[i]), torch.as_tensor(Z[i]))
        for i in np.array_split(np.arange(n), splits)]
    one = TA.CVAccumulator.init(d, device="cpu").update(y, Z)
    fwd = functools.reduce(TA.CVAccumulator.merge, parts)
    rev = functools.reduce(TA.CVAccumulator.merge, parts[::-1])
    listed = TA.distributed_reduce(parts)
    stacked = TA.distributed_reduce(TA.CVAccumulator(
        n=torch.stack([a.n for a in parts]),
        mean=torch.stack([a.mean for a in parts]),
        M2=torch.stack([a.M2 for a in parts])))
    zc = Z - Z.mean(0)
    yc = y - y.mean()
    V = np.concatenate([yc[:, None], zc], axis=1)
    for acc in (one, fwd, rev, listed, stacked):
        assert float(acc.n) == n
        _rel_close(acc.mean.numpy(), np.concatenate([[y.mean()],
                                                     Z.mean(0)]))
        np.testing.assert_allclose(acc.M2.numpy(), V.T @ V, rtol=REL,
                                   atol=REL * np.abs(V.T @ V).max())
        _check_estimate(acc, y, Z)


def test_accumulator_long_stream_float64_holds_where_float32_drifts():
    """10^6 frames in batches of 10^4, values centred far from zero
    (mean 1000, unit spread): the float64 accumulator, streamed or pooled
    from per-batch accumulators by ``distributed_reduce``, stays within
    1e-10 of the two-pass numpy estimate, where the same Welford algebra
    in float32 is off by orders of magnitude more."""
    n, b, d = 10 ** 6, 10 ** 4, 2
    y, Z = _samples(7, n, d, offset=1000.0)
    acc = TA.CVAccumulator.init(d, device="cpu")
    batches = []
    acc32 = [torch.zeros((), dtype=torch.float32),
             torch.zeros(1 + d, dtype=torch.float32),
             torch.zeros((1 + d, 1 + d), dtype=torch.float32)]
    for lo in range(0, n, b):
        acc = acc.update(y[lo:lo + b], Z[lo:lo + b])
        batches.append(TA.CVAccumulator.init(d, device="cpu").update(
            y[lo:lo + b], Z[lo:lo + b]))
        v = torch.as_tensor(np.concatenate([y[lo:lo + b, None],
                                            Z[lo:lo + b]], 1),
                            dtype=torch.float32)
        part = TA.CVAccumulator(
            n=torch.tensor(float(v.shape[0])), mean=v.mean(0),
            M2=(v - v.mean(0)).T @ (v - v.mean(0)))
        nxt = TA._combine(TA.CVAccumulator(*acc32), part)
        acc32 = [nxt.n, nxt.mean, nxt.M2]
    assert float(acc.n) == n
    _check_estimate(acc, y, Z)
    _check_estimate(TA.distributed_reduce(batches), y, Z)
    want = TA.mcv_estimate(y, Z)
    got32 = TA.CVAccumulator(*acc32).estimate()
    assert abs(got32.var - want.var) / want.var > 1e3 * REL


def test_accumulator_d0_naive_fallback():
    y, _ = _samples(8, 40, 1)
    acc = TA.CVAccumulator.init(0, device="cpu").update(y, np.zeros((40, 0)))
    got, want = acc.estimate(), TA.mcv_estimate(y, np.zeros((40, 0)))
    assert got.beta.size == 0 and got.n == 40
    _rel_close(got.mean, want.mean)
    _rel_close(got.var, want.var)
    with pytest.raises(TA.DegenerateSampleError):
        TA.CVAccumulator.init(1, device="cpu").update(
            y[:2], np.zeros((2, 1))).estimate()


def test_distributed_reduce_rejects_unstacked():
    acc = TA.CVAccumulator.init(1, device="cpu")
    with pytest.raises(ValueError, match="stream axis"):
        TA.distributed_reduce(acc)
    with pytest.raises(ValueError, match="at least one"):
        TA.distributed_reduce([])


def test_accumulator_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        TA.CVAccumulator.init(1)
