"""Declarative error-bounded aggregate queries with adaptive allocation.

The paper's second half (§III) answers aggregate queries over video —
"how many cars crossed this intersection today?" — by *sampling* the
expensive oracle and tightening the estimate with control variates from
the cheap specialized filters.  This module makes that declarative and
adaptive, following the two systems the ROADMAP grounds it in
(PAPERS.md):

- **BlazeIt** (Kang et al.): specialized cheap estimators as control
  variates.  The shared-cascade filter verdicts (and the count head)
  over a frame are strongly correlated with the oracle's answer; running
  them over a whole chunk gives the control variate's *exact* chunk mean
  ``mu_Z``, so the CV-adjusted estimator is unbiased and its variance
  shrinks by the squared correlation.
- **ExSample** (Moll et al.): adaptive allocation of oracle calls across
  stream *chunks* via Thompson sampling.  Each chunk keeps a posterior
  over its result rate/variance (``aggregates.ChunkPosteriors``); each
  allocation round draws from every posterior and spends the next oracle
  batch where the draw says it helps most.

The user states WHAT accuracy they need — ``AggregateQuery(pred,
agg="count", eps=0.05, confidence=0.95)`` is "COUNT(pred-frames) ± 5% @
95%" — and ``ContractExecutor`` decides where every oracle call goes,
stopping the moment the Student-t confidence interval clears the
contract (or, for ``limit=k``, the instant the k-th instance is
confirmed).  Every allocation decision is *priced*: the measured
``CostModel``'s oracle coefficient (``calibrate_oracle``) or the
ledger's realized µs/frame converts variance shrink into variance
shrink **per microsecond**, which is also how the executor decides
whether sweeping a chunk's cheap filter verdicts (to enable control
variates there) beats spending the same microseconds on oracle calls.
Spend lands in the ``aggregates.BudgetLedger`` the filter half of the
engine shares (``QueryRegistry.budget_ledger``), unifying the two
halves of the paper under one cost ledger.

This is the JAX package's ``core/contracts.py`` with its import paths
changed: the allocation, estimation and termination logic is the same
numpy code, so a run with the same values, verdicts, seed and explicit
chunk prices gives the same ``ContractResult`` in both packages.  Only
the fleet hook differs: ``chunk_accumulators`` builds the port's float64
``CVAccumulator`` on the executor's ``device`` (default CUDA).

Statistical shape — why the contract holds under ADAPTIVE allocation.
The naive design (one sample stream, allocate where observed variance
is high) is *biased*: a chunk's own values decide when its sampling
stops, and a prefix mean at a value-dependent stopping count does not
have the chunk's mean as its expectation — a low-rate chunk whose
warm-up draws were all zero gets frozen at an estimate of exactly 0.
The executor therefore splits every oracle batch into two streams
(honest estimation, as in sample-split adaptive inference):

- the **decision pool** — a small random subset of each chunk, committed
  before any value is seen; its frames feed ``ChunkPosteriors`` and ONLY
  the allocator ever looks at their values;
- the **estimation pool** — the rest of the chunk, sampled without
  replacement; the allocator never sees these values, so each chunk's
  estimation count is decision-measurable, and because a uniform subset
  of a uniform subset is a uniform subset of the chunk, the stratified
  estimator ``sum_j W_j * mean_j`` is exactly unbiased with the
  ordinary finite-population correction against the chunk size.  An
  oracle-result cache pins that no frame is decoded/oracled twice (the
  ledger charges novel frames only), and a chunk with every frame
  cached flips to its exact mean with zero variance — a census
  terminates with a zero-width interval.

Per-chunk variance is regularized toward the pooled variance with the
posterior's prior mass (a handful of identical draws must not read as
certainty), the CI uses the Student-t quantile on the pooled estimation
degrees of freedom, and a ``safety`` factor (default 1.1) absorbs the
mild anti-conservatism of sequential stopping — the only place sample
values touch a decision (the stop itself), shared by ANY sequential CI
including the uniform baseline.  The guarantee is checked
*empirically*: seeded coverage sweeps (tests/test_torch_contracts.py
here, tests/test_contracts.py for the JAX package) assert coverage >=
nominal minus a binomial tolerance band.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import query as Q
from repro_torch.core.aggregates import (BudgetLedger, ChunkPosteriors,
                                         CVAccumulator,
                                         DegenerateSampleError)
from repro_torch.device import DeviceLike, resolve_device

AGG_KINDS = ("count", "sum", "mean")


@dataclasses.dataclass(frozen=True)
class AggregateQuery:
    """A declarative aggregate with an accuracy contract.

    ``pred`` is a frame-level predicate (the same AST the filter half
    compiles); ``agg`` chooses the per-frame value the aggregate sums:

    - ``"count"`` — 1 when ``pred`` holds on the frame, else 0; the
      result is the NUMBER OF FRAMES satisfying the predicate.
    - ``"sum"``   — the number of class-``cls`` objects on the frame
      when ``pred`` holds, else 0; the result is the total object count
      over qualifying frames ("how many cars, over frames with a
      truck").  Use an always-true ``pred`` (e.g. ``Count(Op.GE, 0)``)
      for an unconditional total.
    - ``"mean"``  — same per-frame value, but the result is the
      per-frame average, not the stream total.

    The contract: the returned estimate is within ``± eps`` (relative
    when ``relative=True``, the default — "± 5%" — else absolute on the
    result scale) of the truth with probability >= ``confidence``.
    ``limit=k`` switches to search semantics: stop as soon as k frames
    satisfying ``pred`` are *confirmed by the oracle* (the eps/confidence
    fields are then ignored — ExSample's task)."""
    pred: Q.Predicate
    agg: str = "count"
    cls: Optional[int] = None
    eps: float = 0.05
    confidence: float = 0.95
    limit: Optional[int] = None
    relative: bool = True

    def __post_init__(self):
        if self.agg not in AGG_KINDS:
            raise ValueError(f"agg must be one of {AGG_KINDS}, "
                             f"got {self.agg!r}")
        if self.agg in ("sum", "mean") and self.cls is None:
            raise ValueError(f"agg={self.agg!r} needs cls= (which class's "
                             f"objects to aggregate)")
        if Q.has_temporal(self.pred):
            raise TypeError("AggregateQuery.pred must be frame-level; "
                            "temporal operators aggregate through the "
                            "windows of repro_torch.core.temporal "
                            "instead")
        if self.limit is None:
            if not 0 < self.eps:
                raise ValueError(f"eps must be > 0, got {self.eps}")
            if not 0.5 <= self.confidence < 1.0:
                raise ValueError(f"confidence must be in [0.5, 1), "
                                 f"got {self.confidence}")
        elif self.limit < 1:
            raise ValueError(f"limit must be >= 1, got {self.limit}")


def make_value_fn(query: AggregateQuery, oracle_fn, n_classes: int,
                  grid: int) -> Callable[[np.ndarray], np.ndarray]:
    """Adapt an object-list oracle (``oracle_fn(idx) -> [objects...]``,
    the cascade executors' contract) into the per-frame value stream
    ``ContractExecutor`` consumes."""
    def value_fn(idx: np.ndarray) -> np.ndarray:
        vals = np.zeros(len(idx), np.float64)
        for k, objs in enumerate(oracle_fn(idx)):
            t = Q.ObjectTable.from_objects(objs)
            ok = Q.eval_objects(query.pred, t, n_classes, grid)
            if query.agg == "count":
                vals[k] = 1.0 if ok else 0.0
            else:
                vals[k] = float(len(t.of_class(query.cls))) if ok else 0.0
        return vals
    return value_fn


@dataclasses.dataclass
class ContractResult:
    """What an aggregate run answers, and what it spent to answer it."""
    query: AggregateQuery
    estimate: float                      # result scale (count/sum: total)
    ci: Tuple[float, float]              # result scale, at `confidence`
    mean: float                          # per-frame scale
    n_sampled: int                       # estimation-stream sample count
    oracle_calls: int                    # NOVEL oracle frames this run paid
    satisfied: bool                      # contract met / k confirmed
    terminated: str                      # contract | limit | census | budget
    rounds: int
    confirmations: List[int]             # LIMIT-k: confirmed frame indices
    allocation: np.ndarray               # per-chunk estimation counts
    decision_calls: np.ndarray           # per-chunk decision-stream counts
    cv_chunks: int                       # chunks with control variates on
    variance_reduction: float            # pooled naive var / CV var
    pricing: Dict                        # how µs were priced (provenance)
    ledger: BudgetLedger

    @property
    def half_width(self) -> float:
        return (self.ci[1] - self.ci[0]) / 2.0


class ContractExecutor:
    """Compiles an ``AggregateQuery`` into an adaptive sampling run.

    ``value_fn(idx) -> (B,) float`` is the oracle (adapted via
    ``make_value_fn`` when the oracle speaks object lists);
    ``verdict_fn(idx) -> (B,) or (B, d) float`` is the cheap filter tap
    (shared-cascade verdicts / count head) used as control variates —
    optional, and per-chunk *priced*: a chunk's verdict sweep (which
    pins the CV's exact chunk mean ``mu_Z``) only happens when the
    modelled variance shrink per microsecond beats spending those
    microseconds on oracle calls (``cv="auto"``; ``"eager"`` sweeps
    everything up front, ``"off"`` disables CVs).

    ``allocation="thompson"`` (default) runs the sample-split adaptive
    scheme from the module docstring: each chunk is pre-split into a
    decision pool (up to ``decision_cap`` frames) and an estimation
    pool; each round's batch is ``decision_frac`` decision frames
    (posterior food, while the pool lasts) plus estimation frames
    (estimator food).  ``allocation="uniform"`` is the classic baseline
    — frames drawn uniformly without replacement, every sample feeding
    the estimator (value-independent allocation needs no split, so its
    decision pool is empty).

    Termination: error contracts stop when the Student-t CI half-width
    (times ``safety``) clears ``± eps``; ``limit=k`` stops at exactly k
    oracle-confirmed frames (frame-at-a-time allocation, so the k-th
    confirmation is the last oracle call); a census (every frame
    oracled) stops with a zero-width interval; ``max_oracle`` caps the
    novel-frame spend (``satisfied=False`` if the contract was not met
    by then).  After the stopping condition fires, NO further frame is
    decoded, filtered, or oracled — the spend counters are provably
    flat (tests/test_torch_contracts.py pins this).

    ``device`` (default CUDA, raising when absent) is where
    ``chunk_accumulators`` builds its accumulators; the allocation loop
    itself is host numpy."""

    def __init__(self, query: AggregateQuery,
                 value_fn: Callable[[np.ndarray], np.ndarray],
                 n_frames: int, *,
                 verdict_fn: Optional[Callable[[np.ndarray],
                                               np.ndarray]] = None,
                 n_chunks: int = 8, min_batch: int = 8,
                 min_per_chunk: int = 2, prior_strength: float = 1.0,
                 safety: float = 1.1, allocation: str = "thompson",
                 decision_frac: float = 0.25, decision_cap: int = 40,
                 cv: str = "auto", cost_model=None,
                 ledger: Optional[BudgetLedger] = None,
                 max_oracle: Optional[int] = None,
                 min_samples: int = 48,
                 sweep_batch: int = 256, seed: int = 0,
                 chunk_oracle_cost: Optional[Sequence[float]] = None,
                 device: DeviceLike = None):
        from repro_torch.core import costmodel as CM
        if n_frames < 1:
            raise ValueError(f"n_frames must be >= 1, got {n_frames}")
        if allocation not in ("thompson", "uniform"):
            raise ValueError(f"allocation must be 'thompson' or 'uniform', "
                             f"got {allocation!r}")
        if cv not in ("auto", "eager", "off"):
            raise ValueError(f"cv must be 'auto', 'eager' or 'off', "
                             f"got {cv!r}")
        if min_batch < 1:
            raise ValueError(f"min_batch must be >= 1, got {min_batch}")
        if not 0.0 < decision_frac < 1.0:
            raise ValueError(f"decision_frac must be in (0, 1), "
                             f"got {decision_frac}")
        if safety < 1.0:
            raise ValueError(f"safety must be >= 1 (it absorbs sequential-"
                             f"stopping anti-conservatism), got {safety}")
        self.device = resolve_device(device)
        self.query = query
        self.value_fn = value_fn
        self.verdict_fn = verdict_fn
        self.n_frames = int(n_frames)
        self.n_chunks = max(1, min(int(n_chunks), self.n_frames))
        self.min_batch = int(min_batch)
        self.min_per_chunk = int(min_per_chunk)
        self.safety = float(safety)
        self.allocation = allocation
        self.decision_frac = float(decision_frac)
        self.decision_cap = int(decision_cap)
        self.cv = cv if verdict_fn is not None else "off"
        self.cost_model = (cost_model if cost_model is not None
                           else CM.default_cost_model())
        self.ledger = ledger if ledger is not None else BudgetLedger()
        self.max_oracle = (int(max_oracle) if max_oracle is not None
                           else self.n_frames)
        # a contract may not terminate before this many oracle frames —
        # tiny pilots underestimate variance (a handful of identical
        # draws looks like certainty), so buy a floor of evidence first
        self.min_samples = min(int(min_samples), self.n_frames,
                               self.max_oracle)
        self.sweep_batch = int(sweep_batch)
        self.rng = np.random.default_rng(seed)
        if chunk_oracle_cost is not None:
            coc = np.asarray(chunk_oracle_cost, np.float64)
            if coc.shape != (self.n_chunks,):
                raise ValueError(
                    f"chunk_oracle_cost must have one entry per chunk "
                    f"({self.n_chunks}), got shape {coc.shape}")
            if not np.all(np.isfinite(coc)) or np.any(coc <= 0):
                raise ValueError("chunk_oracle_cost entries must be "
                                 "positive and finite")
            self.chunk_oracle_cost: Optional[np.ndarray] = coc
        else:
            self.chunk_oracle_cost = None

        # contiguous chunk partition; each chunk's frames are shuffled
        # once up front and SPLIT into a decision pool (first
        # ``decision_cap`` positions — posterior food) and an estimation
        # pool (the rest).  The split is committed before any value is
        # seen, so the estimation pool is a uniform random subset of the
        # chunk and sampling it without replacement stays exactly
        # unbiased no matter what the decision stream observed (and a
        # without-replacement sample of the pool is, marginally, a
        # without-replacement sample of the chunk — the ordinary
        # finite-population correction against N_j applies).  The
        # uniform baseline and LIMIT search need no split (their
        # allocation never reads estimation values): decision pool 0.
        bounds = np.linspace(0, self.n_frames, self.n_chunks + 1)
        self.bounds = bounds.astype(np.int64)
        self.sizes = np.diff(self.bounds)
        self.weights = self.sizes / self.n_frames
        split = (allocation == "thompson" and query.limit is None)
        self._dec_pool = []
        self._est_pool = []
        for lo, hi in zip(self.bounds[:-1], self.bounds[1:]):
            perm = self.rng.permutation(np.arange(lo, hi))
            p = min(self.decision_cap, max(len(perm) // 4, 1)) \
                if split and len(perm) else 0
            self._dec_pool.append(perm[:p])
            self._est_pool.append(perm[p:])
        self._dec_cursor = np.zeros(self.n_chunks, np.int64)
        self._est_cursor = np.zeros(self.n_chunks, np.int64)

        self.post = ChunkPosteriors(self.n_chunks,
                                    prior_strength=prior_strength)
        self._y: List[List[np.ndarray]] = [[] for _ in range(self.n_chunks)]
        self._z: List[List[np.ndarray]] = [[] for _ in range(self.n_chunks)]
        self._n_est = np.zeros(self.n_chunks, np.int64)
        self._n_dec = np.zeros(self.n_chunks, np.int64)
        self._d: Optional[int] = None          # CV dimensionality (lazy)
        self._pooled_cache: Optional[Tuple[int, object]] = None
        self.mu_z = [None] * self.n_chunks     # exact chunk CV means (swept)
        # oracle/verdict result caches: a frame's decode+oracle (and its
        # cheap-filter tap) is paid for AT MOST ONCE; the ledger charges
        # novel frames only
        self._ycache: Dict[int, float] = {}
        self._zcache: Dict[int, np.ndarray] = {}
        self._unique = np.zeros(self.n_chunks, np.int64)
        # realized per-chunk oracle wall time: the batch's µs are split
        # evenly across its novel frames and attributed to their chunks,
        # so chunks whose frames decode/evaluate slower accumulate a
        # higher realized price
        self._chunk_us = np.zeros(self.n_chunks, np.float64)
        self._chunk_oracle_frames = np.zeros(self.n_chunks, np.int64)
        self._oracle_spent = 0                 # novel frames charged
        self._rounds = 0
        self.confirmations: List[int] = []

    # -- spend-charging, cache-aware oracle/filter taps -------------------

    def _chunk_of(self, frames: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.bounds, frames, side="right") - 1

    def _oracle(self, frames: np.ndarray) -> np.ndarray:
        """Per-frame oracle values; novel frames are charged (wall µs +
        frame count) and cached, repeats are free."""
        frames = np.asarray(frames, np.int64)
        novel = np.array(sorted({int(f) for f in frames
                                 if int(f) not in self._ycache}),
                         np.int64)
        if novel.size:
            t0 = time.perf_counter()
            vals = np.asarray(self.value_fn(novel), np.float64)
            us = (time.perf_counter() - t0) * 1e6
            self.ledger.charge_oracle(novel.size, us)
            self._oracle_spent += novel.size
            for f, v in zip(novel, vals):
                self._ycache[int(f)] = float(v)
            chunks = self._chunk_of(novel)
            np.add.at(self._unique, chunks, 1)
            np.add.at(self._chunk_us, chunks, us / novel.size)
            np.add.at(self._chunk_oracle_frames, chunks, 1)
        return np.array([self._ycache[int(f)] for f in frames], np.float64)

    def _verdicts(self, frames: np.ndarray) -> np.ndarray:
        frames = np.asarray(frames, np.int64)
        novel = np.array(sorted({int(f) for f in frames
                                 if int(f) not in self._zcache}),
                         np.int64)
        if novel.size:
            t0 = time.perf_counter()
            z = np.asarray(self.verdict_fn(novel), np.float64)
            us = (time.perf_counter() - t0) * 1e6
            self.ledger.charge_filter(novel.size, us)
            if z.ndim == 1:
                z = z[:, None]
            if self._d is None:
                self._d = z.shape[1]
            for f, row in zip(novel, z):
                self._zcache[int(f)] = row
        return np.stack([self._zcache[int(f)] for f in frames], axis=0)

    # -- pricing -----------------------------------------------------------

    def _oracle_price(self) -> Tuple[float, str]:
        """µs (or static cost units) per oracle frame + provenance."""
        model = self.cost_model.oracle_cost(1.0)
        if self.cost_model.source == "measured" and model is not None:
            return float(model), "measured"
        realized = self.ledger.oracle_us_per_frame()
        if realized is not None:
            return float(realized), "realized"
        if model is not None:                      # static relative units
            return float(model), "static"
        return 1.0, "unknown"                      # pragma: no cover

    def _chunk_prices(self) -> Tuple[np.ndarray, str]:
        """Per-chunk oracle price vector + provenance.  Preference order:
        an explicit ``chunk_oracle_cost`` knob; realized per-chunk wall
        time where a chunk has bought enough oracle frames to trust it
        (``min_per_chunk``), the uniform price filling the rest; else the
        uniform ``_oracle_price()`` broadcast."""
        if self.chunk_oracle_cost is not None:
            return self.chunk_oracle_cost.copy(), "explicit"
        uniform, src = self._oracle_price()
        prices = np.full(self.n_chunks, uniform, np.float64)
        seen = self._chunk_oracle_frames >= max(self.min_per_chunk, 1)
        if seen.any():
            prices[seen] = (self._chunk_us[seen]
                            / self._chunk_oracle_frames[seen])
            return prices, "realized-chunk"
        return prices, src

    def _filter_price(self) -> Tuple[float, str]:
        if self.ledger.filter_frames > 0 and self.ledger.filter_us > 0:
            return (self.ledger.filter_us / self.ledger.filter_frames,
                    "realized")
        # no filter evidence yet: assume the paper's premise (the filter
        # is ~STATIC_COST_ORACLE x cheaper than the oracle) so the first
        # sweep is not priced out before it can be measured
        from repro_torch.core.costmodel import STATIC_COST_ORACLE
        price, src = self._oracle_price()
        return price / STATIC_COST_ORACLE, f"assumed:{src}"

    # -- estimator ---------------------------------------------------------

    def _pooled_est(self):
        """Pooled CV fit over every estimation sample with a verdict tap
        (``aggregates.mcv_estimate`` — the same math ``CVAccumulator``
        streams; the accumulator form is exposed via
        ``pooled_accumulator()`` for the distributed_reduce fleet path).
        None while the pooled sample is degenerate.  Cached per
        estimation count — the fit is reused across the round's beta /
        sweep-pricing / reporting consumers."""
        if self._d is None:
            return None
        from repro_torch.core.aggregates import mcv_estimate
        n_key = int(self._n_est.sum())
        if self._pooled_cache is not None and \
                self._pooled_cache[0] == n_key:
            return self._pooled_cache[1]
        ys = [np.concatenate(c) for c, zc in zip(self._y, self._z) if zc]
        zs = [np.concatenate(zc, axis=0) for zc in self._z if zc]
        est = None
        if ys:
            y = np.concatenate(ys)
            z = np.concatenate(zs, axis=0)
            if y.size >= self._d + 3:
                try:
                    est = mcv_estimate(y, z, mu_z=z.mean(0))
                except (DegenerateSampleError, np.linalg.LinAlgError):
                    est = None                     # pragma: no cover
        self._pooled_cache = (n_key, est)
        return est

    def _beta(self) -> np.ndarray:
        """Pooled control-variate coefficients (zeros when CVs are off or
        the pooled sample is still degenerate)."""
        est = self._pooled_est()
        if est is None:
            return np.zeros(self._d or 0, np.float64)
        return np.asarray(est.beta, np.float64)

    def _chunk_residuals(self, j: int, beta: np.ndarray) -> np.ndarray:
        y = (np.concatenate(self._y[j]) if self._y[j]
             else np.zeros(0, np.float64))
        if beta.size and self.mu_z[j] is not None and self._z[j]:
            z = np.concatenate(self._z[j], axis=0)
            r = y - (z - self.mu_z[j][None, :]) @ beta
            # the pooled beta is fit mostly where variance lives; on a
            # chunk whose values barely move, the adjustment injects
            # verdict noise instead of removing value noise.  Use the
            # residuals only where they demonstrably shrink the chunk's
            # sample variance — both estimators are unbiased (mu_Z is
            # pinned exactly), so the selection costs O(1/n) at most.
            if r.size >= 2 and float(r.var(ddof=1)) < float(y.var(ddof=1)):
                return r
        return y

    def _exact_chunk_mean(self, j: int) -> float:
        lo, hi = int(self.bounds[j]), int(self.bounds[j + 1])
        return float(np.mean([self._ycache[f] for f in range(lo, hi)]))

    def _estimate(self) -> Tuple[float, float, int]:
        """Stratified (mean, variance-of-mean, df) over chunks, CV-adjusted
        where a chunk's verdict sweep pinned ``mu_Z``, exact (variance 0)
        where the oracle cache covers every frame of the chunk."""
        beta = self._beta()
        pooled_all = np.concatenate(
            [np.concatenate(c) for c in self._y if c]) \
            if any(self._y) else np.zeros(0, np.float64)
        pooled_var = float(pooled_all.var(ddof=1)) \
            if pooled_all.size >= 2 else 0.0
        mean = 0.0
        var = 0.0
        n_total = 0
        for j in range(self.n_chunks):
            if self.sizes[j] == 0:
                continue
            if self._unique[j] == self.sizes[j]:
                # census chunk: every frame's oracle value is cached —
                # the chunk contributes its exact mean, zero variance
                mean += self.weights[j] * self._exact_chunk_mean(j)
                continue
            r = self._chunk_residuals(j, beta)
            nj = r.size
            n_total += nj
            if nj == 0:
                # unsampled chunk (only possible with min_per_chunk=0):
                # fall back to the pooled mean/variance — unbiasedness is
                # gone for this chunk, so the warm-up default avoids it
                mean += self.weights[j] * (float(pooled_all.mean())
                                           if pooled_all.size else 0.0)
                var += self.weights[j] ** 2 * pooled_var
                continue
            y_chunk = np.concatenate(self._y[j])
            mean += self.weights[j] * float(r.mean())
            s2 = float(r.var(ddof=1)) if nj >= 2 else 0.0
            if nj < 2 or float(y_chunk.var(ddof=1)) == 0.0:
                # a run of identical draws has zero SAMPLE variance but
                # proves nothing about the chunk's spread — without a
                # floor the CI collapses dishonestly and the chunk is
                # starved while its rare frames go unseen.  For count
                # aggregates (Bernoulli values) the Jeffreys posterior
                # rate gives a principled, 1/n-decaying floor; generic
                # values fall back to the pooled variance.
                if self.query.agg == "count":
                    hits = float((y_chunk > 0).sum())
                    p = (hits + 0.5) / (nj + 1.0)
                    s2 = p * (1.0 - p)
                else:
                    s2 = pooled_var
            # estimation frames are (marginally) a without-replacement
            # uniform sample of the chunk, so the ordinary
            # finite-population correction applies
            s2 *= max(1.0 - nj / float(self.sizes[j]), 0.0)
            var += self.weights[j] ** 2 * (s2 / nj)
        d_eff = beta.size if beta.size else 0
        df = max(n_total - self.n_chunks - d_eff, 1)
        return mean, max(var, 0.0), df

    def _interval(self, mean: float, var: float, df: int) -> float:
        from scipy import stats as sps
        q = 0.5 + self.query.confidence / 2.0
        return float(sps.t.ppf(q, df)) * math.sqrt(var) * self.safety

    def _scale(self) -> float:
        return 1.0 if self.query.agg == "mean" else float(self.n_frames)

    def _contract_met(self, mean: float, half: float) -> bool:
        s = self._scale()
        if self.query.relative:
            # an all-zero sample has zero SAMPLE variance but proves
            # nothing about the true rate — a relative contract on a zero
            # estimate can only be discharged by a census
            if mean == 0.0:
                return False
            return half * s <= self.query.eps * abs(mean * s)
        return half * s <= self.query.eps

    # -- allocation --------------------------------------------------------

    def _dec_left(self, j: int) -> int:
        return len(self._dec_pool[j]) - int(self._dec_cursor[j])

    def _est_left(self, j: int) -> int:
        return len(self._est_pool[j]) - int(self._est_cursor[j])

    def _next_dec(self, j: int, b: int) -> np.ndarray:
        b = min(b, self._dec_left(j))
        lo = self._dec_cursor[j]
        self._dec_cursor[j] += b
        return self._dec_pool[j][lo:lo + b]

    def _next_est(self, j: int, b: int) -> np.ndarray:
        b = min(b, self._est_left(j))
        lo = self._est_cursor[j]
        self._est_cursor[j] += b
        return self._est_pool[j][lo:lo + b]

    def _eligible(self) -> List[int]:
        return [j for j in range(self.n_chunks) if self._est_left(j) > 0]

    def _pick_chunk(self, batch: int) -> Optional[int]:
        elig = self._eligible()
        if not elig:
            return None
        if self.allocation == "uniform":
            # uniform-over-remaining-frames baseline: chunk chosen with
            # probability proportional to its remaining pool
            rem = np.array([self._est_left(j) for j in elig], np.float64)
            return int(self.rng.choice(elig, p=rem / rem.sum()))
        if self.query.limit is not None:
            draws = self.post.draw_rates(self.rng)
            return max(elig, key=lambda j: draws[j])
        # error contract: variance shrink of moving this batch's
        # estimation draws into chunk j — d/dn of W_j^2 s_j^2 / n_j,
        # Thompson-sampled s_j^2 from the DECISION-stream posterior —
        # per microsecond of oracle time, priced PER CHUNK: an expensive
        # chunk must promise proportionally more shrink to win the batch
        # (``_chunk_prices`` — explicit knob, realized per-chunk wall
        # time, or the uniform fallback).  For count aggregates the
        # variance draw comes
        # from the Beta rate posterior (p(1-p)), the same family behind
        # the estimator's zero-spread floor: if the two disagreed, the
        # allocator would starve exactly the chunks whose floor
        # dominates the CI and the contract would never tighten.
        if self.query.agg == "count":
            p = self.post.draw_rates(self.rng)
            draws = p * (1.0 - p)
        else:
            draws = self.post.draw_vars(self.rng)
        n = np.maximum(self._n_est, 1)
        prices, _ = self._chunk_prices()
        score = (self.weights ** 2 * draws
                 * (1.0 / n - 1.0 / (n + batch))) \
            / np.maximum(prices * batch, 1e-12)
        return max(elig, key=lambda j: score[j])

    def _maybe_sweep_cv(self) -> None:
        """Priced lazy CV enablement: sweep the cheap filter over chunk j
        (pinning mu_Z so control variates switch on there) when the
        modelled variance shrink per µs beats the best oracle action."""
        if self.cv == "off" or self.verdict_fn is None:
            return
        todo = [j for j in range(self.n_chunks)
                if self.mu_z[j] is None and self.sizes[j] > 0]
        if not todo:
            return
        if self.cv != "eager":
            # estimate the CV's variance-reduction factor R^2 from the
            # pooled accumulator; before evidence exists, assume the
            # paper's regime (strongly correlated filter, R^2 ~ 0.5)
            r2 = 0.5
            e = self._pooled_est()
            if e is not None:
                r2 = min(max(1.0 - e.var / max(e.naive_var, 1e-30),
                             0.0), 1.0)
            f_price, _ = self._filter_price()
            o_price, _ = self._oracle_price()
            variances = self.post.variances()
            pooled = float(variances[self.post.n >= 2].mean()) \
                if (self.post.n >= 2).any() else 1.0
            keep = []
            for j in todo:
                nj = max(int(self._n_est[j]), 1)
                s2 = variances[j] if self.post.n[j] >= 2 else pooled
                shrink = self.weights[j] ** 2 * s2 * r2 / nj
                # the alternative use of the sweep's microseconds
                # (N_j * filter µs): the oracle calls they would buy on
                # the same chunk, shrinking 1/n_j -> 1/(n_j + afford).
                # Equal spend on both sides, so compare shrink directly.
                afford = max(self.sizes[j] * f_price / max(o_price, 1e-12),
                             1e-12)
                alt = self.weights[j] ** 2 * s2 \
                    * (1.0 / nj - 1.0 / (nj + afford))
                if shrink > alt and shrink > 0:
                    keep.append(j)
            todo = keep
        for j in todo:
            zs = []
            for lo in range(int(self.bounds[j]), int(self.bounds[j + 1]),
                            self.sweep_batch):
                hi = min(lo + self.sweep_batch, int(self.bounds[j + 1]))
                zs.append(self._verdicts(np.arange(lo, hi)))
            self.mu_z[j] = np.concatenate(zs, axis=0).mean(0)

    def _observe_est(self, j: int, frames: np.ndarray,
                     y: np.ndarray) -> None:
        """Fold estimation-stream samples into the estimator state (the
        allocator never reads these values — see module docstring)."""
        self._y[j].append(y)
        self._n_est[j] += len(frames)
        if self.cv != "off" and self.verdict_fn is not None:
            self._z[j].append(self._verdicts(frames))

    def _alloc_round(self, j: int, batch: int) -> None:
        """One allocation round on chunk j: ``decision_frac`` of the
        batch as decision frames (posterior food, while the chunk's
        decision pool lasts), the rest as estimation frames (estimator
        food).  The uniform baseline has an empty decision pool, so its
        whole batch is estimation."""
        b_dec = max(1, int(round(batch * self.decision_frac))) \
            if self._dec_left(j) > 0 else 0
        dec = self._next_dec(j, b_dec)
        if dec.size:
            y_dec = self._oracle(dec)
            self.post.update(j, y_dec)
            self._n_dec[j] += dec.size
        est = self._next_est(j, batch - dec.size)
        if est.size:
            self._observe_est(j, est, self._oracle(est))

    # -- main loop ---------------------------------------------------------

    def run(self) -> ContractResult:
        if self.query.limit is not None:
            return self._run_limit()
        return self._run_contract()

    def _finish_census(self) -> bool:
        """Every estimation pool is drained but the contract still is not
        met: oracle the remaining uncached frames (decision-pool tails)
        within budget.  True if the whole stream ended up cached — the
        answer is then exact."""
        for j in range(self.n_chunks):
            left = np.array([f for f in self._dec_pool[j][self._dec_cursor[j]:]
                             if int(f) not in self._ycache], np.int64)
            for lo in range(0, left.size, max(self.min_batch, 1)):
                if self._oracle_spent >= self.max_oracle:
                    return False
                tail = left[lo:lo + max(self.min_batch, 1)]
                self.post.update(j, self._oracle(tail))
                self._n_dec[j] += tail.size
            self._dec_cursor[j] = len(self._dec_pool[j])
        return bool((self._unique == self.sizes).all())

    def _run_contract(self) -> ContractResult:
        terminated = "budget"
        # warm-up: every chunk gets a minimal stake on BOTH streams so
        # each stratum has a variance estimate and the posterior draws
        # start from evidence, not the prior alone
        for j in range(self.n_chunks):
            if self.sizes[j] == 0 or \
                    self._oracle_spent >= self.max_oracle:
                continue
            dec = self._next_dec(j, self.min_per_chunk)
            if dec.size:
                self.post.update(j, self._oracle(dec))
                self._n_dec[j] += dec.size
            est = self._next_est(j, self.min_per_chunk)
            if est.size:
                self._observe_est(j, est, self._oracle(est))
        while True:
            self._maybe_sweep_cv()
            mean, var, df = self._estimate()
            half = self._interval(mean, var, df)
            if self._oracle_spent >= self.min_samples and \
                    self._contract_met(mean, half):
                terminated = "contract"
                break
            if self._oracle_spent >= self.max_oracle:
                # spending the whole budget may have decoded the whole
                # stream (max_oracle defaults to n_frames) — that is a
                # completed census, not a truncated run
                terminated = ("census"
                              if bool((self._unique == self.sizes).all())
                              else "budget")
                break
            if not self._eligible():
                terminated = ("census" if self._finish_census()
                              else "budget")
                break
            j = self._pick_chunk(self.min_batch)
            self._alloc_round(j, self.min_batch)
            self._rounds += 1
            self.ledger.rounds += 1
        mean, var, df = self._estimate()
        half = self._interval(mean, var, df)
        if terminated == "census":
            # every chunk is exact — the interval collapses
            half = 0.0
        satisfied = self._contract_met(mean, half) or terminated == "census"
        return self._result(mean, half, satisfied, terminated)

    def _run_limit(self) -> ContractResult:
        """ExSample search: frame-at-a-time Thompson allocation, stopping
        the instant the k-th instance is confirmed — the k-th
        confirmation is the LAST oracle call, under any chunk ordering."""
        k = self.query.limit
        terminated = "budget"
        while len(self.confirmations) < k:
            if self._oracle_spent >= self.max_oracle:
                terminated = ("census"
                              if bool((self._unique == self.sizes).all())
                              else "budget")
                break
            j = self._pick_chunk(1)
            if j is None:
                terminated = "census"
                break
            frames = self._next_est(j, 1)
            y = self._oracle(frames)
            self._y[j].append(y)
            self._n_est[j] += 1
            self.post.update(j, y)
            self._rounds += 1
            self.ledger.rounds += 1
            if y[0] > 0:
                self.confirmations.append(int(frames[0]))
                if len(self.confirmations) == k:
                    terminated = "limit"
                    break
        mean, var, df = self._estimate()
        half = self._interval(mean, var, df)
        return self._result(mean, half, len(self.confirmations) >= k,
                            terminated)

    def _result(self, mean: float, half: float, satisfied: bool,
                terminated: str) -> ContractResult:
        s = self._scale()
        o_price, o_src = self._oracle_price()
        f_price, f_src = self._filter_price()
        _, c_src = self._chunk_prices()
        e = self._pooled_est()
        vr = float(e.variance_reduction) if e is not None else 1.0
        return ContractResult(
            query=self.query, estimate=mean * s,
            ci=(mean * s - half * s, mean * s + half * s), mean=mean,
            n_sampled=int(self._n_est.sum()),
            oracle_calls=self._oracle_spent,
            satisfied=satisfied, terminated=terminated, rounds=self._rounds,
            confirmations=list(self.confirmations),
            allocation=self._n_est.copy(),
            decision_calls=self._n_dec.copy(),
            cv_chunks=sum(m is not None for m in self.mu_z),
            variance_reduction=float(vr),
            pricing={"oracle_us_per_frame": o_price,
                     "oracle_price_source": o_src,
                     "filter_us_per_frame": f_price,
                     "filter_price_source": f_src,
                     "chunk_price_source": c_src,
                     "cost_model": self.cost_model.source},
            ledger=self.ledger)

    # -- fleet hook --------------------------------------------------------

    def chunk_accumulators(self) -> List[CVAccumulator]:
        """Per-chunk float64 ``CVAccumulator``s on ``device`` over the
        estimation-stream (y, z) pairs.  Merging them
        (``functools.reduce(CVAccumulator.merge, ...)``) reproduces the
        pooled accumulator — the same associative combination
        ``aggregates.distributed_reduce`` runs as three sums over a
        stream axis, which is how per-stream aggregate state pools."""
        d = self._d or 0
        accs = []
        for j in range(self.n_chunks):
            acc = CVAccumulator.init(d, device=self.device)
            if self._y[j]:
                y = np.concatenate(self._y[j])
                if d and self._z[j]:
                    z = np.concatenate(self._z[j], axis=0)
                else:
                    z = np.zeros((y.size, d))
                acc = acc.update(y, z)
            accs.append(acc)
        return accs

    def pooled_accumulator(self) -> CVAccumulator:
        accs = self.chunk_accumulators()
        return functools.reduce(lambda a, b: a.merge(b), accs)
