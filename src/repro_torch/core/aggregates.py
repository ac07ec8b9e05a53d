"""Monitoring aggregates with control variates (paper §III).

Single CV:      Y_cv = Ybar - beta (Xbar - mu_X),  beta* = Cov(Y,X)/Var(X)
                Var(Y_cv) = (1 - rho^2) Var(Ybar)
Multiple CV:    beta* = Sigma_ZZ^{-1} Sigma_YZ,
                Var(Y_cv) = (1 - R^2) Var(Ybar),
                R^2 = Sigma_YZ' Sigma_ZZ^{-1} Sigma_YZ / sigma_Y^2

Y is the oracle answer on sampled frames; Z are the (cheap, correlated)
filter answers on the same frames.  The estimators (``cv_estimate``,
``mcv_estimate``, ``CVEstimate``) are numpy, as in the JAX package.
``CVAccumulator`` keeps streaming joint moments as float64 tensors on a
device and is *mergeable* (Chan's combination is associative), so
per-stream accumulators pool with ``merge`` or with the three-sum
``distributed_reduce``.

The *state* side of the adaptive aggregate engine
(``repro_torch.core.contracts``) is numpy as well: ``ChunkPosteriors``
(per-chunk Beta / sampled-variance posteriors for Thompson allocation of
oracle calls, drawn from ``np.random.Generator`` exactly as the JAX
package draws them) and ``BudgetLedger`` (the oracle / filter spend
account that the filter and aggregate halves of the engine share).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


class DegenerateSampleError(ValueError):
    """Raised when an estimate is requested from too few samples.

    It survives ``python -O`` (an ``assert`` would not) and tells the
    caller how short the sample was (``n`` observed vs ``needed``), so
    adaptive executors can sample more instead of crashing."""

    def __init__(self, n: int, needed: int = 3):
        self.n = int(n)
        self.needed = int(needed)
        super().__init__(
            f"need >= {needed} samples to estimate (got {n}): the "
            f"residual variance has no degrees of freedom below that")


@dataclasses.dataclass
class CVEstimate:
    mean: float
    var: float                   # variance of the estimator (of the mean)
    naive_var: float             # plain sample-mean estimator variance
    beta: np.ndarray
    n: int

    @property
    def variance_reduction(self) -> float:
        """Paper Table IV metric: Var(naive) / Var(CV).

        Clamped at 1e4: when the filter answers every sampled frame
        exactly (rho ~ 1) the residual variance is ~0 and the raw ratio
        is numerically meaningless — report '>= 10^4' instead."""
        return min(self.naive_var / max(self.var, 1e-30), 1e4)

    def ci95(self) -> Tuple[float, float]:
        """95% CI with the Student-t quantile on the residual degrees of
        freedom (n - 1 - d for d control variates, the variance having
        been estimated from the same sample); it converges to 1.96 for
        large n."""
        from scipy import stats as sps
        df = max(int(self.n) - 1 - int(np.asarray(self.beta).size), 1)
        h = float(sps.t.ppf(0.975, df)) * math.sqrt(max(self.var, 0.0))
        return self.mean - h, self.mean + h


def cv_estimate(y: np.ndarray, x: np.ndarray,
                mu_x: Optional[float] = None) -> CVEstimate:
    """Single control variate (paper §III)."""
    return mcv_estimate(y, np.asarray(x)[:, None],
                        None if mu_x is None else np.array([mu_x]))


def mcv_estimate(y: np.ndarray, Z: np.ndarray,
                 mu_z: Optional[np.ndarray] = None) -> CVEstimate:
    """Multiple control variates (paper §III-A).

    y: (n,) oracle samples.  Z: (n, d) filter samples.
    When mu_z is None the sample mean is used (the paper does the same:
    'we use as mu_X the sample mean over the sampled X_i's'); the variance
    accounting then still reports the within-sample reduction.
    """
    y = np.asarray(y, np.float64)
    Z = np.asarray(Z, np.float64)
    n, d = Z.shape
    if y.shape[0] != n:
        raise ValueError(f"y has {y.shape[0]} samples but Z has {n}")
    if n < 3:
        raise DegenerateSampleError(n)
    ybar = y.mean()
    zbar = Z.mean(0)
    mu = zbar if mu_z is None else np.asarray(mu_z, np.float64)

    yc = y - ybar
    var_y = float(yc @ yc) / (n - 1)
    if d == 0:
        # no control variates: the naive sample mean (np.linalg.solve on
        # a (0, 0) system would crash)
        return CVEstimate(mean=float(ybar), var=var_y / n,
                          naive_var=var_y / n,
                          beta=np.zeros(0, np.float64), n=n)
    Zc = Z - zbar
    S_zz = (Zc.T @ Zc) / (n - 1)
    S_yz = (Zc.T @ yc) / (n - 1)
    # ridge for singular covariances (constant filters)
    beta = np.linalg.solve(S_zz + 1e-12 * np.eye(d), S_yz)

    mean_cv = float(ybar - beta @ (zbar - mu))
    resid = yc - Zc @ beta
    var_resid = float(resid @ resid) / (n - 1)
    return CVEstimate(mean=mean_cv, var=var_resid / n,
                      naive_var=var_y / n, beta=beta, n=n)


# --------------------------------------------------------------------------
# Streaming, mergeable joint-moment accumulator
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CVAccumulator:
    """Welford-style accumulator of joint moments of (Y, Z_1..Z_d).

    The fields are float64 tensors on one device: ``n`` (), ``mean``
    (1+d,) and ``M2`` (1+d, 1+d), the centred co-moment matrix.  A
    *stacked* accumulator carries a leading stream axis on every field
    (``n`` (S,), ``mean`` (S, 1+d), ``M2`` (S, 1+d, 1+d)); only
    ``distributed_reduce`` takes that form.
    """
    n: torch.Tensor
    mean: torch.Tensor
    M2: torch.Tensor

    @staticmethod
    def init(d: int, device: DeviceLike = None) -> "CVAccumulator":
        """Fresh accumulator with float64 moments on ``device`` (default
        CUDA).

        Welford co-moments accumulated in float32 drift on million-frame
        streams (catastrophic cancellation in M2 once mean * n dwarfs
        the per-batch deltas), and a float32 ``n`` stops counting
        exactly past 2^24 frames.  The JAX package therefore uses
        float64 only under ``jax_enable_x64`` and falls back to float32
        otherwise; torch has float64 on the card, so the port always
        accumulates in float64."""
        dev = resolve_device(device)
        k = 1 + d
        return CVAccumulator(
            n=torch.zeros((), dtype=torch.float64, device=dev),
            mean=torch.zeros((k,), dtype=torch.float64, device=dev),
            M2=torch.zeros((k, k), dtype=torch.float64, device=dev))

    def update(self, y, z) -> "CVAccumulator":
        """Batch update.  y: (b,), z: (b, d), tensors or arrays; they are
        moved to the accumulator's device and promoted to float64."""
        dt, dev = self.mean.dtype, self.mean.device
        y = torch.as_tensor(y, device=dev).to(dt)
        z = torch.as_tensor(z, device=dev).to(dt).reshape(
            y.shape[0], self.mean.shape[-1] - 1)
        v = torch.cat([y[:, None], z], dim=1)                # (b, k)
        b = torch.tensor(float(v.shape[0]), dtype=dt, device=dev)
        bm = v.mean(0)
        vc = v - bm
        bM2 = vc.T @ vc
        return _combine(self, CVAccumulator(n=b, mean=bm, M2=bM2))

    def merge(self, other: "CVAccumulator") -> "CVAccumulator":
        return _combine(self, other)

    def estimate(self, mu_z: Optional[np.ndarray] = None) -> CVEstimate:
        """The CV estimate from the moments; the (1+d)-sized solve runs on
        the host in float64."""
        n = float(self.n)
        if n < 3:
            raise DegenerateSampleError(int(n))
        mean = self.mean.detach().cpu().numpy().astype(np.float64)
        cov = self.M2.detach().cpu().numpy().astype(np.float64) / (n - 1)
        var_y = cov[0, 0]
        S_yz = cov[0, 1:]
        S_zz = cov[1:, 1:]
        d = S_zz.shape[0]
        if d == 0:
            # no control variates: the naive mean estimator
            return CVEstimate(mean=float(mean[0]), var=max(var_y, 0.0) / n,
                              naive_var=var_y / n,
                              beta=np.zeros(0, np.float64), n=int(n))
        beta = np.linalg.solve(S_zz + 1e-12 * np.eye(d), S_yz)
        mu = mean[1:] if mu_z is None else np.asarray(mu_z, np.float64)
        mean_cv = float(mean[0] - beta @ (mean[1:] - mu))
        var_resid = float(var_y - beta @ S_yz)
        return CVEstimate(mean=mean_cv, var=max(var_resid, 0.0) / n,
                          naive_var=var_y / n, beta=beta, n=int(n))


def _combine(a: CVAccumulator, b: CVAccumulator) -> CVAccumulator:
    """Chan et al. parallel co-moment combination (associative)."""
    n = a.n + b.n
    safe_n = torch.clamp(n, min=1.0)
    delta = b.mean - a.mean
    mean = a.mean + delta * (b.n / safe_n)
    M2 = a.M2 + b.M2 + torch.outer(delta, delta) * (a.n * b.n / safe_n)
    return CVAccumulator(n=n, mean=mean, M2=M2)


# --------------------------------------------------------------------------
# Adaptive-allocation state: per-chunk posteriors + the budget ledger
# --------------------------------------------------------------------------

class ChunkPosteriors:
    """Per-chunk posterior state for ExSample-style Thompson allocation.

    The stream is partitioned into ``n_chunks`` contiguous chunks; the
    allocator (``repro_torch.core.contracts.ContractExecutor``) decides,
    per oracle batch, WHICH chunk the next oracle calls go to by drawing
    from each chunk's posterior and taking the best draw.  Two posterior
    families cover the two query shapes:

    - ``draw_rates`` — Beta(prior + hits, prior + misses) over each
      chunk's Bernoulli result rate (LIMIT-k search, count contracts).
    - ``draw_vars`` — sampled per-chunk variance: ``s2 * df / chi2(df)``
      with ``prior_strength`` pseudo-observations of the pooled variance
      blended in, so one lucky low-variance chunk is not starved.

    All state is numpy on the host: posterior updates are a handful of
    scalar writes per oracle batch.
    """

    def __init__(self, n_chunks: int, *, prior_strength: float = 1.0):
        if n_chunks < 1:
            raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
        if prior_strength <= 0:
            raise ValueError(f"prior_strength must be > 0, "
                             f"got {prior_strength}")
        self.n_chunks = int(n_chunks)
        self.prior = float(prior_strength)
        self.n = np.zeros(n_chunks, np.int64)        # samples per chunk
        self.hits = np.zeros(n_chunks, np.float64)   # positive samples
        self.sum = np.zeros(n_chunks, np.float64)    # sum of y
        self.sumsq = np.zeros(n_chunks, np.float64)  # sum of y^2

    def update(self, chunk: int, y: np.ndarray,
               hits: Optional[np.ndarray] = None) -> None:
        """Fold one oracle batch's per-frame values (and, for LIMIT-k,
        the 0/1 confirmation outcomes) into chunk ``chunk``'s moments."""
        y = np.asarray(y, np.float64)
        self.n[chunk] += y.size
        self.sum[chunk] += y.sum()
        self.sumsq[chunk] += (y * y).sum()
        h = np.asarray(hits, np.float64) if hits is not None else y
        self.hits[chunk] += (h > 0).sum()

    def means(self) -> np.ndarray:
        return self.sum / np.maximum(self.n, 1)

    def variances(self) -> np.ndarray:
        """Per-chunk sample variances (0 where a chunk has < 2 samples —
        the posterior draw re-inflates those through the prior)."""
        n = np.maximum(self.n, 1)
        var = self.sumsq / n - (self.sum / n) ** 2
        var = np.where(self.n >= 2, var * n / np.maximum(n - 1, 1), 0.0)
        return np.maximum(var, 0.0)

    def draw_rates(self, rng: np.random.Generator) -> np.ndarray:
        """Thompson draw of each chunk's Bernoulli rate."""
        a = self.prior + self.hits
        b = self.prior + np.maximum(self.n - self.hits, 0.0)
        return rng.beta(a, b)

    def draw_vars(self, rng: np.random.Generator) -> np.ndarray:
        """Thompson draw of each chunk's variance (scaled-inv-chi2 with
        ``prior_strength`` pseudo-observations of the pooled variance)."""
        pooled = float(self.variances() @ np.maximum(self.n, 0)
                       / max(self.n.sum(), 1))
        pooled = max(pooled, 1e-12)
        df = self.prior + np.maximum(self.n - 1, 0.0)
        scale = (self.prior * pooled
                 + np.maximum(self.n - 1, 0.0) * self.variances()) / df
        return scale * df / rng.chisquare(df)

    def describe(self) -> Dict:
        return {"n": self.n.tolist(),
                "means": self.means().tolist(),
                "variances": self.variances().tolist()}


@dataclasses.dataclass
class BudgetLedger:
    """Where every microsecond of an aggregate query went.

    The filter half (``MultiQueryExecutor``) and the aggregate half
    (``ContractExecutor``) charge ONE ledger: oracle frames evaluated
    (bucket padding included, as ``CascadeStats.oracle_calls`` counts
    them), filter frames evaluated, and the wall microseconds of each.
    Each oracle call is charged exactly once, by the component that
    issued it."""
    oracle_calls: int = 0        # frames the oracle evaluated (incl. padding)
    oracle_us: float = 0.0
    filter_frames: int = 0       # frames the cheap filter evaluated
    filter_us: float = 0.0
    rounds: int = 0              # allocation rounds (aggregate half)

    def charge_oracle(self, frames: int, us: float = 0.0) -> None:
        self.oracle_calls += int(frames)
        self.oracle_us += float(us)

    def charge_filter(self, frames: int, us: float = 0.0) -> None:
        self.filter_frames += int(frames)
        self.filter_us += float(us)

    def oracle_us_per_frame(self) -> Optional[float]:
        """Realized mean oracle cost — the price the allocator falls back
        to when the ``CostModel`` carries no measured oracle coefficient
        (``costmodel.CostModel.oracle_cost``)."""
        if self.oracle_calls <= 0 or self.oracle_us <= 0:
            return None
        return self.oracle_us / self.oracle_calls

    def describe(self) -> Dict:
        return dataclasses.asdict(self)


def distributed_reduce(accs: Union[CVAccumulator, Sequence[CVAccumulator]],
                       axis_name: Optional[str] = None, *,
                       mesh=None) -> CVAccumulator:
    """Pool accumulators with three sums: Chan's combination written as
    sums of (n, n * mean, M2 + n * outer(mean, mean)), identical to a
    merge tree.

    With ``mesh`` (a ``DeviceMesh``; ``axis_name`` picks its axis, by
    default its only one) this is the JAX package's form: ``accs`` is the
    calling rank's accumulator, and the three sums are all-reduces over
    the axis's group (on host copies where that group is gloo and the
    moments lie on the card), so every rank returns the pooled
    accumulator.  Without a mesh it is the single-card form over a
    *stream* axis: ``accs`` is a list of accumulators (stacked here) or
    one accumulator whose fields carry the leading stream axis.

    The means are taken relative to one accumulator's (the largest's,
    the first on ties) before the sums, which changes nothing
    algebraically but keeps the raw second moments from cancelling when
    the values sit far from zero; over a mesh that costs one all-gather
    of each rank's (n, mean) beside the three all-reduces.
    """
    if mesh is not None:
        return _mesh_reduce(accs, mesh.get_group(axis_name))
    if isinstance(accs, CVAccumulator):
        n, mean, M2 = accs.n, accs.mean, accs.M2
    else:
        accs = list(accs)
        if not accs:
            raise ValueError("distributed_reduce needs at least one "
                             "accumulator")
        n = torch.stack([a.n for a in accs])
        mean = torch.stack([a.mean for a in accs])
        M2 = torch.stack([a.M2 for a in accs])
    if n.dim() != 1:
        raise ValueError(f"distributed_reduce wants a leading stream axis "
                         f"on n, got shape {tuple(n.shape)}")
    ref = mean[torch.argmax(n)]
    dm = mean - ref
    total = n.sum(0)
    s1 = (n[:, None] * dm).sum(0)
    raw2 = M2 + n[:, None, None] * dm[:, :, None] * dm[:, None, :]
    s2 = raw2.sum(0)
    safe_n = torch.clamp(total, min=1.0)
    shift = s1 / safe_n
    return CVAccumulator(n=total, mean=ref + shift,
                         M2=s2 - safe_n * torch.outer(shift, shift))


def _group_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``'s ranks (a new tensor on ``t``'s
    device; over gloo a card's tensor goes through a host copy)."""
    import torch.distributed as dist
    host = t.device.type != "cpu" and dist.get_backend(group) == "gloo"
    out = t.cpu() if host else t.clone()
    dist.all_reduce(out, group=group)
    return out.to(t.device) if host else out


def _mesh_reduce(acc: CVAccumulator, group) -> CVAccumulator:
    import torch.distributed as dist
    if not isinstance(acc, CVAccumulator) or acc.n.dim() != 0:
        raise ValueError("over a mesh, distributed_reduce takes this "
                         "rank's one (unstacked) accumulator")
    world = dist.get_world_size(group)
    mine = torch.cat([acc.n[None], acc.mean])
    parts = torch.zeros((world,) + tuple(mine.shape), dtype=mine.dtype,
                        device=mine.device)
    parts[dist.get_rank(group)] = mine
    parts = _group_sum(parts, group)    # the all-gather, as a sum
    ref = parts[torch.argmax(parts[:, 0]), 1:]
    dm = acc.mean - ref
    total = _group_sum(acc.n, group)
    s1 = _group_sum(acc.n * dm, group)
    s2 = _group_sum(acc.M2 + acc.n * torch.outer(dm, dm), group)
    safe_n = torch.clamp(total, min=1.0)
    shift = s1 / safe_n
    return CVAccumulator(n=total, mean=ref + shift,
                         M2=s2 - safe_n * torch.outer(shift, shift))

