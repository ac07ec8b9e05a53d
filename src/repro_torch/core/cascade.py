"""Filter-cascade query execution (paper §II, §IV-B).

Pipeline per frame batch:

    frames ──► trunk prefix (k layers) ──► branch head ──► predicate mask
                                                             │ pass?
                                              no ◄───────────┤
                                           (skip frame)      ▼ yes
                                                    oracle on the
                                                    compacted survivors

The cascade produces a boolean mask; survivors are compacted and, with
``oracle_bucket``, fed to the oracle in dense fixed-size index batches.
``FilterCascade`` stages one query's conjuncts (counts before locations;
``adaptive=True`` reorders them by observed pass rate and stops once the
conjunction is empty).  ``MultiQueryCascade`` / ``MultiQueryExecutor``
drive N registered queries off ONE shared filter evaluation
(``core.plan``) and one union-mask oracle pass, with the staged plan's
tier and row short-circuiting and the cost-model switch that parks
staging when it cannot win.

The executors take ``device=None`` (CUDA by default, raising when it is
absent) and check that the filter outputs they are handed lie there.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import query as Q
from repro_torch.core.filters import FilterOutputs
from repro_torch.core.stats import SlotStats
from repro_torch.device import DeviceLike, require_on, resolve_device


@dataclasses.dataclass
class CascadeStats:
    frames_in: int = 0
    filter_pass: int = 0
    oracle_calls: int = 0        # frames the oracle EVALUATED — includes
                                 # bucket padding, so cost models stay honest
    oracle_positives: int = 0
    filter_time_s: float = 0.0
    oracle_time_s: float = 0.0
    per_stage_pass: Optional[List[int]] = None
    per_query_pass: Optional[List[int]] = None   # multi-query attribution

    @property
    def selectivity(self) -> float:
        return self.filter_pass / max(self.frames_in, 1)

    def speedup_vs_full(self, oracle_ms: float, filter_ms: float) -> float:
        """Paper Table III metric: brute-force time / cascade time."""
        full = self.frames_in * oracle_ms
        ours = self.frames_in * filter_ms + self.oracle_calls * oracle_ms
        return full / max(ours, 1e-9)


def _stage_cost(pred: Q.Predicate) -> int:
    """Static cost model: count filters are cheaper than location filters."""
    if isinstance(pred, (Q.Count, Q.ClassCount)):
        return 0
    return 1


def _batch_size(batch) -> int:
    """Leading dimension of the first array-like leaf of ``batch``."""
    while isinstance(batch, (dict, list, tuple)):
        batch = next(iter(batch.values())) if isinstance(batch, dict) \
            else batch[0]
    return int(batch.shape[0])


class FilterCascade:
    """Compiles a query into ordered conjunctive stages and executes them.

    Stage pass rates accumulate in a ``SlotStats`` store keyed by the
    canonical stage predicate; pass ``slot_stats`` to share one store."""

    def __init__(self, query: Q.Predicate, *, tau: float = 0.2,
                 adaptive: bool = False,
                 slot_stats: Optional[SlotStats] = None):
        self.query = query
        self.tau = tau
        self.adaptive = adaptive
        if isinstance(query, Q.And):
            self.stages = sorted(query.terms, key=_stage_cost)
        else:
            self.stages = [query]
        self._stage_keys = [SlotStats.key(s) for s in self.stages]
        self.slot_stats = slot_stats if slot_stats is not None else SlotStats()

    def mask(self, out: FilterOutputs) -> torch.Tensor:
        """(B,) candidate mask, short-circuiting stages in order; the
        per-stage pass counts are fetched in one transfer at the end."""
        order = list(range(len(self.stages)))
        if self.adaptive:
            rates = self.slot_stats.pass_rates(self._stage_keys,
                                               canonical=True)
            order = list(np.argsort(rates, kind="stable"))
        m = None
        observed: List[Tuple[int, torch.Tensor]] = []
        for k, i in enumerate(order):
            mi = Q.eval_filters(self.stages[i], out, tau=self.tau)
            m = mi if m is None else (m & mi)
            observed.append((i, mi.sum()))
            if self.adaptive and k + 1 < len(order) and not bool(m.any()):
                break              # empty conjunction: skip later conjuncts
        counts = torch.stack([c for _, c in observed]).cpu().numpy()
        self.slot_stats.observe_many(
            [self._stage_keys[i] for i, _ in observed], counts,
            seen=float(m.shape[0]), canonical=True)
        return m


def compact_survivors(mask: torch.Tensor, *arrays: torch.Tensor,
                      bucket: Optional[int] = None):
    """Sort surviving frames to the front; pad to ``bucket``.

    Returns (n_survivors, gathered arrays, original indices).  ``bucket``
    must hold every survivor; an overflowing bucket raises."""
    B = mask.shape[0]
    order = torch.argsort((~mask).to(torch.int8), stable=True)
    n = int(mask.sum())
    bucket = bucket or B
    if bucket < B and n > bucket:
        raise ValueError(
            f"compact_survivors: {n} survivors exceed bucket={bucket}; "
            f"the order[:bucket] gather would drop {n - bucket} of them — "
            f"raise the bucket (or loop over fixed-size chunks like "
            f"bucketed_oracle)")
    idx = order[:bucket]
    gathered = tuple(a[idx] for a in arrays)
    return n, gathered, idx


def compact_indices(mask: np.ndarray, *, min_bucket: int = 8,
                    cap: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Host-side power-of-two bucketing of a boolean row mask.

    Returns ``(idx, n)``: the (bucket,) int32 vector of True-row indices
    padded by repeating the last survivor (so duplicate scatters write
    identical values) and the real survivor count.  The bucket is the
    smallest power of two >= max(n, min_bucket), capped at ``cap``."""
    mask = np.asarray(mask)
    idx = np.nonzero(mask)[0]
    n = int(idx.size)
    cap = int(cap) if cap is not None else int(mask.shape[0])
    bucket = max(1, int(min_bucket))
    while bucket < n:
        bucket <<= 1
    bucket = min(bucket, cap)
    if bucket < n:
        raise ValueError(f"compact_indices: cap={cap} cannot hold the "
                         f"{n} surviving rows")
    out = np.empty(bucket, np.int32)
    out[:n] = idx
    out[n:] = idx[-1] if n else 0
    return out, n


def bucketed_oracle(oracle_fn: Callable[[Any, np.ndarray], List],
                    batch, idx: np.ndarray,
                    bucket: Optional[int]) -> List:
    """Run the oracle over survivors in dense, fixed-size index batches
    (the tail padded by repeating the last survivor; padded results are
    dropped).  Without a bucket this is a single ragged call."""
    if idx.size == 0:
        return []
    if not bucket:
        return list(oracle_fn(batch, idx))
    out: List = []
    for k in range(0, idx.size, bucket):
        chunk = idx[k:k + bucket]
        pad = bucket - chunk.size
        if pad:
            chunk = np.concatenate(
                [chunk, np.full(pad, chunk[-1], chunk.dtype)])
        out.extend(list(oracle_fn(batch, chunk))[:bucket - pad])
    return out


def oracle_frames_evaluated(n_survivors: int, bucket: Optional[int]) -> int:
    """Frames ``bucketed_oracle`` runs the oracle on: survivors rounded up
    to whole buckets (the padding is real oracle work)."""
    if not bucket or n_survivors == 0:
        return n_survivors
    return -(-n_survivors // bucket) * bucket


@dataclasses.dataclass
class CascadeResult:
    answers: np.ndarray          # (B,) bool final query answers
    stats: CascadeStats


class CascadeExecutor:
    """End-to-end: filter head -> cascade mask -> oracle on survivors.

    ``filter_fn(batch) -> FilterOutputs`` is the branch head over the
    trunk prefix; its outputs must lie on ``device`` (default CUDA).
    ``oracle_fn(batch, idx) -> list[objects]`` is the expensive full
    evaluation."""

    def __init__(self, cascade: FilterCascade,
                 filter_fn: Callable[[Any], FilterOutputs],
                 oracle_fn: Callable[[Any, np.ndarray], List],
                 n_classes: int, grid: int,
                 oracle_bucket: Optional[int] = None,
                 device: DeviceLike = None):
        self.cascade = cascade
        self.filter_fn = filter_fn
        self.oracle_fn = oracle_fn
        self.n_classes = n_classes
        self.grid = grid
        self.oracle_bucket = oracle_bucket
        self.device = resolve_device(device)
        self.stats = CascadeStats()

    def run_batch(self, batch) -> CascadeResult:
        B = _batch_size(batch)
        t0 = time.perf_counter()
        fout = self.filter_fn(batch)
        require_on(fout.counts, self.device, "filter outputs")
        mask = self.cascade.mask(fout).cpu().numpy()
        t1 = time.perf_counter()

        answers = np.zeros(B, bool)
        idx = np.nonzero(mask)[0]
        t2 = t1
        if idx.size:
            objs = bucketed_oracle(self.oracle_fn, batch, idx,
                                   self.oracle_bucket)
            t2 = time.perf_counter()
            for j, obj_list in zip(idx, objs):
                answers[j] = Q.eval_objects(self.cascade.query, obj_list,
                                            self.n_classes, self.grid)
        self.stats.frames_in += B
        self.stats.filter_pass += int(mask.sum())
        self.stats.oracle_calls += oracle_frames_evaluated(
            int(idx.size), self.oracle_bucket)
        self.stats.oracle_positives += int(answers.sum())
        self.stats.filter_time_s += t1 - t0
        self.stats.oracle_time_s += t2 - t1
        return CascadeResult(answers=answers, stats=self.stats)


# --------------------------------------------------------------------------
# Multi-query shared cascade (repro_torch.core.plan)
# --------------------------------------------------------------------------

class MultiQueryCascade:
    """N concurrent queries driven off ONE shared filter evaluation.

    ``masks`` returns the per-query (B, N) candidate matrix.  With
    ``adaptive=True`` the plan runs *staged* (``plan.StagedQueryPlan``):
    cost tiers ordered by population pass rates from a ``SlotStats``
    store, short-circuiting tiers and rows once queries are decided.
    Observed pass rates feed back after every batch and the staging
    order is recomputed every ``restage_every`` batches.  At each such
    boundary the cascade compares the staged cost against the exhaustive
    plan's under the same ``cost_model`` and *parks* staging when it is
    not earning its keep (``mode`` is "staged" or "exhaustive"); a parked
    cascade runs ``evaluate_with_counts`` so the statistics keep
    learning, and probes staging again one batch per boundary.
    ``leaf_table`` / ``step_cache`` are the registry-owned stores that
    keep slot ids and built steps across plan rebuilds.

    A measured ``cost_model`` is also *watched*: each staged batch's
    predicted cost and observed wall time (host clock, after a device
    sync) feed a ``costmodel.CalibrationMonitor`` (pass
    ``calibration_monitor=`` to share one across epoch rebuilds, as
    ``QueryRegistry`` does), and at restage boundaries a drifted or stale
    model latches ``recalibration_due``.  The cascade never re-measures
    on its own; ``MultiQueryStreamExecutor(auto_recalibrate=True)`` or
    the operator acts on the flag."""

    def __init__(self, queries: Sequence[Q.Predicate], *, tau: float = 0.2,
                 adaptive: bool = False,
                 slot_stats: Optional[SlotStats] = None,
                 restage_every: int = 16,
                 step_overhead: Optional[float] = None,
                 min_bucket: Optional[int] = None, cost_model=None,
                 spatial_body: str = "auto",
                 calibration_monitor=None,
                 leaf_table=None, step_cache=None):
        from repro_torch.core import costmodel as CM
        from repro_torch.core.plan import QueryPlan
        self.queries = tuple(queries)
        self.tau = tau
        self.adaptive = adaptive
        self.restage_every = restage_every
        self.plan = QueryPlan(self.queries, tau=tau, leaf_table=leaf_table)
        if not adaptive:
            if slot_stats is not None:
                raise ValueError("slot_stats is only read/updated by the "
                                 "adaptive cascade; pass adaptive=True")
            if cost_model is not None:
                raise ValueError("cost_model only drives the adaptive "
                                 "cascade's staging decisions; pass "
                                 "adaptive=True")
            if calibration_monitor is not None:
                raise ValueError("calibration_monitor is only fed by the "
                                 "adaptive cascade's staged batches; pass "
                                 "adaptive=True")
            if step_cache is not None:
                raise ValueError("step_cache holds the adaptive cascade's "
                                 "staged steps; pass adaptive=True")
        if restage_every < 1:
            raise ValueError(f"restage_every must be >= 1, "
                             f"got {restage_every}")
        self.cost_model = (cost_model if cost_model is not None
                           else CM.default_cost_model() if adaptive
                           else CM.static_cost_model())
        self.step_overhead = (step_overhead if step_overhead is not None
                              else self.cost_model.step_overhead())
        self.slot_stats = (slot_stats if slot_stats is not None
                           else SlotStats()) if adaptive else None
        self._staged = (self.plan.build_staged(self.slot_stats,
                                               min_bucket=min_bucket,
                                               cost_model=self.cost_model,
                                               spatial_body=spatial_body,
                                               step_cache=step_cache)
                        if adaptive else None)
        self._batches = 0
        self._last_batch: Optional[int] = None
        self._cost_staged = 0.0      # modelled cost of staged batches
        self._staged_batches = 0     # batches behind _cost_staged
        self.mode = "staged" if adaptive else "exhaustive"
        self.restages = 0
        # drift watch: measured models are monitored by default (one
        # perf_counter pair + an EWMA update per staged batch); the
        # monitor only flags — ``recalibration_due`` latches at the next
        # restage boundary and an opt-in consumer re-measures
        self.calibration_monitor = (
            calibration_monitor if calibration_monitor is not None
            else CM.CalibrationMonitor(self.cost_model)
            if adaptive and self.cost_model.source == "measured" else None)
        if self.calibration_monitor is not None \
                and self.calibration_monitor.active \
                and self.cost_model.source != "measured":
            # abstract static units against wall microseconds would be
            # garbage drift (and, under auto mode, spurious re-profiles)
            warnings.warn(
                "calibration_monitor watches a measured model but this "
                "cascade prices with the static model; its drift ledger "
                "will not be fed — pass "
                "cost_model=calibration_monitor.model to monitor")
        self.recalibration_due = False
        self._monitor_gen = (self.calibration_monitor.generation
                             if self.calibration_monitor is not None
                             else -1)

    def _run_staged(self, out: FilterOutputs,
                    presumed_decided=None) -> torch.Tensor:
        monitor = self.calibration_monitor
        watch = (monitor is not None and monitor.active
                 and self.cost_model.source == "measured")
        if watch:
            t0 = time.perf_counter()
        m = self._staged.evaluate(out, presumed_decided=presumed_decided)
        if watch:
            if m.is_cuda:
                torch.cuda.synchronize(m.device)
            wall_us = (time.perf_counter() - t0) * 1e6
        self._staged.flush_stats(self.slot_stats)
        rep = self._staged.last_report
        predicted = rep.cost_run + self.step_overhead * rep.stages_run
        self._cost_staged += predicted
        self._staged_batches += 1
        # a batch that built new steps spent its wall time building, not
        # executing: feeding it would latch a calibrated model as drifted
        if watch and rep.steps_compiled == 0:
            monitor.observe(predicted, wall_us)
        return m

    def masks(self, out: FilterOutputs,
              presumed_decided=None) -> torch.Tensor:
        """(B, N) per-query candidate masks.  ``presumed_decided`` is a
        work-skipping hint for the staged path only (see
        ``StagedQueryPlan.evaluate``)."""
        if self._staged is None:
            return self.plan.evaluate(out)
        self._batches += 1
        self._last_batch = int(out.counts.shape[0])
        boundary = self._batches % self.restage_every == 0
        # the exhaustive program evaluates EVERY leaf, so it cannot run a
        # grid-needing plan on count-only (OD-COF) outputs
        exhaustive_infeasible = self.plan._needs_grid and out.grid is None
        if self.mode == "staged" or boundary or exhaustive_infeasible:
            m = self._run_staged(out, presumed_decided)  # boundary probes
        else:
            m, counts = self.plan.evaluate_with_counts(out)
            self.slot_stats.observe_many(self.plan.live_slot_keys,
                                         counts.cpu().numpy(), m.shape[0],
                                         canonical=True)
        if boundary:
            # park or un-park staging on the cost balance, then re-sort
            # the stages from the freshest population rates
            exhaustive_cost = self.plan.exhaustive_cost_model(
                self.cost_model, batch=self._last_batch)
            observed = (self._cost_staged / self._staged_batches
                        if self._staged_batches else float("inf"))
            if self.mode == "staged":
                decide = observed
            else:
                decide = min(observed, self._staged.predicted_batch_cost(
                    self.slot_stats, self.step_overhead,
                    batch=self._last_batch))
            self.mode = "staged" if decide < exhaustive_cost \
                else "exhaustive"
            self._cost_staged = 0.0
            self._staged_batches = 0
            self.restages += int(self._staged.restage(self.slot_stats))
            # the drift check rides the same boundary: latch (sticky
            # across transient decay) until the monitor is reset
            monitor = self.calibration_monitor
            if monitor is not None:
                if monitor.should_recalibrate():
                    self.recalibration_due = True
                    self._monitor_gen = monitor.generation
                elif self.recalibration_due \
                        and monitor.generation != self._monitor_gen:
                    self.recalibration_due = False
        return m

    @property
    def staging_report(self):
        """Last staged batch's stage execution report (adaptive mode)."""
        return self._staged.last_report if self._staged is not None else None


@dataclasses.dataclass
class MultiCascadeResult:
    answers: np.ndarray          # (B, N) bool final per-query answers
    stats: CascadeStats


class MultiQueryExecutor:
    """Shared end-to-end cascade: one branch-head forward, one union-mask
    oracle compaction, per-query exact answers on the survivors.

    The oracle runs once on frames where *any* query's filter passes;
    ``stats.per_query_pass`` attributes the surviving frames per query.
    Each surviving frame's object list is parsed into an ``ObjectTable``
    once and shared by every query probing that frame.  The filter
    outputs must lie on ``device`` (default CUDA).  ``budget_ledger``
    (an ``aggregates.BudgetLedger``, e.g. the ``QueryRegistry``'s) is
    charged once per call: the filter frames and µs, and the oracle
    frames (bucket padding included) and µs — the account the aggregate
    half (``ContractExecutor``) charges too."""

    def __init__(self, cascade: MultiQueryCascade,
                 filter_fn: Callable[[Any], FilterOutputs],
                 oracle_fn: Callable[[Any, np.ndarray], List],
                 n_classes: int, grid: int,
                 oracle_bucket: Optional[int] = None,
                 budget_ledger=None, device: DeviceLike = None):
        self.cascade = cascade
        self.filter_fn = filter_fn
        self.oracle_fn = oracle_fn
        self.n_classes = n_classes
        self.grid = grid
        self.oracle_bucket = oracle_bucket
        self.budget_ledger = budget_ledger
        self.device = resolve_device(device)
        self.stats = CascadeStats(
            per_query_pass=[0] * len(cascade.queries))

    def run_batch(self, batch) -> MultiCascadeResult:
        B = _batch_size(batch)
        N = len(self.cascade.queries)
        t0 = time.perf_counter()
        fout = self.filter_fn(batch)
        require_on(fout.counts, self.device, "filter outputs")
        masks = self.cascade.masks(fout).cpu().numpy()        # (B, N)
        t1 = time.perf_counter()

        union = masks.any(1)
        idx = np.nonzero(union)[0]
        answers = np.zeros((B, N), bool)
        t2 = t1
        if idx.size:
            objs = bucketed_oracle(self.oracle_fn, batch, idx,
                                   self.oracle_bucket)
            t2 = time.perf_counter()
            for j, obj_list in zip(idx, objs):
                table = Q.ObjectTable.from_objects(obj_list)  # parse ONCE
                for qi in np.nonzero(masks[j])[0]:
                    answers[j, qi] = Q.eval_objects(
                        self.cascade.queries[qi], table,
                        self.n_classes, self.grid)
        self.stats.frames_in += B
        self.stats.filter_pass += int(union.sum())
        self.stats.oracle_calls += oracle_frames_evaluated(
            int(idx.size), self.oracle_bucket)
        self.stats.oracle_positives += int(answers.any(1).sum())
        for qi in range(N):
            self.stats.per_query_pass[qi] += int(masks[:, qi].sum())
        self.stats.filter_time_s += t1 - t0
        self.stats.oracle_time_s += t2 - t1
        if self.budget_ledger is not None:
            self.budget_ledger.charge_filter(B, (t1 - t0) * 1e6)
            self.budget_ledger.charge_oracle(
                oracle_frames_evaluated(int(idx.size), self.oracle_bucket),
                (t2 - t1) * 1e6)
        return MultiCascadeResult(answers=answers, stats=self.stats)
