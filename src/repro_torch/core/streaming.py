"""Streaming execution: windows, samplers, multi-query multiplexing and
the aggregate session.

Maps the paper's query surface (``WINDOW HOPPING (SIZE n, ADVANCE BY m)``)
and its sampling-based aggregate evaluation onto a batched executor that
multiplexes the registered queries (queries register/retire mid-stream;
the shared-cascade engine is rebuilt only when the registered set
actually changes), keeps the cost model fresh
(``MultiQueryStreamExecutor(auto_recalibrate=True)`` re-runs
``costmodel.calibrate`` when the registry's ``CalibrationMonitor`` flags
drift), and runs error-bounded aggregate contracts against the same
registry and budget ledger (``AggregateStreamSession``, whose verdict
tap reads the filter's tensors).  It also carries the production
concerns of a live deployment: per-window deadlines with frame dropping
(``StreamExecutor`` / ``StragglerPolicy`` — the stream does not wait for
a straggling device) and the fleet warm start
(``QueryRegistry(gossip_paths=)``, used by ``distributed.multistream``).
Otherwise plain Python and numpy, as in the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import os
import time
import warnings
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch.core.stats import SlotStats
from repro_torch.device import DeviceLike, require_on, resolve_device


@dataclasses.dataclass(frozen=True)
class HoppingWindow:
    """WINDOW HOPPING (SIZE size, ADVANCE BY advance) over frame ids.

    ``emit_partial`` controls the stream tail: by default (False, the
    paper's semantics — a window is a fixed-size aggregation unit) only
    full windows are emitted, so the last ``< size`` stretch of the
    stream is never covered by any window.  With ``emit_partial=True``
    the final scheduled window is emitted clamped to the stream end
    (``(start, n_frames)`` with ``start < n_frames``), so a monitoring
    deployment that must account for every ingested frame can opt in.
    With ``advance > size`` (sampling windows) the frames in the gap
    between the last full window and the next scheduled start are
    *skipped by design*, not a tail — they are never emitted under
    either setting."""
    size: int
    advance: int
    emit_partial: bool = False

    def windows(self, n_frames: int) -> Iterator[Tuple[int, int]]:
        start = 0
        while start + self.size <= n_frames:
            yield (start, start + self.size)
            start += self.advance
        if self.emit_partial and start < n_frames:
            yield (start, n_frames)


def stream_seed(base_seed: int, stream_id) -> int:
    """Per-stream seed derived from ``(base_seed, stream_id)``.

    S parallel streams configured with one base seed must not sample
    identical frame offsets (correlated sampling defeats the variance
    reduction the aggregate estimators assume).  Hashing the pair
    through blake2b gives each stream an independent, deterministic
    sub-seed — the JAX package's, bit for bit."""
    import hashlib
    h = hashlib.blake2b(f"{base_seed}:{stream_id}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big")


class FrameSampler:
    """Uniform sampling of frame indices within a window (w/o replacement).

    ``stream_id`` (optional) derives the rng seed via ``stream_seed`` so
    per-stream samplers built from one base seed draw independent
    sequences; without it the base seed is used directly."""

    def __init__(self, seed: int = 0, stream_id=None):
        if stream_id is not None:
            seed = stream_seed(seed, stream_id)
        self.rng = np.random.default_rng(seed)

    def sample(self, lo: int, hi: int, n: int) -> np.ndarray:
        """n distinct sorted indices from [lo, hi); clamped to the window.

        A degenerate window (``hi <= lo``) yields an empty sample rather
        than feeding ``rng.choice`` a negative size."""
        n = max(min(n, hi - lo), 0)
        return np.sort(self.rng.choice(np.arange(lo, max(hi, lo)), size=n,
                                       replace=False))


@dataclasses.dataclass
class StragglerPolicy:
    """Deadline-based frame dropping.

    A window of ``size`` frames at ``fps`` must complete within
    ``size / fps * slack``; when the executor falls behind, incoming
    frames are dropped (monitoring semantics: stale frames are worthless).
    """
    fps: float = 30.0
    slack: float = 1.0

    def deadline_s(self, n_frames: int) -> float:
        return n_frames / self.fps * self.slack


@dataclasses.dataclass
class StreamStats:
    frames_seen: int = 0
    frames_processed: int = 0
    frames_dropped: int = 0
    windows: int = 0
    wall_s: float = 0.0

    @property
    def drop_rate(self) -> float:
        return self.frames_dropped / max(self.frames_seen, 1)

    @property
    def fps(self) -> float:
        return self.frames_processed / max(self.wall_s, 1e-9)


class StreamExecutor:
    """Drives a per-batch processing fn over a (simulated) live stream.

    ``process(batch_indices) -> None`` is charged against the deadline;
    when cumulative processing time exceeds the arrival clock, whole
    batches are dropped until the executor catches up (straggler
    mitigation at the ingest boundary).  A ``process`` that launches
    device work should synchronise before it returns, so the wall clock
    it is charged covers that work.
    """

    def __init__(self, process: Callable[[np.ndarray], None],
                 batch: int, policy: StragglerPolicy):
        self.process = process
        self.batch = batch
        self.policy = policy
        self.stats = StreamStats()

    def run(self, n_frames: int,
            simulate_slow: Optional[Callable[[int], float]] = None):
        """Drive the stream.  ``budget`` is the processor's slack against
        the arrival clock: each batch's arrival interval is credited, each
        processed batch's cost is charged.  The drop decision is made the
        moment a batch arrives, against the slack accrued *so far* — the
        incoming batch's own interval must not subsidize it.  A dropped
        batch still advances the arrival clock — its interval elapses
        whether or not the frames are processed, and that elapsed time is
        exactly how the processor catches back up.

        ``simulate_slow(lo) -> seconds`` *replaces* the wall-clock charge
        for the batch (it does not add to it), so simulated traces are
        bit-deterministic."""
        t_start = time.perf_counter()
        arrival_per_batch = self.batch / self.policy.fps * self.policy.slack
        budget = 0.0
        for lo in range(0, n_frames, self.batch):
            idx = np.arange(lo, min(lo + self.batch, n_frames))
            self.stats.frames_seen += idx.size
            if budget < 0:                      # behind schedule: drop
                self.stats.frames_dropped += idx.size
                budget += arrival_per_batch     # arrival clock still runs
                continue
            budget += arrival_per_batch
            t0 = time.perf_counter()
            self.process(idx)
            if simulate_slow is not None:
                budget -= simulate_slow(lo)
            else:
                budget -= time.perf_counter() - t0
            self.stats.frames_processed += idx.size
        self.stats.wall_s = time.perf_counter() - t_start
        return self.stats


# --------------------------------------------------------------------------
# Multi-query multiplexing (queries come and go mid-stream)
# --------------------------------------------------------------------------

def _accepts_kw(factory: Callable, name: str) -> bool:
    """Does the engine factory opt into receiving keyword ``name``
    (``slot_stats``, ``calibration_monitor``, ``leaf_table``,
    ``step_cache``, ``budget_ledger``, ``device``)?

    Opt-in is by parameter NAME — never by arity: a legacy one-arg
    factory that happens to carry an unrelated second default
    (``def factory(queries, tau=0.2)``) must not silently receive a
    SlotStats object as ``tau``."""
    try:
        params = inspect.signature(factory).parameters
    except (TypeError, ValueError):
        return False
    p = params.get(name)
    return p is not None and p.kind in (
        inspect.Parameter.POSITIONAL_OR_KEYWORD,
        inspect.Parameter.KEYWORD_ONLY)


class QueryRegistry:
    """Live set of registered queries with epoch versioning.

    ``epoch`` bumps on every register/retire, so executors rebuild their
    shared-cascade plan lazily — only when the set changed, never per
    batch.  The registry owns the epoch-surviving stores every rebuilt
    engine inherits: the population's ``SlotStats`` (learned per-slot
    selectivities and stage ledgers), the ``plan.CanonicalLeafTable``
    (stable slot ids) and the ``stepcache.StepCache`` (built staged
    steps).  ``stats_path`` merges a ``SlotStats.save`` snapshot at
    construction (a corrupt one is ignored with a warning) and
    ``save_stats()`` writes it back.  ``batch()`` / ``register_many``
    coalesce a burst of registrations into one epoch bump.

    ``calibration_monitor`` (a ``costmodel.CalibrationMonitor``) rides
    along like the stats store, so the cost model's drift ledger
    survives plan rebuilds; ``MultiQueryStreamExecutor(
    auto_recalibrate=True)`` reads it.  ``budget_ledger`` (an
    ``aggregates.BudgetLedger``, a fresh one by default) is the
    population's single spend account: the filter half
    (``MultiQueryExecutor``) and the aggregate half
    (``AggregateStreamSession``) both charge it.

    ``gossip_paths`` is the fleet-scale variant of ``stats_path``: a list
    of PEER workers' snapshot files, merged on top at construction
    (``SlotStats.load_merged`` — corrupt peers skipped with a warning),
    so a new worker joining a fleet inherits the population's pooled
    selectivity priors and stage ledgers instead of cold-starting its
    stage order."""

    def __init__(self, slot_stats: Optional[SlotStats] = None, *,
                 stats_path: Optional[str] = None,
                 gossip_paths: Optional[Sequence[str]] = None,
                 calibration_monitor=None,
                 leaf_table=None, step_cache=None,
                 budget_ledger=None):
        from repro_torch.core.aggregates import BudgetLedger
        from repro_torch.core.plan import CanonicalLeafTable
        from repro_torch.core.stepcache import StepCache
        self._next_id = 0
        self._active: Dict[int, Any] = {}
        self.epoch = 0
        self._batch_depth = 0
        self._batch_dirty = False
        self.slot_stats = slot_stats if slot_stats is not None else SlotStats()
        self.leaf_table = (leaf_table if leaf_table is not None
                           else CanonicalLeafTable())
        self.step_cache = (step_cache if step_cache is not None
                           else StepCache())
        self.budget_ledger = (budget_ledger if budget_ledger is not None
                              else BudgetLedger())
        self.calibration_monitor = calibration_monitor
        self.stats_path = stats_path
        if stats_path is not None and os.path.exists(stats_path):
            try:
                self.slot_stats.merge(SlotStats.load(stats_path))
            except (ValueError, OSError) as e:
                warnings.warn(f"ignoring unreadable SlotStats snapshot "
                              f"{stats_path!r}: {e}")
        if gossip_paths:
            # fleet warm start: peer snapshots merged on top of whatever
            # this worker already resumed from its own stats_path
            self.slot_stats.merge(SlotStats.load_merged(gossip_paths))

    def touch(self) -> None:
        """Bump the epoch without changing the query set, forcing every
        executor to rebuild its engine at the next batch boundary."""
        self._bump()

    def _bump(self) -> None:
        if self._batch_depth > 0:
            self._batch_dirty = True
        else:
            self.epoch += 1

    @contextlib.contextmanager
    def batch(self):
        """Coalesce every register/retire/touch inside the ``with`` into
        a single epoch bump at exit (none if nothing changed).  Reentrant;
        the bump happens even if the block raises."""
        self._batch_depth += 1
        try:
            yield self
        finally:
            self._batch_depth -= 1
            if self._batch_depth == 0 and self._batch_dirty:
                self._batch_dirty = False
                self.epoch += 1

    def register_many(self, queries: Sequence[Any]) -> List[int]:
        """Register a burst under one epoch bump; returns the new qids."""
        with self.batch():
            return [self.register(q) for q in queries]

    def save_stats(self, path: Optional[str] = None) -> str:
        """Snapshot the population store to ``path`` (default: the
        ``stats_path`` given at construction)."""
        p = path if path is not None else self.stats_path
        if p is None:
            raise ValueError("no path: pass save_stats(path) or construct "
                             "QueryRegistry(stats_path=...)")
        return self.slot_stats.save(p)

    def register(self, query) -> int:
        qid = self._next_id
        self._next_id += 1
        self._active[qid] = query
        self._bump()
        return qid

    def retire(self, qid: int) -> None:
        if qid not in self._active:
            raise ValueError(
                f"cannot retire query id {qid}: not registered (already "
                f"retired, or never issued by this registry); active ids: "
                f"{sorted(self._active)}")
        del self._active[qid]
        self._bump()

    def active(self) -> List[Tuple[int, Any]]:
        """(qid, query) pairs in registration order."""
        return sorted(self._active.items())

    def __len__(self) -> int:
        return len(self._active)


@dataclasses.dataclass
class WindowResult:
    span: Tuple[int, int]
    hits: Dict[int, int]        # qid -> frames answering True in the window
    frames: int


class MultiQueryStreamExecutor:
    """Windowed executor that multiplexes N concurrent queries per batch.

    ``engine_factory(queries) -> fn(batch_indices) -> (B, N) bool`` builds
    the shared evaluation (typically a ``MultiQueryExecutor`` over a
    ``MultiQueryCascade``); it is re-invoked only when the registry epoch
    moves, so registrations/retirements take effect at the next batch
    boundary.  A factory whose signature declares a parameter named
    ``slot_stats``, ``leaf_table``, ``step_cache`` or ``device`` receives
    the registry's store of that name (or the executor's device) as a
    keyword; the opt-in is by parameter name, never arity.

    ``calibration_monitor`` and ``budget_ledger`` opt into the
    registry's drift monitor and spend account the same way.

    ``device`` (default CUDA, raising when absent) is where the engines
    run.  ``on_window(result)`` fires after each hopping window and may
    register/retire queries (mid-stream multiplexing).

    ``auto_recalibrate=True`` closes the calibration-freshness loop
    (it needs a registry with a ``calibration_monitor``): at window
    boundaries, when the monitor flags drift or staleness, the executor
    runs ``recalibrate_fn`` (default ``costmodel.calibrate(save=True,
    device=device)``), resets the monitor around the fresh model, and
    bumps the registry epoch so the next batch rebuilds engines on the
    new coefficients.  Off by default: recalibration is seconds of
    foreground timing.
    """

    def __init__(self, registry: QueryRegistry,
                 engine_factory: Callable[...,
                                          Callable[[np.ndarray], np.ndarray]],
                 window: HoppingWindow, batch: int, *,
                 auto_recalibrate: bool = False,
                 recalibrate_fn: Optional[Callable[[], Any]] = None,
                 device: DeviceLike = None):
        self.registry = registry
        self.engine_factory = engine_factory
        self.window = window
        self.batch = batch
        self.device = resolve_device(device)
        self.rebuilds = 0
        self.recalibrations = 0
        self.auto_recalibrate = auto_recalibrate
        self.recalibrate_fn = recalibrate_fn
        if auto_recalibrate and registry.calibration_monitor is None:
            raise ValueError(
                "auto_recalibrate needs a drift signal: construct the "
                "registry with a costmodel.CalibrationMonitor "
                "(QueryRegistry(calibration_monitor=...)) and hand it to "
                "the adaptive cascade via the engine factory")
        self._epoch = -1
        self._engine: Optional[Callable] = None
        self._qids: Tuple[int, ...] = ()
        self._factory_kw = {name: _accepts_kw(engine_factory, name)
                            for name in ("slot_stats", "calibration_monitor",
                                         "leaf_table", "step_cache",
                                         "budget_ledger", "device")}

    def _refresh(self):
        if self.registry.epoch != self._epoch:
            items = self.registry.active()
            self._qids = tuple(qid for qid, _ in items)
            if not items:
                self._engine = None
            else:
                queries = tuple(q for _, q in items)
                stores = {"slot_stats": self.registry.slot_stats,
                          "calibration_monitor":
                              self.registry.calibration_monitor,
                          "leaf_table": self.registry.leaf_table,
                          "step_cache": self.registry.step_cache,
                          "budget_ledger": self.registry.budget_ledger,
                          "device": self.device}
                kw = {k: v for k, v in stores.items() if self._factory_kw[k]}
                self._engine = self.engine_factory(queries, **kw)
            self._epoch = self.registry.epoch
            self.rebuilds += 1
        return self._engine, self._qids

    def _maybe_recalibrate(self) -> bool:
        """Window-boundary freshness check (auto mode): re-measure when
        the shared monitor flags, install the fresh model, force an
        engine rebuild.  Never raises past a failed re-measure — a
        monitoring stream keeps answering on drifted coefficients rather
        than die re-profiling them."""
        monitor = self.registry.calibration_monitor
        if not (self.auto_recalibrate and monitor is not None
                and monitor.should_recalibrate()):
            return False
        from repro_torch.core import costmodel as CM
        fn = self.recalibrate_fn or (
            lambda: CM.calibrate(save=True, device=self.device))
        try:
            model = fn()
        except Exception as e:
            warnings.warn(f"auto-recalibration failed ({e}); keeping the "
                          f"current model")
            return False
        monitor.recalibrations += 1
        if model is None:
            # a recalibrate_fn that writes to disk and returns nothing:
            # reload through the normal resolver so the monitor adopts
            # the freshly saved coefficients
            model = CM.default_cost_model(device=self.device)
        monitor.reset(model)
        if model.source == "measured":
            # persist the bumped counters next to the fresh coefficients
            # (best effort: a read-only disk must not kill the run)
            try:
                CM.save_calibration(model, monitor=monitor)
            except (OSError, ValueError):
                pass
        if monitor.should_recalibrate():
            # still flagged right after a re-measure (e.g. the reloaded
            # model is static or past max_age): another attempt would
            # loop seconds-long re-profiles forever
            warnings.warn("recalibration did not clear the monitor's "
                          "flag; disabling auto_recalibrate")
            self.auto_recalibrate = False
        self.recalibrations += 1
        self.registry.touch()       # engines rebuild on the new model
        return True

    def run(self, n_frames: int,
            on_window: Optional[Callable[[WindowResult], None]] = None
            ) -> List[WindowResult]:
        results = []
        for lo, hi in self.window.windows(n_frames):
            hits: Dict[int, int] = {}
            started = None      # engine object already window-started
            for b0 in range(lo, hi, self.batch):
                idx = np.arange(b0, min(b0 + self.batch, hi))
                engine, qids = self._refresh()
                if engine is None:              # nothing registered
                    continue
                if engine is not started:
                    # stateful engines scope their state to the hopping
                    # window; the hook fires once per (window, engine)
                    hook = getattr(engine, "on_window_start", None)
                    if hook is not None:
                        hook(lo, hi)
                    started = engine
                ans = np.asarray(engine(idx))   # (B, n_active)
                for k, qid in enumerate(qids):
                    hits[qid] = hits.get(qid, 0) + int(ans[:, k].sum())
            res = WindowResult(span=(lo, hi), hits=hits, frames=hi - lo)
            results.append(res)
            self._maybe_recalibrate()           # drift check per window
            if on_window is not None:
                on_window(res)                  # may mutate the registry
        return results


class AggregateStreamSession:
    """One aggregate-contract run wired into a registry-backed stream.

    The paper's two query halves meet here: the session registers the
    contract's predicate in the shared ``QueryRegistry`` (same epoch and
    leaf-table lifecycle as every filter query), taps the shared plan's
    verdicts as the contract's control variates, and charges every
    oracle and filter microsecond to the registry's ``budget_ledger`` —
    the account ``MultiQueryExecutor(budget_ledger=...)`` charges too.

    ``filter_fn(idx) -> FilterOutputs`` fetches the cheap per-frame filter
    outputs for arbitrary frame indices, on ``device`` (default CUDA);
    ``oracle_fn(idx) -> [objects...]`` is the expensive detector.  The
    verdict tap runs the predicate's plan over the fetched outputs and —
    when the aggregate targets a class's object count — adds the count
    head's column for that class as a second control variate (BlazeIt's
    specialized counter).  Both columns move to the host as float64.

    Use as a context manager (the registration is retired on exit even
    when the run raises)::

        with AggregateStreamSession(registry, q, filter_fn=f,
                                    oracle_fn=o, n_frames=n,
                                    n_classes=c, grid=g) as sess:
            result = sess.run()
    """

    def __init__(self, registry: QueryRegistry, query, *,
                 filter_fn: Callable[[np.ndarray], Any],
                 oracle_fn: Callable[[np.ndarray], List],
                 n_frames: int, n_classes: int, grid: int,
                 tau: float = 0.2, cost_model=None, seed: int = 0,
                 device: DeviceLike = None, **executor_knobs):
        from repro_torch.core.cascade import MultiQueryCascade
        from repro_torch.core.contracts import ContractExecutor, make_value_fn
        dev = resolve_device(device)
        self.registry = registry
        self.query = query
        self.qid = registry.register(query.pred)
        self._retired = False
        cascade = MultiQueryCascade([query.pred], tau=tau,
                                    leaf_table=registry.leaf_table)
        cls = query.cls

        def verdict_fn(idx: np.ndarray) -> np.ndarray:
            fout = filter_fn(idx)
            require_on(fout.counts, dev, "filter outputs")
            cols = [cascade.masks(fout)[:, 0].double()]
            if cls is not None:
                cols.append(fout.counts[:, cls].double())
            return torch.stack(cols, dim=1).cpu().numpy()

        self.executor = ContractExecutor(
            query, make_value_fn(query, oracle_fn, n_classes, grid),
            n_frames, verdict_fn=verdict_fn, cost_model=cost_model,
            ledger=registry.budget_ledger, seed=seed, device=dev,
            **executor_knobs)

    def run(self):
        return self.executor.run()

    def close(self) -> None:
        if not self._retired:
            self.registry.retire(self.qid)
            self._retired = True

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()
