"""Streaming execution: hopping windows and multi-query multiplexing.

Maps the paper's query surface (``WINDOW HOPPING (SIZE n, ADVANCE BY m)``)
onto a batched executor that multiplexes the registered queries
(queries register/retire mid-stream; the shared-cascade engine is
rebuilt only when the registered set actually changes).  Plain Python
and numpy, as in the JAX package; its samplers, the straggler-dropping
``StreamExecutor``, auto-recalibration and the aggregate session are not
ported yet.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import os
import warnings
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np

from repro_torch.core.stats import SlotStats
from repro_torch.device import DeviceLike, resolve_device


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


# --------------------------------------------------------------------------
# Multi-query multiplexing (queries come and go mid-stream)
# --------------------------------------------------------------------------

def _accepts_kw(factory: Callable, name: str) -> bool:
    """Does the engine factory opt into receiving keyword ``name``
    (``slot_stats``, ``leaf_table``, ``step_cache``, ``device``)?

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
    coalesce a burst of registrations into one epoch bump."""

    def __init__(self, slot_stats: Optional[SlotStats] = None, *,
                 stats_path: Optional[str] = None,
                 leaf_table=None, step_cache=None):
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
        self.stats_path = stats_path
        if stats_path is not None and os.path.exists(stats_path):
            try:
                self.slot_stats.merge(SlotStats.load(stats_path))
            except (ValueError, OSError) as e:
                warnings.warn(f"ignoring unreadable SlotStats snapshot "
                              f"{stats_path!r}: {e}")

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

    ``device`` (default CUDA, raising when absent) is where the engines
    run.  ``on_window(result)`` fires after each hopping window and may
    register/retire queries (mid-stream multiplexing).
    """

    def __init__(self, registry: QueryRegistry,
                 engine_factory: Callable[...,
                                          Callable[[np.ndarray], np.ndarray]],
                 window: HoppingWindow, batch: int, *,
                 device: DeviceLike = None):
        self.registry = registry
        self.engine_factory = engine_factory
        self.window = window
        self.batch = batch
        self.device = resolve_device(device)
        self.rebuilds = 0
        self._epoch = -1
        self._engine: Optional[Callable] = None
        self._qids: Tuple[int, ...] = ()
        self._factory_kw = {name: _accepts_kw(engine_factory, name)
                            for name in ("slot_stats", "leaf_table",
                                         "step_cache", "device")}

    def _refresh(self):
        if self.registry.epoch != self._epoch:
            items = self.registry.active()
            self._qids = tuple(qid for qid, _ in items)
            if not items:
                self._engine = None
            else:
                queries = tuple(q for _, q in items)
                stores = {"slot_stats": self.registry.slot_stats,
                          "leaf_table": self.registry.leaf_table,
                          "step_cache": self.registry.step_cache,
                          "device": self.device}
                kw = {k: v for k, v in stores.items() if self._factory_kw[k]}
                self._engine = self.engine_factory(queries, **kw)
            self._epoch = self.registry.epoch
            self.rebuilds += 1
        return self._engine, self._qids

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
            if on_window is not None:
                on_window(res)                  # may mutate the registry
        return results
