"""Fleet-scale multi-stream serving: S camera streams, one staged plan.

The port of the JAX package's ``distributed/multistream.py``.  The
single-stream executors (``repro_torch.core.streaming``)
drive one camera through the shared multi-query cascade; a monitor
serves many cameras x many registered queries.  This module multiplexes
S streams through ONE ``StagedQueryPlan`` by stacking their per-chunk
filter outputs on a leading stream axis and running each staged tier as
one step over the stack (``StagedQueryPlan.evaluate_group``: the stream
axis is a batch dimension, so a tier's stats kernel runs once over the
S·B frames):

- **Hash routing.**  Streams are ordered by a stable hash of their ids
  (``route_streams``, the JAX package's blake2b hash, so positions and
  slots equal the reference's) and cut into contiguous slot blocks, one
  per rank of the process group; a stream keeps its stack position (and
  so its rank) across chunks and registry epochs.

- **The stream mesh.**  With a ``("stream",)`` mesh
  (``sharding.stream_mesh``, one rank per process of the group), each
  rank fetches, stacks and evaluates only its contiguous block of the
  streams: every group step runs under ``sharding.ShardMap`` (the
  reference's ``shard_map``) on the rank's block, so a tier's stats
  kernel runs over its (S / W)·B frames.  The staging decisions stay
  group-wide and equal on every rank: each stage's undecided table, the
  temporal tier's decided and suppressed flags, the prefetch's skip test
  and the straggler policy's wall clock are reduced over a gloo group on
  the host, the pass counts are summed into every rank's ``SlotStats``,
  and every restage takes rank 0's order.  ``run_chunk`` returns every
  stream's answers on every rank.  Where S does not divide over the
  mesh, ``spec_for`` falls back to replication, as in the reference:
  every rank runs all S streams, with no collective but the wall clock.

- **Prefetch.**  ``run_chunk(idx, next_idx)`` stages chunk k+1's stacked
  outputs one chunk ahead.  Outputs that ``fetch`` returns on the host
  are copied to the card with ``non_blocking=True`` on a side CUDA
  stream, behind an event the compute stream waits on before it reads
  them; outputs already on the card are only stacked.  The next chunk is
  staged after this chunk's answers are fetched, so its device work
  overlaps the host's bookkeeping between chunks; a chunk that will be
  skipped (below) is not staged at all.

- **Fleet warm start (gossip).**  The engine's ``SlotStats`` store
  typically comes from ``QueryRegistry(gossip_paths=[...])``
  (``SlotStats.load_merged``), so stage ordering starts from the
  fleet's pooled selectivity priors.

- **Fleet-wide temporal short-circuiting.**  When any registered query
  carries a temporal operator, the engine compiles the set through ONE
  shared ``TemporalProgram`` structure with per-stream automaton state,
  stages the *deduped frame signals* through the group plan, and
  advances all S windows at once with ``temporal.advance_group`` (one
  batched step over the stream axis).  Each stream's window-decided
  signal columns feed ``evaluate_group(presumed_decided=...)``; a chunk
  where EVERY stream's every query is window-decided skips fetch,
  stacking and the staged plan outright.  The executor fires
  ``on_window_start`` at hopping-window boundaries exactly as the
  single-stream loop does (including for engines rebuilt mid-window by
  registry churn, which cold-restart their automata).

Per-stream answers are bit-identical to running each stream serially
through ``MultiQueryStreamExecutor`` (pinned in
tests/test_torch_multistream.py), including under mid-stream
register/retire and per-stream skew.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import query as Q
from repro_torch.core.filters import FilterOutputs
from repro_torch.core.plan import QueryPlan
from repro_torch.core.streaming import (HoppingWindow, QueryRegistry,
                                        StragglerPolicy, StreamStats,
                                        _accepts_kw, stream_seed)
from repro_torch.core.temporal import (TemporalProgram, TemporalStats,
                                       advance_group)
from repro_torch.device import DeviceLike, require_on, resolve_device
from repro_torch.distributed import sharding as SH


# --------------------------------------------------------------------------
# Stream routing
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StreamContext:
    """One stream's fixed identity within the fleet executor.

    ``position`` is the stream's index on the stacked stream axis (fixed
    across chunks), ``slot`` the slot block it is routed to, ``seed`` the
    per-stream sampling seed derived via ``streaming.stream_seed`` so
    parallel streams never sample identical frame offsets."""
    stream_id: Any
    position: int
    slot: int
    seed: int


def _stream_hash(stream_id: Any) -> int:
    h = hashlib.blake2b(str(stream_id).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big")


def route_streams(stream_ids: Sequence[Any], n_slots: int, *,
                  base_seed: int = 0) -> List[StreamContext]:
    """Hash-route streams to fixed slots.

    Streams are ordered by a stable hash of their ids and cut into
    ``n_slots`` contiguous, balanced blocks.  The hash (not the raw id)
    decides adjacency, so consecutively-numbered cameras spread across
    slots; because it depends only on the id, a stream keeps its slot
    across restarts and across workers."""
    if len(set(stream_ids)) != len(stream_ids):
        raise ValueError("duplicate stream ids")
    n_slots = max(1, int(n_slots))
    ordered = sorted(stream_ids, key=lambda sid: (_stream_hash(sid),
                                                  str(sid)))
    S = len(ordered)
    return [StreamContext(stream_id=sid, position=i,
                          slot=i * n_slots // max(S, 1),
                          seed=stream_seed(base_seed, sid))
            for i, sid in enumerate(ordered)]


# --------------------------------------------------------------------------
# Group engine: stacked staged-plan evaluation
# --------------------------------------------------------------------------

class ShardedPlanGroupEngine:
    """Evaluates S streams' chunks through one shared staged plan.

    ``fetch(stream_ctx, idx) -> FilterOutputs`` supplies one stream's
    filter outputs for a chunk's frame indices (all streams advance in
    lockstep over the same stream-local frame schedule), on ``device``
    (default CUDA, raising when absent) or on the host, whence they are
    copied.  ``run_chunk`` stacks them on the stream axis and runs
    ``StagedQueryPlan.evaluate_group`` — group-uniform staging, one step
    per executed tier for the whole fleet slice.

    ``mesh`` (a ``("stream",)`` mesh from ``sharding.stream_mesh``, over
    an initialised process group: without one it raises) shards the
    streams: ``shard_wrap`` is a ``sharding.ShardMap`` and each rank
    serves its block ``local_streams``; where S does not divide over the
    mesh (``spec_for`` falls back to replication) ``shard_wrap`` is None
    and every rank serves all S.  ``wrap_sig`` is a content digest of
    the mesh (ranks, axis names, shape and spec), which keys the group
    steps so that rebuilt engines over the same mesh share them.

    ``slot_stats`` is the shared population ledger (typically the
    registry's, possibly gossip-warm-started): it orders the stages at
    construction and keeps learning from the group's full-batch tiers;
    every ``restage_every`` chunks the engine re-sorts its stage order
    from the live ledger.  ``cost_model`` prices the group steps
    (default: ``default_cost_model()``).  ``leaf_table`` / ``step_cache``
    are the registry's plan-lifecycle stores: with both, an epoch rebuild
    of this engine keeps its slot ids and re-hits every group step (and
    temporal step) whose signature did not change."""

    def __init__(self, queries: Sequence,
                 streams: Sequence[StreamContext],
                 fetch: Callable[[StreamContext, np.ndarray], FilterOutputs],
                 *, slot_stats=None, mesh=None, tau: float = 0.2,
                 cost_model=None, min_bucket: Optional[int] = None,
                 spatial_body: str = "auto", restage_every: int = 16,
                 leaf_table=None, step_cache=None,
                 device: DeviceLike = None):
        from repro_torch.core import costmodel as CM
        self.device = resolve_device(device)
        self.streams = sorted(streams, key=lambda c: c.position)
        if [c.position for c in self.streams] != list(range(len(streams))):
            raise ValueError("stream positions must be 0..S-1 "
                             "(use route_streams)")
        self.fetch = fetch
        self.slot_stats = slot_stats
        self.mesh = mesh
        self.restage_every = restage_every
        self.queries = tuple(queries)
        self._step_cache = step_cache
        S = len(self.streams)
        self.shard_wrap: Optional[SH.ShardMap] = None
        self.wrap_sig: Optional[Tuple] = None
        self._host: Optional[SH.MeshHost] = None
        self._block = slice(0, S)
        if mesh is not None:
            spec = SH.spec_for(("stream",), (S,), mesh, SH.DEFAULT_RULES)
            if len(spec) and spec[0] is not None:
                self.shard_wrap = SH.ShardMap(mesh, spec)
                self.wrap_sig = self.shard_wrap.signature()
                self._block = self.shard_wrap.block(S)
            # both raise without an initialised process group
            self._host = self.shard_wrap or SH.MeshHost(mesh)
        self.local_streams = self.streams[self._block]
        # temporal queries: plan over the deduped frame signals, keep
        # per-stream automaton state (shared structure, one window per
        # stream of this rank's block), advance the windows with one
        # batched step
        if any(Q.has_temporal(q) for q in self.queries):
            self.temporal: Optional[List[TemporalProgram]] = [
                TemporalProgram(self.queries, step_cache=step_cache,
                                device=self.device)
                for _ in self.local_streams]
            self.temporal_stats = TemporalStats()
            plan_queries = tuple(self.temporal[0].frame_queries)
        else:
            self.temporal = None
            self.temporal_stats = None
            plan_queries = self.queries
        self.plan = QueryPlan(plan_queries, tau=tau, leaf_table=leaf_table)
        self.cost_model = cost_model if cost_model is not None \
            else CM.default_cost_model(device=self.device)
        self.staged = self.plan.build_staged(
            slot_stats, min_bucket=min_bucket, cost_model=self.cost_model,
            spatial_body=spatial_body, step_cache=step_cache)
        self._agree()
        self._chunks = 0
        self._next: Optional[Tuple[Tuple[int, int, int], FilterOutputs,
                                   Optional[torch.cuda.Event]]] = None
        self._copy_stream: Optional[torch.cuda.Stream] = None

    @staticmethod
    def _key(idx: np.ndarray) -> Tuple[int, int, int]:
        return (int(idx[0]), int(idx[-1]), int(idx.size))

    def _stack(self, idx: np.ndarray
               ) -> Tuple[FilterOutputs, Optional[torch.cuda.Event]]:
        """Stack this rank's streams' chunk outputs on the stream axis, on
        the engine's device.  Host outputs bound for the card are copied
        on a side stream; the returned event marks the copy's end."""
        outs = [self.fetch(ctx, idx) for ctx in self.local_streams]
        counts = torch.stack([o.counts for o in outs])
        grid = None if outs[0].grid is None \
            else torch.stack([o.grid for o in outs])
        event = None
        if counts.device.type == "cpu" and self.device.type == "cuda":
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._copy_stream):
                counts = counts.pin_memory().to(self.device,
                                                non_blocking=True)
                if grid is not None:
                    grid = grid.pin_memory().to(self.device,
                                                non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._copy_stream)
        require_on(counts, self.device, "filter outputs")
        return FilterOutputs(counts=counts, grid=grid), event

    def prefetch(self, idx: np.ndarray) -> None:
        """Stage a chunk's stacked inputs ahead of time."""
        self._next = (self._key(idx), *self._stack(idx))

    def _take(self, idx: np.ndarray) -> FilterOutputs:
        """This chunk's stacked outputs: the prefetched ones when they
        are for ``idx``, else fetched now.  A side-stream copy is waited
        for on the compute stream, and its tensors are marked as used
        there (so the allocator does not hand their memory back to the
        side stream while the compute stream still reads them)."""
        if self._next is not None and self._next[0] == self._key(idx):
            _, outs, event = self._next
        else:
            outs, event = self._stack(idx)
        self._next = None
        if event is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(event)
            for t in (outs.counts, outs.grid):
                if t is not None:
                    t.record_stream(compute)
        return outs

    def stage_order(self) -> List[str]:
        """Current stage execution order (warm-start observability)."""
        return [self.staged.stages[si].name for si in self.staged.order]

    def on_window_start(self, lo: int, hi: int) -> None:
        """Hopping-window boundary: restart every stream's automaton
        window (no-op without temporal queries).  ``MultiStreamExecutor``
        fires this once per (window, engine) pair — including engines
        rebuilt mid-window by registry churn, which restart their
        automata from the current batch (the single-stream contract)."""
        if self.temporal is None:
            return
        for prog in self.temporal:
            prog.start_window(hi - lo)
        self.temporal_stats.windows += 1

    def _agree(self) -> None:
        """Under the wrap, every rank takes rank 0's stage and slot order
        (the summed pass counts keep the ledgers equal; this holds the
        order equal even where the ranks' ledgers started apart)."""
        if self.shard_wrap is not None:
            self.staged.adopt_staging(
                *self.shard_wrap.broadcast(self.staged.staging()))

    def _learn(self) -> None:
        if self.slot_stats is not None:
            self.staged.flush_stats(self.slot_stats)
            self._chunks += 1
            if self.restage_every and \
                    self._chunks % self.restage_every == 0:
                self.staged.restage(self.slot_stats)
                self._agree()

    def _assemble(self, local: np.ndarray) -> np.ndarray:
        """Every stream's rows on every rank: this rank's block, gathered
        over the mesh under the wrap."""
        return local if self.shard_wrap is None \
            else self.shard_wrap.gather(local)

    def chunk_seconds(self, seconds: float) -> float:
        """The chunk's wall time as the straggler policy charges it: the
        slowest rank's over a mesh, so every rank drops alike."""
        return seconds if self._host is None else self._host.max(seconds)

    def run_chunk(self, idx: np.ndarray,
                  next_idx: Optional[np.ndarray] = None) -> np.ndarray:
        """(S, B, N) bool answers for one chunk (every stream's, on every
        rank of a mesh); stages ``next_idx``'s inputs once this chunk's
        answers are on the host."""
        if self.temporal is not None:
            ans = self._run_chunk_temporal(idx)
        else:
            value = self.staged.evaluate_group(
                self._take(idx), shard_wrap=self.shard_wrap,
                wrap_sig=self.wrap_sig)
            ans = self._assemble(value.cpu().numpy())
            self._learn()
        if next_idx is not None and next_idx.size and \
                not self._skips_next():
            self.prefetch(next_idx)
        return ans

    def _skips_next(self) -> bool:
        """Will the next chunk skip fetching (every stream's every query
        window-decided, on every rank)?  Then there is nothing to
        prefetch."""
        if self.temporal is None:
            return False
        done = all(p.all_decided for p in self.temporal)
        return done if self.shard_wrap is None else self.shard_wrap.all(done)

    def _run_chunk_temporal(self, idx: np.ndarray) -> np.ndarray:
        """Temporal chunk path: staged frame signals (with per-stream
        ``presumed_decided`` suppression) -> one batched step advancing
        all S windows at once.  The fleet path has no oracle tier —
        filter masks ARE the per-frame signal verdicts (the engine's
        standing masks-as-answers semantics), so the automata consume
        them directly."""
        progs = self.temporal
        S, B = len(self.streams), int(idx.size)
        M = progs[0].n_signals
        wrap = dict(step_cache=self._step_cache, shard_wrap=self.shard_wrap,
                    wrap_sig=self.wrap_sig)
        # each stream's all-decided flag and suppressed signals, for every
        # stream of the fleet (gathered over the mesh under the wrap)
        flags = self._assemble(np.array(
            [[p.all_decided, *p.suppressed_signals()] for p in progs],
            bool).reshape(len(progs), 1 + M))
        ts = self.temporal_stats
        ts.frames_in += S * B
        tc = self.cost_model.temporal_cost(frames=B, batch=B)
        if tc is not None:
            ts.cost_temporal_model += S * tc
        if flags[:, 0].all():
            # every stream's every query is window-decided: skip fetch,
            # stacking, and the whole staged plan for this chunk
            self._next = None
            ts.frames_skipped += S * B
            ts.cost_saved_model += S * self.plan.exhaustive_cost_model(
                self.cost_model, batch=B)
            return self._assemble(advance_group(
                progs, torch.zeros((len(progs), B, M), dtype=torch.bool,
                                   device=self.device), **wrap))
        suppressed = flags[:, 1:]
        ts.signal_evals_skipped += B * int(suppressed.sum())
        value = self.staged.evaluate_group(
            self._take(idx), shard_wrap=self.shard_wrap,
            wrap_sig=self.wrap_sig,
            presumed_decided=suppressed if suppressed.any() else None)
        rep = self.staged.last_report
        if rep is not None:
            ts.cost_saved_model += rep.cost_presumed_saved
        self._learn()
        # suppressed columns carry UNSPECIFIED mask values (the staged
        # plan stopped evaluating them) — zero them before the automata;
        # every consumer of a suppressed signal is frozen or decided, so
        # the value is semantically irrelevant but must be deterministic
        live = torch.as_tensor(~suppressed[self._block],
                               device=value.device)
        return self._assemble(advance_group(
            progs, value & live[:, None, :], **wrap))


def plan_group_engine_factory(fetch, **engine_kw) -> Callable:
    """Adapter: a ``MultiStreamExecutor`` engine factory around
    ``ShardedPlanGroupEngine`` (``fetch(stream_ctx, idx)`` as above;
    ``engine_kw`` forwarded — mesh, tau, cost_model, ...)."""
    def factory(queries, streams, slot_stats=None, leaf_table=None,
                step_cache=None, device=None):
        return ShardedPlanGroupEngine(queries, streams, fetch,
                                      slot_stats=slot_stats,
                                      leaf_table=leaf_table,
                                      step_cache=step_cache, device=device,
                                      **engine_kw)
    return factory


# --------------------------------------------------------------------------
# The fleet executor
# --------------------------------------------------------------------------

@dataclasses.dataclass
class MultiWindowResult:
    span: Tuple[int, int]
    hits: Dict[Any, Dict[int, int]]     # stream id -> qid -> hit frames
    frames: int                         # per-stream frames in the window


class MultiStreamExecutor:
    """Windowed serving loop for S concurrent streams over one registry.

    The fleet analogue of ``MultiQueryStreamExecutor``: all streams
    advance in lockstep through the hopping-window schedule, and each
    chunk (one batch interval across every stream) is evaluated by a
    *group engine* built by ``engine_factory(queries, streams, ...) ->
    engine`` with ``engine.run_chunk(idx, next_idx) -> (S, B, N)`` — see
    ``plan_group_engine_factory``.  The factory is re-invoked only when
    the registry epoch moves, so mid-stream register/retire takes effect
    at the next chunk boundary exactly as in the single-stream executor.
    A factory that declares ``slot_stats``, ``leaf_table``,
    ``step_cache`` or ``device`` receives the registry's store of that
    name (or the executor's device, default CUDA, raising when absent);
    the opt-in is by parameter name.

    Per-stream ``StreamStats`` (frames seen/processed/dropped) and
    per-chunk latency samples are kept as ``StreamExecutor`` does for one
    stream; ``latency_percentile(p)`` reports the serving percentile.
    With a ``StragglerPolicy``, drop accounting runs per stream against
    the arrival clock (each stream is charged an equal 1/S share of the
    chunk's wall time, over a mesh the slowest rank's: the engine's
    ``chunk_seconds``); a behind stream's chunk results are discarded —
    its rows still ride the stacked step (group shapes are uniform), but
    stale answers are never reported.

    Streams are routed to ``n_slots`` contiguous slot blocks as the
    reference routes them; by default one per rank of the process group
    where one exists, else one.  ``on_window(result)`` fires after each
    window with per-stream hit counts and may mutate the registry
    (mid-stream multiplexing).
    """

    def __init__(self, registry: QueryRegistry, engine_factory: Callable,
                 window: HoppingWindow, batch: int,
                 stream_ids: Sequence[Any], *, n_slots: Optional[int] = None,
                 base_seed: int = 0,
                 policy: Optional[StragglerPolicy] = None,
                 device: DeviceLike = None):
        self.registry = registry
        self.engine_factory = engine_factory
        self.window = window
        self.batch = batch
        self.policy = policy
        self.device = resolve_device(device)
        if n_slots is None:
            n_slots = dist.get_world_size() if dist.is_available() and \
                dist.is_initialized() else 1
        self.streams = route_streams(stream_ids, n_slots,
                                     base_seed=base_seed)
        self.stats: Dict[Any, StreamStats] = {
            c.stream_id: StreamStats() for c in self.streams}
        self.chunk_latencies_s: List[float] = []
        self.rebuilds = 0
        self._epoch = -1
        self._engine = None
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
                self._engine = self.engine_factory(queries, self.streams,
                                                   **kw)
            self._epoch = self.registry.epoch
            self.rebuilds += 1
        return self._engine, self._qids

    def latency_percentile(self, p: float) -> float:
        """p-th percentile of per-chunk serving latency (seconds)."""
        if not self.chunk_latencies_s:
            return 0.0
        return float(np.percentile(self.chunk_latencies_s, p))

    def run(self, n_frames: int,
            on_window: Optional[Callable[[MultiWindowResult], None]] = None
            ) -> List[MultiWindowResult]:
        t_run = time.perf_counter()
        arrival = (self.batch / self.policy.fps * self.policy.slack
                   if self.policy is not None else 0.0)
        budget = {c.stream_id: 0.0 for c in self.streams}
        results = []
        for lo, hi in self.window.windows(n_frames):
            chunks = [np.arange(b0, min(b0 + self.batch, hi))
                      for b0 in range(lo, hi, self.batch)]
            hits: Dict[Any, Dict[int, int]] = {
                c.stream_id: {} for c in self.streams}
            # window-scoped engine hook (temporal automata): fired once
            # per (window, engine) pair — a mid-window rebuild gets the
            # hook too and cold-restarts its state
            started = None
            for k, idx in enumerate(chunks):
                engine, qids = self._refresh()
                if engine is None:
                    continue
                if engine is not started:
                    hook = getattr(engine, "on_window_start", None)
                    if hook is not None:
                        hook(lo, hi)
                    started = engine
                # drop decision at chunk arrival, against slack accrued
                # so far — the StreamExecutor discipline, per stream
                dropped = set()
                for c in self.streams:
                    self.stats[c.stream_id].frames_seen += idx.size
                    if self.policy is not None \
                            and budget[c.stream_id] < 0:
                        dropped.add(c.stream_id)
                        self.stats[c.stream_id].frames_dropped += idx.size
                    budget[c.stream_id] += arrival
                nxt = chunks[k + 1] if k + 1 < len(chunks) else None
                t0 = time.perf_counter()
                ans = engine.run_chunk(idx, nxt)    # (S, B, n_active)
                dt = time.perf_counter() - t0
                if self.policy is not None:
                    charge = getattr(engine, "chunk_seconds", None)
                    if charge is not None:
                        dt = charge(dt)
                self.chunk_latencies_s.append(dt)
                share = dt / max(len(self.streams), 1)
                for c in self.streams:
                    sid = c.stream_id
                    if sid in dropped:
                        continue        # stale results discarded
                    budget[sid] -= share
                    st = self.stats[sid]
                    st.frames_processed += idx.size
                    h = hits[sid]
                    for qk, qid in enumerate(qids):
                        h[qid] = h.get(qid, 0) \
                            + int(ans[c.position, :, qk].sum())
            for c in self.streams:
                self.stats[c.stream_id].windows += 1
            res = MultiWindowResult(span=(lo, hi), hits=hits,
                                    frames=hi - lo)
            results.append(res)
            if on_window is not None:
                on_window(res)          # may mutate the registry
        wall = time.perf_counter() - t_run
        for st in self.stats.values():
            st.wall_s = wall
        return results

    @property
    def aggregate_fps(self) -> float:
        """Fleet-level processed frames per second of wall time."""
        done = sum(st.frames_processed for st in self.stats.values())
        wall = max((st.wall_s for st in self.stats.values()),
                   default=0.0)
        return done / max(wall, 1e-9)
