"""Unified cascade statistics: population-level pass rates per predicate.

``SlotStats`` is the one store behind every adaptive-ordering decision in
the system.  It maps a *canonical* predicate (``query.canonicalize`` —
e.g. RIGHT(a, b) and LEFT(b, a) share one entry) to observed
(passed, seen) frame counts, aggregated over the **whole registered query
population** rather than per query:

- ``FilterCascade(adaptive=True)`` records per-stage unconditional
  frame-level pass rates here (replacing its former private
  ``_pass_counts/_seen`` arrays), so a single-query cascade and the
  shared multi-query plan learn from — and agree on — one ledger.
- ``StagedQueryPlan`` (repro_torch.core.plan) orders its cost-tier stages and
  the slots within them by these rates, and feeds observations back in
  one deferred device fetch per batch.
- ``QueryRegistry`` (repro_torch.core.streaming) owns a store that outlives
  epoch-lazy plan rebuilds, so a query registered mid-stream inherits the
  population's learned selectivities instead of restarting cold.

Rates are smoothed by a weak prior (``prior_pass/prior_seen``, default
1/2 -> cold rate 0.5) so a slot never divides by zero and cold slots sort
deterministically between observed extremes.

Beyond per-predicate pass rates, the store also keeps a **per-stage row
ledger** (``observe_stage_rows``/``stage_row_frac``/``stage_exec_rate``):
for every cost tier of the staged planner, what fraction of each batch's
rows the tier actually had to evaluate after row-level compaction, and
how often it executed at all (vs being tier-skipped).  Those rates feed
the restage-boundary decisions in ``MultiQueryCascade`` — a parked
cascade predicts the staged plan's per-batch cost from the ledger
(``StagedQueryPlan.predicted_batch_cost``) instead of relying only on
probe batches — and, because ``QueryRegistry`` owns the store, they
survive epoch-lazy plan rebuilds just like the slot rates do.

The row ledger's companion is the **per-stage survival ledger**
(``observe_stage_survival``/``stage_survival``): of the undecided rows a
tier actually evaluated, what fraction remained undecided after it.
Survival is *position-conditioned* — a tier that historically ran last
saw only rows the earlier tiers failed to decide — so it must never be
consumed as an unconditional selectivity; the greedy sequential order
search in ``StagedQueryPlan._staging_order`` is the one safe consumer
(it predicts each position's incoming row count from the survivals of
the stages it has already placed, the same prefix-conditioning direction
the observations were made under).

A fourth ledger deliberately does NOT live here: the cost model's
decaying prediction-*error* ledger
(``costmodel.CalibrationMonitor``) — it is keyed to one backend's
fitted coefficients, not to the query population, so persisting or
merging it with the population store would couple two lifetimes that
drift independently (queries churn; machines recalibrate).
docs/tuning.md tabulates which ledger feeds which decision.

The whole store (slot rates + both stage ledgers) round-trips through
``save``/``load`` as JSON — canonical predicate keys included, via a
small structural codec — so a redeployed monitor resumes with the
population's learned selectivities instead of relearning them from the
prior (``QueryRegistry(stats_path=...)`` wires this up).  ``load``
builds a fresh store; ``merge`` folds one store into another without
clobbering fresh observations (counts add; the decayed EWMA ledgers add
accumulator-pairwise, so merged fractions are weight-proportional blends
and subsequent traffic decays the loaded mass away at the normal rate —
a restart never pins the engine to a dead regime).
"""
from __future__ import annotations

import json
import os
import time
import warnings
from typing import Dict, Hashable, Iterable, Sequence

import numpy as np

from repro_torch.core import query as Q

SNAPSHOT_VERSION = 1


# ---------------------------------------------------------------------------
# canonical-predicate JSON codec (save/load round-trip)
# ---------------------------------------------------------------------------

def _encode_pred(p) -> Dict:
    """Structural JSON form of a predicate tree.  Keys in the store are
    canonical (``Q.canonicalize``), and the codec preserves structure
    exactly, so decode(encode(k)) == k for every stored key — including
    whole-tree keys from ``FilterCascade`` stages, not just leaves."""
    if isinstance(p, Q.Count):
        return {"t": "count", "op": p.op.value, "v": p.value,
                "tol": p.tolerance}
    if isinstance(p, Q.ClassCount):
        return {"t": "ccount", "cls": p.cls, "op": p.op.value,
                "v": p.value, "tol": p.tolerance}
    if isinstance(p, Q.Spatial):
        return {"t": "spatial", "a": p.cls_a, "rel": p.rel.value,
                "b": p.cls_b, "r": p.radius}
    if isinstance(p, Q.Region):
        return {"t": "region", "cls": p.cls, "rect": list(p.rect),
                "min": p.min_count, "r": p.radius}
    if isinstance(p, Q.And):
        return {"t": "and", "terms": [_encode_pred(x) for x in p.terms]}
    if isinstance(p, Q.Or):
        return {"t": "or", "terms": [_encode_pred(x) for x in p.terms]}
    if isinstance(p, Q.Not):
        return {"t": "not", "term": _encode_pred(p.term)}
    # temporal operators never become plan slots (the temporal tier
    # strips them to frame signals first), but whole-tree keys can pass
    # through generic persistence paths — the codec must round-trip
    # every Predicate, not just the frame-level subset
    if isinstance(p, Q.Duration):
        return {"t": "duration", "pred": _encode_pred(p.pred),
                "min": p.min_frames}
    if isinstance(p, Q.Sequence):
        return {"t": "sequence", "first": _encode_pred(p.first),
                "then": _encode_pred(p.then), "within": p.within}
    if isinstance(p, Q.SlidingCount):
        return {"t": "slidingcount", "pred": _encode_pred(p.pred),
                "w": p.window, "op": p.op.value, "v": p.value}
    raise TypeError(f"not a predicate: {p!r}")


def _decode_pred(d: Dict):
    t = d["t"]
    if t == "count":
        return Q.Count(Q.Op(d["op"]), int(d["v"]), int(d["tol"]))
    if t == "ccount":
        return Q.ClassCount(int(d["cls"]), Q.Op(d["op"]), int(d["v"]),
                            int(d["tol"]))
    if t == "spatial":
        return Q.Spatial(int(d["a"]), Q.Rel(d["rel"]), int(d["b"]),
                         int(d["r"]))
    if t == "region":
        return Q.Region(int(d["cls"]), tuple(int(x) for x in d["rect"]),
                        int(d["min"]), int(d["r"]))
    if t == "and":
        return Q.And(tuple(_decode_pred(x) for x in d["terms"]))
    if t == "or":
        return Q.Or(tuple(_decode_pred(x) for x in d["terms"]))
    if t == "not":
        return Q.Not(_decode_pred(d["term"]))
    if t == "duration":
        return Q.Duration(_decode_pred(d["pred"]), int(d["min"]))
    if t == "sequence":
        return Q.Sequence(_decode_pred(d["first"]),
                          _decode_pred(d["then"]), int(d["within"]))
    if t == "slidingcount":
        return Q.SlidingCount(_decode_pred(d["pred"]), int(d["w"]),
                              Q.Op(d["op"]), int(d["v"]))
    raise ValueError(f"unknown predicate tag {t!r}")


class SlotStats:
    """Pass-rate store keyed by canonical predicate (``query.canonicalize``).

    ``passed``/``seen`` are float frame counts; ``pass_rate`` is the
    prior-smoothed ratio.  Keys may be handed in as raw predicates —
    they are canonicalized on every access, so mirror spellings of the
    same test always hit the same entry.
    """

    def __init__(self, *, prior_pass: float = 1.0, prior_seen: float = 2.0,
                 stage_decay: float = 0.9):
        if prior_seen <= 0:
            raise ValueError("prior_seen must be positive")
        if not 0.0 < stage_decay <= 1.0:
            raise ValueError("stage_decay must be in (0, 1]")
        self.prior_pass = float(prior_pass)
        self.prior_seen = float(prior_seen)
        self.stage_decay = float(stage_decay)
        self._passed: Dict[Hashable, float] = {}
        self._seen: Dict[Hashable, float] = {}
        # per-stage row ledger (staged planner feedback; keys are stage
        # names — "counts", "spatial", "region@r2" — stable across plan
        # rebuilds that keep the same tier structure).  Unlike the
        # per-slot pass counts, these accumulators DECAY (EWMA with
        # effective window ~1/(1 - stage_decay) observations): the ledger
        # drives the staged-vs-exhaustive mode prediction, and a lifetime
        # average would let a long-dead traffic pattern veto that
        # decision for as long again — after workload drift the
        # prediction must converge to the new regime in bounded time.
        self._stage_rows: Dict[str, float] = {}
        self._stage_batch: Dict[str, float] = {}
        self._stage_exec: Dict[str, float] = {}
        # survival ledger: of the rows a stage evaluated (undecided-in),
        # how many stayed undecided after it.  Decayed like the row
        # ledger — it feeds the greedy order search, which must track the
        # live workload, not a lifetime average.
        self._surv_in: Dict[str, float] = {}
        self._surv_out: Dict[str, float] = {}

    @staticmethod
    def key(pred) -> Hashable:
        """Canonical, hashable identity of a predicate (leaf or tree)."""
        return Q.canonicalize(pred)

    # ``canonical=True`` on the accessors below skips re-canonicalization
    # for callers whose keys were precomputed with ``key()`` at build time
    # (the per-batch feedback loops: StagedQueryPlan.flush_stats,
    # FilterCascade.mask) — canonicalizing a query tree allocates a fresh
    # dataclass tree, which has no place in a per-slot-per-batch loop.

    # -- updates ----------------------------------------------------------

    def observe(self, pred, passed: float, seen: float, *,
                canonical: bool = False) -> None:
        """Record that ``pred`` was evaluated on ``seen`` frames and let
        ``passed`` of them through."""
        if seen <= 0:
            return
        k = pred if canonical else self.key(pred)
        self._passed[k] = self._passed.get(k, 0.0) + float(passed)
        self._seen[k] = self._seen.get(k, 0.0) + float(seen)

    def observe_many(self, preds: Sequence, passed, seen: float, *,
                     canonical: bool = False) -> None:
        """Batch update: every predicate was evaluated on the same
        ``seen`` frames.  The ONE place the per-batch feedback loops
        (FilterCascade.mask, StagedQueryPlan.flush_stats, the adaptive
        cascade's exhaustive path) fold fetched counts into the ledger —
        future changes to the feedback contract (decay, windowing) land
        here once."""
        for p, n in zip(preds, passed):
            self.observe(p, float(n), seen, canonical=canonical)

    def observe_stage_rows(self, stage: str, rows: float,
                           batch: float) -> None:
        """Record that one cost tier evaluated ``rows`` of a ``batch``-row
        batch (``rows`` includes bucket padding — it is the work actually
        paid, the same convention as ``oracle_frames_evaluated``; 0 means
        the tier was skipped outright)."""
        if batch <= 0:
            return
        g = self.stage_decay
        self._stage_rows[stage] = g * self._stage_rows.get(stage, 0.0) \
            + float(rows)
        self._stage_batch[stage] = g * self._stage_batch.get(stage, 0.0) \
            + float(batch)
        self._stage_exec[stage] = g * self._stage_exec.get(stage, 0.0) \
            + (float(batch) if rows > 0 else 0.0)

    def observe_stage_survival(self, stage: str, rows_in: float,
                               rows_out: float) -> None:
        """Record that a tier evaluated ``rows_in`` true undecided rows
        (bucket padding excluded — survival is a property of the real
        rows, unlike the paid-work convention of the row ledger) and
        left ``rows_out`` of them undecided.  Position-conditioned: only
        the greedy sequential order search may consume it (see module
        docstring)."""
        if rows_in <= 0:
            return
        g = self.stage_decay
        self._surv_in[stage] = g * self._surv_in.get(stage, 0.0) \
            + float(rows_in)
        self._surv_out[stage] = g * self._surv_out.get(stage, 0.0) \
            + float(rows_out)

    # -- reads ------------------------------------------------------------

    def stage_row_frac(self, stage: str) -> float:
        """Smoothed expected fraction of a batch's rows the tier evaluates
        (cold default 1.0 — assume full-batch work until observed)."""
        return ((self._stage_rows.get(stage, 0.0) + self.prior_seen)
                / (self._stage_batch.get(stage, 0.0) + self.prior_seen))

    def stage_exec_rate(self, stage: str) -> float:
        """Smoothed probability the tier executes at all (cold 1.0)."""
        return ((self._stage_exec.get(stage, 0.0) + self.prior_seen)
                / (self._stage_batch.get(stage, 0.0) + self.prior_seen))

    def stage_survival(self, stage: str) -> float:
        """Smoothed fraction of a tier's evaluated rows that remain
        undecided after it (cold 1.0 — assume the tier decides nothing
        until observed, which makes the greedy order search degenerate
        to the classic cost/benefit ratio sort on a cold store)."""
        return ((self._surv_out.get(stage, 0.0) + self.prior_seen)
                / (self._surv_in.get(stage, 0.0) + self.prior_seen))

    def pass_rate(self, pred, *, canonical: bool = False) -> float:
        k = pred if canonical else self.key(pred)
        return ((self._passed.get(k, 0.0) + self.prior_pass)
                / (self._seen.get(k, 0.0) + self.prior_seen))

    def pass_rates(self, preds: Sequence, *,
                   canonical: bool = False) -> np.ndarray:
        return np.array([self.pass_rate(p, canonical=canonical)
                         for p in preds], np.float64)

    def seen(self, pred, *, canonical: bool = False) -> float:
        return self._seen.get(pred if canonical else self.key(pred), 0.0)

    def snapshot(self) -> Dict[Hashable, Dict[str, float]]:
        """Reporting view: key -> {passed, seen, rate}."""
        return {k: {"passed": self._passed[k], "seen": self._seen[k],
                    "rate": (self._passed[k] + self.prior_pass)
                            / (self._seen[k] + self.prior_seen)}
                for k in self._seen}

    # -- persistence ------------------------------------------------------

    _STAGE_FIELDS = ("_stage_rows", "_stage_batch", "_stage_exec",
                     "_surv_in", "_surv_out")

    def save(self, path: str) -> str:
        """Serialize the whole store (slot counts, both stage ledgers,
        priors) to JSON.  Atomic (tmp + rename): a monitor snapshotting
        on a timer must never leave a half-written file for the next
        restart to trip over.  Floats round-trip exactly (json uses
        repr), so loaded pass rates, row fractions and
        ``predicted_batch_cost`` equal the saved ones bit-for-bit."""
        payload = {
            "version": SNAPSHOT_VERSION,
            "saved_at": time.time(),
            "prior_pass": self.prior_pass,
            "prior_seen": self.prior_seen,
            "stage_decay": self.stage_decay,
            "slots": [{"key": _encode_pred(k), "passed": self._passed[k],
                       "seen": self._seen[k]} for k in self._seen],
            "stages": {f: dict(getattr(self, f))
                       for f in self._STAGE_FIELDS},
        }
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "SlotStats":
        """Rebuild a store from a ``save`` snapshot.  Raises ValueError
        on a corrupt/foreign payload (and OSError on an unreadable
        path) — callers that must survive bad snapshots (e.g.
        ``QueryRegistry``) catch and start cold instead."""
        with open(path) as f:
            payload = json.load(f)
        if not isinstance(payload, dict) \
                or payload.get("version") != SNAPSHOT_VERSION:
            raise ValueError(f"not a SlotStats v{SNAPSHOT_VERSION} "
                             f"snapshot: {path}")
        try:
            st = cls(prior_pass=float(payload["prior_pass"]),
                     prior_seen=float(payload["prior_seen"]),
                     stage_decay=float(payload["stage_decay"]))
            for e in payload["slots"]:
                k = _decode_pred(e["key"])
                st._passed[k] = float(e["passed"])
                st._seen[k] = float(e["seen"])
            stages = payload.get("stages", {})
            for f in cls._STAGE_FIELDS:
                getattr(st, f).update(
                    {str(name): float(v)
                     for name, v in stages.get(f, {}).items()})
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"corrupt SlotStats snapshot {path}: {e}") \
                from e
        return st

    @classmethod
    def load_merged(cls, paths: Iterable[str]) -> "SlotStats":
        """Fleet warm-start (gossip): fold several workers' ``save``
        snapshots into one fresh store via ``merge``, so a new worker
        begins with the fleet's pooled selectivity priors and stage
        ledgers instead of cold-starting.  A corrupt/unreadable snapshot
        is skipped with a warning — the same survival discipline as
        ``QueryRegistry``'s single-snapshot resume: a bad peer file must
        never take down a starting worker.  Priors/decay come from the
        first snapshot that loads (they parameterize the smoothing, not
        the observations); with no loadable snapshot the store is simply
        cold."""
        st: "SlotStats" = None  # type: ignore[assignment]
        for p in paths:
            try:
                peer = cls.load(p)
            except (ValueError, OSError) as e:
                warnings.warn(f"ignoring unreadable SlotStats snapshot "
                              f"{p!r}: {e}")
                continue
            if st is None:
                st = peer
            else:
                st.merge(peer)
        return st if st is not None else cls()

    def merge(self, other: "SlotStats") -> "SlotStats":
        """Fold another store into this one (returns self).

        Slot counts add — two histories of the same predicate are one
        longer history.  The EWMA stage ledgers add accumulator-pairwise
        (numerators and denominators separately), so each merged
        fraction is the weight-proportional blend of the two stores'
        fractions, and future observations decay the merged mass at the
        normal geometric rate — loading yesterday's snapshot into a
        store that already has fresh observations augments them instead
        of clobbering them, and the loaded history fades on the same
        schedule as any other old observation."""
        for k, s in other._seen.items():
            self._seen[k] = self._seen.get(k, 0.0) + s
            self._passed[k] = self._passed.get(k, 0.0) \
                + other._passed.get(k, 0.0)
        for f in self._STAGE_FIELDS:
            mine, theirs = getattr(self, f), getattr(other, f)
            for name, v in theirs.items():
                mine[name] = mine.get(name, 0.0) + v
        return self

    def __len__(self) -> int:
        return len(self._seen)

    def __repr__(self) -> str:
        return f"SlotStats({len(self)} slots)"
