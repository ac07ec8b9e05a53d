"""Declarative video-monitoring query AST and its two evaluators.

The AST, canonicalization, NNF and the exact evaluator are plain Python
and numpy, as in the JAX package; ``eval_filters`` and
``spatial_relation`` run on tensors.

Queries combine (paper §I, §II):
- ``Count``       — total number of objects in the frame (CF)
- ``ClassCount``  — number of objects of one class (CCF)
- ``Spatial``     — ORDER(a, b) in {LEFT, RIGHT, ABOVE, BELOW} (CLF)
- ``Region``      — objects of a class inside a screen rectangle (CLF),
                    e.g. "bicycle not in bike lane"
- ``And / Or / Not`` connectives.

Temporal/event-pattern operators (VidCEP's sequence/duration patterns and
the temporal-queries line of work — see docs/paper_mapping.md) lift those
frame-level predicates to events over a hopping window:

- ``Duration``     — the predicate holds for >= k *consecutive* frames
- ``Sequence``     — ``first`` holds, then ``then`` holds within m frames
- ``SlidingCount`` — the count of predicate-true frames over a sliding
                     sub-window satisfies a comparison.

They are declared here (they are part of the query language) but never
evaluated by this module's two frame-level evaluators: a temporal query
is compiled by the temporal tier (``repro.core.temporal`` in the JAX
package; not ported yet) into a streaming automaton whose
input alphabet is the per-frame verdicts of its frame-level
sub-predicates.  ``And/Or/Not`` may combine temporal operators with
frame-level predicates; temporal operators may not nest inside each
other (validated at construction).

Two evaluation modes:
- ``eval_filters``  — vectorised approximate evaluation on the branch-head
  ``FilterOutputs`` of a frame batch (counts with +-tolerance, occupancy
  grids with Manhattan-radius dilation -> the paper's CF/CCF/CLF-k filters).
- ``eval_objects``  — exact evaluation on oracle object lists
  (class id + grid cell per object), the semantics the oracle (full
  detection) provides.  Used as ground truth for accuracy/f1 benchmarks.
  Exact evaluation is *tolerance-free by definition*: the CF-k/CCF-k
  ``tolerance`` relaxation widens only the approximate filter (a recall
  knob against count noise); the oracle answers the paper's strict
  predicate.  See ``_eval_table`` for the pinned asymmetry.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.filters import FilterOutputs


class Rel(str, enum.Enum):
    LEFT = "left"        # a strictly left of b (column index smaller)
    RIGHT = "right"
    ABOVE = "above"      # a strictly above b (row index smaller)
    BELOW = "below"


class Op(str, enum.Enum):
    EQ = "=="
    GE = ">="
    LE = "<="


@dataclasses.dataclass(frozen=True)
class Count:
    """Total objects in frame vs ``value``.  ``tolerance`` (CF-k) widens
    the *approximate filter only* — exact evaluation ignores it (see
    ``_eval_table``)."""
    op: Op
    value: int
    tolerance: int = 0          # CF-k relaxation (filter-side only)


@dataclasses.dataclass(frozen=True)
class ClassCount:
    """Objects of class ``cls`` vs ``value``.  ``tolerance`` (CCF-k)
    widens the *approximate filter only* — exact evaluation ignores it
    (see ``_eval_table``)."""
    cls: int
    op: Op
    value: int
    tolerance: int = 0          # CCF-k relaxation (filter-side only)


@dataclasses.dataclass(frozen=True)
class Spatial:
    cls_a: int
    rel: Rel
    cls_b: int
    radius: int = 0             # CLF-k relaxation (Manhattan dilation)


@dataclasses.dataclass(frozen=True)
class Region:
    cls: int
    rect: Tuple[int, int, int, int]      # (r0, c0, r1, c1) half-open, grid coords
    min_count: int = 1          # >= this many objects (cells) inside
    radius: int = 0


@dataclasses.dataclass(frozen=True)
class And:
    terms: Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class Or:
    terms: Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class Not:
    term: Any


# --------------------------------------------------------------------------
# Temporal / event-pattern operators (compiled by repro.core.temporal)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Duration:
    """Event: ``pred`` holds for >= ``min_frames`` *consecutive* frames
    of the current hopping window ("car left of truck for >= 5 s").

    The per-frame output is latched: False until the frame that completes
    the first qualifying run, True from that frame to the window end.
    ``pred`` must be frame-level (no nested temporal operators)."""
    pred: Any
    min_frames: int

    def __post_init__(self):
        if self.min_frames < 1:
            raise ValueError(f"min_frames must be >= 1, "
                             f"got {self.min_frames}")
        _check_frame_level(self.pred, "Duration.pred")


@dataclasses.dataclass(frozen=True)
class Sequence:
    """Event: ``first`` holds at some frame s, and ``then`` holds at a
    frame strictly after it but within ``within`` frames
    (s < t <= s + within) — VidCEP's SEQ pattern on two frame predicates.

    Latched per-frame output, like ``Duration``.  A frame where both
    ``first`` and ``then`` hold does NOT complete the pattern by itself
    (``then`` must be strictly later)."""
    first: Any
    then: Any
    within: int

    def __post_init__(self):
        if self.within < 1:
            raise ValueError(f"within must be >= 1, got {self.within}")
        _check_frame_level(self.first, "Sequence.first")
        _check_frame_level(self.then, "Sequence.then")


@dataclasses.dataclass(frozen=True)
class SlidingCount:
    """Event: some *complete* sliding sub-window of ``window`` consecutive
    frames (inside the current hopping window) has a ``pred``-true frame
    count satisfying ``op value`` ("a pedestrian in >= 8 of any 10
    consecutive frames").

    Latched per-frame output: False until the frame that completes the
    first qualifying sub-window, True afterwards.  Sub-windows are exact
    (no tolerance field — the count is over boolean frame verdicts, not
    noisy detector counts)."""
    pred: Any
    window: int
    op: Op
    value: int

    def __post_init__(self):
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if self.value < 0:
            raise ValueError(f"value must be >= 0, got {self.value}")
        _check_frame_level(self.pred, "SlidingCount.pred")


TEMPORAL_TYPES = (Duration, Sequence, SlidingCount)

Predicate = Union[Count, ClassCount, Spatial, Region, And, Or, Not,
                  Duration, Sequence, SlidingCount]


def has_temporal(q: Predicate) -> bool:
    """Does the tree contain any temporal operator?  (Such queries must
    go through ``repro.core.temporal``; the frame-level evaluators and
    ``repro_torch.core.plan.QueryPlan`` reject them.)"""
    if isinstance(q, TEMPORAL_TYPES):
        return True
    if isinstance(q, (And, Or)):
        return any(has_temporal(t) for t in q.terms)
    if isinstance(q, Not):
        return has_temporal(q.term)
    return False


def _check_frame_level(q: Predicate, where: str) -> None:
    if has_temporal(q):
        raise TypeError(f"{where} must be a frame-level predicate; "
                        f"temporal operators cannot nest: {q!r}")


def leaves(q: Predicate) -> List[Predicate]:
    if isinstance(q, (And, Or)):
        out: List[Predicate] = []
        for t in q.terms:
            out.extend(leaves(t))
        return out
    if isinstance(q, Not):
        return leaves(q.term)
    if isinstance(q, Duration):
        return leaves(q.pred)
    if isinstance(q, Sequence):
        return leaves(q.first) + leaves(q.then)
    if isinstance(q, SlidingCount):
        return leaves(q.pred)
    return [q]


def canonicalize_leaf(q: Predicate) -> Predicate:
    """Canonical form of a leaf predicate, for deduplication across queries.

    The four spatial relations come in mirror pairs over the same extremum
    comparison (see ``spatial_relation``):

        RIGHT(a, b)  ==  max_col(a) > min_col(b)  ==  LEFT(b, a)
        BELOW(a, b)  ==  max_row(a) > min_row(b)  ==  ABOVE(b, a)

    so every Spatial leaf is normalised to its LEFT/ABOVE spelling.  Leaves
    are frozen dataclasses with hashable fields, so the canonical leaf is
    itself the dedup key (``leaf_key``).
    """
    if isinstance(q, Spatial):
        if q.rel == Rel.RIGHT:
            return Spatial(q.cls_b, Rel.LEFT, q.cls_a, q.radius)
        if q.rel == Rel.BELOW:
            return Spatial(q.cls_b, Rel.ABOVE, q.cls_a, q.radius)
    return q


def leaf_key(q: Predicate):
    """Hashable dedup key: two leaves with equal keys evaluate identically
    on every frame (used by the multi-query planner in repro_torch.core.plan)."""
    return canonicalize_leaf(q)


def canonicalize(q: Predicate) -> Predicate:
    """Recursive canonicalization: every leaf of the tree is replaced by
    its ``canonicalize_leaf`` spelling, connectives preserved.

    Idempotent, and equal to ``leaf_key`` on leaves — this is the key
    function of the population statistics store (repro_torch.core.stats), so a
    cascade stage over RIGHT(a, b) and a plan slot over LEFT(b, a)
    accumulate into one entry."""
    if isinstance(q, (And, Or)):
        terms = tuple(canonicalize(t) for t in q.terms)
        return And(terms) if isinstance(q, And) else Or(terms)
    if isinstance(q, Not):
        return Not(canonicalize(q.term))
    if isinstance(q, Duration):
        return Duration(canonicalize(q.pred), q.min_frames)
    if isinstance(q, Sequence):
        return Sequence(canonicalize(q.first), canonicalize(q.then),
                        q.within)
    if isinstance(q, SlidingCount):
        return SlidingCount(canonicalize(q.pred), q.window, q.op, q.value)
    return canonicalize_leaf(q)


def to_nnf(q: Predicate, negate: bool = False) -> Predicate:
    """Negation normal form: push Not down to the leaves (De Morgan).

    The result contains And/Or over leaves and Not-wrapped leaves only —
    the shape the multi-query planner lowers to its levelized incidence
    program (internal nodes are then pure And/Or gates)."""
    if isinstance(q, Not):
        return to_nnf(q.term, not negate)
    if isinstance(q, And):
        terms = tuple(to_nnf(t, negate) for t in q.terms)
        return Or(terms) if negate else And(terms)
    if isinstance(q, Or):
        terms = tuple(to_nnf(t, negate) for t in q.terms)
        return And(terms) if negate else Or(terms)
    return Not(q) if negate else q


# --------------------------------------------------------------------------
# Approximate evaluation on FilterOutputs (batched)
# --------------------------------------------------------------------------

def _cmp(x, op: Op, v: int, tol: int):
    if op == Op.EQ:
        return (x >= v - tol) & (x <= v + tol)
    if op == Op.GE:
        return x >= v - tol
    return x <= v + tol


def eval_filters(q: Predicate, out: FilterOutputs, *,
                 tau: float = 0.2) -> torch.Tensor:
    """Returns (B,) bool candidate mask (True = frame may satisfy q)."""
    if isinstance(q, And):
        m = eval_filters(q.terms[0], out, tau=tau)
        for t in q.terms[1:]:
            m = m & eval_filters(t, out, tau=tau)
        return m
    if isinstance(q, Or):
        m = eval_filters(q.terms[0], out, tau=tau)
        for t in q.terms[1:]:
            m = m | eval_filters(t, out, tau=tau)
        return m
    if isinstance(q, Not):
        return ~eval_filters(q.term, out, tau=tau)
    if isinstance(q, Count):
        total = out.count_pred().sum(-1)
        return _cmp(total, q.op, q.value, q.tolerance)
    if isinstance(q, ClassCount):
        c = out.count_pred()[:, q.cls]
        return _cmp(c, q.op, q.value, q.tolerance)
    if isinstance(q, Spatial):
        occ = out.occupancy(tau, q.radius)               # (B,g,g,C)
        return spatial_relation(occ[..., q.cls_a], occ[..., q.cls_b], q.rel)
    if isinstance(q, Region):
        occ = out.occupancy(tau, q.radius)[..., q.cls]
        r0, c0, r1, c1 = q.rect
        inside = occ[:, r0:r1, c0:c1]
        return inside.sum(dim=(1, 2)) >= q.min_count
    raise TypeError(q)


def spatial_relation(occ_a: torch.Tensor, occ_b: torch.Tensor,
                     rel: Rel) -> torch.Tensor:
    """(B,g,g) bool maps -> (B,) 'exists a-cell and b-cell with rel'."""
    B, g, _ = occ_a.shape
    dev = occ_a.device
    idx = torch.arange(g, device=dev)
    big = torch.full((), g + 1, device=dev)
    neg = torch.full((), -1, device=dev)

    def min_over(mask, ix):
        return torch.where(mask, ix, big).amin(dim=(1, 2))

    def max_over(mask, ix):
        return torch.where(mask, ix, neg).amax(dim=(1, 2))

    any_a = occ_a.any(2).any(1)
    any_b = occ_b.any(2).any(1)
    if rel in (Rel.LEFT, Rel.RIGHT):
        ca = idx[None, None, :]
        if rel == Rel.LEFT:      # exists a.col < b.col
            return any_a & any_b & (min_over(occ_a, ca) < max_over(occ_b, ca))
        return any_a & any_b & (max_over(occ_a, ca) > min_over(occ_b, ca))
    ra = idx[None, :, None]
    if rel == Rel.ABOVE:         # exists a.row < b.row
        return any_a & any_b & (min_over(occ_a, ra) < max_over(occ_b, ra))
    return any_a & any_b & (max_over(occ_a, ra) > min_over(occ_b, ra))


# --------------------------------------------------------------------------
# Exact evaluation on oracle object lists
# --------------------------------------------------------------------------

def objects_to_grid(objs: np.ndarray, n_classes: int, grid: int) -> np.ndarray:
    """objs: (N, 3) rows of (cls, row, col) -> (g, g, C) bool occupancy."""
    occ = np.zeros((grid, grid, n_classes), bool)
    for cls, r, c in objs:
        occ[int(r), int(c), int(cls)] = True
    return occ


class ObjectTable:
    """An oracle object list parsed ONCE into a (n, 3) int64 table.

    ``eval_objects`` historically re-materialized ``np.asarray(list(objs))``
    at every node of the recursion, for every (frame, query) pair; a shared
    multi-query oracle pass evaluates many queries on the same surviving
    frame, so the executor builds one table per frame and every query (and
    every node within a query) reuses it.  Per-class row subsets are memoized
    too — Spatial/Region leaves of different queries about the same class
    share the filter."""

    __slots__ = ("arr", "_by_class")

    def __init__(self, arr: np.ndarray):
        self.arr = arr
        self._by_class: Dict[int, np.ndarray] = {}

    @classmethod
    def from_objects(cls, objs) -> "ObjectTable":
        if isinstance(objs, ObjectTable):
            return objs
        return cls(np.asarray(list(objs), dtype=np.int64).reshape(-1, 3))

    def of_class(self, c: int) -> np.ndarray:
        sub = self._by_class.get(c)
        if sub is None:
            sub = self.arr[self.arr[:, 0] == c]
            self._by_class[c] = sub
        return sub

    def __len__(self) -> int:
        return len(self.arr)


def eval_objects(q: Predicate, objs, n_classes: int, grid: int) -> bool:
    """Exact semantics on an oracle object list [(cls, row, col), ...] or a
    pre-parsed ``ObjectTable`` (hoisted parsing for shared oracle passes)."""
    return _eval_table(q, ObjectTable.from_objects(objs), n_classes, grid)


def _eval_table(q: Predicate, t: ObjectTable, n_classes: int,
                grid: int) -> bool:
    """Exact semantics, *pinned tolerance-free* for Count/ClassCount.

    The CF-k/CCF-k ``tolerance`` is a recall relaxation of the
    approximate filter only: it absorbs the branch head's count noise so
    true-positive frames are not filtered out before the oracle sees
    them.  The oracle itself answers the strict predicate — widening it
    by +-tolerance would change the *query semantics* with the filter
    knob, and the accuracy benchmarks (filter vs exact) would be
    comparing a query against a different query.  The asymmetry is
    intentional and regression-pinned (tests/test_query_properties.py);
    docs/paper_mapping.md has the paper-side rationale."""
    if isinstance(q, And):
        return all(_eval_table(x, t, n_classes, grid) for x in q.terms)
    if isinstance(q, Or):
        return any(_eval_table(x, t, n_classes, grid) for x in q.terms)
    if isinstance(q, Not):
        return not _eval_table(q.term, t, n_classes, grid)
    if isinstance(q, Count):
        # tolerance deliberately NOT passed (exact = strict; see above)
        return bool(_cmp(np.int64(len(t)), q.op, q.value, 0))
    if isinstance(q, ClassCount):
        return bool(_cmp(np.int64(len(t.of_class(q.cls))), q.op, q.value, 0))
    if isinstance(q, Spatial):
        a = t.of_class(q.cls_a)
        b = t.of_class(q.cls_b)
        if len(a) == 0 or len(b) == 0:
            return False
        if q.rel == Rel.LEFT:
            return bool(a[:, 2].min() < b[:, 2].max())
        if q.rel == Rel.RIGHT:
            return bool(a[:, 2].max() > b[:, 2].min())
        if q.rel == Rel.ABOVE:
            return bool(a[:, 1].min() < b[:, 1].max())
        return bool(a[:, 1].max() > b[:, 1].min())
    if isinstance(q, Region):
        a = t.of_class(q.cls)
        r0, c0, r1, c1 = q.rect
        inside = ((a[:, 1] >= r0) & (a[:, 1] < r1) &
                  (a[:, 2] >= c0) & (a[:, 2] < c1))
        return bool(inside.sum() >= q.min_count)
    raise TypeError(q)
