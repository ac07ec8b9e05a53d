"""Multi-query planner: N declarative queries -> one shared evaluation.

The port of the JAX package's ``core/plan.py``; the design is the same,
and so are the results, bit for bit:

1.  **Leaf canonicalization + dedup.**  Every leaf of every query is
    canonicalized (``query.canonicalize_leaf``) and assigned a *slot* in
    a ``CanonicalLeafTable``; two queries asking the same question share
    one slot, evaluated once.  Slot ids stay stable across register /
    retire churn.

2.  **Grouped, batched leaf lowering.**  Count/ClassCount slots are one
    gather over the (B, C+1) rounded count table plus an interval test;
    Spatial slots are evaluated from the (B, C, 5) spatial statistics of
    the spatial-stats kernel (``kernels.spatial_predicate``); Region
    slots group by dilation radius and read one summed-area table per
    radius (triangular matmuls).

3.  **Incidence-matrix reassembly.**  Query trees are normalised to NNF,
    flattened into one levelized node program over the *distinct*
    canonical trees, and evaluated bottom-up with one gather, one matmul
    against a 0/1 incidence matrix and one threshold per depth level.

4.  **Staged adaptive execution** (``StagedQueryPlan``).  The slots are
    partitioned into cost tiers (counts, the spatial-stats tier, one
    stage per Region radius) evaluated stage by stage with three-valued
    bound propagation; a query column whose bounds agree is decided, a
    stage no undecided column needs is skipped, and between tiers the
    undecided *rows* are compacted into power-of-two buckets so the next
    tier evaluates only those rows — the spatial tier through the
    row-list kernel (``spatial_stats_rows_bgc``), which reads each frame
    in place.  Stage order comes from population statistics
    (``core.stats.SlotStats``) priced by a ``costmodel.CostModel``.

5.  **Fleet execution** (``StagedQueryPlan.evaluate_group``).  S
    streams' stacked batches go through one staged walk with
    group-uniform staging decisions; the stream axis is a batch
    dimension, so each executed tier is one step (and one stats-kernel
    launch) for the whole fleet slice.  ``evaluate`` is its S = 1 case.

Where the JAX package jit-compiles each stage step, the port builds an
eager closure and caches it under the same content signature in a
``StepCache``; ``StageReport.steps_compiled`` counts closures built, so
it stays comparable with the reference.  Functional ``.at[].set``
updates become in-place ``index_put`` on the plan's own state tensors
(duplicate padded rows write identical values, so the winner of a
duplicate write does not matter).  Every tensor a step reads is on the
device of the filter outputs it is given.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import cam as CAM
from repro_torch.core import costmodel as CM
from repro_torch.core import query as Q
from repro_torch.core.filters import FilterOutputs
from repro_torch.core.stepcache import StepCache, content_digest
from repro_torch.kernels import ops as kops
from repro_torch.kernels import spatial_predicate as SP

_I32_MAX = np.iinfo(np.int32).max
_I32_MIN = np.iinfo(np.int32).min


class CanonicalLeafTable:
    """Persistent canonical-predicate -> slot map with stable slot ids.

    The incremental half of the plan lifecycle: a ``QueryPlan`` built
    against a shared table (``QueryPlan(..., leaf_table=...)`` — the
    ``QueryRegistry`` owns one the same way it owns ``SlotStats``) keeps
    slot ids stable across registry epochs, so a query registering or
    retiring is a *delta* against the table instead of a re-numbering of
    every leaf:

    - ``sync(queries)`` diffs the new query multiset against the last
      synced one at canonical-tree granularity (each tree canonicalized
      once ever, memoized) — only the changed trees' leaves touch the
      refcounts, so a K-query delta over an N-query population is O(K),
      not O(N).
    - A leaf whose refcount drops to zero is **tombstoned**, not freed:
      it keeps its slot id, so re-registering the same predicate
      resurrects the slot — and every compiled-step signature that
      mentions it — instead of allocating a fresh column.
    - Tombstones are compacted (dead columns dropped, live slots
      renumbered densely, ``version`` bumped so plan signatures move)
      only when the dead fraction of the slot space crosses
      ``compact_threshold`` — fragmentation is bounded without paying a
      global renumber per retirement.

    Slot ids are allocated first-seen in query order, exactly like the
    pre-table planner, so a fresh private table (what a standalone
    ``QueryPlan`` builds) reproduces the legacy slot layout verbatim.
    """

    def __init__(self, *, compact_threshold: float = 0.5):
        if not 0.0 < compact_threshold <= 1.0:
            raise ValueError(f"compact_threshold must be in (0, 1], "
                             f"got {compact_threshold}")
        self.compact_threshold = compact_threshold
        self._slots: Dict[Q.Predicate, int] = {}    # key -> slot (live
        self._keys: List[Q.Predicate] = []          # AND tombstoned)
        self._refs: Dict[Q.Predicate, int] = {}     # leaf-occurrence refs
        self._canon: Dict[Q.Predicate, Q.Predicate] = {}   # query memo
        self._synced: "Dict[Q.Predicate, int]" = {}  # canon tree -> mult
        self.version = 0            # bumps on compaction (slot ids moved)
        self.registrations = 0      # new slots ever allocated
        self.retirements = 0        # slots that hit refcount 0
        self.resurrections = 0      # tombstones brought back live
        self.compactions = 0

    def canonical(self, query: Q.Predicate) -> Q.Predicate:
        """Memoized ``Q.canonicalize`` — each distinct query tree is
        canonicalized once per table lifetime, however many epochs
        re-register it."""
        tree = self._canon.get(query)
        if tree is None:
            tree = Q.canonicalize(query)
            self._canon[query] = tree
        return tree

    @property
    def width(self) -> int:
        """Slot-column count (live + tombstoned) — the leaf-matrix width
        of every plan built against this table."""
        return len(self._keys)

    @property
    def n_live(self) -> int:
        return sum(1 for k in self._keys if self._refs.get(k, 0) > 0)

    @property
    def n_tombstones(self) -> int:
        return len(self._keys) - self.n_live

    def is_live(self, slot: int) -> bool:
        return self._refs.get(self._keys[slot], 0) > 0

    def slot_of(self, key: Q.Predicate) -> int:
        return self._slots[key]

    def live_items(self) -> List[Tuple[Q.Predicate, int]]:
        """(canonical key, slot) pairs of live slots, slot-ordered."""
        return [(k, self._slots[k]) for k in self._keys
                if self._refs.get(k, 0) > 0]

    def sync(self, queries: Sequence[Q.Predicate]) -> None:
        """Make the table's refcounts reflect ``queries`` (a multiset).

        The delta-registration path: trees present in both the old and
        new population are untouched; retired trees decrement their
        leaves (tombstoning zeros), new trees allocate/resurrect slots
        first-seen in query order.  May compact (see class docstring) —
        callers build the plan *after* sync so they see the final ids."""
        trees = [self.canonical(q) for q in queries]
        new: Dict[Q.Predicate, int] = {}
        for t in trees:
            new[t] = new.get(t, 0) + 1
        # retired trees first: a slot freed here can be resurrected (not
        # re-allocated) by a new tree registering the same predicate
        for tree, old_mult in self._synced.items():
            drop = old_mult - new.get(tree, 0)
            if drop <= 0:
                continue
            for leaf in Q.leaves(tree):
                key = Q.leaf_key(leaf)
                r = self._refs[key] - drop
                assert r >= 0, f"refcount underflow for {key!r}"
                self._refs[key] = r
                if r == 0:
                    self.retirements += 1
        seen: set = set()
        for tree in trees:
            add = new[tree] - self._synced.get(tree, 0)
            if add <= 0 or tree in seen:
                continue
            seen.add(tree)
            for leaf in Q.leaves(tree):
                key = Q.leaf_key(leaf)
                if key not in self._slots:
                    self._slots[key] = len(self._keys)
                    self._keys.append(key)
                    self._refs[key] = 0
                    self.registrations += 1
                elif self._refs.get(key, 0) == 0:
                    self.resurrections += 1
                self._refs[key] += add
        self._synced = new
        self.maybe_compact()

    def maybe_compact(self) -> bool:
        """Drop tombstoned columns when they exceed ``compact_threshold``
        of the slot space.  Renumbers live slots densely (stable order),
        bumps ``version`` — plans built before a compaction keep working
        (they hold their own baked arrays) but their step signatures no
        longer match newly built plans', which is exactly right: the
        column layout changed."""
        width = len(self._keys)
        dead = [k for k in self._keys if self._refs.get(k, 0) == 0]
        if not dead or len(dead) / max(width, 1) <= self.compact_threshold:
            return False
        live = [k for k in self._keys if self._refs.get(k, 0) > 0]
        self._keys = live
        self._slots = {k: i for i, k in enumerate(live)}
        for k in dead:
            del self._refs[k]
        self.version += 1
        self.compactions += 1
        return True

    def snapshot(self) -> Dict[str, int]:
        return {"width": self.width, "live": self.n_live,
                "tombstones": self.n_tombstones, "version": self.version,
                "registrations": self.registrations,
                "retirements": self.retirements,
                "resurrections": self.resurrections,
                "compactions": self.compactions}

    def __repr__(self) -> str:
        return (f"CanonicalLeafTable(width={self.width}, "
                f"live={self.n_live}, tombstones={self.n_tombstones}, "
                f"version={self.version})")


def _count_bounds(op: Q.Op, value: int, tol: int) -> Tuple[int, int]:
    """EQ/GE/LE with +-tol as one closed interval [lo, hi] over int32."""
    if op == Q.Op.EQ:
        return value - tol, value + tol
    if op == Q.Op.GE:
        return value - tol, _I32_MAX
    return _I32_MIN, value + tol


@dataclasses.dataclass(frozen=True)
class _Level:
    """All And/Or nodes at one tree depth, across every query."""
    node_ids: np.ndarray        # (P,) columns written by this level
    child_idx: np.ndarray       # (K,) columns read (leaf slots or nodes)
    child_neg: np.ndarray       # (K,) bool — NNF literal negation
    incidence: np.ndarray       # (P, K) 0/1 parent-child matrix
    required: np.ndarray        # (P,) n_children for And, 1 for Or


@dataclasses.dataclass
class _Stage:
    """One cost tier of the staged plan (a lowering group of slots)."""
    name: str
    kind: str                   # 'count' | 'spatial' | 'region'
    slots: np.ndarray           # slot columns this stage decides
    cost: float                 # full-batch cost under the build-time
                                # CostModel (reporting / describe); live
                                # decisions re-query the model per rows
    payload: Tuple              # kind-specific baked index arrays
    radius: int = 0             # region dilation radius (cost queries)


class _DeviceConsts:
    """Baked numpy arrays as tensors on a device, converted once.

    Keyed by the array's identity; the entry holds the array itself, so
    an id cannot be reused while its entry lives."""

    def __init__(self):
        self._cache: Dict[Tuple[int, str, bool], Tuple[np.ndarray,
                                                       torch.Tensor]] = {}

    def __call__(self, arr: np.ndarray, device: torch.device,
                 index: bool = False) -> torch.Tensor:
        key = (id(arr), str(device), index)
        hit = self._cache.get(key)
        if hit is None:
            t = torch.as_tensor(np.asarray(arr), device=device)
            if index:
                t = t.long()
            hit = (arr, t)
            self._cache[key] = hit
        return hit[1]


class QueryPlan:
    """Compiles N query ASTs into one shared batched evaluation.

    ``evaluate(out) -> (B, N) bool``; all index arrays and incidence
    matrices are baked at plan-build time.  ``build_staged`` wraps the
    same lowering in the adaptive stage-by-stage executor.
    """

    def __init__(self, queries: Sequence[Q.Predicate], *, tau: float = 0.2,
                 leaf_table: Optional[CanonicalLeafTable] = None,
                 prev: Optional["QueryPlan"] = None):
        if not queries:
            raise ValueError("QueryPlan needs at least one query")
        self.queries = tuple(queries)
        for q in self.queries:
            if Q.has_temporal(q):
                raise TypeError(
                    f"QueryPlan evaluates frame-level predicates only; "
                    f"temporal operators go through "
                    f"repro_torch.core.temporal (TemporalEngine): {q!r}")
        self.tau = tau
        self._const = _DeviceConsts()
        if leaf_table is None and prev is not None:
            leaf_table = prev.leaf_table
        self.leaf_table = (leaf_table if leaf_table is not None
                           else CanonicalLeafTable())

        # ---- pass 1: canonical leaf slots (delta-sync on the table) ----
        table = self.leaf_table
        table.sync(self.queries)
        self.n_total_leaves = sum(len(Q.leaves(q)) for q in self.queries)
        self.n_slot_cols = table.width
        live = table.live_items()                   # (key, slot) pairs
        self.n_unique_leaves = len(live)
        self.slot_keys: List[Optional[Q.Predicate]] = \
            [None] * self.n_slot_cols               # None == tombstone
        for key, slot in live:
            self.slot_keys[slot] = key
        self.live_slots = np.array([slot for _, slot in live], np.int64) \
            if live else np.zeros(0, np.int64)

        # ---- distinct-tree dedup: each canonical query tree compiles
        # once; per-qid answers are a gather through ``dup_map``.
        trees = [table.canonical(q) for q in self.queries]
        distinct = sorted(set(trees), key=repr)
        tree_to_di = {t: i for i, t in enumerate(distinct)}
        self.dup_map = np.array([tree_to_di[t] for t in trees], np.int64)
        self.n_distinct = len(distinct)
        self._distinct_trees = tuple(distinct)

        self.query_slot_incidence = np.zeros(
            (len(self.queries), self.n_slot_cols), bool)
        for qi, tree in enumerate(trees):
            for leaf in Q.leaves(tree):
                self.query_slot_incidence[qi, table.slot_of(
                    Q.leaf_key(leaf))] = True
        self.distinct_slot_incidence = np.zeros(
            (self.n_distinct, self.n_slot_cols), bool)
        for di, tree in enumerate(distinct):
            for leaf in Q.leaves(tree):
                self.distinct_slot_incidence[di, table.slot_of(
                    Q.leaf_key(leaf))] = True

        # ---- lower LIVE slots by kind into grouped numpy index tables ----
        cnt: List[Tuple[int, int, int, int]] = []    # (slot, cls|C, lo, hi)
        spa: List[Tuple[int, int, int, bool, int]] = []  # slot,a,b,row?,r
        reg: Dict[int, List[Tuple[int, int, Tuple, int]]] = defaultdict(list)
        self._needs_grid = False
        for leaf, slot in live:
            if isinstance(leaf, Q.Count):
                lo, hi = _count_bounds(leaf.op, leaf.value, leaf.tolerance)
                cnt.append((slot, -1, lo, hi))
            elif isinstance(leaf, Q.ClassCount):
                lo, hi = _count_bounds(leaf.op, leaf.value, leaf.tolerance)
                cnt.append((slot, leaf.cls, lo, hi))
            elif isinstance(leaf, Q.Spatial):
                self._needs_grid = True
                spa.append((slot, leaf.cls_a, leaf.cls_b,
                            leaf.rel == Q.Rel.ABOVE, leaf.radius))
            elif isinstance(leaf, Q.Region):
                self._needs_grid = True
                reg[leaf.radius].append((slot, leaf.cls, leaf.rect,
                                         leaf.min_count))
            else:
                raise TypeError(f"not a leaf predicate: {leaf!r}")

        self._cnt = None
        if cnt:
            a = np.array(cnt, np.int64)
            self._cnt = (a[:, 0], a[:, 1].astype(np.int32),
                         a[:, 2].astype(np.int32), a[:, 3].astype(np.int32))
        self._spa = None
        if spa:
            self._spa = (np.array([s[0] for s in spa]),
                         np.array([s[1] for s in spa], np.int32),
                         np.array([s[2] for s in spa], np.int32),
                         np.array([s[3] for s in spa], bool),
                         np.array([s[4] for s in spa], np.int32))
        self._reg: List[Tuple[int, np.ndarray, np.ndarray, np.ndarray,
                              np.ndarray]] = []
        for radius, items in sorted(reg.items()):
            slots = np.array([i[0] for i in items])
            cls = np.array([i[1] for i in items], np.int32)
            rects = np.array([i[2] for i in items], np.int32)    # (n, 4)
            minc = np.array([i[3] for i in items], np.float32)
            self._reg.append((radius, slots, cls, rects, minc))

        # ---- pass 2: levelized node program over distinct NNF trees ----
        L = self.n_slot_cols
        internal: List[Tuple[bool, List[Tuple[int, bool]]]] = []
        node_level: Dict[int, int] = {}
        memo: Dict[Q.Predicate, Tuple[int, bool, int]] = {}

        def compile_node(node) -> Tuple[int, bool, int]:
            """-> (column, negated, level); columns 0..L-1 are leaf slots.
            Memoized on the canonical subtree."""
            hit = memo.get(node)
            if hit is not None:
                return hit
            if isinstance(node, Q.Not):          # NNF: term is a leaf
                col, neg, lvl = compile_node(node.term)
                res = (col, not neg, lvl)
            elif isinstance(node, (Q.And, Q.Or)):
                if not node.terms:
                    raise ValueError(f"empty connective: {node!r}")
                ch = [compile_node(t) for t in node.terms]
                lvl = 1 + max(c[2] for c in ch)
                col = L + len(internal)
                internal.append((isinstance(node, Q.And),
                                 [(c[0], c[1]) for c in ch]))
                node_level[col] = lvl
                res = (col, False, lvl)
            else:
                res = (table.slot_of(Q.leaf_key(node)), False, 0)
            memo[node] = res
            return res

        roots = [compile_node(Q.to_nnf(t)) for t in distinct]
        self._roots = np.array([r[0] for r in roots])       # (D,)
        self._root_neg = np.array([r[1] for r in roots], bool)
        self.n_internal = len(internal)

        by_level: Dict[int, List[int]] = defaultdict(list)
        for col, lvl in node_level.items():
            by_level[lvl].append(col)
        self._levels: List[_Level] = []
        for lvl in sorted(by_level):
            cols = sorted(by_level[lvl])
            child_idx: List[int] = []
            child_neg: List[bool] = []
            spans: List[Tuple[int, int]] = []
            required = []
            for col in cols:
                is_and, children = internal[col - L]
                spans.append((len(child_idx), len(children)))
                child_idx.extend(c for c, _ in children)
                child_neg.extend(n for _, n in children)
                required.append(len(children) if is_and else 1)
            inc = np.zeros((len(cols), len(child_idx)), np.float32)
            for p, (start, k) in enumerate(spans):
                inc[p, start:start + k] = 1.0
            self._levels.append(_Level(
                node_ids=np.array(cols),
                child_idx=np.array(child_idx),
                child_neg=np.array(child_neg, bool),
                incidence=inc,
                required=np.array(required, np.float32)))

        # content signature of everything a step bakes from the PLAN side
        sig_parts: List = [L, self.n_internal, self.n_distinct, self.tau,
                           self._roots, self._root_neg]
        for lev in self._levels:
            sig_parts.extend([lev.node_ids, lev.child_idx, lev.child_neg,
                              lev.incidence, lev.required])
        self.plan_sig = content_digest(*sig_parts)

    # -- grouped leaf evaluation ------------------------------------------

    def _count_values(self, out: FilterOutputs,
                      payload: Optional[Tuple] = None) -> torch.Tensor:
        """(B, k) bool for the count-gather group (CF/CCF interval tests)."""
        _, cls, lo, hi = payload if payload is not None else self._cnt
        dev = out.counts.device
        counts = out.count_pred()                          # (B, C) int32
        ext = torch.cat([counts, counts.sum(-1, keepdim=True,
                                            dtype=torch.int32)], dim=1)
        x = ext[:, self._const(cls, dev, index=True)]   # -1: the total col
        return (x >= self._const(lo, dev)) & (x <= self._const(hi, dev))

    def _spatial_values(self, out: FilterOutputs,
                        payload: Optional[Tuple] = None,
                        class_slice: Optional[Tuple] = None,
                        rows: Optional[torch.Tensor] = None,
                        body: str = "rows") -> torch.Tensor:
        """(B, k) bool for the spatial tier from the (C', 5) stats.

        ``class_slice=(classes, a_idx, b_idx)`` reduces only the grid
        planes the tier's leaves reference: the stats kernel reads them
        from the full grid in place (its plain version gathers them).
        ``rows`` restricts the reduction to a row subset; ``body`` picks
        ``"rows"`` (the row-list kernel, reading frames in place) or
        ``"full"`` (gather the rows, then the full-batch kernel).  Either
        way (R, k)."""
        _, a, b, use_row, radius = payload if payload is not None \
            else self._spa
        dev = out.grid.device
        g = out.grid.shape[1]
        grid = out.grid
        classes = None
        if class_slice is not None and \
                len(class_slice[0]) < out.grid.shape[-1]:
            classes, a, b = class_slice
            classes = self._const(classes, dev, index=True)
        if rows is not None:
            if body == "full":
                stats = kops.spatial_stats_inline(grid[rows], self.tau,
                                                  classes=classes)
            else:
                stats = kops.spatial_stats_rows_inline(grid, rows, self.tau,
                                                       classes=classes)
        elif classes is None:
            stats = out.spatial_stats(self.tau)
        else:
            stats = kops.spatial_stats_inline(grid, self.tau,
                                              classes=classes)
        return SP.eval_spatial_leaves(
            stats, self._const(a, dev, index=True),
            self._const(b, dev, index=True), self._const(use_row, dev),
            self._const(radius, dev), grid=g)

    def _region_sat_values(self, occ: torch.Tensor, cls: np.ndarray,
                           rects: np.ndarray, minc: np.ndarray
                           ) -> torch.Tensor:
        """(B, k) bool rectangle-count tests on an (already dilated)
        occupancy map, via one summed-area table built from (g, g)
        triangular matmuls (exact for 0/1 cell sums in float32)."""
        dev = occ.device
        g = occ.shape[1]
        tri = torch.tril(torch.ones((g, g), dtype=torch.float32, device=dev))
        s = torch.einsum("ij,bjkc->bikc", tri, occ.float())
        s = torch.einsum("kl,bilc->bikc", tri, s)
        sat = F.pad(s, (0, 0, 1, 0, 1, 0))
        # a rect past the grid edge reads the edge, as the reference's
        # clamping gather does (torch indexing would raise instead)
        r0, c0, r1, c1 = (self._const(rects, dev, index=True)[:, k]
                          .clamp(max=g) for k in range(4))
        inside = (sat[:, r1, c1] - sat[:, r0, c1]
                  - sat[:, r1, c0] + sat[:, r0, c0])       # (B, n, C)
        n = torch.arange(len(cls), device=dev)
        return inside[:, n, self._const(cls, dev, index=True)] \
            >= self._const(minc, dev)

    # -- leaf matrix ------------------------------------------------------

    def leaf_values(self, out: FilterOutputs) -> torch.Tensor:
        """(B, L_unique) bool — each deduped leaf evaluated exactly once,
        reordered into slot order with one permutation gather."""
        if self._needs_grid and out.grid is None:
            raise ValueError("plan has Spatial/Region leaves but the filter "
                             "head emits no grid (OD-COF)")
        parts: List[torch.Tensor] = []
        cols: List[np.ndarray] = []
        if self._cnt is not None:
            parts.append(self._count_values(out))
            cols.append(self._cnt[0])
        if self._spa is not None:
            parts.append(self._spatial_values(out))
            cols.append(self._spa[0])
        if self._reg:
            occ = out.occupancy(self.tau)        # ONE threshold pass, bool
            prev_radius = 0
            for radius, slots, cls, rects, minc in self._reg:
                if radius > prev_radius:         # incremental dilation
                    occ = CAM.dilate_manhattan(occ, radius - prev_radius)
                    prev_radius = radius
                parts.append(self._region_sat_values(occ, cls, rects, minc))
                cols.append(slots)
        order = np.concatenate(cols)
        inv = np.zeros(self.n_slot_cols, np.int64)
        inv[order] = np.arange(order.size)     # tombstoned columns keep 0
        dev = out.counts.device
        return torch.cat(parts, dim=1)[:, torch.as_tensor(inv, device=dev)]

    # -- full evaluation --------------------------------------------------

    def _run_program(self, leaf: torch.Tensor,
                     known_ext: Optional[np.ndarray] = None,
                     fill: float = 0.0) -> torch.Tensor:
        """Levelized incidence program over a (B, L) float leaf matrix ->
        (B, L + n_internal) node values.  With ``known_ext``, literals of
        unknown columns read ``fill``."""
        dev = leaf.device
        B = leaf.shape[0]
        vals = torch.cat([leaf, torch.zeros((B, self.n_internal),
                                            dtype=torch.float32, device=dev)],
                         dim=1)
        c = self._const
        for lev in self._levels:
            child = vals[:, c(lev.child_idx, dev, index=True)]
            child = torch.where(c(lev.child_neg, dev), 1.0 - child, child)
            if known_ext is not None:
                child = torch.where(
                    torch.as_tensor(known_ext[lev.child_idx], device=dev),
                    child, fill)
            sums = child @ c(lev.incidence, dev).T
            newv = sums >= c(lev.required, dev) - 0.5
            vals[:, c(lev.node_ids, dev, index=True)] = newv.float()
        return vals

    def _assemble(self, leaf: torch.Tensor) -> torch.Tensor:
        """(B, L) bool leaf matrix -> (B, N) root masks."""
        dev = leaf.device
        vals = self._run_program(leaf.float())
        masks = (vals[:, self._const(self._roots, dev, index=True)] > 0.5) \
            ^ self._const(self._root_neg, dev)
        return masks[:, self._const(self.dup_map, dev, index=True)]

    def evaluate(self, out: FilterOutputs) -> torch.Tensor:
        """(B, N) per-query candidate masks from one shared leaf pass."""
        return self._assemble(self.leaf_values(out))

    def evaluate_with_counts(self, out: FilterOutputs
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(masks (B, N), per-LIVE-slot pass counts)`` — the exhaustive
        path of the adaptive cascade keeps the statistics learning."""
        leaf = self.leaf_values(out)
        live = self._const(self.live_slots, leaf.device, index=True)
        return self._assemble(leaf), leaf[:, live].sum(0)

    @property
    def live_slot_keys(self) -> List[Q.Predicate]:
        return [self.slot_keys[s] for s in self.live_slots]

    # -- three-valued propagation (staged execution) ----------------------

    def propagate_bounds(self, leaf_vals: torch.Tensor, known
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Partial-knowledge evaluation of every query.

        ``leaf_vals``: (B, L) bool with arbitrary values at unknown
        slots; ``known``: (L,) bool.  Returns ``(value, decided)``, both
        (B, N): the program runs with unknown literals forced to 0 (lower
        bound) and to 1 (upper bound); And/Or gates are monotone, so
        agreement means decided and ``value`` is then exact."""
        lo, dec = self._propagate_distinct(leaf_vals, known)
        dm = self._const(self.dup_map, leaf_vals.device, index=True)
        return lo[:, dm], dec[:, dm]

    def _propagate_distinct(self, leaf_vals: torch.Tensor, known
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``propagate_bounds`` in distinct-query space (B, D)."""
        dev = leaf_vals.device
        known = (known.cpu().numpy() if torch.is_tensor(known)
                 else np.asarray(known, bool))
        known_ext = np.concatenate([known, np.ones(self.n_internal, bool)])
        leaf = leaf_vals.float()
        roots = self._const(self._roots, dev, index=True)
        root_known = torch.as_tensor(known_ext[self._roots], device=dev)

        def run(fill: float) -> torch.Tensor:
            vals = self._run_program(leaf, known_ext, fill)
            root = vals[:, roots] > 0.5
            return torch.where(root_known, root,
                               torch.full_like(root, fill > 0.5))

        lo_raw = run(0.0)
        hi_raw = run(1.0)
        # a negated root literal swaps the bounds: lower(~x) = ~upper(x)
        neg = self._const(self._root_neg, dev)
        lo = torch.where(neg, ~hi_raw, lo_raw)
        hi = torch.where(neg, ~lo_raw, hi_raw)
        return lo, lo == hi

    # -- staging ----------------------------------------------------------

    def stage_descriptors(self, cost_model: Optional[CM.CostModel] = None
                          ) -> List[_Stage]:
        """The plan's cost tiers, unordered."""
        cm = cost_model if cost_model is not None else CM.static_cost_model()
        stages: List[_Stage] = []
        if self._cnt is not None:
            stages.append(_Stage("counts", "count", self._cnt[0],
                                 cm.stage_rank_cost("count"), self._cnt))
        if self._spa is not None:
            stages.append(_Stage("spatial", "spatial", self._spa[0],
                                 cm.stage_rank_cost("spatial"), self._spa))
        for radius, slots, cls, rects, minc in self._reg:
            stages.append(_Stage(f"region@r{radius}", "region", slots,
                                 cm.stage_rank_cost("region", radius=radius),
                                 (radius, slots, cls, rects, minc),
                                 radius=radius))
        return stages

    def exhaustive_cost_model(self, cost_model: Optional[CM.CostModel] = None,
                              *, batch: Optional[float] = None) -> float:
        """Cost of one ``evaluate`` call under ``cost_model`` (shared
        threshold, incremental dilation — the adaptive cascade's
        exhaustive baseline)."""
        cm = cost_model if cost_model is not None else CM.static_cost_model()
        return cm.exhaustive_cost(
            has_counts=self._cnt is not None,
            has_spatial=self._spa is not None,
            radii=[radius for radius, *_ in self._reg],
            batch=batch if batch is not None else CM.REF_BATCH)

    def build_staged(self, stats=None, *,
                     order: Optional[Sequence[int]] = None,
                     min_bucket: Optional[int] = None,
                     cost_model: Optional[CM.CostModel] = None,
                     spatial_body: str = "auto",
                     step_cache: Optional[StepCache] = None
                     ) -> "StagedQueryPlan":
        return StagedQueryPlan(self, stats, order=order,
                               min_bucket=min_bucket, cost_model=cost_model,
                               spatial_body=spatial_body,
                               step_cache=step_cache)

    @property
    def sharing_factor(self) -> float:
        """total leaves across queries / unique evaluated leaves (>= 1)."""
        return self.n_total_leaves / max(self.n_unique_leaves, 1)


# --------------------------------------------------------------------------
# Staged adaptive execution
# --------------------------------------------------------------------------

@dataclasses.dataclass
class StageReport:
    """What one ``StagedQueryPlan.evaluate`` call actually did."""
    order: List[str] = dataclasses.field(default_factory=list)
    ran: List[str] = dataclasses.field(default_factory=list)
    skipped: List[str] = dataclasses.field(default_factory=list)
    undecided_after: List[int] = dataclasses.field(default_factory=list)
    rows_evaluated: List[int] = dataclasses.field(default_factory=list)
    # rows each executed stage processed: the bucket, padding included
    undecided_rows_in: List[int] = dataclasses.field(default_factory=list)
    bodies: List[str] = dataclasses.field(default_factory=list)
    # per executed stage: "batch" (full batch), "rows" (compacted; the
    # spatial tier through the row-list kernel) or "full" (compacted
    # spatial tier through the full-batch kernel on the gathered rows)
    steps_compiled: int = 0     # step closures newly built by this batch
    batch: int = 0
    cost_run: float = 0.0       # cost-model cost of the executed stages
    cost_total: float = 0.0     # cost-model cost of the exhaustive plan
    skipped_presumed: List[str] = dataclasses.field(default_factory=list)
    cost_presumed_saved: float = 0.0

    @property
    def stages_run(self) -> int:
        return len(self.ran)


class StagedQueryPlan:
    """Stage-by-stage evaluation of a ``QueryPlan`` with short-circuiting.

    Evaluation walks the cost tiers in ``self.order``; after each tier,
    three-valued propagation marks every (frame, query) cell decided or
    not.  The walk stops once every query column is decided and skips any
    tier none of whose slots appears in a still-undecided query;
    decidedness is monotone in the known-slot set, so the returned masks
    are bit-identical to ``QueryPlan.evaluate``.  Between tiers the
    undecided rows are compacted into a power-of-two bucket (padded by
    repeating the last row) and the next tier evaluates only those rows,
    scattering results back into the full-batch state.

    Each executed tier is one *step* — stage evaluation, scatter, both
    propagation passes, the undecided reductions and the per-slot pass
    counts — cached per (stage, set-of-stages-already-run, bucket, body,
    stream count) under content signatures in a ``StepCache``.  The one
    host round trip per executed tier is the (S, D + B) undecided fetch.  Per-slot pass
    counts stay on the device until ``flush_stats``.
    """

    def __init__(self, plan: QueryPlan, stats=None, *,
                 order: Optional[Sequence[int]] = None,
                 min_bucket: Optional[int] = None,
                 cost_model: Optional[CM.CostModel] = None,
                 spatial_body: str = "auto",
                 step_cache: Optional[StepCache] = None):
        self.plan = plan
        self.cost_model = (cost_model if cost_model is not None
                           else CM.static_cost_model())
        if min_bucket is None:
            min_bucket = self.cost_model.derived_min_bucket()
        if min_bucket < 1:
            raise ValueError(f"min_bucket must be >= 1, got {min_bucket}")
        self.min_bucket = min_bucket
        if spatial_body not in ("auto", "rows", "full"):
            raise ValueError(f"spatial_body must be 'auto', 'rows' or "
                             f"'full', got {spatial_body!r}")
        self.spatial_body = spatial_body
        self._last_batch: Optional[int] = None
        self.stages = plan.stage_descriptors(self.cost_model)
        self._uses_stage = np.stack(
            [plan.distinct_slot_incidence[:, st.slots].any(1)
             for st in self.stages], axis=1)
        self._slot_weight = plan.query_slot_incidence.sum(0).astype(float)
        self.order, self._perms = self._staging_order(stats)
        self._forced_order = order is not None
        if order is not None:
            if sorted(order) != list(range(len(self.stages))):
                raise ValueError(f"order must permute stages "
                                 f"0..{len(self.stages) - 1}, got {order!r}")
            self.order = list(order)
        self.step_cache = (step_cache if step_cache is not None
                           else StepCache())
        self._stage_sigs = [self._stage_sig(si)
                            for si in range(len(self.stages))]
        self._prefix_sigs: Dict[frozenset, str] = {}
        self._trace_count = 0       # step closures built by THIS plan
        self.last_report: Optional[StageReport] = None
        self._pending = None
        self._wrap_refs: List = []  # keep unsigned shard_wraps alive so
        #                             their ids stay unambiguous in keys

    @property
    def step_cache_max(self) -> int:
        """Capacity of the (possibly shared) step cache."""
        return self.step_cache.capacity

    # -- step signatures --------------------------------------------------

    def _stage_sig(self, si: int) -> str:
        """Digest of everything stage ``si``'s body bakes."""
        st = self.stages[si]
        perm = self._perms[si]
        parts: List = [st.kind, st.radius]
        for p in st.payload:
            if isinstance(p, np.ndarray):
                parts.append(p[perm])
            else:
                parts.append(p)                  # region radius scalar
        parts.append(st.slots[perm])
        return content_digest(*parts)

    def _prefix_sig(self, ran: frozenset) -> str:
        """Digest of the SET of slot columns already known (order-free)."""
        sig = self._prefix_sigs.get(ran)
        if sig is None:
            slots = np.zeros(0, np.int64) if not ran else np.unique(
                np.concatenate([self.stages[sj].slots for sj in ran]))
            sig = content_digest(slots)
            self._prefix_sigs[ran] = sig
        return sig

    # -- ordering ---------------------------------------------------------

    def _slot_rates(self, stats) -> np.ndarray:
        """(L,) prior-smoothed pass rate per slot column, quantized so a
        stable order does not flap on statistical noise."""
        rates = np.full(self.plan.n_slot_cols, 0.5)
        if stats is None or self.plan.live_slots.size == 0:
            return rates
        rates[self.plan.live_slots] = stats.pass_rates(
            self.plan.live_slot_keys, canonical=True)
        return np.round(rates, 3)

    def _staging_order(self, stats
                       ) -> Tuple[List[int], Dict[int, np.ndarray]]:
        """Greedy position-aware stage order (cost per expected decision
        at the rows the placed prefix is predicted to leave); slots within
        a stage most-selective first."""
        rates = self._slot_rates(stats)
        cm = self.cost_model
        B = float(self._last_batch or CM.REF_BATCH)
        n = len(self.stages)
        benefit = [float(np.sum(self._slot_weight[st.slots]
                                * (1.0 - rates[st.slots])))
                   for st in self.stages]
        survival = [round(stats.stage_survival(st.name), 3)
                    if stats is not None else 1.0 for st in self.stages]
        order: List[int] = []
        remaining = list(range(n))
        frac = 1.0
        while remaining:
            rows = max(frac, 1.0 / B) * B
            best = min(remaining, key=lambda si: (
                cm.stage_cost(self.stages[si].kind, rows=rows, batch=B,
                              radius=self.stages[si].radius)
                / (benefit[si] + 1e-3), si))
            remaining.remove(best)
            order.append(best)
            frac *= survival[best]
        perms = {si: np.argsort(rates[st.slots], kind="stable")
                 for si, st in enumerate(self.stages)}
        return order, perms

    def restage(self, stats) -> bool:
        """Re-sort stages/slots from the population stats; True when
        anything changed.  Steps are content-signed, so nothing is ever
        dropped from the cache here."""
        order, perms = self._staging_order(stats)
        if self._forced_order:
            order = self.order
        changed = order != self.order
        for si in range(len(self.stages)):
            if not np.array_equal(perms[si], self._perms[si]):
                self._perms[si] = perms[si]
                self._stage_sigs[si] = self._stage_sig(si)
                changed = True
        self.order = order
        return changed

    def staging(self) -> Tuple[List[int], Dict[int, np.ndarray]]:
        """The stage order and each stage's slot order."""
        return list(self.order), dict(self._perms)

    def adopt_staging(self, order: Sequence[int],
                      perms: Dict[int, np.ndarray]) -> None:
        """Take another plan's ``staging()`` of the same stages (the fleet
        engine gives every rank of a mesh rank 0's)."""
        self.order = list(order)
        for si, perm in perms.items():
            if not np.array_equal(perm, self._perms[si]):
                self._perms[si] = perm
                self._stage_sigs[si] = self._stage_sig(si)

    # -- stage steps ------------------------------------------------------

    def _stage_body(self, si: int) -> Callable:
        """``(out, rows=None) -> (B|R, k) bool`` for one stage,
        slot-permuted."""
        plan = self.plan
        st = self.stages[si]
        perm = self._perms[si]
        if st.kind == "count":
            slots, cls, lo, hi = st.payload
            payload = (slots[perm], cls[perm], lo[perm], hi[perm])

            def body(out, rows=None, payload=payload):
                if rows is not None:
                    out = FilterOutputs(counts=out.counts[rows])
                return plan._count_values(out, payload)

            return body
        if st.kind == "spatial":
            slots, a, b, use_row, radius = st.payload
            payload = (slots[perm], a[perm], b[perm], use_row[perm],
                       radius[perm])
            cs = SP.stage_class_slice(payload[1], payload[2])
            return lambda out, rows=None, body="rows": plan._spatial_values(
                out, payload, class_slice=cs, rows=rows, body=body)
        radius, slots, cls, rects, minc = st.payload
        cls, rects, minc = cls[perm], rects[perm], minc[perm]

        def body(out, rows=None, radius=radius, cls=cls, rects=rects,
                 minc=minc):
            grid = out.grid if rows is None else out.grid[rows]
            occ = CAM.threshold_map(grid, plan.tau, logits=False)
            if radius:              # boolean dilation composes exactly
                occ = CAM.dilate_manhattan(occ, radius)
            return plan._region_sat_values(occ, cls, rects, minc)

        return body

    def _stage_slots(self, si: int) -> np.ndarray:
        return self.stages[si].slots[self._perms[si]]

    def _body_for(self, si: int, bucket: Optional[int]) -> str:
        """Which body evaluates stage ``si`` at this bucket."""
        if bucket is None:
            return "batch"
        if self.stages[si].kind != "spatial":
            return "rows"
        if self.spatial_body != "auto":
            return self.spatial_body
        return self.cost_model.spatial_body(rows=bucket)

    # -- execution --------------------------------------------------------

    def _get_step(self, si: int, ran: frozenset, bucket: Optional[int],
                  body: str, n_streams: int,
                  shard_wrap: Optional[Callable] = None,
                  wrap_sig: Optional[Tuple] = None) -> Callable:
        """The step for stage ``si`` given the stages that already ran,
        over S = ``n_streams`` streams' flat (S·B) batch: eval + scatter
        + both propagation passes + per-stream undecided reductions +
        pass counts.  ``bucket=None`` is the full-batch step; with a
        bucket the step takes (S·bucket,) flat row ids ``s·B + r`` (each
        stream's survivors padded to the bucket) plus the (S,) real
        survivor counts.

        The JAX package keeps a single-stream step and vmaps it over the
        stream axis for the fleet (``_get_group_step``, optionally
        ``shard_map``-ed over a device mesh); here the stream axis is a
        batch dimension of one step family, and one stream is S = 1.
        The full-batch step sees the flat (S·B, g, g, C) view, so the
        stage's stats kernel runs once over S·B frames; the compacted
        step's row kernel runs once over every stream's survivors.  Only
        the undecided reductions and ``presumed`` are per stream:
        decidedness is reshaped to (S, B, D) before reducing.  Every
        other operation is per row, so each stream's slice is
        bit-identical to its walk alone (pinned by
        tests/test_torch_multistream.py).

        Under a ``shard_wrap`` (``distributed.sharding.ShardMap`` over a
        ``("stream",)`` mesh) the step runs on the calling rank's block of
        ``n_streams`` streams.  Keys carry the stream count and the mesh
        identity: ``wrap_sig`` (a content digest of the mesh, so rebuilt
        engines over the same mesh share steps), else the wrap's id, with
        the wrap kept alive so that a recycled id never aliases a dead
        wrap's entries."""
        if shard_wrap is None:
            wrap_key: Optional[Tuple] = None
        elif wrap_sig is not None:
            wrap_key = wrap_sig
        else:
            self._wrap_refs.append(shard_wrap)
            wrap_key = ("wrapid", id(shard_wrap))
        key = ("gstep", self.plan.plan_sig, self._stage_sigs[si],
               self._prefix_sig(ran), bucket, body, n_streams, wrap_key)
        step = self.step_cache.get(key)
        if step is not None:
            return step
        plan = self.plan
        D = plan.n_distinct
        stage_body = self._stage_body(si)
        slots = self._stage_slots(si)
        spatial = self.stages[si].kind == "spatial"
        known = np.zeros(plan.n_slot_cols, bool)
        for sj in ran:
            known[self.stages[sj].slots] = True
        known[slots] = True

        def undecided(decided, presumed):
            """(S, D + B): per stream, the undecided distinct columns and
            the undecided rows (``presumed`` is (S, D))."""
            dec = decided.view(presumed.shape[0], -1, D) \
                | presumed[:, None, :]
            return torch.cat([~dec.all(1), ~dec.all(2)], dim=1)

        if bucket is None:
            def step(out, leaf_vals, presumed):
                vals = stage_body(out)                 # (S·B, k) bool
                leaf_vals[:, plan._const(slots, vals.device,
                                         index=True)] = vals
                value, decided = plan._propagate_distinct(leaf_vals, known)
                return (leaf_vals, value, decided,
                        undecided(decided, presumed), vals.sum(0))
        else:
            def step(out, leaf_vals, value, decided, idx, n_real, presumed):
                vals = (stage_body(out, rows=idx, body=body) if spatial
                        else stage_body(out, rows=idx))  # (S·bucket, k)
                sub = leaf_vals[idx]
                sub[:, plan._const(slots, vals.device, index=True)] = vals
                leaf_vals[idx] = sub
                v, dec = plan._propagate_distinct(sub, known)
                value[idx] = v
                decided[idx] = dec
                # each stream's padded duplicate rows must not inflate
                # the pass counts
                valid = (torch.arange(bucket, device=vals.device)[None, :]
                         < n_real[:, None]).reshape(-1)
                return (leaf_vals, value, decided,
                        undecided(decided, presumed),
                        (vals & valid[:, None]).sum(0))

        if shard_wrap is not None:
            step = shard_wrap(step)
        self._trace_count += 1
        self.step_cache.put(key, step)
        return step

    def evaluate(self, out: FilterOutputs,
                 presumed_decided: Optional[np.ndarray] = None
                 ) -> torch.Tensor:
        """(B, N) bool masks, bit-identical to ``QueryPlan.evaluate`` —
        but stages stop/skip as soon as the undecided set allows, and
        each stage evaluates only the rows still undecided.

        ``presumed_decided`` — optional (N,) bool mask of query columns
        the caller already decided out of band; they stop contributing
        to the skip test, the early stop and the row compaction, and
        their returned values are unspecified.

        One stream is the S = 1 case of ``evaluate_group``: the outputs
        gain a stream axis as views, so the kernels read them in place."""
        N = len(self.plan.queries)
        if presumed_decided is not None:
            presumed_decided = np.asarray(presumed_decided, bool)
            if presumed_decided.shape != (N,):
                raise ValueError(f"presumed_decided must be shape ({N},), "
                                 f"got {presumed_decided.shape}")
            presumed_decided = presumed_decided[None]
        stacked = FilterOutputs(
            counts=out.counts[None],
            grid=None if out.grid is None else out.grid[None])
        return self.evaluate_group(
            stacked, presumed_decided=presumed_decided)[0]

    # -- fleet execution ----------------------------------------------------

    def evaluate_group(self, outs: FilterOutputs, *,
                       shard_wrap: Optional[Callable] = None,
                       wrap_sig: Optional[Tuple] = None,
                       presumed_decided: Optional[np.ndarray] = None
                       ) -> torch.Tensor:
        """(S, B, N) bool masks for S streams' stacked batches — each
        stream's slice bit-identical to ``evaluate`` on that stream's
        batch alone.

        ``outs`` carries a leading stream axis (counts (S, B, C), grid
        (S, B, g, g, C) or None), typically stacked one chunk ahead by
        ``distributed.multistream``.  The stages read the flat (S·B, ...)
        view of it (a view when the stack is contiguous).

        Staging decisions are **group-uniform**: a tier runs when ANY
        stream's undecided queries need it, the row-compaction bucket is
        the power of two covering the WORST stream's undecided count
        (every stream's rows padded to it), and the spatial body is
        chosen once for the group at that bucket.  Both relaxations only
        ever evaluate *more* rows or tiers for a stream than its solo
        staging would, and decided (frame, query) cells are invariant to
        extra evaluation (the monotonicity that makes tier skipping
        sound), so per-stream answers stay bit-identical while the group
        keeps one step — and one host sync — per stage for the whole
        fleet slice.

        Ledger feedback aggregates across streams: full-batch stage
        evaluations contribute S·B frames of unconditional per-slot pass
        counts, and the stage row/survival ledgers see the group's total
        paid rows over an S·B-row batch (``flush_stats`` is unchanged).
        ``StageReport`` costs are priced per stream at the rows each
        stream's slice evaluated, times S.

        ``presumed_decided`` — optional (S, N) bool mask of query columns
        each *stream's* temporal tier has already window-decided (see
        ``evaluate``).  Presumption is per stream: stream s's presumed
        columns stop feeding its skip/stop/compaction tests while other
        streams keep evaluating.  Presumed columns' returned values are
        UNSPECIFIED, as in ``evaluate``; stages skipped only thanks to
        presumption land in ``StageReport.skipped_presumed`` /
        ``cost_presumed_saved``.

        ``shard_wrap`` — a ``distributed.sharding.ShardMap`` over a
        ``("stream",)`` mesh of W ranks: ``outs`` is then the calling
        rank's contiguous block of S / W streams, and so is the returned
        (S / W, B, N) tensor.  Each step runs on the rank's rows (the
        stats kernel over (S / W)·B frames, the row kernel on local flat
        ids), while every staging decision stays group-wide and equal on
        every rank: the per-stage (S / W, D + B) undecided fetch becomes
        an all-gather of the (S, D + B) table, ``presumed_decided`` is
        the whole (S, N) mask, the report is priced at S, and
        ``flush_stats`` sums the pass counts over the ranks.  A rank that
        decided from its own rows alone would take other branches than
        its peers, and their collectives would no longer pair.
        ``wrap_sig`` — a stable content signature of the wrap's mesh,
        keying the steps (see ``_get_step``)."""
        plan = self.plan
        dev = outs.counts.device
        S, B = outs.counts.shape[:2]
        blk = slice(0, S)
        if shard_wrap is not None:
            S *= shard_wrap.world
            blk = shard_wrap.block(S)
        S_loc = blk.stop - blk.start
        self._last_batch = B
        N = len(plan.queries)
        D = plan.n_distinct
        if presumed_decided is None:
            presumed = np.zeros((S, N), bool)
        else:
            presumed = np.asarray(presumed_decided, bool)
            if presumed.shape != (S, N):
                raise ValueError(f"presumed_decided must be shape "
                                 f"({S}, {N}), got {presumed.shape}")
        # per-stream distinct-space presumption: a distinct column is
        # presumed only when ALL query columns mapping to it are
        presumed_d = np.ones((S, D), bool)
        for s in range(S):
            np.logical_and.at(presumed_d[s], plan.dup_map, presumed[s])
        if presumed_d.all():
            # every stream's every query is window-decided: the whole
            # group batch is one presumed skip
            report = StageReport(
                order=[self.stages[s].name for s in self.order],
                cost_total=S * plan.exhaustive_cost_model(self.cost_model,
                                                          batch=B),
                batch=S * B)
            stage_rows = []
            for si in self.order:
                st = self.stages[si]
                report.skipped.append(st.name)
                report.skipped_presumed.append(st.name)
                report.cost_presumed_saved += S * self.cost_model.stage_cost(
                    st.kind, rows=B, batch=B, radius=st.radius)
                stage_rows.append((st.name, 0, S * B, None, None))
            self.last_report = report
            self._pending = ([], stage_rows, None)
            return torch.zeros((S_loc, B, N), dtype=torch.bool, device=dev)
        flat = FilterOutputs(
            counts=outs.counts.reshape(S_loc * B, *outs.counts.shape[2:]),
            grid=None if outs.grid is None
            else outs.grid.reshape(S_loc * B, *outs.grid.shape[2:]))
        presumed_dev = torch.as_tensor(presumed_d[blk], device=dev)
        leaf_vals = torch.zeros((S_loc * B, plan.n_slot_cols),
                                dtype=torch.bool, device=dev)
        value = torch.zeros((S_loc * B, D), dtype=torch.bool, device=dev)
        decided = torch.zeros((S_loc * B, D), dtype=torch.bool, device=dev)
        undecided_cols = ~presumed_d
        undecided_rows = np.ones((S, B), bool)
        report = StageReport(order=[self.stages[s].name for s in self.order],
                             cost_total=S * plan.exhaustive_cost_model(
                                 self.cost_model, batch=B),
                             batch=S * B)
        traces_before = self._trace_count
        pending: List[Tuple[np.ndarray, torch.Tensor, int]] = []
        stage_rows: List[Tuple[str, int, int, Optional[int],
                               Optional[int]]] = []
        ran: frozenset = frozenset()
        for si in self.order:
            st = self.stages[si]
            if not (self._uses_stage[None, :, si] & undecided_cols).any():
                report.skipped.append(st.name)
                if (self._uses_stage[None, :, si] & presumed_d).any():
                    # would have run for presumed columns' sake alone
                    report.skipped_presumed.append(st.name)
                    report.cost_presumed_saved += \
                        S * self.cost_model.stage_cost(
                            st.kind, rows=B, batch=B, radius=st.radius)
                stage_rows.append((st.name, 0, S * B, None, None))
                continue
            if st.kind != "count" and outs.grid is None:
                raise ValueError(
                    f"stage {st.name!r} has Spatial/Region leaves of an "
                    f"undecided query but the filter head emits no grid "
                    f"(OD-COF)")
            n_rows = undecided_rows.sum(1)              # (S,)
            worst = int(n_rows.max())
            if worst >= B:
                bucket = B                              # full-batch step
            else:
                bucket = max(1, int(self.min_bucket))
                while bucket < worst:
                    bucket <<= 1
                bucket = min(bucket, B)
            if bucket >= B:
                body = self._body_for(si, None)
                step = self._get_step(si, ran, None, body, S_loc,
                                      shard_wrap, wrap_sig)
                leaf_vals, value, decided, undec, counts = step(
                    flat, leaf_vals, presumed_dev)
                rows_eval = B
            else:
                body = self._body_for(si, bucket)
                step = self._get_step(si, ran, bucket, body, S_loc,
                                      shard_wrap, wrap_sig)
                # this rank's streams' undecided rows padded (repeating
                # the last survivor, so duplicate scatters are benign) to
                # the GROUP bucket, as local flat ids
                idx = np.zeros((S_loc, bucket), np.int64)
                for s, rows in enumerate(undecided_rows[blk]):
                    rows_s = np.nonzero(rows)[0]
                    n = rows_s.size
                    idx[s, :n] = rows_s
                    idx[s, n:] = rows_s[-1] if n else 0
                idx += (np.arange(S_loc, dtype=np.int64) * B)[:, None]
                leaf_vals, value, decided, undec, counts = step(
                    flat, leaf_vals, value, decided,
                    torch.as_tensor(idx.reshape(-1), device=dev),
                    torch.as_tensor(n_rows[blk], device=dev), presumed_dev)
                rows_eval = bucket
            if rows_eval == B:
                # only full-batch evaluations feed the per-slot ledger,
                # S·B unconditional frames (a compacted stage sees its
                # slots conditioned on the row being undecided, not the
                # frame-level selectivity)
                pending.append((self._stage_slots(si), counts, S * B))
            undec = undec.cpu().numpy()     # ONE (S, D + B) fetch/stage
            if shard_wrap is not None:      # ... gathered over the ranks
                undec = shard_wrap.gather(undec)
            undecided_cols, undecided_rows = undec[:, :D], undec[:, D:]
            stage_rows.append((st.name, rows_eval * S, S * B,
                               int(n_rows.sum()),
                               int(undecided_rows.sum())))
            ran = ran | {si}
            report.ran.append(st.name)
            report.rows_evaluated.append(rows_eval * S)
            report.undecided_rows_in.append(int(n_rows.sum()))
            report.bodies.append(body)
            report.cost_run += S * self.cost_model.stage_cost(
                st.kind, rows=rows_eval, batch=B, radius=st.radius,
                body=body if body in ("rows", "full") else None)
            report.undecided_after.append(
                int((undecided_cols[:, plan.dup_map] & ~presumed).sum()))
            if not undecided_cols.any():
                break
        assert report.ran, "every query owns at least one slot, so a " \
                           "stage runs while any column is undecided"
        for sj in self.order[len(report.ran) + len(report.skipped):]:
            report.skipped.append(self.stages[sj].name)
            stage_rows.append((self.stages[sj].name, 0, S * B, None, None))
        report.steps_compiled = self._trace_count - traces_before
        self.last_report = report
        self._pending = (pending, stage_rows, shard_wrap)
        dm = plan._const(plan.dup_map, dev, index=True)
        return value.view(S_loc, B, D)[:, :, dm]

    def flush_stats(self, stats) -> None:
        """Fold the last batch's per-slot pass counts into ``stats`` with
        one device fetch (summed over the ranks under a ``shard_wrap``, so
        every rank's ledger sees the whole group's); per-stage row traffic
        goes to the stage ledger behind ``predicted_batch_cost``."""
        if not self._pending:
            return
        pending, stage_rows, shard_wrap = self._pending
        self._pending = None
        if pending:
            counts = torch.cat([c for _, c, _ in pending]).cpu().numpy()
            if shard_wrap is not None:
                counts = shard_wrap.psum(counts)
            off = 0
            for slots, _, seen in pending:
                stats.observe_many(
                    [self.plan.slot_keys[s] for s in slots],
                    counts[off:off + len(slots)], seen, canonical=True)
                off += len(slots)
        for name, rows, batch, surv_in, surv_out in stage_rows:
            stats.observe_stage_rows(name, rows, batch)
            if surv_in:
                stats.observe_stage_survival(name, surv_in, surv_out)

    def predicted_batch_cost(self, stats,
                             step_overhead: Optional[float] = None,
                             *, batch: Optional[int] = None) -> float:
        """Ledger-predicted cost of one staged batch: each stage priced
        at its learned row fraction, plus ``step_overhead`` per expected
        execution."""
        cm = self.cost_model
        if step_overhead is None:
            step_overhead = cm.step_overhead()
        B = float(batch or self._last_batch or CM.REF_BATCH)
        cost = 0.0
        for si in self.order:
            st = self.stages[si]
            if stats is None:
                frac, execd = 1.0, 1.0
            else:
                frac = stats.stage_row_frac(st.name)
                execd = stats.stage_exec_rate(st.name)
            rows_cond = min(frac / max(execd, 1e-9), 1.0) * B
            cost += execd * cm.stage_cost(st.kind, rows=rows_cond, batch=B,
                                          radius=st.radius) \
                + step_overhead * execd
        return cost

    def describe(self) -> List[Dict]:
        """Operator view of the current staging (order, cost, slots)."""
        return [{"stage": self.stages[si].name,
                 "kind": self.stages[si].kind,
                 "cost": self.stages[si].cost,
                 "slots": [repr(self.plan.slot_keys[s])
                           for s in self._stage_slots(si)]}
                for si in self.order]


def plan_queries(queries: Sequence[Q.Predicate], *,
                 tau: float = 0.2,
                 leaf_table: Optional[CanonicalLeafTable] = None,
                 prev: Optional[QueryPlan] = None) -> QueryPlan:
    return QueryPlan(queries, tau=tau, leaf_table=leaf_table, prev=prev)
