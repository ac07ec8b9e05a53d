"""Temporal/event-pattern query tier: streaming automata over frame masks.

The port of the JAX package's ``core/temporal.py``; the design is the
same, and so are the answers and the decidedness, bit for bit.

The paper's monitoring queries are inherently temporal ("a car left of a
truck *for at least five seconds*"), but every evaluator below this module
is frame-at-a-time.  This module compiles duration/sequence/window
operators into streaming state machines over per-frame predicate
verdicts, and uses the staged planner's three-valued decidedness in
*time*: once a query's window outcome is decided (duration met, sequence
deadline blown, sliding-count target unreachable), its frame-level
sub-predicates stop being evaluated for the rest of the window
(``StagedQueryPlan.evaluate(presumed_decided=...)``), and a batch where
every query is decided skips the filter head and the oracle entirely.

1.  **Stripping + signal dedup** (``TemporalProgram``).  Every temporal
    operator becomes a reference to a *streaming automaton* and every
    maximal frame-level subtree (each automaton's input predicate too) a
    reference to a deduplicated, canonicalized *frame signal*, evaluated
    once by the shared frame-level cascade over ``frame_queries``.

2.  **Batched automata.**  Automaton state lives in per-kind vectors
    (run lengths, sequence deadlines, sliding-count ring buffers).  The
    default backend (``"scan"``) advances a batch with one step on the
    program's device: a function ``(state, signals) -> (state', out)``
    written once for a leading stream axis (state leaves (S, ...),
    signals (S, B, M), outputs (S, B, N); one stream is S = 1) that loops
    over the B frames in Python, advancing every automaton of every
    stream at once with tensor ops and no host sync, then runs the
    levelized assembly as masked matmuls (0/1 operands, small integer
    sums: exact).  It takes the place of the JAX package's jitted
    ``lax.scan`` and is cached in a ``StepCache`` under the program's
    content digest.  ``backend="numpy"`` keeps the per-frame numpy loop
    as the differential reference (an explicit argument only: no
    environment variable changes what the card runs).  ``advance_group`` runs the same step at
    S = len(programs), so the fleet engine advances S windows at once.
    Decidedness stays on the host in numpy: the step's final state is
    copied back into the per-kind mirrors after each batch, in one
    device-to-host transfer.

3.  **NNF incidence assembly.**  The stripped skeletons are normalised to
    NNF and flattened into one levelized incidence program over (frame
    signals ++ automaton outputs), used once per batch on the values and
    once per decidedness update on interval bounds (monotone gates make
    the interval propagation exact).

4.  **Window-outcome short-circuit** (``TemporalEngine``).  After each
    batch the program re-derives per-query *future decidedness*: an
    automaton is decided when latched (True forever) or when even an
    all-favourable future cannot complete the event (False forever).  A
    frame signal consumed only by decided queries and frozen automata is
    *suppressed*: the engine feeds it to the staged planner as
    ``presumed_decided``, drops it from the oracle union, and once every
    query is decided skips the rest of the window outright.

Held bit for bit against the JAX package and against the naive per-frame
replay ``replay_reference`` in tests/test_torch_temporal.py.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import query as Q
from repro_torch.core.stepcache import StepCache, content_digest
from repro_torch.device import DeviceLike, require_on, resolve_device

__all__ = ["TemporalProgram", "TemporalEngine", "TemporalStats",
           "advance_group", "replay_reference"]

# valid values for TemporalProgram(backend=)
_BACKENDS = ("scan", "numpy")


# --------------------------------------------------------------------------
# stripped-skeleton leaf references
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _FRef:
    """Skeleton leaf: column ``j`` of the frame-signal matrix."""
    j: int


@dataclasses.dataclass(frozen=True)
class _TRef:
    """Skeleton leaf: output of automaton ``i``."""
    i: int


_OP_CODE = {Q.Op.EQ: 0, Q.Op.GE: 1, Q.Op.LE: 2}


def _cmp_vec(x: np.ndarray, op_code: np.ndarray,
             value: np.ndarray) -> np.ndarray:
    """Vectorized Op over per-automaton op codes (exact, tolerance-free —
    the temporal count is over boolean frame verdicts)."""
    return np.where(op_code == 0, x == value,
                    np.where(op_code == 1, x >= value, x <= value))


@dataclasses.dataclass
class TemporalStats:
    """What the temporal short-circuit saved (fed by ``TemporalEngine``)."""
    frames_in: int = 0
    frames_skipped: int = 0        # whole frames never filtered/oracled
                                   # (every query's window outcome decided)
    signal_evals_skipped: int = 0  # (frame x suppressed-signal) evaluations
                                   # avoided while some queries stayed live
    oracle_frames: int = 0
    windows: int = 0
    cost_saved_model: float = 0.0  # CostModel-priced work avoided: presumed
                                   # stage skips + whole-batch filter skips
    cost_temporal_model: float = 0.0  # CostModel-priced automaton-advance
                                      # work actually paid (measured when a
                                      # "temporal" coefficient is calibrated)


# the step's state leaves: the int32 counters first, then the bool
# latches and buffers, so every leaf of a packed byte buffer starts
# 4-byte aligned
_N_INT_LEAVES = 4


def _fetch(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Copy int32/bool tensors (int32 first) to the host in ONE transfer:
    their bytes are concatenated on the device by one ``cat`` and split
    on the host; each comes back as a view with its shape and dtype."""
    flat = torch.cat([t.reshape(-1).view(torch.uint8) for t in tensors])
    host = flat.cpu().numpy()
    out, off = [], 0
    for t in tensors:
        n = t.numel() * t.element_size()
        dtype = np.int32 if t.dtype == torch.int32 else np.bool_
        out.append(host[off:off + n].view(dtype).reshape(tuple(t.shape)))
        off += n
    return out


def _push(programs: Sequence["TemporalProgram"],
          device: torch.device) -> Tuple[torch.Tensor, ...]:
    """The programs' automaton state stacked on a leading stream axis,
    as the step's input on ``device``, in ONE transfer: the leaves are
    packed into one byte buffer on the host, copied once, and split on
    the device into views (int counters narrowed to int32 — values are
    bounded by the window length, so exact)."""
    leaves = [np.stack(leaf) for leaf in zip(*(p._state_arrays()
                                               for p in programs))]
    host = np.concatenate(
        [(a.astype(np.int32) if i < _N_INT_LEAVES else a.astype(bool))
         .reshape(-1).view(np.uint8) for i, a in enumerate(leaves)])
    flat = torch.from_numpy(host).to(device)
    out, off = [], 0
    for i, a in enumerate(leaves):
        dtype, size = ((torch.int32, 4) if i < _N_INT_LEAVES
                       else (torch.bool, 1))
        n = a.size * size
        out.append(flat[off:off + n].view(dtype).view(a.shape))
        off += n
    return tuple(out)


class TemporalProgram:
    """Compiles N (possibly temporal) queries into shared frame signals,
    batched streaming automata, and an NNF incidence assembly.

    Lifecycle: ``start_window(n)`` resets all state for a hopping window
    of ``n`` frames; ``advance(signals)`` consumes the next (B, M) bool
    frame-signal verdicts and returns the (B, N) per-frame query
    outputs; ``query_decided``/``suppressed_signals`` expose the
    window-outcome short-circuit state *as of the frames consumed so
    far*.  Purely frame-level queries (no temporal operator) are
    supported — their output is just the assembled frame verdict and
    they never become future-decided.

    ``backend`` selects how ``advance`` runs the automata: ``"scan"``
    (default) advances the
    batch with the batched torch step on ``device`` (default CUDA,
    raising when absent), cached in ``step_cache`` (a private
    ``StepCache`` when none is given) under the program's content
    digest; ``"numpy"`` keeps the per-frame loop on the host — the
    differential reference — and takes no device.  Both are
    bit-identical by construction and by test.
    """

    def __init__(self, queries: Sequence[Q.Predicate], *,
                 backend: str = "scan",
                 step_cache: Optional[StepCache] = None,
                 device: DeviceLike = None):
        if not queries:
            raise ValueError("TemporalProgram needs at least one query")
        if backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {_BACKENDS}, "
                             f"got {backend!r}")
        self.backend = backend
        self.device = resolve_device(device) if backend == "scan" else None
        self._step_cache = step_cache if step_cache is not None \
            else StepCache()
        self.scan_traces = 0          # scan-step builds (compile-equivalent)
        self.queries = tuple(queries)
        N = len(self.queries)

        self._sig_index: Dict[Q.Predicate, int] = {}
        self.frame_queries: List[Q.Predicate] = []
        auto_index: Dict[Tuple, int] = {}
        auto_specs: List[Tuple] = []
        # (query, skeleton-FRef) incidence rows, filled during strip
        self._fref_rows: List[List[int]] = [[] for _ in range(N)]
        self._troot_rows: List[List[int]] = [[] for _ in range(N)]

        def sig(pred: Q.Predicate) -> int:
            key = Q.canonicalize(pred)
            j = self._sig_index.get(key)
            if j is None:
                j = len(self.frame_queries)
                self._sig_index[key] = j
                self.frame_queries.append(key)
            return j

        def strip(q: Q.Predicate, qi: int):
            if not Q.has_temporal(q):
                j = sig(q)
                self._fref_rows[qi].append(j)
                return _FRef(j)
            if isinstance(q, Q.Duration):
                spec = ("dur", sig(q.pred), q.min_frames)
            elif isinstance(q, Q.Sequence):
                spec = ("seq", sig(q.first), sig(q.then), q.within)
            elif isinstance(q, Q.SlidingCount):
                spec = ("cnt", sig(q.pred), q.window,
                        _OP_CODE[q.op], q.value)
            elif isinstance(q, (Q.And, Q.Or)):
                terms = tuple(strip(t, qi) for t in q.terms)
                return Q.And(terms) if isinstance(q, Q.And) else Q.Or(terms)
            elif isinstance(q, Q.Not):
                return Q.Not(strip(q.term, qi))
            else:  # pragma: no cover - has_temporal implies one of these
                raise TypeError(q)
            i = auto_index.get(spec)
            if i is None:
                i = len(auto_specs)
                auto_index[spec] = i
                auto_specs.append(spec)
            self._troot_rows[qi].append(i)
            return _TRef(i)

        skeletons = [Q.to_nnf(strip(q, qi))
                     for qi, q in enumerate(self.queries)]
        self.n_signals = M = len(self.frame_queries)
        self.n_automata = T = len(auto_specs)

        # ---- per-kind automaton parameter vectors -----------------------
        dur = [(i, s) for i, s in enumerate(auto_specs) if s[0] == "dur"]
        seq = [(i, s) for i, s in enumerate(auto_specs) if s[0] == "seq"]
        cnt = [(i, s) for i, s in enumerate(auto_specs) if s[0] == "cnt"]
        self._d_cols = np.array([i for i, _ in dur], int)
        self._d_sig = np.array([s[1] for _, s in dur], int)
        self._d_min = np.array([s[2] for _, s in dur], int)
        self._s_cols = np.array([i for i, _ in seq], int)
        self._s_siga = np.array([s[1] for _, s in seq], int)
        self._s_sigb = np.array([s[2] for _, s in seq], int)
        self._s_within = np.array([s[3] for _, s in seq], int)
        self._c_cols = np.array([i for i, _ in cnt], int)
        self._c_sig = np.array([s[1] for _, s in cnt], int)
        self._c_win = np.array([s[2] for _, s in cnt], int)
        self._c_op = np.array([s[3] for _, s in cnt], int)
        self._c_val = np.array([s[4] for _, s in cnt], int)

        # (T, M) which signals each automaton consumes
        self._auto_sig = np.zeros((T, M), bool)
        for i, s in enumerate(auto_specs):
            self._auto_sig[i, s[1]] = True
            if s[0] == "seq":
                self._auto_sig[i, s[2]] = True
        # (N, M) skeleton FRef incidence (signals a query reads directly)
        self._fref_inc = np.zeros((N, M), bool)
        for qi, cols in enumerate(self._fref_rows):
            self._fref_inc[qi, cols] = True
        # (N, T) which automata each query's skeleton reads
        self._tref_inc = np.zeros((N, T), bool)
        for qi, cols in enumerate(self._troot_rows):
            self._tref_inc[qi, cols] = True
        # (N, M) all signals a query needs live (direct + via automata)
        self.query_signal_incidence = (
            self._fref_inc | (self._tref_inc @ self._auto_sig))
        self.has_temporal = T > 0

        self._compile_levels(skeletons)
        # content signature: everything the scan step bakes in (per-kind
        # parameter vectors + the levelized assembly) — the StepCache
        # key, so two programs over the same canonical queries share
        # built steps
        self.program_sig = content_digest(
            "temporal-program", M, T, N,
            self._d_cols, self._d_sig, self._d_min,
            self._s_cols, self._s_siga, self._s_sigb, self._s_within,
            self._c_cols, self._c_sig, self._c_win, self._c_op,
            self._c_val, self.root_col, self.root_neg, self.n_cols,
            *[part for lvl in self._levels for part in lvl])
        self.start_window(0)

    # -- skeleton compilation (levelized NNF incidence program) -----------

    def _compile_levels(self, skeletons: Sequence[Q.Predicate]) -> None:
        M, T = self.n_signals, self.n_automata
        next_col = [M + T]
        nodes: List[Tuple[int, int, List[Tuple[int, bool]], bool]] = []
        # (col, depth, [(child_col, neg)], is_and)

        def compile_node(node) -> Tuple[int, bool, int]:
            """-> (column, negated, depth)."""
            if isinstance(node, Q.Not):        # NNF: literal negation only
                col, neg, d = compile_node(node.term)
                return col, not neg, d
            if isinstance(node, _FRef):
                return node.j, False, 0
            if isinstance(node, _TRef):
                return M + node.i, False, 0
            assert isinstance(node, (Q.And, Q.Or))
            children = [compile_node(t) for t in node.terms]
            depth = 1 + max(d for _, _, d in children)
            col = next_col[0]
            next_col[0] += 1
            nodes.append((col, depth,
                          [(c, n) for c, n, _ in children],
                          isinstance(node, Q.And)))
            return col, False, depth

        roots = [compile_node(sk) for sk in skeletons]
        self.root_col = np.array([c for c, _, _ in roots], int)
        self.root_neg = np.array([n for _, n, _ in roots], bool)
        self.n_cols = next_col[0]

        self._levels: List[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray, np.ndarray]] = []
        by_depth: Dict[int, List] = {}
        for col, depth, children, is_and in nodes:
            by_depth.setdefault(depth, []).append((col, children, is_and))
        for depth in sorted(by_depth):
            lvl = by_depth[depth]
            child_pairs = []
            for _, children, _ in lvl:
                child_pairs.extend(children)
            child_idx = np.array([c for c, _ in child_pairs], int)
            child_neg = np.array([n for _, n in child_pairs], bool)
            node_ids = np.array([c for c, _, _ in lvl], int)
            incidence = np.zeros((len(lvl), len(child_pairs)))
            required = np.zeros(len(lvl))
            off = 0
            for p, (_, children, is_and) in enumerate(lvl):
                incidence[p, off:off + len(children)] = 1.0
                required[p] = len(children) if is_and else 1
                off += len(children)
            self._levels.append((node_ids, child_idx, child_neg,
                                 incidence, required))

    def _assemble(self, leaf_vals: np.ndarray) -> np.ndarray:
        """(B, M+T) bool leaf values -> (B, N) bool root values via the
        levelized incidence program (one matmul per depth level)."""
        B = leaf_vals.shape[0]
        vals = np.zeros((B, self.n_cols), bool)
        vals[:, :leaf_vals.shape[1]] = leaf_vals
        for node_ids, child_idx, child_neg, inc, req in self._levels:
            lit = vals[:, child_idx] ^ child_neg[None, :]
            vals[:, node_ids] = (lit.astype(np.float64) @ inc.T) >= req
        out = vals[:, self.root_col] ^ self.root_neg[None, :]
        return out

    def _root_bounds(self, leaf_lo: np.ndarray,
                     leaf_hi: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Interval propagation through the same levels: (lo, hi) per
        query root.  Exact for the monotone NNF gates."""
        lo = np.zeros(self.n_cols, bool)
        hi = np.zeros(self.n_cols, bool)
        m = leaf_lo.shape[0]
        lo[:m], hi[:m] = leaf_lo, leaf_hi
        for node_ids, child_idx, child_neg, inc, req in self._levels:
            lit_lo = np.where(child_neg, ~hi[child_idx], lo[child_idx])
            lit_hi = np.where(child_neg, ~lo[child_idx], hi[child_idx])
            lo[node_ids] = (lit_lo.astype(np.float64) @ inc.T) >= req
            hi[node_ids] = (lit_hi.astype(np.float64) @ inc.T) >= req
        root_lo = np.where(self.root_neg, ~hi[self.root_col],
                           lo[self.root_col])
        root_hi = np.where(self.root_neg, ~lo[self.root_col],
                           hi[self.root_col])
        return root_lo, root_hi

    # -- window lifecycle -------------------------------------------------

    def start_window(self, n_frames: int) -> None:
        """Reset all automaton state for a hopping window of ``n_frames``
        frames (temporal operators are scoped to the window)."""
        self.window_len = int(n_frames)
        self.pos = 0
        nd, ns, nc = len(self._d_cols), len(self._s_cols), len(self._c_cols)
        self._d_run = np.zeros(nd, np.int64)
        self._d_latch = np.zeros(nd, bool)
        self._d_dead = np.zeros(nd, bool)
        self._s_arm = np.zeros(ns, np.int64)
        self._s_latch = np.zeros(ns, bool)
        self._s_dead = np.zeros(ns, bool)
        wmax = int(self._c_win.max()) if nc else 1
        self._c_buf = np.zeros((nc, wmax), bool)
        self._c_cnt = np.zeros(nc, np.int64)
        self._c_latch = np.zeros(nc, bool)
        self._c_dead = np.zeros(nc, bool)
        # per-query window-outcome latch: -1 undecided, else 0/1
        self._q_dec = np.full(len(self.queries), -1, np.int8)
        self._update_decidedness()

    # -- streaming --------------------------------------------------------

    def advance(self, signals) -> np.ndarray:
        """Consume the next (B, M) bool frame-signal verdicts (numpy, or
        a tensor on the program's device); return the (B, N) bool
        per-frame query outputs.

        Suppressed signals may carry arbitrary values: every automaton
        that reads them is frozen (latched or dead — state no longer
        updates) and every query whose skeleton reads them directly is
        window-decided, so its output column is overridden with the
        latched outcome below.  Feeding more frames than
        ``start_window`` declared is an error."""
        if not torch.is_tensor(signals):
            signals = np.asarray(signals, bool)
        B = signals.shape[0]
        if tuple(signals.shape) != (B, self.n_signals):
            raise ValueError(f"signals must be (B, {self.n_signals}), "
                             f"got {tuple(signals.shape)}")
        if self.pos + B > self.window_len:
            raise ValueError(
                f"advance past window end: pos={self.pos} + B={B} > "
                f"window_len={self.window_len} (call start_window)")
        # decidedness as of the window prefix consumed BEFORE this batch:
        # these columns' outputs are constants this whole batch
        dec_before = self._q_dec.copy()
        if self.backend == "scan" and B:
            out = self._advance_scan(signals)
        else:
            out = self._advance_numpy(_host_bool(signals))
        self.pos += B
        decided = dec_before >= 0
        if decided.any():
            out[:, decided] = dec_before[decided].astype(bool)[None, :]
        self._update_decidedness()
        return out

    def _advance_numpy(self, signals: np.ndarray) -> np.ndarray:
        """The per-frame loop backend (differential reference)."""
        B = signals.shape[0]
        T = self.n_automata
        touts = np.zeros((B, T), bool)
        nd, ns, nc = (len(self._d_cols), len(self._s_cols),
                      len(self._c_cols))
        for f in range(B):
            x = signals[f]
            t_abs = self.pos + f
            if nd:
                act = ~(self._d_latch | self._d_dead)
                xin = x[self._d_sig]
                self._d_run = np.where(
                    act, np.where(xin, self._d_run + 1, 0), self._d_run)
                self._d_latch |= act & (self._d_run >= self._d_min)
            if ns:
                act = ~(self._s_latch | self._s_dead)
                a = x[self._s_siga]
                b = x[self._s_sigb]
                # latch against the PRE-decrement arming: `then` must be
                # strictly after `first`
                self._s_latch |= act & (self._s_arm > 0) & b
                arm2 = np.maximum(self._s_arm - 1, 0)
                arm2 = np.where(a, np.maximum(arm2, self._s_within), arm2)
                self._s_arm = np.where(act, arm2, self._s_arm)
            if nc:
                act = ~(self._c_latch | self._c_dead)
                xin = x[self._c_sig]
                rows = np.arange(nc)
                col = t_abs % self._c_win
                old = self._c_buf[rows, col]
                self._c_cnt = np.where(act, self._c_cnt + xin - old,
                                       self._c_cnt)
                self._c_buf[rows, col] = np.where(act, xin, old)
                complete = (t_abs + 1) >= self._c_win
                self._c_latch |= act & complete & _cmp_vec(
                    self._c_cnt, self._c_op, self._c_val)
            if nd:
                touts[f, self._d_cols] = self._d_latch
            if ns:
                touts[f, self._s_cols] = self._s_latch
            if nc:
                touts[f, self._c_cols] = self._c_latch
        return self._assemble(np.concatenate([signals, touts], axis=1))

    # -- the batched torch step -------------------------------------------

    def _state_arrays(self) -> Tuple[np.ndarray, ...]:
        """This stream's automaton state as host arrays, in the step's
        leaf order (the ``_N_INT_LEAVES`` counters first)."""
        return (np.asarray(self.pos), self._d_run, self._s_arm,
                self._c_cnt, self._d_latch, self._d_dead, self._s_latch,
                self._s_dead, self._c_buf, self._c_latch, self._c_dead)

    def _absorb_state(self, state: Sequence[np.ndarray]) -> None:
        """Write one stream's step state (host arrays) back into the
        numpy mirrors the host-side decidedness logic
        (``_auto_future_decided``) reads."""
        (_, d_run, s_arm, c_cnt, d_latch, d_dead, s_latch, s_dead,
         c_buf, c_latch, c_dead) = state
        self._d_run = d_run.astype(np.int64)
        self._d_latch = d_latch.astype(bool)
        self._d_dead = d_dead.astype(bool)
        self._s_arm = s_arm.astype(np.int64)
        self._s_latch = s_latch.astype(bool)
        self._s_dead = s_dead.astype(bool)
        self._c_buf = c_buf.astype(bool)
        self._c_cnt = c_cnt.astype(np.int64)
        self._c_latch = c_latch.astype(bool)
        self._c_dead = c_dead.astype(bool)

    def build_scan_fn(self) -> Callable:
        """The batch function ``(state, (S, B, M) bool) -> (state', (S, B,
        N) bool)`` for a leading stream axis: a Python loop over the B
        frames advancing every automaton of every stream at once, then
        the levelized assembly as masked matmuls.  All program structure
        is baked in; its tensors are made on the device of the first
        call's signals (once per device).  No host sync inside: ``pos``
        is a tensor of the state, so the ring-buffer column
        ``pos % c_win`` is computed on the device."""
        nd, ns, nc = (len(self._d_cols), len(self._s_cols),
                      len(self._c_cols))
        T, M = self.n_automata, self.n_signals
        index = {"d_cols": self._d_cols, "d_sig": self._d_sig,
                 "s_cols": self._s_cols, "s_siga": self._s_siga,
                 "s_sigb": self._s_sigb, "c_cols": self._c_cols,
                 "c_sig": self._c_sig, "root_col": self.root_col}
        params = {"d_min": self._d_min, "s_within": self._s_within,
                  "c_win": self._c_win, "c_op": self._c_op,
                  "c_val": self._c_val}
        levels, root_neg, n_cols = self._levels, self.root_neg, self.n_cols
        consts: Dict[str, Dict[str, Any]] = {}

        def on(device: torch.device) -> Dict[str, Any]:
            c = consts.get(str(device))
            if c is None:
                def t(a, dtype=None):
                    return torch.as_tensor(a, dtype=dtype, device=device)
                c = {k: t(v, torch.long) for k, v in index.items()}
                c.update({k: t(v, torch.int32) for k, v in params.items()})
                c["root_neg"] = t(root_neg)
                c["levels"] = [
                    (t(node_ids, torch.long), t(child_idx, torch.long),
                     t(child_neg), t(inc, torch.float32),
                     t(req, torch.float32))
                    for node_ids, child_idx, child_neg, inc, req in levels]
                consts[str(device)] = c
            return c

        def batch_fn(state, signals):
            k = on(signals.device)
            (pos, d_run, s_arm, c_cnt, d_latch, d_dead, s_latch, s_dead,
             c_buf, c_latch, c_dead) = state
            S, B = signals.shape[:2]
            d_out, s_out, c_out = [], [], []
            for f in range(B):
                x = signals[:, f]                               # (S, M)
                if nd:
                    act = ~(d_latch | d_dead)
                    xin = x[:, k["d_sig"]]
                    d_run = torch.where(
                        act, torch.where(xin, d_run + 1, 0), d_run)
                    d_latch = d_latch | (act & (d_run >= k["d_min"]))
                    d_out.append(d_latch)
                if ns:
                    act = ~(s_latch | s_dead)
                    a = x[:, k["s_siga"]]
                    b = x[:, k["s_sigb"]]
                    # latch against the PRE-decrement arming, exactly as
                    # the numpy loop: `then` strictly after `first`
                    s_latch = s_latch | (act & (s_arm > 0) & b)
                    arm2 = torch.clamp(s_arm - 1, min=0)
                    arm2 = torch.where(a, torch.maximum(arm2, k["s_within"]),
                                       arm2)
                    s_arm = torch.where(act, arm2, s_arm)
                    s_out.append(s_latch)
                if nc:
                    act = ~(c_latch | c_dead)
                    xin = x[:, k["c_sig"]]
                    col = (pos[:, None] % k["c_win"]).long()    # (S, nc)
                    old = torch.gather(c_buf, 2, col[..., None])[..., 0]
                    c_cnt = torch.where(
                        act, c_cnt + xin.to(torch.int32)
                        - old.to(torch.int32), c_cnt)
                    c_buf = c_buf.scatter(
                        2, col[..., None],
                        torch.where(act, xin, old)[..., None])
                    complete = (pos[:, None] + 1) >= k["c_win"]
                    op, val = k["c_op"], k["c_val"]
                    hit = torch.where(op == 0, c_cnt == val,
                                      torch.where(op == 1, c_cnt >= val,
                                                  c_cnt <= val))
                    c_latch = c_latch | (act & complete & hit)
                    c_out.append(c_latch)
                pos = pos + 1
            touts = torch.zeros((S, B, T), dtype=torch.bool,
                                device=signals.device)
            for cols, outs in ((k["d_cols"], d_out), (k["s_cols"], s_out),
                               (k["c_cols"], c_out)):
                if outs:
                    touts[:, :, cols] = torch.stack(outs, dim=1)
            vals = torch.zeros((S, B, n_cols), dtype=torch.bool,
                               device=signals.device)
            vals[:, :, :M + T] = torch.cat([signals, touts], dim=2)
            for node_ids, child_idx, child_neg, inc, req in k["levels"]:
                lit = vals[:, :, child_idx] ^ child_neg
                vals[:, :, node_ids] = (lit.float() @ inc.T) >= req
            out = vals[:, :, k["root_col"]] ^ k["root_neg"]
            return (pos, d_run, s_arm, c_cnt, d_latch, d_dead, s_latch,
                    s_dead, c_buf, c_latch, c_dead), out

        return batch_fn

    def _get_scan_step(self, B: int) -> Callable:
        """The single-stream step for batch size ``B``, from the step
        cache (key: program digest + B)."""
        key = ("tstep", self.program_sig, int(B))
        step = self._step_cache.get(key)
        if step is None:
            step = self.build_scan_fn()
            self._step_cache.put(key, step)
            self.scan_traces += 1
        return step

    def _advance_scan(self, signals) -> np.ndarray:
        step = self._get_scan_step(signals.shape[0])
        sig = _device_bool(signals, self.device)[None]
        state2, out = step(_push([self], self.device), sig)
        host = _fetch(list(state2) + [out])
        self._absorb_state([leaf[0] for leaf in host[:-1]])
        return host[-1][0].astype(bool)

    # -- window-outcome decidedness ---------------------------------------

    def _auto_future_decided(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-automaton (decided, value) for the window remainder:
        latched -> True forever; provably-unreachable -> False forever.
        Updates the per-kind ``dead`` latches (freezing state updates so
        suppressed garbage inputs can never resurrect an automaton)."""
        R = self.window_len - self.pos
        T = self.n_automata
        dec = np.zeros(T, bool)
        val = np.zeros(T, bool)
        if len(self._d_cols):
            # even an unbroken all-true future cannot reach min_frames
            self._d_dead |= ~self._d_latch & (self._d_run + R < self._d_min)
            dec[self._d_cols] = self._d_latch | self._d_dead
            val[self._d_cols] = self._d_latch
        if len(self._s_cols):
            # alive iff armed with >= 1 frame left, or a fresh
            # first-then pair still fits (needs two future frames;
            # within >= 1 is validated at construction)
            alive = ((self._s_arm > 0) & (R >= 1)) | (R >= 2)
            self._s_dead |= ~self._s_latch & ~alive
            dec[self._s_cols] = self._s_latch | self._s_dead
            val[self._s_cols] = self._s_latch
        if len(self._c_cols):
            for n, i in enumerate(self._c_cols):
                if self._c_latch[n] or self._c_dead[n]:
                    continue
                w = int(self._c_win[n])
                pos = self.pos
                # future sub-windows end k frames ahead (k >= 1), must be
                # complete (start >= 0 -> k >= w - pos) and fit the
                # window (k <= R); k > w adds nothing beyond k == w
                # (zero overlap with known history either way)
                k_lo = max(1, w - pos)
                k_hi = min(R, w)
                feasible = False
                if k_lo <= k_hi:
                    hist_len = min(pos, w)
                    hist = np.array(
                        [self._c_buf[n, (pos - 1 - j) % w]
                         for j in range(hist_len)], bool)  # recent first
                    for k in range(k_lo, k_hi + 1):
                        overlap = max(w - k, 0)
                        trues = int(hist[:overlap].sum())
                        lo, hi = trues, trues + min(k, w)
                        code = int(self._c_op[n])
                        v = int(self._c_val[n])
                        if (code == 0 and lo <= v <= hi) \
                                or (code == 1 and hi >= v) \
                                or (code == 2 and lo <= v):
                            feasible = True
                            break
                if not feasible:
                    self._c_dead[n] = True
            dec[self._c_cols] = self._c_latch | self._c_dead
            val[self._c_cols] = self._c_latch
        return dec, val

    def _update_decidedness(self) -> None:
        a_dec, a_val = self._auto_future_decided()
        M, T = self.n_signals, self.n_automata
        leaf_lo = np.zeros(M + T, bool)
        leaf_hi = np.ones(M + T, bool)
        leaf_lo[M:] = a_dec & a_val
        leaf_hi[M:] = ~a_dec | a_val
        root_lo, root_hi = self._root_bounds(leaf_lo, leaf_hi)
        newly = (self._q_dec < 0) & (root_lo == root_hi)
        # purely frame-level queries can never be future-decided (their
        # output tracks live frame signals); the bounds handle that
        # naturally: their roots keep lo=0, hi=1
        self._q_dec = np.where(newly, root_lo.astype(np.int8), self._q_dec)

    @property
    def query_decided(self) -> np.ndarray:
        """(N,) int8: -1 while the window outcome is open, else 0/1."""
        return self._q_dec.copy()

    @property
    def all_decided(self) -> bool:
        return bool((self._q_dec >= 0).all())

    def suppressed_signals(self) -> np.ndarray:
        """(M,) bool — frame signals whose verdicts can no longer change
        any query's output this window: every query reading the signal
        directly is window-decided and every automaton consuming it is
        frozen (latched or dead)."""
        live_q = self._q_dec < 0
        needed_direct = self._fref_inc[live_q].any(0)
        frozen = np.zeros(self.n_automata, bool)
        frozen[self._d_cols] = self._d_latch | self._d_dead
        frozen[self._s_cols] = self._s_latch | self._s_dead
        frozen[self._c_cols] = self._c_latch | self._c_dead
        needed_auto = self._auto_sig[~frozen].any(0)
        return ~(needed_direct | needed_auto)


def _host_bool(signals) -> np.ndarray:
    if torch.is_tensor(signals):
        return signals.bool().cpu().numpy()
    return np.asarray(signals, bool)


def _device_bool(signals, device: torch.device) -> torch.Tensor:
    """Signals as a bool tensor on ``device``: host arrays are copied
    there; a tensor must already lie there (nothing moves implicitly)."""
    if torch.is_tensor(signals):
        require_on(signals, device, "temporal signals")
        return signals.bool()
    return torch.as_tensor(np.asarray(signals, bool), device=device)


# --------------------------------------------------------------------------
# fleet-wide advance (one step over a leading stream axis)
# --------------------------------------------------------------------------

# keepalive for unsigned shard_wraps baked into cached group steps (as
# StagedQueryPlan._wrap_refs: the key holds only id(wrap), so the wrap
# must outlive the entry to keep ids unique)
_GROUP_WRAP_REFS: List[Any] = []


def advance_group(programs: Sequence[TemporalProgram], signals, *,
                  step_cache: Optional[StepCache] = None,
                  shard_wrap: Optional[Callable] = None,
                  wrap_sig: Optional[Tuple] = None) -> np.ndarray:
    """Advance S structurally identical ``TemporalProgram`` windows by
    one (S, B, M) bool signal batch at once (numpy, or a tensor on the
    programs' device); returns the (S, B, N) bool per-frame query
    outputs.

    The scan backend stacks each program's automaton state on a leading
    stream axis and runs ONE batched step at S = len(programs), cached
    in ``step_cache`` under the program digest + (B, S) + mesh identity
    — the temporal analogue of ``StagedQueryPlan.evaluate_group``'s
    group steps.  Under the fleet engine's ``shard_wrap``
    (``distributed.sharding.ShardMap`` over a ``("stream",)`` mesh),
    ``programs`` and ``signals`` are the calling rank's block of the
    fleet's streams and the outputs are that block's; the key's S is
    the fleet's (the block's times the ranks) and its mesh slot
    ``wrap_sig`` (else the wrap's id, the wrap kept alive).  The numpy
    backend falls back to a per-stream ``advance`` loop (the
    differential reference).  Per-program host-side semantics are
    unchanged either way: decided columns stay latched to their
    pre-batch values and decidedness updates after the batch.

    Programs must share a content digest (same canonical queries), a
    device, the same window position, and the same window length — the
    fleet engine guarantees this by starting every stream's window
    together."""
    programs = list(programs)
    if not programs:
        raise ValueError("advance_group needs at least one program")
    p0 = programs[0]
    S = len(programs)
    shape = tuple(signals.shape)
    if len(shape) != 3 or shape[0] != S or shape[2] != p0.n_signals:
        raise ValueError(f"signals must be (S={S}, B, {p0.n_signals}), "
                         f"got {shape}")
    B = shape[1]
    for p in programs[1:]:
        if p.program_sig != p0.program_sig:
            raise ValueError("advance_group needs structurally "
                             "identical programs (digest mismatch)")
        if p.pos != p0.pos or p.window_len != p0.window_len:
            raise ValueError("advance_group needs aligned windows: "
                             f"pos {p.pos} != {p0.pos} or window_len "
                             f"{p.window_len} != {p0.window_len}")
        if p.backend != p0.backend or p.device != p0.device:
            raise ValueError("advance_group needs programs of one backend "
                             "on one device")
    if p0.pos + B > p0.window_len:
        raise ValueError(
            f"advance past window end: pos={p0.pos} + B={B} > "
            f"window_len={p0.window_len} (call start_window)")
    if p0.backend != "scan" or B == 0:
        host = _host_bool(signals)
        return np.stack([p.advance(host[s]) for s, p in enumerate(programs)])

    cache = step_cache if step_cache is not None else p0._step_cache
    if wrap_sig is not None:
        wrap_key: Any = wrap_sig
    elif shard_wrap is not None:
        wrap_key = ("wrapid", id(shard_wrap))
        _GROUP_WRAP_REFS.append(shard_wrap)
    else:
        wrap_key = None
    n_streams = S if shard_wrap is None else S * shard_wrap.world
    key = ("tgstep", p0.program_sig, int(B), n_streams, wrap_key)
    step = cache.get(key)
    if step is None:
        step = p0.build_scan_fn()
        if shard_wrap is not None:
            step = shard_wrap(step)
        cache.put(key, step)
        p0.scan_traces += 1

    dev = p0.device
    dec_before = np.stack([p._q_dec for p in programs])
    state2, out = step(_push(programs, dev), _device_bool(signals, dev))
    host = _fetch(list(state2) + [out])
    out = host[-1].astype(bool)
    for s, p in enumerate(programs):
        p._absorb_state([leaf[s] for leaf in host[:-1]])
        p.pos += B
        decided = dec_before[s] >= 0
        if decided.any():
            out[s][:, decided] = \
                dec_before[s][decided].astype(bool)[None, :]
        p._update_decidedness()
    return out


# --------------------------------------------------------------------------
# reference replay (the naive per-frame semantics the automata must match)
# --------------------------------------------------------------------------

def replay_reference(query: Q.Predicate,
                     frame_value: Callable[[Q.Predicate, int], bool],
                     n_frames: int) -> List[bool]:
    """Naive per-frame replay oracle: the per-frame outputs of ``query``
    over a window of ``n_frames`` frames, where ``frame_value(pred, t)``
    gives the exact frame-level verdict of a (frame-level) sub-predicate
    at frame ``t``.

    Deliberately written as a direct, quadratic transcription of the
    operator definitions (re-scanning the prefix at every frame) with no
    shared state, so the streamed ``TemporalProgram`` can be property-
    tested against it bit-for-bit.  This is the specification; the
    automata are the implementation."""

    def out_at(q: Q.Predicate, t: int) -> bool:
        if isinstance(q, Q.And):
            return all(out_at(x, t) for x in q.terms)
        if isinstance(q, Q.Or):
            return any(out_at(x, t) for x in q.terms)
        if isinstance(q, Q.Not):
            return not out_at(q.term, t)
        if isinstance(q, Q.Duration):
            for end in range(q.min_frames - 1, t + 1):
                if all(frame_value(q.pred, s)
                       for s in range(end - q.min_frames + 1, end + 1)):
                    return True
            return False
        if isinstance(q, Q.Sequence):
            for s in range(t + 1):
                if not frame_value(q.first, s):
                    continue
                for t2 in range(s + 1, min(s + q.within, t) + 1):
                    if frame_value(q.then, t2):
                        return True
            return False
        if isinstance(q, Q.SlidingCount):
            for end in range(q.window - 1, t + 1):
                c = sum(1 for s in range(end - q.window + 1, end + 1)
                        if frame_value(q.pred, s))
                if Q._cmp(np.int64(c), q.op, q.value, 0):
                    return True
            return False
        return bool(frame_value(q, t))

    return [out_at(query, t) for t in range(n_frames)]


# --------------------------------------------------------------------------
# end-to-end engine (filter cascade -> oracle -> automata -> short-circuit)
# --------------------------------------------------------------------------

class TemporalEngine:
    """Per-batch engine multiplexing N (possibly temporal) queries over a
    stream, with the window-outcome short-circuit wired through every
    tier.

    Built for ``MultiQueryStreamExecutor``: the instance is the callable
    the engine factory returns (``engine(idx) -> (B, N) bool``), and the
    executor invokes ``on_window_start`` at each hopping-window boundary
    (temporal state is scoped to the window; an engine rebuilt mid-window
    by registry churn restarts its automata from the current batch).

    Per batch:

    1.  signals whose consumers are all window-decided are *suppressed*;
        if every query is decided the whole batch is skipped (no filter
        head, no oracle — frame-skipping in time), priced at the
        exhaustive plan cost into ``stats.cost_saved_model``;
    2.  otherwise the shared cascade evaluates the deduped frame signals
        with ``presumed_decided=suppressed`` (the staged planner skips
        tiers/rows those signals alone would have paid for);
    3.  the oracle verifies the union of the *live* signals' candidate
        frames once, each surviving frame's object list parsed into one
        ``ObjectTable`` shared by every live signal probing it;
    4.  the automata consume the exact verdicts and emit the per-frame
        query outputs (decided columns are latched constants).

    ``filter_fn(idx) -> FilterOutputs`` (on ``device``, default CUDA,
    raising when absent) and ``oracle_fn(idx, sel) -> [object lists]``
    work on frame-index arrays, as in the streaming examples.
    Adaptive-cascade knobs (``slot_stats``, ``cost_model``,
    ``calibration_monitor``, ``min_bucket``, ...) pass through to
    ``MultiQueryCascade`` over the frame signals; a ``step_cache`` is
    shared with the program so the temporal steps survive epoch rebuilds
    alongside the plan steps.  ``backend`` selects the automaton backend
    (see ``TemporalProgram``)."""

    def __init__(self, queries: Sequence[Q.Predicate],
                 filter_fn: Callable[[np.ndarray], Any],
                 oracle_fn: Callable[[np.ndarray, np.ndarray], List],
                 n_classes: int, grid: int, *, tau: float = 0.2,
                 oracle_bucket: Optional[int] = None,
                 backend: str = "scan",
                 device: DeviceLike = None,
                 **cascade_kw):
        from repro_torch.core.cascade import MultiQueryCascade
        self.device = resolve_device(device)
        self.program = TemporalProgram(
            queries, backend=backend,
            step_cache=cascade_kw.get("step_cache"), device=self.device)
        self.cascade = MultiQueryCascade(
            tuple(self.program.frame_queries), tau=tau, **cascade_kw)
        self.filter_fn = filter_fn
        self.oracle_fn = oracle_fn
        self.n_classes = n_classes
        self.grid = grid
        self.oracle_bucket = oracle_bucket
        self.stats = TemporalStats()
        self._seen_report = None

    def on_window_start(self, lo: int, hi: int) -> None:
        self.program.start_window(hi - lo)
        self.stats.windows += 1

    def __call__(self, idx: np.ndarray) -> np.ndarray:
        from repro_torch.core.cascade import (bucketed_oracle,
                                              oracle_frames_evaluated)
        idx = np.asarray(idx)
        B = idx.size
        M = self.program.n_signals
        self.stats.frames_in += B
        cm = self.cascade.cost_model
        if cm is not None:
            tc = cm.temporal_cost(frames=B, batch=B)
            if tc is not None:
                self.stats.cost_temporal_model += tc
        if self.program.all_decided:
            # every query's window outcome is latched: skip the filter
            # head, the plan, and the oracle for the whole batch
            self.stats.frames_skipped += B
            self.stats.cost_saved_model += \
                self.cascade.plan.exhaustive_cost_model(
                    self.cascade.cost_model, batch=B)
            return self.program.advance(np.zeros((B, M), bool))
        suppressed = self.program.suppressed_signals()
        live = ~suppressed
        self.stats.signal_evals_skipped += B * int(suppressed.sum())
        fout = self.filter_fn(idx)
        require_on(fout.counts, self.device, "filter outputs")
        masks = self.cascade.masks(
            fout, presumed_decided=suppressed if suppressed.any()
            else None).cpu().numpy()
        rep = self.cascade.staging_report
        # a fresh report object per staged evaluate: identity-dedup so an
        # exhaustive-mode batch never re-counts the previous staged one
        if rep is not None and rep is not self._seen_report:
            self._seen_report = rep
            self.stats.cost_saved_model += rep.cost_presumed_saved
        cand = masks & live[None, :]
        union = cand.any(1)
        sel = np.nonzero(union)[0]
        verdicts = np.zeros((B, M), bool)
        if sel.size:
            objs = bucketed_oracle(self.oracle_fn, idx, sel,
                                   self.oracle_bucket)
            self.stats.oracle_frames += oracle_frames_evaluated(
                int(sel.size), self.oracle_bucket)
            live_cols = np.nonzero(live)[0]
            for j, obj_list in zip(sel, objs):
                table = Q.ObjectTable.from_objects(obj_list)
                for s in live_cols:
                    if cand[j, s]:
                        verdicts[j, s] = Q.eval_objects(
                            self.program.frame_queries[s], table,
                            self.n_classes, self.grid)
        return self.program.advance(verdicts)
