"""Measured cost model for the staged multi-query planner.

Every staging decision in the adaptive engine is a cost comparison: the
stage order in ``StagedQueryPlan._staging_order`` ranks tiers by cost per
expected decision, ``StageReport.cost_run`` accumulates what a staged
batch paid, ``predicted_batch_cost`` projects that cost from the row
ledger, ``MultiQueryCascade`` parks staging when the staged cost stops
beating the exhaustive plan's, and the aggregate tier
(``repro_torch.core.contracts``) prices oracle calls against variance
shrink.

``CostModel`` answers every such question through one interface with two
sources:

- **static** — the JAX package's hand-picked relative constants
  (count=1, spatial=6, region=10+2·radius, step_overhead=4, oracle=100),
  reproduced exactly, so the port's staging decisions equal the
  reference's when no calibration is loaded.  Missing, corrupt, stale,
  wrong-schema or foreign calibrations all degrade here.
- **measured** — per-stage affine coefficients ``cost(rows) = overhead +
  per_row · rows`` in microseconds, fitted by ``calibrate()`` from timings
  of the port's own stage bodies (the count gather, the full-batch stats
  through ``kernels.ops``, the row-gathered stats kernel, the region
  body, one dilation step) at several row counts, plus the per-stage
  step overhead (the three-valued propagation and its host fetch).  On
  the card each body is timed by ``torch.cuda.Event`` pairs around
  synchronised calls.  ``calibrate_oracle`` adds the caller's oracle.

A measured model also derives the spatial body per bucket
(``spatial_body``), the compaction floor (``derived_min_bucket``) and,
through ``CalibrationMonitor``, when to recalibrate (a decaying
prediction-error ledger fed by the adaptive cascade;
``MultiQueryStreamExecutor(auto_recalibrate=True)`` acts on it).

Calibrations serialize to ``results/calibration/<backend>.json`` where
the backend key is ``torch-cuda`` or ``torch-cpu`` — never the JAX
package's ``cpu`` / ``tpu`` keys, and the fingerprint (torch and CUDA
versions, device name and compute capability; on the CPU the host
architecture and core count) carries no jax version, so a JAX
calibration and a torch one can never load into each other.
``load_calibration`` also refuses files older than ``max_age_s`` (30
days).  ``REPRO_CALIBRATION`` overrides the default path; ``off`` / ``0``
/ ``none`` disable loading (the test suite pins this).  ``calibrate``
also fits the optional ``"temporal"`` coefficient: the temporal tier's
batched automaton step (``repro_torch.core.temporal``) on a reference
12-query program, which ``temporal_cost`` prices.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

# ---------------------------------------------------------------------------
# static fallback constants (the pre-calibration hand-picked model)
# ---------------------------------------------------------------------------

# Relative units, the JAX package's constants.  A count stage is one
# gather over a (B, C+1) table; the spatial tier is a full-grid stats
# reduction; a region stage thresholds, dilates ``radius`` times, and
# builds a summed-area table with two (g, g) matmuls.
STATIC_COST_COUNT = 1.0
STATIC_COST_SPATIAL = 6.0
STATIC_COST_REGION = 10.0
STATIC_COST_DILATE_STEP = 2.0
# The adaptive cascade's historical default step overhead (three-valued
# propagation + the per-stage (N + B,) undecided fetch), in the same
# relative units.
STATIC_STEP_OVERHEAD = 4.0
# Static relative cost of one oracle frame (full-model forward + exact
# detection semantics) vs the filter stages above — the paper's premise
# is a ~2 orders-of-magnitude gap between the specialized filter and the
# oracle, which is what makes cascades (and sampled aggregation) pay.
STATIC_COST_ORACLE = 100.0
# Static relative cost of advancing the temporal automata over one full
# batch of frame verdicts (the batched step in repro_torch.core.temporal)
# — cheap next to any filter stage, but nonzero so the temporal tier's
# work stays priced instead of free.
STATIC_COST_TEMPORAL = 2.0

#: Reference batch size for batch-agnostic cost queries (stage ranking
#: before any traffic has been seen).  The static model is scale-free in
#: the batch, so this only matters for measured models.
REF_BATCH = 64

CALIBRATION_VERSION = 1
CALIBRATION_DIR = os.path.join("results", "calibration")
DEFAULT_MAX_AGE_S = 30 * 86400.0

#: Coefficient keys a complete calibration must provide.
STAGE_COEFF_KEYS = ("count", "spatial", "spatial_rows", "region", "dilate")


@dataclasses.dataclass(frozen=True)
class StageCoeff:
    """Affine per-stage cost: ``cost(rows) = overhead + per_row * rows``.

    For measured models both terms are microseconds; the fixed
    ``overhead`` is the dispatch + kernel-launch + fixed-shape work that
    does not shrink when row compaction hands the stage fewer rows."""
    per_row: float
    overhead: float = 0.0

    def cost(self, rows: float) -> float:
        return self.overhead + self.per_row * float(rows)


class CostModel:
    """One interface for every staging-cost question.

    ``stage_cost(kind, rows=, batch=, radius=)`` is the cost of running
    one stage body on ``rows`` (possibly compacted) rows of a
    ``batch``-row batch; ``exhaustive_cost`` is the cost of the
    exhaustive shared plan on the same batch (shared threshold,
    incremental dilation — less than the sum of staged stage costs);
    ``step_overhead()`` is the per-executed-stage overhead the staged
    path pays on top of the stage bodies.  All three are in one unit
    system per model instance (abstract units for static, microseconds
    for measured), so every comparison the planner/cascade makes —
    ordering scores, the staged-vs-exhaustive park switch, the
    ledger-predicted cost — is internally consistent as long as a single
    model instance is used throughout, which is what
    ``StagedQueryPlan``/``MultiQueryCascade`` enforce.

    Static semantics reproduce the legacy arithmetic exactly:
    ``stage_cost = unit_cost(kind, radius) * rows / batch`` (the old
    ``st.cost * rows_evaluated / B`` scaling), making the fallback
    behaviour bit-identical to the pre-calibration engine.
    """

    def __init__(self, *, source: str, backend: str = "static",
                 coeffs: Optional[Dict[str, StageCoeff]] = None,
                 step_overhead_cost: float = STATIC_STEP_OVERHEAD,
                 fingerprint: Optional[Dict[str, str]] = None,
                 calibrated_at: Optional[float] = None,
                 samples: Optional[Dict[str, List]] = None):
        if source not in ("static", "measured"):
            raise ValueError(f"source must be 'static' or 'measured', "
                             f"got {source!r}")
        if source == "measured":
            missing = [k for k in STAGE_COEFF_KEYS
                       if coeffs is None or k not in coeffs]
            if missing:
                raise ValueError(f"measured CostModel missing stage "
                                 f"coefficients: {missing}")
        self.source = source
        self.backend = backend
        self.coeffs = dict(coeffs or {})
        self._step_overhead = float(step_overhead_cost)
        self.fingerprint = dict(fingerprint or {})
        self.calibrated_at = calibrated_at
        self.samples = samples or {}

    # -- queries ----------------------------------------------------------

    @staticmethod
    def _static_unit(kind: str, radius: int) -> float:
        if kind == "count":
            return STATIC_COST_COUNT
        if kind == "spatial":
            return STATIC_COST_SPATIAL
        if kind == "region":
            return STATIC_COST_REGION + STATIC_COST_DILATE_STEP * radius
        raise ValueError(f"unknown stage kind {kind!r}")

    def stage_cost(self, kind: str, *, rows: float, batch: float,
                   radius: int = 0, body: Optional[str] = None) -> float:
        """Cost of one stage-body invocation on ``rows`` rows of a
        ``batch``-row batch.  ``rows < batch`` means the stage runs
        compacted (row-level short-circuiting): the measured model then
        prices the spatial tier at the CHEAPER of its two bodies — the
        row-gathered kernel and the full-batch reduction over the
        gathered subgrid — matching ``spatial_body``'s choice (the two
        coefficient sets have a different fixed/variable split, and
        which wins depends on the row count).  ``body`` ("rows"/"full")
        overrides the choice for callers that forced a specific body
        (``StagedQueryPlan(spatial_body=...)``), so their reported costs
        price the work they actually ran."""
        if self.source == "static":
            return self._static_unit(kind, radius) \
                * float(rows) / max(float(batch), 1.0)
        if kind == "count":
            return self.coeffs["count"].cost(rows)
        if kind == "spatial":
            if rows >= batch:
                return self.coeffs["spatial"].cost(rows)
            if body is None:
                body = self.spatial_body(rows=rows)
            key = "spatial_rows" if body == "rows" else "spatial"
            return self.coeffs[key].cost(rows)
        if kind == "region":
            return self.coeffs["region"].cost(rows) \
                + radius * self.coeffs["dilate"].cost(rows)
        raise ValueError(f"unknown stage kind {kind!r}")

    def spatial_body(self, *, rows: float) -> str:
        """Which spatial body a compacted stage should run on ``rows``
        gathered rows: ``"rows"`` (the scalar-prefetched row-gather
        kernel) or ``"full"`` (gather the rows, then the full-batch
        reduction over the subgrid).  Both are bit-identical; only the
        cost differs.  The static model always answers ``"rows"`` — the
        pre-crossover engine's hard-wired choice, so disabling
        calibration collapses exactly to that behaviour.  A measured
        model compares the two fitted affine costs at ``rows`` and picks
        the cheaper (ties go to the row kernel)."""
        if self.source == "static":
            return "rows"
        return ("rows" if self.coeffs["spatial_rows"].cost(rows)
                <= self.coeffs["spatial"].cost(rows) else "full")

    def spatial_crossover_rows(self) -> Optional[float]:
        """Row count where the two spatial bodies tie (measured models).
        Which body wins on which side depends on the fit's orientation
        (usually the overhead-free row kernel below, the cheaper-slope
        full-batch reduction above, but a calibration can invert that)
        — ``spatial_body`` is the authority on who wins where; this is
        the tie point for diagnostics.  None when one body dominates at
        every row count (equal slopes, or the tie lies at ``rows <= 0``)
        or under the static model (no second coefficient set)."""
        if self.source == "static":
            return None
        r_ = self.coeffs["spatial_rows"]
        f_ = self.coeffs["spatial"]
        d = r_.per_row - f_.per_row
        if d == 0:
            return None          # parallel costs never tie
        rows = (f_.overhead - r_.overhead) / d
        return rows if rows > 0 else None

    #: bounds for the calibration-derived compaction floor: at least 1
    #: (a floor of 0 is meaningless), at most 128 (a near-zero fitted
    #: per-row cost must not derive a floor that disables compaction on
    #: every realistic batch).
    MIN_BUCKET_BOUNDS = (1, 128)

    def derived_min_bucket(self, default: int = 8) -> int:
        """The row-compaction bucket floor this backend's calibration
        implies (``StagedQueryPlan`` uses this when no explicit
        ``min_bucket=`` is given).

        The floor mediates padded-row waste against compiled-variant
        proliferation: every executed stage already pays the measured
        per-stage ``step_overhead()`` (propagation + undecided fetch),
        so buckets whose worst-case per-row work costs less than that
        overhead are effectively free to pad — shrinking them further
        multiplies jitted step variants without moving the per-batch
        cost.  The derived floor is therefore the largest power of two
        whose full padding cost, at the most expensive per-row
        coefficient a compacted stage can run (count gather; the
        row-gather spatial kernel, which is the body chosen at small
        buckets; region + one dilation step), stays within the step
        overhead — clamped to ``MIN_BUCKET_BOUNDS``.  The static model
        has no microsecond scale to derive from and returns ``default``
        (8, the historical hand-set knob — regression-pinned)."""
        if self.source == "static":
            return int(default)
        worst_per_row = max(
            self.coeffs["count"].per_row,
            self.coeffs["spatial_rows"].per_row,
            self.coeffs["region"].per_row + self.coeffs["dilate"].per_row)
        lo, hi = self.MIN_BUCKET_BOUNDS
        if worst_per_row <= 0:
            return hi
        target = self._step_overhead / worst_per_row
        floor = 1
        while floor * 2 <= target:
            floor <<= 1
        return int(min(max(floor, lo), hi))

    def stage_rank_cost(self, kind: str, *, radius: int = 0,
                        batch: float = REF_BATCH) -> float:
        """Full-batch stage cost — the batch-level number ``_Stage.cost``
        carries for reporting/describe and the cold ordering score."""
        if self.source == "static":
            return self._static_unit(kind, radius)    # batch-scale-free
        return self.stage_cost(kind, rows=batch, batch=batch, radius=radius)

    def exhaustive_cost(self, *, has_counts: bool, has_spatial: bool,
                        radii: Sequence[int],
                        batch: float = REF_BATCH) -> float:
        """Cost of one exhaustive ``QueryPlan.evaluate`` call.  Differs
        from the sum of staged stage costs: the exhaustive program
        thresholds the grid once and dilates incrementally
        radius-to-radius, while each staged region stage dilates from
        scratch (it must be skippable and reorderable) — the mode-switch
        comparison in the adaptive cascade has to use THIS as the
        exhaustive baseline or staging looks better than it is on
        multi-radius plans."""
        cost = 0.0
        prev = 0
        if self.source == "static":
            if has_counts:
                cost += STATIC_COST_COUNT
            if has_spatial:
                cost += STATIC_COST_SPATIAL
            for r in radii:
                cost += STATIC_COST_REGION \
                    + STATIC_COST_DILATE_STEP * (r - prev)
                prev = r
            return cost
        B = float(batch)
        if has_counts:
            cost += self.coeffs["count"].cost(B)
        if has_spatial:
            cost += self.coeffs["spatial"].cost(B)
        for r in radii:
            cost += self.coeffs["region"].cost(B) \
                + (r - prev) * self.coeffs["dilate"].cost(B)
            prev = r
        return cost

    def step_overhead(self) -> float:
        """Per-executed-stage overhead of the staged path (two-pass
        three-valued propagation + the per-stage undecided fetch), in
        this model's cost units."""
        return self._step_overhead

    def oracle_cost(self, rows: float = 1.0) -> Optional[float]:
        """Cost of running the oracle on ``rows`` frames, in this
        model's units — the price the aggregate tier's adaptive
        allocator compares variance shrink against
        (repro_torch.core.contracts).  The static model answers with the
        legacy relative constant (``STATIC_COST_ORACLE`` per frame); a
        measured model answers in microseconds from its ``"oracle"``
        coefficient — an *optional* entry, because the oracle is caller
        code the standard ``calibrate()`` cannot see
        (``calibrate_oracle`` measures it in place).  A measured model
        without the entry returns None: mixing the static relative
        constant into a microsecond model would be unit soup, so the
        caller self-calibrates from its realized spend instead
        (``BudgetLedger.oracle_us_per_frame``)."""
        if self.source == "static":
            return STATIC_COST_ORACLE * float(rows)
        c = self.coeffs.get("oracle")
        return c.cost(rows) if c is not None else None

    def temporal_cost(self, *, frames: float,
                      batch: Optional[float] = None) -> Optional[float]:
        """Cost of advancing the temporal automata over ``frames``
        frames of a ``batch``-frame batch (repro_torch.core.temporal's
        batched step), in this model's units.  The static model follows
        the stage convention (``unit * rows / batch``, scale-free at full
        batch); a measured model answers in microseconds from its
        ``"temporal"`` coefficient — optional like ``"oracle"``, fitted
        by ``calibrate()``, absent from calibrations written before the
        temporal tier was ported, where returning None beats mixing unit
        systems."""
        if self.source == "static":
            b = batch if batch is not None else frames
            return STATIC_COST_TEMPORAL * float(frames) / max(float(b), 1.0)
        c = self.coeffs.get("temporal")
        return c.cost(frames) if c is not None else None

    def describe(self) -> Dict:
        """Operator/provenance view (recorded next to bench results)."""
        return {
            "source": self.source,
            "backend": self.backend,
            "step_overhead": self._step_overhead,
            "coeffs": {k: dataclasses.asdict(c)
                       for k, c in self.coeffs.items()},
            "calibrated_at": self.calibrated_at,
            "fingerprint": self.fingerprint,
            # the two decisions this model derives:
            # where the spatial bodies cross, and the compaction floor
            "spatial_crossover_rows": self.spatial_crossover_rows(),
            "derived_min_bucket": self.derived_min_bucket(),
        }

    def __repr__(self) -> str:
        return f"CostModel(source={self.source!r}, backend={self.backend!r})"


def static_cost_model() -> CostModel:
    """The legacy hand-picked model — the provable fallback."""
    return CostModel(source="static")


# ---------------------------------------------------------------------------
# backend identity + persistence
# ---------------------------------------------------------------------------

def _lookup_device(device: DeviceLike) -> torch.device:
    """The device whose calibration a lookup reads: ``device`` as given,
    or — like ``jax.default_backend()`` for the JAX package — the one
    torch runs on in this process (the card when there is one).  Lookups
    run nothing; ``calibrate`` itself takes ``device=None`` as CUDA and
    raises without a card."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def backend_key(device: DeviceLike = None) -> str:
    """``torch-cuda`` or ``torch-cpu``: the calibration file's name and the
    model's ``backend``, disjoint from the JAX package's keys."""
    return f"torch-{_lookup_device(device).type}"


def fingerprint_backend(device: DeviceLike = None) -> Dict[str, str]:
    """Identity of the device a calibration was (or would be) measured on.
    A calibration is only valid for an exactly matching fingerprint: on
    a card the torch and CUDA versions, the device name and its compute
    capability; on the CPU the host architecture and core count (the
    device kind alone, "cpu", would let any machine trust any other's
    microseconds) and the torch version.  It names no jax version, so a
    JAX-package calibration never matches.  Deliberately not the
    hostname: a redeploy of the same image on the same machine loads."""
    import platform as _platform
    dev = _lookup_device(device)
    fp = {"platform": dev.type, "torch": torch.__version__}
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        fp.update(device_kind=props.name,
                  capability=f"{props.major}.{props.minor}",
                  cuda=str(torch.version.cuda))
    else:
        fp.update(device_kind="cpu", host_arch=_platform.machine(),
                  cpu_count=str(os.cpu_count()))
    return fp


def calibration_path(backend: Optional[str] = None,
                     directory: str = CALIBRATION_DIR, *,
                     device: DeviceLike = None) -> str:
    """Default on-disk location: ``results/calibration/<backend>.json``
    (CWD-relative), ``backend`` defaulting to ``backend_key(device)``."""
    if backend is None:
        backend = backend_key(device)
    return os.path.join(directory, f"{backend}.json")


def save_calibration(model: CostModel, path: Optional[str] = None, *,
                     monitor: Optional["CalibrationMonitor"] = None) -> str:
    """Serialize a measured model (atomic write: tmp + rename).

    With ``monitor`` given, its drift-ledger state rides along under a
    ``"monitor"`` key so a restarted process resumes the drift evidence
    instead of forgetting it (``CalibrationMonitor.restore`` /
    ``load_monitor_state``).  The block is advisory: ``load_calibration``
    ignores it (same schema version — unknown keys were always allowed),
    and a corrupt or foreign block cold-starts the monitor exactly like
    ``SlotStats.load`` cold-starts the slot ledger."""
    if model.source != "measured":
        raise ValueError("only measured CostModels are saved; the static "
                         "fallback is code, not data")
    path = path or calibration_path(model.backend)
    payload = {
        "version": CALIBRATION_VERSION,
        "backend": model.backend,
        "fingerprint": model.fingerprint,
        "calibrated_at": model.calibrated_at,
        "step_overhead_us": model._step_overhead,
        "coeffs": {k: dataclasses.asdict(c)
                   for k, c in model.coeffs.items()},
        "samples": model.samples,
    }
    if monitor is not None and monitor.active:
        payload["monitor"] = monitor.state_dict()
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
    os.replace(tmp, path)
    return path


def load_calibration(path: Optional[str] = None, *,
                     max_age_s: float = DEFAULT_MAX_AGE_S,
                     device: DeviceLike = None) -> Optional[CostModel]:
    """Load a measured calibration, or None when it must not be trusted.

    Returns None (never raises) when the file is missing or unreadable,
    the JSON is corrupt or the wrong schema version, coefficients are
    missing/non-finite/negative, the backend fingerprint does not match
    ``device`` (``fingerprint_backend``), or the
    calibration is older than ``max_age_s``.  Callers fall back to
    ``static_cost_model()`` — degrading to the hand-tuned constants is
    always safe; trusting a foreign calibration is not."""
    path = path or calibration_path(device=device)
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(payload, dict) \
            or payload.get("version") != CALIBRATION_VERSION:
        return None
    coeffs_raw = payload.get("coeffs")
    if not isinstance(coeffs_raw, dict):
        return None
    coeffs: Dict[str, StageCoeff] = {}
    for k in STAGE_COEFF_KEYS:
        c = coeffs_raw.get(k)
        try:
            per_row = float(c["per_row"])
            overhead = float(c.get("overhead", 0.0))
        except (TypeError, KeyError, ValueError):
            return None
        if not (np.isfinite(per_row) and np.isfinite(overhead)) \
                or per_row < 0 or overhead < 0:
            return None
        coeffs[k] = StageCoeff(per_row=per_row, overhead=overhead)
    # optional coefficients: "oracle" (calibrate_oracle — the oracle is
    # caller code, absent in most calibrations) and "temporal" (the
    # automaton step, absent from calibrations written before the
    # temporal tier was ported).  Both are advisory, so a malformed entry
    # drops the entry, not the file
    for opt in ("oracle", "temporal"):
        c = coeffs_raw.get(opt)
        if isinstance(c, dict):
            try:
                per_row = float(c["per_row"])
                overhead = float(c.get("overhead", 0.0))
                if np.isfinite(per_row) and np.isfinite(overhead) \
                        and per_row >= 0 and overhead >= 0:
                    coeffs[opt] = StageCoeff(per_row=per_row,
                                             overhead=overhead)
            except (TypeError, KeyError, ValueError):
                pass
    try:
        step = float(payload.get("step_overhead_us"))
        calibrated_at = float(payload.get("calibrated_at"))
    except (TypeError, ValueError):
        return None
    if not (np.isfinite(step) and step >= 0):
        return None
    if max_age_s is not None and time.time() - calibrated_at > max_age_s:
        return None                                   # stale
    if payload.get("fingerprint") != fingerprint_backend(device):
        return None                                   # foreign backend
    return CostModel(source="measured",
                     backend=payload.get("backend", "unknown"),
                     coeffs=coeffs, step_overhead_cost=step,
                     fingerprint=payload["fingerprint"],
                     calibrated_at=calibrated_at,
                     samples=payload.get("samples") or {})


def load_monitor_state(path: Optional[str] = None, *,
                       device: DeviceLike = None) -> Optional[Dict]:
    """The raw ``"monitor"`` block of a calibration file, or None.

    Missing file, unreadable JSON, or an absent/non-dict block all
    return None (never raises) — the caller passes the result straight
    to ``CalibrationMonitor.restore``, which treats None as a cold
    start.  No validation happens here; ``restore`` owns the distrust
    rules so they live next to the state they protect."""
    path = path or calibration_path(device=device)
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(payload, dict):
        return None
    block = payload.get("monitor")
    return block if isinstance(block, dict) else None


_DISABLE_VALUES = ("off", "0", "none", "disable", "disabled", "false")


def default_cost_model(path: Optional[str] = None, *,
                       max_age_s: float = DEFAULT_MAX_AGE_S,
                       device: DeviceLike = None) -> CostModel:
    """The model the adaptive engine uses when none is given explicitly:
    the measured per-backend calibration when present and trustworthy,
    else the static constants.  ``REPRO_CALIBRATION`` overrides the path
    (or disables loading with ``off``/``0``/``none``); ``device`` picks
    the backend whose calibration is read (``calibration_path``)."""
    if path is None:
        env = os.environ.get("REPRO_CALIBRATION", "")
        if env.lower() in _DISABLE_VALUES:
            return static_cost_model()
        path = env or None
    model = load_calibration(path, max_age_s=max_age_s, device=device)
    return model if model is not None else static_cost_model()


# ---------------------------------------------------------------------------
# calibration harness
# ---------------------------------------------------------------------------

def _timeit(fn, *args, repeat: int = 3, warmup: int = 1,
            device: DeviceLike = None, host_clock: bool = False) -> float:
    """Median microseconds of ``fn(*args)``.

    On a CUDA ``device`` each call is bracketed by a ``torch.cuda.Event``
    pair on a drained stream and the end event is waited for, so the
    interval covers the call's launches and its device work (with
    ``host_clock=True`` the host clock runs between two synchronisations
    instead, for callables whose work is host code).  Elsewhere
    ``time.perf_counter`` times the call (eager CPU work is synchronous).
    """
    dev = None if device is None else torch.device(device)
    on_card = dev is not None and dev.type == "cuda"
    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(repeat):
        if on_card and not host_clock:
            with torch.cuda.device(dev):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                fn(*args)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) * 1e3)    # ms -> us
        else:
            if on_card:
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            fn(*args)
            if on_card:
                torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e6)
    times.sort()
    return times[len(times) // 2]


def _fit_affine(samples: Sequence[Tuple[float, float]]) -> StageCoeff:
    """Least-squares ``t = overhead + per_row * rows`` over (rows, us)
    samples, clamped to the physically meaningful quadrant (timing noise
    can produce a slightly negative intercept or slope)."""
    r = np.array([s[0] for s in samples], np.float64)
    t = np.array([s[1] for s in samples], np.float64)
    if len(samples) < 2 or np.ptp(r) == 0:
        rows = max(float(r[0]), 1.0) if len(samples) else 1.0
        return StageCoeff(per_row=float(t.mean()) / rows, overhead=0.0)
    A = np.stack([np.ones_like(r), r], axis=1)
    (a, b), *_ = np.linalg.lstsq(A, t, rcond=None)
    return StageCoeff(per_row=float(max(b, 1e-9)),
                      overhead=float(max(a, 0.0)))


def calibrate(*, batch: int = 256, grid: int = 16, classes: int = 8,
              rows_points: Optional[Sequence[int]] = None,
              repeat: int = 3, tau: float = 0.2, save: bool = True,
              path: Optional[str] = None, seed: int = 0,
              device: DeviceLike = None) -> CostModel:
    """Time the staged planner's stage bodies on ``device`` (default
    CUDA) and fit a ``CostModel``.

    Times, at several row counts (median of ``repeat`` calls; CUDA-event
    intervals on the card, ``_timeit``), the port's own bodies:

    - the count tier's row-indexed gather (``FilterOutputs.count_pred``)
      and interval test,
    - the full-batch spatial stats through ``kernels.ops`` (the
      ``spatial_stats_bgc`` kernel on the card) + ORDER() evaluation,
    - the row-gathered stats (``ops.spatial_stats_rows_inline``, the
      ``spatial_stats_rows_bgc`` kernel) — what a compacted spatial
      stage runs,
    - the region body (threshold + summed-area table + rect gathers),
    - one Manhattan-dilation step (the per-radius increment),
    - the staged executor's per-stage overhead: the two-pass
      three-valued propagation over a reference plan plus the host
      fetch of its (N + B,) undecided vector (the port's staged plan
      syncs once per stage),
    - and the temporal tier's batched automaton step
      (``TemporalProgram.build_scan_fn``) on a reference 12-query
      program (four each of Duration, Sequence and SlidingCount), the
      optional ``"temporal"`` coefficient.

    Fits ``overhead + per_row * rows`` per body and (by default) writes
    ``results/calibration/<backend>.json`` stamped with the fingerprint,
    so ``default_cost_model()`` loads it on the next start.
    """
    from repro_torch.core import cam as CAM
    from repro_torch.core import query as Q
    from repro_torch.core.filters import FilterOutputs
    from repro_torch.core.plan import QueryPlan
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import spatial_predicate as SP

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    B, G, C = int(batch), int(grid), int(classes)
    if rows_points is None:
        rows_points = sorted({max(1, B // 16), max(2, B // 4),
                              max(4, B // 2), B})
    rows_points = [min(int(r), B) for r in rows_points]

    def on_dev(a):
        return torch.as_tensor(a, device=dev)

    def timeit(fn, *args):
        return _timeit(fn, *args, repeat=repeat, device=dev)

    def row_ids(r):
        return on_dev(rng.integers(0, B, r).astype(np.int64))

    counts = on_dev(rng.normal(2, 2, (B, C)).astype(np.float32))
    glogits = on_dev(rng.normal(0, 0.7, (B, G, G, C)).astype(np.float32))

    samples: Dict[str, List[Tuple[int, float]]] = {
        k: [] for k in STAGE_COEFF_KEYS}

    # --- count tier: row-indexed gather + interval test ------------------
    k_cnt = min(8, C + 1)
    cls = on_dev(np.arange(-1, k_cnt - 1, dtype=np.int64))  # total + classes
    lo = on_dev(np.zeros(k_cnt, np.int32))
    hi = on_dev(np.full(k_cnt, 4, np.int32))

    def count_body(c, rows):
        x = FilterOutputs(counts=c[rows]).count_pred()
        ext = torch.cat([x, x.sum(-1, keepdim=True, dtype=torch.int32)],
                        dim=1)
        v = ext[:, cls]
        return (v >= lo) & (v <= hi)

    for r in rows_points:
        samples["count"].append((r, timeit(count_body, counts, row_ids(r))))

    # --- spatial tier: stats kernels + ORDER() leaves --------------------
    n_spa = min(4, C * (C - 1)) or 1
    a_idx = on_dev(np.arange(n_spa, dtype=np.int64) % C)
    b_idx = on_dev((np.arange(n_spa, dtype=np.int64) + 1) % C)
    use_row = on_dev(np.arange(n_spa) % 2 == 0)
    radii = on_dev(np.zeros(n_spa, np.int32))

    def spa_eval(stats):
        return SP.eval_spatial_leaves(stats, a_idx, b_idx, use_row, radii,
                                      grid=G)

    def spa_full(g):
        return spa_eval(kops.spatial_stats_inline(g, tau))

    for r in rows_points:
        samples["spatial"].append((r, timeit(spa_full, glogits[:r])))

    def spa_rows(g, rows):
        return spa_eval(kops.spatial_stats_rows_inline(g, rows, tau))

    for r in rows_points:
        samples["spatial_rows"].append(
            (r, timeit(spa_rows, glogits, row_ids(r))))

    # --- region tier: threshold + SAT + rect gathers ---------------------
    n_reg = 4
    reg_cls = on_dev(np.arange(n_reg, dtype=np.int64) % C)
    rects = np.tile(np.array([0, 0, G // 2, G], np.int64), (n_reg, 1))
    r0, c0, r1, c1 = (on_dev(rects[:, k]) for k in range(4))
    minc = on_dev(np.ones(n_reg, np.float32))
    tri = torch.tril(torch.ones((G, G), dtype=torch.float32, device=dev))
    reg_n = torch.arange(n_reg, device=dev)

    def region_body(g):
        occ = CAM.threshold_map(g, tau, logits=False)
        s = torch.einsum("ij,bjkc->bikc", tri, occ.float())
        s = torch.einsum("kl,bilc->bikc", tri, s)
        sat = torch.nn.functional.pad(s, (0, 0, 1, 0, 1, 0))
        inside = (sat[:, r1, c1] - sat[:, r0, c1]
                  - sat[:, r1, c0] + sat[:, r0, c0])
        return inside[:, reg_n, reg_cls] >= minc

    for r in rows_points:
        samples["region"].append((r, timeit(region_body, glogits[:r])))

    occ_full = glogits > tau
    for r in rows_points:
        samples["dilate"].append(
            (r, timeit(CAM.dilate_manhattan, occ_full[:r], 1)))

    # --- per-stage step overhead: propagation + undecided fetch ----------
    ref_queries = []
    for i in range(6):
        ref_queries.append(Q.And((
            Q.ClassCount(i % C, Q.Op.GE, 2),
            Q.Or((Q.Spatial(i % C, Q.Rel.LEFT, (i + 1) % C),
                  Q.Region(i % C, (0, 0, G // 2, G), 1))))))
    ref_plan = QueryPlan(ref_queries, tau=tau)
    known = np.ones(ref_plan.n_slot_cols, bool)
    leaf_vals = on_dev(rng.random((B, ref_plan.n_slot_cols)) < 0.5)

    def step_overhead_body(lv):
        _, decided = ref_plan.propagate_bounds(lv, known)
        return torch.cat([~decided.all(0), ~decided.all(1)]).cpu()

    step_us = timeit(step_overhead_body, leaf_vals)

    # --- temporal tier: the batched automaton step -----------------------
    from repro_torch.core.temporal import TemporalProgram, _push
    t_queries = []
    for i in range(4):
        p1 = Q.ClassCount(i % C, Q.Op.GE, 1)
        p2 = Q.ClassCount((i + 1) % C, Q.Op.GE, 1)
        t_queries += [Q.Duration(p1, 3), Q.Sequence(p1, p2, 4),
                      Q.SlidingCount(p2, 6, Q.Op.GE, 2)]
    t_prog = TemporalProgram(t_queries, device=dev)
    t_sig_all = on_dev(rng.random((1, B, t_prog.n_signals)) < 0.5)
    t_prog.start_window(B)
    t_step = t_prog.build_scan_fn()
    t_state = _push([t_prog], dev)
    samples["temporal"] = [
        (r, timeit(t_step, t_state, t_sig_all[:, :r])) for r in rows_points]

    coeffs = {k: _fit_affine(v) for k, v in samples.items()}
    model = CostModel(
        source="measured", backend=backend_key(dev), coeffs=coeffs,
        step_overhead_cost=step_us, fingerprint=fingerprint_backend(dev),
        calibrated_at=time.time(),
        samples={k: [[int(r), float(t)] for r, t in v]
                 for k, v in samples.items()})
    if save:
        save_calibration(model, path)
    return model


def calibrate_oracle(model: CostModel, oracle_fn, make_batch, *,
                     rows_points: Sequence[int] = (1, 4, 16),
                     repeat: int = 3, save: bool = False,
                     path: Optional[str] = None,
                     device: DeviceLike = None) -> CostModel:
    """Measure the caller's oracle and fold an ``"oracle"`` coefficient
    into a measured ``CostModel`` (the aggregate tier's price).

    ``calibrate()`` times the engine's own stage bodies; the oracle —
    full-model forward, exact detector, ground-truth annotator — is
    caller code, so the caller hands it in: ``make_batch(rows) -> args``
    builds a representative input of ``rows`` frames and
    ``oracle_fn(*args)`` is what the executor will invoke.  The oracle
    may be host code, so it is timed by the host clock between two
    synchronisations of ``device`` (default CUDA).  Fits the same affine
    microsecond form and returns a NEW model (the input is not mutated);
    with ``save=True`` the merged set is written through
    ``save_calibration``.  Only measured models can absorb a microsecond
    coefficient; the static model raises."""
    if model.source != "measured":
        raise ValueError("calibrate_oracle extends a measured CostModel; "
                         "the static model already has a relative oracle "
                         "constant (STATIC_COST_ORACLE)")
    dev = resolve_device(device)
    samples: List[Tuple[int, float]] = []
    for r in rows_points:
        args = make_batch(int(r))
        if not isinstance(args, tuple):
            args = (args,)
        samples.append((int(r), _timeit(oracle_fn, *args, repeat=repeat,
                                        device=dev, host_clock=True)))
    coeffs = dict(model.coeffs)
    coeffs["oracle"] = _fit_affine(samples)
    merged = CostModel(
        source="measured", backend=model.backend, coeffs=coeffs,
        step_overhead_cost=model._step_overhead,
        fingerprint=model.fingerprint, calibrated_at=model.calibrated_at,
        samples={**model.samples,
                 "oracle": [[int(r), float(t)] for r, t in samples]})
    if save:
        save_calibration(merged, path)
    return merged


# ---------------------------------------------------------------------------
# calibration freshness: drift-triggered recalibration
# ---------------------------------------------------------------------------

class CalibrationMonitor:
    """Decaying prediction-error ledger that decides WHEN to recalibrate.

    ``calibrate()`` is a one-shot profile; the machine it described
    keeps changing underneath it (co-tenant load, clocks under a power
    limit, a driver update that survived the fingerprint, a workload
    whose shapes the fit extrapolates badly to).  Every staged batch
    already produces both sides of the check for free: the model's
    predicted cost of the executed stages (``StageReport.cost_run`` +
    per-stage overheads) and the observed wall time of the same batch.  The monitor folds each
    pair into an EWMA ledger of symmetric relative error (fold-change
    ``max/min - 1``, so over- and under-prediction count alike; the
    same ``stage_decay``-style geometry as the ``SlotStats`` stage
    ledgers — a drift signal must track the live machine, not a
    lifetime average) and flags recalibration when the smoothed error
    exceeds ``rel_threshold`` (default 1.0 ≈ consistently 2x off in
    either direction) with at least ``min_weight`` effective
    observations of evidence — or when the calibration's 30-day
    staleness lapses mid-run (``load_calibration`` refuses stale files
    at load time; a long-lived process needs the same check on a clock).

    Only *measured* models are monitored: the static model's abstract
    units cannot be compared against wall microseconds, and there is no
    calibration to refresh (``observe`` no-ops, ``should_recalibrate``
    stays False).  The monitor never runs calibration itself — it is a
    pure signal.  ``MultiQueryCascade`` feeds it and latches
    ``recalibration_due`` at restage boundaries;
    ``MultiQueryStreamExecutor(auto_recalibrate=True)`` is the opt-in
    consumer that actually re-runs ``calibrate()``; a manual
    ``calibrate()`` stays the operator's path.
    """

    def __init__(self, model: CostModel, *, rel_threshold: float = 1.0,
                 decay: float = 0.9, min_weight: float = 8.0,
                 max_age_s: float = DEFAULT_MAX_AGE_S,
                 clock=time.time):
        if rel_threshold <= 0:
            raise ValueError("rel_threshold must be positive")
        if not 0.0 < decay <= 1.0:
            raise ValueError("decay must be in (0, 1]")
        if decay < 1.0 and min_weight >= 1.0 / (1.0 - decay):
            raise ValueError(
                f"min_weight={min_weight} is unreachable: the decayed "
                f"observation count converges to 1/(1-decay) = "
                f"{1.0 / (1.0 - decay):.1f}, so drift could never fire")
        self.rel_threshold = float(rel_threshold)
        self.decay = float(decay)
        self.min_weight = float(min_weight)
        self.max_age_s = float(max_age_s)
        self._clock = clock
        self.recalibrations = 0      # times reset() followed a re-fit
        self.reset(model)

    def reset(self, model: Optional[CostModel] = None) -> None:
        """Zero the error ledger, optionally adopting a fresh model
        (called after a recalibration installed new coefficients).
        Bumps ``generation`` so consumers holding a latched flag
        (``MultiQueryCascade.recalibration_due``) can see that the
        drift they latched on has been dealt with."""
        if model is not None:
            self.model = model
        self.generation = getattr(self, "generation", -1) + 1
        self._err_acc = 0.0          # decayed sum of relative errors
        self._weight = 0.0           # decayed observation count

    @property
    def active(self) -> bool:
        """Is there anything to monitor?  (measured models only)"""
        return self.model.source == "measured"

    def observe(self, predicted_us: float, observed_us: float) -> None:
        """Fold one staged batch's (model-predicted, wall-observed)
        microsecond pair into the error ledger.  The error is the
        *symmetric* fold-change ``max/min - 1``: a model 2x too cheap
        and a model 2x too expensive both score 1.0 — a one-sided
        ``|obs-pred|/pred`` would be structurally blind to
        over-prediction (it is bounded by 1 from that side), and a
        calibration taken under co-tenant load over-predicts.
        Non-positive or non-finite pairs are ignored (a zero prediction
        means the model was not consulted; wall-clock glitches must not
        poison the ledger)."""
        if not self.active:
            return
        if not (np.isfinite(predicted_us) and np.isfinite(observed_us)) \
                or predicted_us <= 0 or observed_us <= 0:
            return
        lo, hi = sorted((float(predicted_us), float(observed_us)))
        rel_err = hi / lo - 1.0
        self._err_acc = self.decay * self._err_acc + rel_err
        self._weight = self.decay * self._weight + 1.0

    @property
    def drift(self) -> float:
        """Smoothed symmetric prediction error (``max/min - 1`` per
        observation; 0.0 on a cold ledger, 1.0 ≈ consistently 2x off in
        either direction)."""
        if self._weight <= 0:
            return 0.0
        return self._err_acc / self._weight

    @property
    def weight(self) -> float:
        """Effective observation count behind ``drift`` (decayed)."""
        return self._weight

    def stale(self) -> bool:
        """Has the calibration's wall-clock staleness lapsed mid-run?"""
        if not self.active or self.model.calibrated_at is None:
            return False
        return self._clock() - self.model.calibrated_at > self.max_age_s

    def should_recalibrate(self) -> bool:
        """True when the evidence says the coefficients no longer
        describe this machine: sustained relative error above the
        threshold (with ``min_weight`` effective observations — one
        outlier batch must not trigger a multi-second re-profile), or
        wall-clock staleness."""
        if not self.active:
            return False
        if self.stale():
            return True
        return self._weight >= self.min_weight \
            and self.drift > self.rel_threshold

    def state_dict(self) -> Dict:
        """JSON-serializable drift-ledger state for persistence inside
        the calibration file (``save_calibration(monitor=...)``).  The
        model's ``calibrated_at`` rides along as the evidence's identity:
        drift observed against one set of coefficients says nothing
        about another, so ``restore`` refuses a block whose timestamp
        does not match the model it is restored onto."""
        return {"err_acc": self._err_acc, "weight": self._weight,
                "generation": self.generation,
                "recalibrations": self.recalibrations,
                "calibrated_at": self.model.calibrated_at}

    @classmethod
    def restore(cls, model: CostModel, state: Optional[Dict],
                **kwargs) -> "CalibrationMonitor":
        """Monitor warm-started from a persisted ``state_dict`` block.

        The same distrust discipline as ``SlotStats.load`` and
        ``load_calibration``: any problem — None/absent block, wrong
        types, non-finite or negative accumulators, a decayed weight
        exceeding what the configured ``decay`` can produce, or evidence
        recorded against a different calibration (``calibrated_at``
        mismatch) — yields a clean cold-start monitor and never raises.
        Restoring stale-but-valid drift evidence is safe (worst case: an
        early recalibration); restoring foreign or corrupt evidence is
        not, so everything suspect is dropped wholesale."""
        mon = cls(model, **kwargs)
        if not isinstance(state, dict):
            return mon
        try:
            err = float(state["err_acc"])
            weight = float(state["weight"])
            generation = int(state["generation"])
            recalibrations = int(state["recalibrations"])
            calibrated_at = float(state["calibrated_at"])
        except (KeyError, TypeError, ValueError):
            return mon
        if not (np.isfinite(err) and np.isfinite(weight)) \
                or err < 0 or weight < 0 \
                or generation < 0 or recalibrations < 0:
            return mon
        if mon.decay < 1.0 and weight >= 1.0 / (1.0 - mon.decay):
            return mon               # impossible under this decay
        if model.calibrated_at is None \
                or calibrated_at != float(model.calibrated_at):
            return mon               # evidence about other coefficients
        mon._err_acc = err
        mon._weight = weight
        mon.generation = generation
        mon.recalibrations = recalibrations
        return mon

    def describe(self) -> Dict:
        """Operator/provenance view (recorded next to bench results)."""
        return {"active": self.active, "drift": self.drift,
                "weight": self._weight, "stale": self.stale(),
                "rel_threshold": self.rel_threshold,
                "should_recalibrate": self.should_recalibrate(),
                "recalibrations": self.recalibrations}

    def __repr__(self) -> str:
        return (f"CalibrationMonitor(drift={self.drift:.3f}, "
                f"weight={self._weight:.1f}, "
                f"due={self.should_recalibrate()})")
