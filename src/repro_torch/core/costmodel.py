"""Cost model for the staged multi-query planner (static part).

Every staging decision in the adaptive engine is a cost comparison: the
stage order in ``StagedQueryPlan._staging_order`` ranks tiers by cost per
expected decision, ``StageReport.cost_run`` accumulates what a staged
batch paid, ``predicted_batch_cost`` projects that cost from the row
ledger, and ``MultiQueryCascade`` parks staging when the staged cost
stops beating the exhaustive plan's.

``CostModel`` answers every such query through one interface.  This
slice of the port carries the **static** model — the JAX package's
hand-picked relative constants (count=1, spatial=6, region=10+2·radius,
step_overhead=4), reproduced exactly so the port's staging decisions
equal the reference's — and the arithmetic of a **measured** model
(affine per-stage ``overhead + per_row · rows`` coefficients), which a
caller may construct by hand.  Calibrating those coefficients on CUDA
timings is still to be ported, so ``default_cost_model`` returns the
static model.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

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

#: Reference batch size for batch-agnostic cost queries (stage ranking
#: before any traffic has been seen).  The static model is scale-free in
#: the batch, so this only matters for measured models.
REF_BATCH = 64

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

    def describe(self) -> Dict:
        """Operator/provenance view (recorded next to bench results)."""
        return {
            "source": self.source,
            "backend": self.backend,
            "step_overhead": self._step_overhead,
            "coeffs": {k: dataclasses.asdict(c)
                       for k, c in self.coeffs.items()},
            # the two decisions this model derives (docs/tuning.md):
            # where the spatial bodies cross, and the compaction floor
            "spatial_crossover_rows": self.spatial_crossover_rows(),
            "derived_min_bucket": self.derived_min_bucket(),
        }

    def __repr__(self) -> str:
        return f"CostModel(source={self.source!r}, backend={self.backend!r})"


def static_cost_model() -> CostModel:
    """The legacy hand-picked model — the provable fallback."""
    return CostModel(source="static")


def default_cost_model() -> CostModel:
    """The model the adaptive engine uses when none is given: the static
    constants (no calibration is loaded in this slice of the port)."""
    return static_cost_model()
