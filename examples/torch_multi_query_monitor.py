"""Multi-query monitor on the PyTorch/CUDA port: N concurrent queries, one
shared cascade — the twin of examples/multi_query_monitor.py, importing
only ``repro_torch``.

Demonstrates the multi-query subsystem end to end on a synthetic stream:

- ``QueryRegistry``          — live query set with epoch versioning; owns
                               the population ``SlotStats`` store that
                               survives plan rebuilds
- ``MultiQueryCascade``      — deduplicating shared-plan filter evaluation,
                               run *staged and adaptive* here: cost tiers
                               ordered by learned population pass rates,
                               later tiers skipped once every query is
                               decided (watch the staging report lines)
- ``MultiQueryExecutor``     — ONE union-mask oracle compaction per batch
                               (dense ``oracle_bucket`` index batches),
                               per-query attribution in the stats
- ``MultiQueryStreamExecutor`` — hopping windows that multiplex query
                               registrations/retirements mid-stream (the
                               shared plan is rebuilt only when the
                               registered set changes; each rebuild hands
                               the registry's SlotStats to the new engine,
                               so mid-stream registrations inherit the
                               learned selectivities instead of starting
                               cold)

Filter outputs are derived from the stream's ground truth (oracle-grade
branch heads) so the example runs in seconds without training; swap in
``train_filter`` heads (see examples/monitoring_queries.py) for the
learned-filter version.  The filter outputs live on ``--device``
(default ``cuda``; ``--device cpu`` runs anywhere), and every batch's
filter and oracle spend is charged to the registry's budget ledger.

    python examples/torch_multi_query_monitor.py [--frames 1024] [--device cpu]

``--stats PATH`` persists the population store across runs
(``SlotStats.save``/``load`` via ``QueryRegistry(stats_path=...)``): the
second invocation resumes with the first one's learned selectivities and
row ledger instead of relearning them from the prior.
"""
import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse

import numpy as np
import torch

from repro_torch.core import cascade as CS
from repro_torch.core import query as Q
from repro_torch.core.filters import FilterOutputs
from repro_torch.core.streaming import (HoppingWindow,
                                        MultiQueryStreamExecutor,
                                        QueryRegistry)
from repro_torch.data.synthetic import PRESETS, VideoStream, collect


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=1024)
    ap.add_argument("--window", type=int, default=256)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--stats", default=None, metavar="PATH",
                    help="persist SlotStats here across runs (loaded at "
                         "start when present, saved at exit)")
    args = ap.parse_args()

    scene = PRESETS["jackson-like"]
    data = collect(VideoStream(scene), args.frames)
    dev = torch.device(args.device)
    counts = torch.as_tensor(data["counts"].astype(np.float32), device=dev)
    grid = torch.as_tensor(data["occupancy"], device=dev).float()

    registry = QueryRegistry(stats_path=args.stats)
    if args.stats and len(registry.slot_stats):
        print(f"resumed {len(registry.slot_stats)} learned slot rates "
              f"from {args.stats}")
    q_busy = registry.register(Q.Count(Q.Op.GE, 3))
    q_car = registry.register(Q.ClassCount(0, Q.Op.GE, 1))
    q_order = registry.register(
        Q.And((Q.ClassCount(0, Q.Op.GE, 1),
               Q.Spatial(0, Q.Rel.LEFT, 1, radius=1))))
    names = {q_busy: "busy", q_car: "car>=1", q_order: "car-left-of"}

    engines = []

    def engine_factory(queries, slot_stats, budget_ledger, device):
        """(queries, registry SlotStats, ledger, device) ->
        fn(frame_indices) -> (B, N) bool.  Rebuilt only on registry
        epoch changes (watch ``executor.rebuilds``); the shared
        ``slot_stats`` store carries the learned pass rates across
        rebuilds."""
        mqc = CS.MultiQueryCascade(queries, adaptive=True,
                                   slot_stats=slot_stats, restage_every=4)

        def filter_fn(idx):
            i = torch.as_tensor(idx, device=device)
            return FilterOutputs(counts=counts[i], grid=grid[i])

        def oracle_fn(idx, sel):                 # union-of-needs compaction
            return [[tuple(o) for o in data["objects"][idx[j]]]
                    for j in sel]

        ex = CS.MultiQueryExecutor(mqc, filter_fn, oracle_fn,
                                   scene.n_classes, scene.grid,
                                   oracle_bucket=16,
                                   budget_ledger=budget_ledger,
                                   device=device)
        engines.append((ex, queries))
        return lambda idx: ex.run_batch(idx).answers

    executor = MultiQueryStreamExecutor(
        registry, engine_factory,
        HoppingWindow(size=args.window, advance=args.window), args.batch,
        device=dev)

    def on_window(res):
        lo, hi = res.span
        hits = ", ".join(f"{names[qid]}={n}" for qid, n in
                         sorted(res.hits.items()))
        casc = engines[-1][0].cascade
        rep = casc.staging_report
        # the report describes the last batch that actually ran staged;
        # when staging is parked it would be stale — show the mode only
        staging = (f"  [stages {len(rep.ran)}/{len(rep.order)} ran, "
                   f"mode={casc.mode}]" if rep and casc.mode == "staged"
                   else f"  [mode={casc.mode}]")
        print(f"window [{lo:5d}, {hi:5d})  {hits}{staging}")
        if lo == 0:                       # mid-stream registration
            qid = registry.register(Q.Not(Q.ClassCount(1, Q.Op.GE, 1)))
            names[qid] = "no-person"
            print("  -> registered 'no-person' (takes effect next batch; "
                  f"inherits {len(registry.slot_stats)} learned slot rates)")
        if lo == args.window:             # mid-stream retirement
            registry.retire(q_busy)
            print("  -> retired 'busy'")

    executor.run(args.frames, on_window)
    print(f"\nplan rebuilds: {executor.rebuilds} "
          f"(one per registry change, never per batch)")
    ex, queries = engines[-1]                    # current engine's stats
    st = ex.stats
    print(f"last engine: {st.frames_in} frames in, "
          f"{st.oracle_calls} oracle calls (union of needs); per-query "
          f"attribution: " + ", ".join(
              f"{names[qid]}={n}" for (qid, _), n in
              zip(registry.active(), st.per_query_pass)))
    print(f"population stats: {len(registry.slot_stats)} slots learned "
          f"across {executor.rebuilds} engine rebuilds (stats survive "
          f"registration churn)")
    led = registry.budget_ledger
    print(f"budget ledger: {led.filter_frames} filter frames "
          f"({led.filter_us / 1e3:.1f} ms), {led.oracle_calls} oracle "
          f"frames ({led.oracle_us / 1e3:.1f} ms)")
    if args.stats:
        registry.save_stats()
        print(f"saved population stats to {args.stats} — the next run "
              f"resumes warm (stats survive restarts too)")


if __name__ == "__main__":
    main()
