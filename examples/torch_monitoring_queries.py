"""End-to-end run on the PyTorch/CUDA port (the paper's kind = video
query *serving*): the twin of examples/monitoring_queries.py, importing
only ``repro_torch``.

Trains filter branches on each Table-II-matched stream, then serves the
paper's seven queries (q1-q7 analogues) through the filter cascade: the
strict query is answered by the oracle on the frames that the tolerant
query's ``FilterCascade`` lets through (the §IV-B experiment).  Each
tolerant query also runs through the shared staged plan
(``StagedQueryPlan``: the count tier, then the spatial-stats kernels on
the rows it leaves undecided), whose mask must equal the cascade's.
Filter ms is taken after the card has finished (synchronised clock).
The model lives on ``--device`` (default ``cuda``; ``--device cpu`` runs
anywhere).

    python examples/torch_monitoring_queries.py \
        [--steps 250] [--frames 1024] [--adaptive] [--device cpu]
"""
import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse
import time

import numpy as np
import torch

from repro_torch.core import cascade as CS
from repro_torch.core import query as Q
from repro_torch.core.plan import QueryPlan, StagedQueryPlan
from repro_torch.data.synthetic import PRESETS, VideoStream, collect
from repro_torch.device import resolve_device
from repro_torch.models.config import BranchSpec
from repro_torch.train.filter_train import train_filter

ORACLE_MS = 200.0     # paper §IV: Mask R-CNN per frame

# q1..q7 analogues (paper §IV-B): scene, strict query, tolerant variant;
# a copy of benchmarks/table3_query_speedup.py's QUERIES
QUERIES = [
    ("q1", "coral-like",
     lambda: Q.ClassCount(0, Q.Op.EQ, 2),
     lambda: Q.ClassCount(0, Q.Op.EQ, 2, tolerance=1)),
    ("q2", "coral-like",
     lambda: Q.And((Q.ClassCount(0, Q.Op.EQ, 2),
                    Q.Region(0, (4, 0, 8, 4)))),
     lambda: Q.And((Q.ClassCount(0, Q.Op.EQ, 2, tolerance=1),
                    Q.Region(0, (4, 0, 8, 4), radius=1)))),
    ("q3", "jackson-like",
     lambda: Q.And((Q.ClassCount(0, Q.Op.EQ, 1),
                    Q.ClassCount(1, Q.Op.EQ, 1))),
     lambda: Q.And((Q.ClassCount(0, Q.Op.EQ, 1, tolerance=1),
                    Q.ClassCount(1, Q.Op.EQ, 1, tolerance=1)))),
    ("q4", "jackson-like",
     lambda: Q.And((Q.ClassCount(0, Q.Op.GE, 1),
                    Q.ClassCount(1, Q.Op.GE, 1))),
     lambda: Q.And((Q.ClassCount(0, Q.Op.GE, 1, tolerance=1),
                    Q.ClassCount(1, Q.Op.GE, 1, tolerance=1)))),
    ("q5", "jackson-like",
     lambda: Q.And((Q.ClassCount(0, Q.Op.EQ, 1),
                    Q.ClassCount(1, Q.Op.EQ, 1),
                    Q.Spatial(0, Q.Rel.LEFT, 1))),
     lambda: Q.And((Q.ClassCount(0, Q.Op.EQ, 1, tolerance=1),
                    Q.ClassCount(1, Q.Op.EQ, 1, tolerance=1),
                    Q.Spatial(0, Q.Rel.LEFT, 1, radius=1)))),
    # q6/q7 constants calibrated to the detrac-like base rates (15.8
    # objects/frame, class mix 92/6/2): "exactly one bus among >= 10 cars"
    ("q6", "detrac-like",
     lambda: Q.And((Q.ClassCount(1, Q.Op.EQ, 1),
                    Q.ClassCount(0, Q.Op.GE, 10))),
     lambda: Q.And((Q.ClassCount(1, Q.Op.EQ, 1, tolerance=1),
                    Q.ClassCount(0, Q.Op.GE, 10, tolerance=2)))),
    ("q7", "detrac-like",
     lambda: Q.And((Q.ClassCount(1, Q.Op.EQ, 1),
                    Q.ClassCount(0, Q.Op.GE, 10),
                    Q.Spatial(0, Q.Rel.LEFT, 1))),
     lambda: Q.And((Q.ClassCount(1, Q.Op.EQ, 1, tolerance=2),
                    Q.ClassCount(0, Q.Op.GE, 10, tolerance=3),
                    Q.Spatial(0, Q.Rel.LEFT, 1, radius=2)))),
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--frames", type=int, default=1024)
    ap.add_argument("--adaptive", action="store_true",
                    help="adaptive (observed-selectivity) filter ordering")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    filters, results = {}, []
    print(f"{'q':4s} {'stream':14s} {'recall':>7s} {'select':>7s} "
          f"{'speedup':>9s} {'filter ms':>9s}")
    for name, scene_name, strict_q, tolerant_q in QUERIES:
        scene = PRESETS[scene_name]
        if scene_name not in filters:
            spec = BranchSpec(layer=2, grid=scene.grid,
                              n_classes=scene.n_classes, kind="od",
                              head_dim=64)
            filters[scene_name] = train_filter(scene, spec,
                                               steps=args.steps,
                                               n_frames=2048, device=dev)
        tf = filters[scene_name]
        data = collect(VideoStream(scene), args.frames)

        query = strict_q()
        cascade = CS.FilterCascade(tolerant_q(), adaptive=args.adaptive)

        sync()
        t0 = time.perf_counter()
        fout = tf.apply(data["embeds"], device=dev)
        mask = cascade.mask(fout)
        sync()
        filter_ms = (time.perf_counter() - t0) / args.frames * 1e3
        staged = StagedQueryPlan(QueryPlan([tolerant_q()])).evaluate(fout)
        if not torch.equal(staged[:, 0], mask):
            raise RuntimeError(f"{name}: the staged plan's mask differs "
                               f"from the cascade's")
        mask = mask.cpu().numpy()

        truth = np.array([Q.eval_objects(query, o, scene.n_classes,
                                         scene.grid)
                          for o in data["objects"]])
        answers = np.zeros(args.frames, bool)
        for j in np.nonzero(mask)[0]:
            answers[j] = truth[j]       # oracle-exact on survivors
        recall = (answers & truth).sum() / max(truth.sum(), 1)
        sel = mask.mean()
        speedup = (args.frames * ORACLE_MS) / (
            args.frames * filter_ms + mask.sum() * ORACLE_MS)
        print(f"{name:4s} {scene_name:14s} {recall:7.3f} {sel:7.3f} "
              f"{speedup:8.1f}x {filter_ms:9.2f}")
        results.append(dict(name=name, scene=scene_name, recall=recall,
                            selectivity=sel, speedup=speedup,
                            filter_ms=filter_ms, mask=mask, truth=truth,
                            answers=answers, objects=data["objects"]))
    return results


if __name__ == "__main__":
    main()
