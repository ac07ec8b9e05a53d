"""Serving launcher: the paper's monitoring pipeline end to end (the JAX
package's ``launch/serve.py`` on one card).

    PYTHONPATH=src python -m repro_torch.launch.serve --scene jackson-like \\
        --frames 2000 --batch 64 --query q5 --train-steps 200 [--device cpu]

Trains an OD filter branch, then streams synthetic video frames through
the filter cascade (``FilterCascade(adaptive=True)``); only surviving
frames reach the (expensive) oracle, so answers on survivors are the
oracle's.  Reports throughput, selectivity, recall against ground truth
and the Table-III-style speedup.  The straggler policy drops frames when
processing falls behind the stream.  ``--device`` defaults to ``cuda``.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import numpy as np

from repro_torch.core import cascade as CS
from repro_torch.core import query as Q
from repro_torch.core.streaming import StragglerPolicy, StreamExecutor
from repro_torch.data.synthetic import PRESETS, VideoStream, collect
from repro_torch.device import resolve_device
from repro_torch.models.config import BranchSpec
from repro_torch.train.filter_train import train_filter

QUERIES = {
    # analogues of the paper's q1..q7 (§IV-B) on the synthetic scenes
    "q1": lambda: Q.ClassCount(0, Q.Op.EQ, 2, tolerance=1),
    "q2": lambda: Q.And((Q.ClassCount(0, Q.Op.EQ, 2, tolerance=1),
                         Q.Region(0, (4, 0, 8, 4), radius=1))),
    "q3": lambda: Q.And((Q.ClassCount(0, Q.Op.EQ, 1),
                         Q.ClassCount(1, Q.Op.EQ, 1))),
    "q4": lambda: Q.And((Q.ClassCount(0, Q.Op.GE, 1),
                         Q.ClassCount(1, Q.Op.GE, 1))),
    "q5": lambda: Q.And((Q.ClassCount(0, Q.Op.EQ, 1, tolerance=0),
                         Q.ClassCount(1, Q.Op.EQ, 1, tolerance=0),
                         Q.Spatial(0, Q.Rel.LEFT, 1, radius=1))),
}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=list(PRESETS), default="jackson-like")
    ap.add_argument("--query", choices=list(QUERIES), default="q4")
    ap.add_argument("--frames", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--train-steps", type=int, default=200)
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--oracle-ms", type=float, default=200.0,
                    help="oracle cost per frame (paper: Mask R-CNN 200ms)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> Dict[str, Any]:
    """Runs the pipeline and prints its lines; returns the reported
    numbers with the per-frame ``answers``, ``truth`` and ``survived``
    (the filter's mask; frames dropped by the straggler policy are
    neither)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    scene = PRESETS[args.scene]
    print(f"[serve] training OD filter branch on {args.scene} ...")
    spec = BranchSpec(layer=2, grid=scene.grid, n_classes=scene.n_classes,
                      kind="od", head_dim=64)
    tf = train_filter(scene, spec, steps=args.train_steps, batch=32,
                      device=dev)

    print(f"[serve] streaming {args.frames} frames, query {args.query}")
    data = collect(VideoStream(scene), args.frames)
    query = QUERIES[args.query]()
    cascade = CS.FilterCascade(query, adaptive=True)

    def oracle_fn(idx, sub):
        return [data["objects"][idx[j]] for j in sub]

    answers = np.zeros(args.frames, bool)
    survived = np.zeros(args.frames, bool)
    stats = CS.CascadeStats()

    def process(idx):
        t0 = time.perf_counter()
        fout = tf.apply(data["embeds"][idx], device=dev)
        mask = cascade.mask(fout).cpu().numpy()
        t1 = time.perf_counter()
        sub = np.nonzero(mask)[0]
        survived[idx[sub]] = True
        if sub.size:
            for j, objs in zip(sub, oracle_fn(idx, sub)):
                answers[idx[j]] = Q.eval_objects(query, objs,
                                                 scene.n_classes, scene.grid)
        stats.frames_in += idx.size
        stats.filter_pass += int(mask.sum())
        stats.oracle_calls += int(sub.size)
        stats.filter_time_s += t1 - t0

    ex = StreamExecutor(process, batch=args.batch,
                        policy=StragglerPolicy(fps=args.fps, slack=4.0))
    st = ex.run(args.frames)

    truth = np.array([Q.eval_objects(query, o, scene.n_classes, scene.grid)
                      for o in data["objects"]])
    tp = int((answers & truth).sum())
    fn_ = int((~answers & truth).sum())
    recall = tp / max(tp + fn_, 1)
    filter_ms = stats.filter_time_s / max(stats.frames_in, 1) * 1e3
    speed = stats.speedup_vs_full(args.oracle_ms, filter_ms)
    print(f"[serve] processed {st.frames_processed} frames "
          f"({st.fps:.0f} fps), dropped {st.frames_dropped}")
    print(f"[serve] selectivity {stats.selectivity:.3f} "
          f"oracle_calls {stats.oracle_calls}  recall {recall:.3f} "
          f"(answers are oracle-exact on survivors)")
    print(f"[serve] filter {filter_ms:.2f} ms/frame; speedup vs "
          f"run-oracle-on-everything: {speed:.1f}x")
    return {"frames_processed": st.frames_processed, "fps": st.fps,
            "dropped": st.frames_dropped, "selectivity": stats.selectivity,
            "oracle_calls": stats.oracle_calls, "recall": recall,
            "filter_ms": filter_ms, "speedup": speed, "answers": answers,
            "truth": truth, "survived": survived}


if __name__ == "__main__":
    main()
