"""Pair-run the filter stream's main path in two checkouts on one card.

    python3 tools/torch_stream_pairs.py TREE_A TREE_B [--rounds 3]
        [--repeats 5]

Each round starts one process per checkout in the order A B B A (the
next round B A A B), so drift of the machine over the call falls on
both sides alike.  A process builds its checkout's kernels, trains the
g = 56 filter as that checkout's ``chip_smoke.py`` does, runs its
``main_path`` once untimed, then ``--repeats`` times, and prints one
JSON line: per run the learned pass's frames/s, wall, filter and plan
ms (host clock around synchronised work, as the smoke reports them) and
the ground-truth pass's frames/s.  The last line compares the two sides:
medians, ranges, and the share of A's runs faster than B's (0.5 when
the two are one distribution).  Needs a CUDA card; each checkout must
hold ``chip_smoke.py`` and ``src/repro_torch``.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import statistics
import subprocess
import sys


def one(tree: str, repeats: int) -> dict:
    tree = os.path.abspath(tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(tree, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, cs.SRC)
    import torch
    from repro_torch.data.synthetic import VideoStream, collect
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    build.build_all()
    scene, trunk, bspec = cs.configure(False)
    tf, _ = cs.training_phase(torch, dev, scene, trunk, bspec, False)
    serve = dataclasses.replace(
        tf, trunk_cfg=dataclasses.replace(trunk, attn_impl="pallas"))
    data = collect(VideoStream(scene, dynamics_seed=cs.SEED), cs.N_FRAMES)
    runs = []
    for _ in range(repeats + 1):
        r, _, _, _ = cs.main_path(torch, dev, scene, serve, data)
        _, _, engines, wall, plan_s, _ = r["learned"]
        filt = sum(e.stats.filter_time_s for e in engines) - plan_s
        runs.append({"fps": cs.N_FRAMES / wall, "wall_ms": wall * 1e3,
                     "filter_ms": filt * 1e3, "plan_ms": plan_s * 1e3,
                     "gt_fps": cs.N_FRAMES / r["ground_truth"][3]})
    return {"tree": tree, "untimed": runs[0], "runs": runs[1:]}


def summary(side: list) -> dict:
    out = {}
    for key in ("fps", "plan_ms", "filter_ms", "gt_fps"):
        xs = [r[key] for r in side]
        out[key] = {"median": statistics.median(xs), "min": min(xs),
                    "max": max(xs)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one(args.one, args.repeats)), flush=True)
        return 0
    if len(args.trees) != 2:
        ap.error("give two checkouts")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(gpu, flush=True)
    sides = {t: [] for t in args.trees}
    a, b = args.trees
    for rnd in range(args.rounds):
        for tree in ((a, b, b, a) if rnd % 2 == 0 else (b, a, a, b)):
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", tree,
                 "--repeats", str(args.repeats)], capture_output=True,
                text=True)
            if res.returncode != 0:
                print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
                return 1
            line = json.loads(res.stdout.strip().splitlines()[-1])
            sides[tree] += line["runs"]
            print(json.dumps({"round": rnd, **line}), flush=True)
    fa = [r["fps"] for r in sides[a]]
    fb = [r["fps"] for r in sides[b]]
    faster = sum((x > y) + 0.5 * (x == y) for x in fa for y in fb)
    print(json.dumps({"gpu": gpu, "a": a, "b": b,
                      "a_summary": summary(sides[a]),
                      "b_summary": summary(sides[b]),
                      "share_a_faster": faster / (len(fa) * len(fb)),
                      "runs_per_side": len(fa)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
