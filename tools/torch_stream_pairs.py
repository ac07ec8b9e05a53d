"""Pair-run the filter stream's main path in two checkouts on one card.

    python3 tools/torch_stream_pairs.py TREE_A TREE_B [--rounds 3]
        [--repeats 5] [--path stream|decode]

Each round starts one process per checkout in the order A B B A (the
next round B A A B), so drift of the machine over the call falls on
both sides alike.  A process builds its checkout's kernels, trains the
g = 56 filter as that checkout's ``chip_smoke.py`` does, runs its
``main_path`` once untimed, then ``--repeats`` times, and prints one
JSON line: per run the learned pass's frames/s, wall, filter and plan
ms (host clock around synchronised work, as the smoke reports them) and
the ground-truth pass's frames/s.  The last line compares the two sides:
medians, ranges, and the share of A's runs faster than B's (0.5 when
the two are one distribution).  ``--path decode`` runs the smoke's zoo
serving instead: qwen2-0.5b in bf16 under ``pallas``, 16 requests x 1024
prompt tokens and 32 greedy decode steps (``serve_steps``); a run's
numbers are its median decode step and its prefill, in ms.  Needs a
CUDA card; each checkout must hold ``chip_smoke.py`` and
``src/repro_torch``.
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


# per path: the number compared and whether more is better
PATHS = {"stream": ("fps", True), "decode": ("step_ms", False)}


def _smoke(tree: str):
    """The checkout's ``chip_smoke`` module, its kernels built; (module,
    torch, device)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(tree, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, cs.SRC)
    import torch
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    return cs, torch, torch.device("cuda")


def one_decode(tree: str, repeats: int) -> dict:
    tree = os.path.abspath(tree)
    cs, torch, dev = _smoke(tree)
    import numpy as np
    from repro_torch.models import model as M
    from repro_torch.models import serve as SV
    cfg = cs.model_config("qwen2_0p5b", False, attn_impl="pallas",
                          dtype="bfloat16")
    n, cap = cs.ZOO_REQUESTS, cs.ZOO_PROMPT + cs.ZOO_DECODE
    params = M.init_params(torch.Generator(dev).manual_seed(cs.SEED + 2),
                           cfg, device=dev)
    prompts = torch.as_tensor(np.random.default_rng(cs.SEED + 2).integers(
        0, cfg.vocab_size, (n, cs.ZOO_PROMPT)), device=dev)
    runs = []
    for _ in range(repeats + 1):
        t_pre, steps, _, finite, _ = cs.serve_steps(
            torch, dev, SV, params, cfg, prompts,
            SV.init_cache(cfg, n, cap, device=dev), cs.ZOO_DECODE)
        if not finite:
            raise SystemExit("a logit is not finite")
        runs.append({"step_ms": statistics.median(steps) * 1e3,
                     "prefill_ms": t_pre * 1e3})
    return {"tree": tree, "untimed": runs[0], "runs": runs[1:]}


def one(tree: str, repeats: int) -> dict:
    tree = os.path.abspath(tree)
    cs, torch, dev = _smoke(tree)
    from repro_torch.data.synthetic import VideoStream, collect
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
    for key in side[0]:
        xs = [r[key] for r in side]
        out[key] = {"median": statistics.median(xs), "min": min(xs),
                    "max": max(xs)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--path", choices=sorted(PATHS), default="stream")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        fn = one_decode if args.path == "decode" else one
        print(json.dumps(fn(args.one, args.repeats)), flush=True)
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
                 "--repeats", str(args.repeats), "--path", args.path],
                capture_output=True, text=True)
            if res.returncode != 0:
                print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
                return 1
            line = json.loads(res.stdout.strip().splitlines()[-1])
            sides[tree] += line["runs"]
            print(json.dumps({"round": rnd, **line}), flush=True)
    key, more = PATHS[args.path]
    fa = [r[key] for r in sides[a]]
    fb = [r[key] for r in sides[b]]
    faster = sum(((x > y) if more else (x < y)) + 0.5 * (x == y)
                 for x in fa for y in fb)
    print(json.dumps({"gpu": gpu, "a": a, "b": b,
                      "a_summary": summary(sides[a]),
                      "b_summary": summary(sides[b]),
                      "share_a_faster": faster / (len(fa) * len(fb)),
                      "runs_per_side": len(fa)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
