"""Bisect the port's filter-quality low tail: initialisation against
batch draw.

Trains the OD filter of tests/test_system.py (JACKSON-like scene, head_dim
48, layer 2, 140 steps x 32 over 768 frames) with the port's training
step on the CPU, for a range of seeds (0-10 by default), in one of five
modes, and prints the held-out ``cf_acc_1`` (256 frames, dynamics seed
99) as one JSON line a seed:

    ref   the JAX package's own ``train_filter``
    port  the port's ``train_filter`` (its init, its batch draw)
    a     the JAX package's init, the port's batch draw
    b     the port's init, the JAX package's batch indices
    c     the JAX package's init and batch indices

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/torch_filter_tail_probe.py a
    ... tools/torch_filter_tail_probe.py port --first 0 --seeds 50  # 0-49

Needs both packages (jax and torch); a seed takes about 25 s on one CPU
core.  ``--first`` and ``--seeds`` cut a range into pieces that run in
parallel processes.
"""
import argparse
import json
import time

import jax
import numpy as np
import torch

from repro.models.config import BranchSpec as RBranch
from repro.train import filter_train as RT
from repro_torch.data.synthetic import (JACKSON_LIKE, VideoStream,
                                        class_weights, collect)
from repro_torch.interop import params_from_numpy
from repro_torch.models.config import BranchSpec
from repro_torch.optim import adamw, clip_by_global_norm, exponential_decay
from repro_torch.train import filter_train as TT

STEPS, BATCH, N_FRAMES, EVAL_FRAMES = 140, 32, 768, 256
MODES = {"port": ("port", "port"), "a": ("ref", "port"),
         "b": ("port", "ref"), "c": ("ref", "ref")}


def _spec(cls):
    return cls(layer=2, grid=JACKSON_LIKE.grid,
               n_classes=JACKSON_LIKE.n_classes, kind="od", head_dim=48)


def train_port(seed: int, init: str, draw: str) -> TT.TrainedFilter:
    """``TT.train_filter``'s loop with the init and the batch indices
    taken from either package."""
    scene, spec = JACKSON_LIKE, _spec(BranchSpec)
    trunk = TT.default_trunk(grid=scene.grid)
    if init == "port":
        params = TT.init_filter_model(torch.Generator().manual_seed(seed),
                                      trunk, spec, scene.d_embed,
                                      device="cpu")
    else:
        ref = RT.init_filter_model(jax.random.PRNGKey(seed),
                                   RT.default_trunk(grid=scene.grid),
                                   _spec(RBranch), scene.d_embed)
        params = params_from_numpy(jax.tree.map(np.asarray, ref),
                                   device="cpu")
    data = collect(VideoStream(scene), N_FRAMES)
    embeds = torch.as_tensor(data["embeds"])
    count_scale = np.maximum(data["counts"].mean(0), 1.0).astype(np.float32)
    counts = torch.as_tensor(data["counts"] / count_scale,
                             dtype=torch.float32)
    occ = torch.as_tensor(data["occupancy"], dtype=torch.float32)
    opt = adamw(exponential_decay(2e-3, 5e-4))
    opt_state = opt.init(params)
    density = float(np.mean(data["occupancy"], dtype=np.float32))
    lam_grid = 20.0 * min(1.0, 0.02 / max(density, 1e-3))
    step = TT.make_train_step(trunk, spec, opt, clip_by_global_norm(1.0),
                              class_weights(data["counts"]), lam_grid,
                              device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    key = jax.random.PRNGKey(seed)
    warm = max(STEPS // 6, 1)
    for i in range(STEPS):
        if draw == "port":
            idx = torch.randint(0, N_FRAMES, (BATCH,), generator=gen)
        else:
            key, sub = jax.random.split(key)
            idx = torch.as_tensor(np.array(
                jax.random.randint(sub, (BATCH,), 0, N_FRAMES)))
        beta = np.float32(0.0 if i < warm else
                          10.0 * max(0.2, 1.0 - (i - warm) / STEPS))
        params, opt_state, _ = step(params, opt_state, i, embeds[idx],
                                    counts[idx], occ[idx], beta)
    return TT.TrainedFilter(params=params, trunk_cfg=trunk, spec=spec,
                            losses=[], count_scale=count_scale)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=["ref", *MODES])
    ap.add_argument("--first", type=int, default=0,
                    help="the first seed of the range")
    ap.add_argument("--seeds", type=int, default=11,
                    help="how many seeds, from --first on")
    ap.add_argument("--threads", type=int, default=1)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    for seed in range(args.first, args.first + args.seeds):
        t0 = time.perf_counter()
        if args.mode == "ref":
            tf = RT.train_filter(JACKSON_LIKE, _spec(RBranch), steps=STEPS,
                                 batch=BATCH, n_frames=N_FRAMES, seed=seed)
            res = RT.evaluate_filter(tf, JACKSON_LIKE, n_frames=EVAL_FRAMES)
        else:
            tf = train_port(seed, *MODES[args.mode])
            res = TT.evaluate_filter(tf, JACKSON_LIKE, n_frames=EVAL_FRAMES,
                                     device="cpu")
        print(json.dumps({"mode": args.mode, "seed": seed,
                          "cf_acc_1": res["cf_acc_1"],
                          "clf_f1_1": float(res["clf_f1_1"].mean()),
                          "s": round(time.perf_counter() - t0, 1)}),
              flush=True)


if __name__ == "__main__":
    main()
