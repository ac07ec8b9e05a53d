"""Training launcher of the model zoo (the JAX package's
``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_0p5b \\
        --steps 100 --batch 8 --seq 512 --ckpt-dir /tmp/ckpt --ckpt-every 50
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
    PYTHONPATH=src torchrun --nproc-per-node=N -m repro_torch.launch.train \\
        --smoke --mesh host

The reference's flags plus ``--device`` (default ``cuda``).  Without
``--mesh`` the step runs on one card with no process group
(``step_for_cell``).  ``--mesh host`` starts the process group from
``torchrun``'s environment (NCCL on CUDA, gloo with ``--device cpu``)
and trains over a (1, world) ("data", "model") mesh through the sharding
plan (``jit_step_for_cell``): every rank draws the same initial state
and token stream, and the plan splits them (the batches in the
loader's prefetch thread: ``ShardedLoader`` with the plan's input
placements; one card keeps ``DeviceLoader``).  ``single`` / ``multi`` are
the 256- and 512-rank production meshes and raise elsewhere.  Under a
mesh, a checkpoint is the whole state, gathered at each ``--ckpt-every``
step and written by rank 0; the SIGTERM handler is not installed there
(a signal reaching the ranks at different steps would desynchronise the
gather).  The loop wires the same concerns together: the
token stream with a VLM's stub ``embeds`` and an encoder-decoder's stub
``frames``, prefetching host -> device loading, the warmup-cosine AdamW
step, checkpoint / restore with preemption handling, and the log line.
As in the reference, a resumed run draws the token stream again from its
first batch.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.data.pipeline import (DeviceLoader, ShardedLoader,
                                       TokenStream)
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (init_distributed, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models.config import ShapeCell
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.optim.optimizers import tree_map
from repro_torch.train import step as TS


@dataclasses.dataclass
class TrainRun:
    """What ``main`` ran: the first step, and per step its loss, gradient
    norm and host seconds (the step and the loss's fetch)."""
    start: int
    losses: List[float]
    grad_norms: List[float]
    step_s: List[float]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS, default="qwen2_0p5b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh", choices=["host", "single", "multi"],
                    default=None,
                    help="train over a device mesh (under torchrun); "
                         "default: one card, no process group")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def with_extras(it, cfg, batch: int, seq: int):
    """The stub inputs of the token stream: a VLM's zero prefix
    ``embeds`` (the tokens cut to leave room for it), an
    encoder-decoder's zero ``frames``."""
    for b in it:
        if cfg.vlm_prefix:
            p = min(cfg.vlm_prefix, seq // 2)
            b["embeds"] = np.zeros((batch, p, cfg.d_model), np.float32)
            b["tokens"] = b["tokens"][:, : seq - p]
            b["labels"] = b["labels"][:, : seq - p]
        if cfg.enc_dec:
            b["frames"] = np.zeros((batch, cfg.enc_len, cfg.d_model),
                                   np.float32)
        yield b


def _mesh(kind: str, dev: torch.device):
    if kind == "host":
        return make_host_mesh(dev)
    return make_production_mesh(multi_pod=kind == "multi", device=dev)


def main(argv=None) -> TrainRun:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cell = ShapeCell("cli", args.seq, args.batch, "train")
    opt = adamw(warmup_cosine(args.lr, 10, max(args.steps, 11)),
                weight_decay=0.01)
    plan, own_group, rank = None, False, 0
    if args.mesh is None:
        step_fn = TS.step_for_cell(cfg, cell, opt, clip_norm=1.0)
    else:
        own_group = not dist.is_initialized()
        init_distributed(dev)
        rank = dist.get_rank()
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        step_fn, plan = TS.jit_step_for_cell(cfg, cell, _mesh(args.mesh, dev),
                                             opt, clip_norm=1.0)
    gen = torch.Generator(dev).manual_seed(0)

    def init(device):
        return TS.init_state(gen, cfg, opt, device=device)

    mgr: Optional[CheckpointManager] = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, every=args.ckpt_every)
        if plan is None:
            mgr.preempt.install()
        state, start = mgr.restore_or_init(init, device=dev)
        start += 1
    else:
        state, start = init(dev), 0
    if plan is not None:
        state = plan.place(state, plan.state_shardings)

    stream = TokenStream(cfg.vocab_size, args.batch, args.seq)
    run = TrainRun(start, [], [], [])
    t0 = time.perf_counter()
    batches = with_extras(iter(stream), cfg, args.batch, args.seq)
    loader = DeviceLoader(batches, dev) if plan is None else \
        ShardedLoader(batches, plan.input_shardings, plan.mesh)
    with loader:
        for step, batch in zip(range(start, args.steps), loader):
            ts = time.perf_counter()
            state, metrics = step_fn(state, batch)
            run.losses.append(float(metrics["loss"]))
            run.step_s.append(time.perf_counter() - ts)
            run.grad_norms.append(float(metrics["grad_norm"]))
            if mgr is not None and plan is None:
                mgr.step(state, step)
            elif mgr is not None and step % args.ckpt_every == 0:
                whole = tree_map(lambda t: t.full_tensor(), state)
                if rank == 0:
                    mgr.step(whole, step)
                del whole
            if step % args.log_every == 0 and rank == 0:
                dt = time.perf_counter() - t0
                print(f"step {step:5d} loss {run.losses[-1]:.4f} "
                      f"gnorm {run.grad_norms[-1]:.3f} ({dt:.1f}s)",
                      flush=True)
    if mgr is not None:
        mgr.wait()
    if own_group:
        dist.destroy_process_group()
    if rank == 0:
        print("done.")
    return run


if __name__ == "__main__":
    main()
