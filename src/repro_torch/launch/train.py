"""Training launcher of the model zoo (the JAX package's
``launch/train.py`` on one card).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_0p5b \\
        --steps 100 --batch 8 --seq 512 --ckpt-dir /tmp/ckpt --ckpt-every 50
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu

The reference's flags less ``--mesh`` (one card), plus ``--device``
(default ``cuda``).  The loop wires the same concerns together: the
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

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.data.pipeline import DeviceLoader, TokenStream
from repro_torch.device import resolve_device
from repro_torch.models.config import ShapeCell
from repro_torch.optim import adamw, warmup_cosine
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


def main(argv=None) -> TrainRun:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cell = ShapeCell("cli", args.seq, args.batch, "train")
    opt = adamw(warmup_cosine(args.lr, 10, max(args.steps, 11)),
                weight_decay=0.01)
    step_fn = TS.step_for_cell(cfg, cell, opt, clip_norm=1.0)
    gen = torch.Generator(dev).manual_seed(0)

    def init(device):
        return TS.init_state(gen, cfg, opt, device=device)

    mgr: Optional[CheckpointManager] = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, every=args.ckpt_every)
        mgr.preempt.install()
        state, start = mgr.restore_or_init(init, device=dev)
        start += 1
    else:
        state, start = init(dev), 0

    stream = TokenStream(cfg.vocab_size, args.batch, args.seq)
    run = TrainRun(start, [], [], [])
    t0 = time.perf_counter()
    with DeviceLoader(with_extras(iter(stream), cfg, args.batch, args.seq),
                      dev) as loader:
        for step, batch in zip(range(start, args.steps), loader):
            ts = time.perf_counter()
            state, metrics = step_fn(state, batch)
            run.losses.append(float(metrics["loss"]))
            run.step_s.append(time.perf_counter() - ts)
            run.grad_norms.append(float(metrics["grad_norm"]))
            if mgr is not None:
                mgr.step(state, step)
            if step % args.log_every == 0:
                dt = time.perf_counter() - t0
                print(f"step {step:5d} loss {run.losses[-1]:.4f} "
                      f"gnorm {run.grad_norms[-1]:.3f} ({dt:.1f}s)",
                      flush=True)
    if mgr is not None:
        mgr.wait()
    print("done.")
    return run


if __name__ == "__main__":
    main()
