"""Learning-rate schedules (pure functions of the step counter).

The step may be a Python int or a tensor; every schedule computes in
float32 on a 0-dim tensor, as the JAX package's schedules do on a jnp
scalar."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def linear_warmup(lr: float, warmup_steps: int):
    def f(step):
        return lr * torch.clamp((_f32(step) + 1) / max(warmup_steps, 1),
                                max=1.0)
    return f


def cosine_decay(lr: float, decay_steps: int, final_frac: float = 0.1):
    def f(step):
        s = torch.clamp(_f32(step), max=float(decay_steps))
        cos = 0.5 * (1 + torch.cos(math.pi * s / max(decay_steps, 1)))
        return lr * (final_frac + (1 - final_frac) * cos)
    return f


def warmup_cosine(lr: float, warmup_steps: int, decay_steps: int,
                  final_frac: float = 0.1):
    wu = linear_warmup(lr, warmup_steps)
    cd = cosine_decay(lr, decay_steps, final_frac)

    def f(step):
        step = torch.as_tensor(step)
        return torch.where(step < warmup_steps, wu(step),
                           cd(step - warmup_steps))
    return f


def exponential_decay(lr: float, decay: float):
    """Paper §IV: 'exponential decay of 5e-4'."""
    def f(step):
        return lr * torch.exp(-decay * _f32(step))
    return f
