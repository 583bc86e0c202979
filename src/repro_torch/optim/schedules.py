"""Learning-rate schedules (counterpart of `repro/optim/schedules.py`):
pure functions of the step (an int or a tensor) returning a float32
0-d tensor on the CPU, computed in float32 as the JAX package does."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant_lr(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def cosine_schedule(base_lr: float, total_steps: int,
                    final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(_f32(step) / total_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return base_lr * (final_frac + (1 - final_frac) * cos)
    return fn


def linear_warmup_cosine(base_lr: float, warmup_steps: int,
                         total_steps: int, final_frac: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup_steps, 1),
                          final_frac)

    def fn(step):
        s = _f32(step)
        warm = base_lr * s / max(warmup_steps, 1)
        return torch.where(s < warmup_steps, warm, cos(s - warmup_steps))
    return fn
