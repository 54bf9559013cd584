"""Learning-rate schedules (pure functions of the step): a port of
``repro.optim.schedules``, in f32 as the reference computes them."""
from __future__ import annotations

import math

import torch


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1):
    """Linear warmup then cosine decay to ``floor * peak_lr``; the step
    (an int or an int tensor) is taken as f32 and the result is an f32
    scalar tensor."""
    def schedule(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(1, warmup_steps)
        t = torch.clamp((step - warmup_steps) / max(1, total_steps
                                                    - warmup_steps), 0.0, 1.0)
        cos = floor * peak_lr + (1 - floor) * peak_lr * 0.5 * (
            1 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, cos)
    return schedule


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)
