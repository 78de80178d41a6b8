"""Learning-rate schedules as float32 functions of the step (the counterpart
of ``repro.optim.schedule``).  A step is an int or an integer tensor; the rate
is a 0-d float32 tensor on the step's device."""
from __future__ import annotations

import math

import torch


def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.1):
    def lr(step):
        t = torch.clamp(torch.as_tensor(step).float() / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return base_lr * (min_frac + (1 - min_frac) * cos)
    return lr


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int, min_frac: float = 0.1):
    """Linear warm-up, then cosine decay.  At step 0 the rate is 0, as in the
    reference: the first update moves the moments, not the parameters."""
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), min_frac)

    def lr(step):
        step = torch.as_tensor(step)
        w = torch.clamp(step.float() / max(warmup, 1), max=1.0)
        return w * cos(torch.clamp(step - warmup, min=0))
    return lr
