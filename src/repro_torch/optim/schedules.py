"""Learning-rate schedules (the port of ``repro/optim/schedules.py``).

Each schedule maps a step -- a Python int or a 0-d tensor -- to the rate,
computed in float32 as the reference does: a 0-d float32 tensor on the
step's device (the CPU for a Python int), so that AdamW reads it without
a host round trip.
"""
from __future__ import annotations

import math

import torch


def _step(step):
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def warmup_cosine(peak, warmup_steps, total_steps, floor=0.1):
    """Linear warm-up to ``peak`` over ``warmup_steps``, then a cosine down
    to ``floor * peak`` at ``total_steps``."""
    def lr(step):
        s = _step(step)
        warm = peak * s / max(warmup_steps, 1)
        frac = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5
                      * (1 + torch.cos(math.pi * frac)))
        return torch.where(s < warmup_steps, warm, cos)
    return lr


def inverse_sqrt(gamma):
    """The paper's RADiSA step size: eta_t = gamma / (1 + sqrt(t - 1))."""
    def lr(step):
        s = _step(step)
        return gamma / (1.0 + torch.sqrt(torch.clamp(s - 1.0, min=0.0)))
    return lr


def constant(v):
    return lambda step: v
