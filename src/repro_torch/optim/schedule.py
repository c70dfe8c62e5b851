"""LR schedules (port of ``repro/optim/schedule.py``).

A schedule maps the optimizer's step (a 0-dim int tensor, or a Python
number) to the learning rate.  ``warmup_cosine`` computes in fp32 tensor
ops on the step's device, as the JAX version does in jnp, so reading the
rate never synchronises with the card."""
from __future__ import annotations

import math

import torch


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps) /
                           max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                         (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


def constant(lr_value: float):
    return lambda step: lr_value
