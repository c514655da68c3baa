"""LR schedules (port of `repro.optim.schedule`)."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, floor: float = 0.1) -> torch.Tensor:
    """Linear warmup from step 1 to `peak_lr`, then a cosine decay to
    `floor * peak_lr` at `total_steps`; a float32 scalar on `step`'s
    device, in the reference's arithmetic order."""
    step = torch.as_tensor(step).to(torch.float32)
    # warm from step 1 so the first optimizer step is never a no-op
    warm = peak_lr * (step + 1) / max(warmup_steps, 1)
    frac = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    frac = torch.clamp(frac, 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5
                     * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup_steps, warm, cos)
