"""LR schedules (the counterpart of `repro.optim.schedule`): pure functions
of the step counter, in f32 as JAX's."""

from __future__ import annotations

import math

import torch


def cosine_schedule(
    step, *, peak_lr: float, warmup: int = 200, total: int = 10000, min_frac: float = 0.1
) -> torch.Tensor:
    """Linear warmup from 0 over `warmup` steps, then a cosine from
    `peak_lr` down to ``min_frac * peak_lr`` at `total` -> a 0-d f32 CPU
    tensor.  Step 0 gives 0 at any warmup of 1 or more, as in JAX."""
    s = torch.as_tensor(step, dtype=torch.float32)
    warm = s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return peak_lr * torch.where(s < warmup, warm, cos)
