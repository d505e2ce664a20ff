"""Learning-rate schedules, ported from ``repro/optim/schedule.py``."""
from __future__ import annotations

import math

import torch


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_fraction: float = 0.1):
    """Linear warmup then cosine decay to ``final_fraction * peak``; the
    schedule maps a step count (an integer tensor) to a float32 rate."""
    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).float()
        warm = peak_lr * step / max(warmup_steps, 1)
        progress = torch.clamp((step - warmup_steps)
                               / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_fraction + (1 - final_fraction)
                         * 0.5 * (1 + torch.cos(math.pi * progress)))
        return torch.where(step < warmup_steps, warm, cos)
    return schedule
