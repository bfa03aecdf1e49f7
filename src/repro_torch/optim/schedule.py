"""Learning-rate schedules, callable on the step count (a 0-d tensor).

Port of the reference's ``optim/schedule.py``.
"""
from __future__ import annotations

import math

import torch


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.1):
    def sched(count: torch.Tensor) -> torch.Tensor:
        c = count.to(torch.float32)
        warm = peak * c / max(warmup, 1)
        prog = torch.clamp((c - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5
                      * (1 + torch.cos(math.pi * prog)))
        return torch.where(c < warmup, warm, cos)
    return sched


def constant(lr: float):
    def sched(count: torch.Tensor) -> torch.Tensor:
        return torch.tensor(lr, dtype=torch.float32, device=count.device)
    return sched
