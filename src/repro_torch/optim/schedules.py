"""Learning-rate schedules (port of ``repro.optim.schedules``)."""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import TrainConfig


def make_schedule(cfg: TrainConfig):
    """Returns lr(step) -> float32 0-d tensor; ``step`` is a 0-d tensor."""
    def lr_fn(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        lr = torch.full_like(step, cfg.lr)
        if cfg.schedule == "cosine":
            total = max(cfg.total_steps - cfg.warmup_steps, 1)
            frac = torch.clamp((step - cfg.warmup_steps) / total, 0.0, 1.0)
            lr = lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
        if cfg.warmup_steps > 0:
            lr = lr * torch.clamp(step / cfg.warmup_steps, max=1.0)
        return lr

    return lr_fn
