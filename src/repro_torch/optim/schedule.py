"""Learning-rate schedules as ``step -> lr`` functions: the step is an int or
a 0-d tensor, the rate a 0-d float32 tensor on the step's device."""
from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "warmup_linear", "constant", "make_schedule"]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def _warm_and_t(step, peak_lr, warmup_steps, total_steps):
    warm = peak_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
    t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps,
                                                1), 0.0, 1.0)
    return warm, t


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(step):
        step = _f32(step)
        warm, t = _warm_and_t(step, peak_lr, warmup_steps, total_steps)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)
    return fn


def warmup_linear(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.0):
    def fn(step):
        step = _f32(step)
        warm, t = _warm_and_t(step, peak_lr, warmup_steps, total_steps)
        lin = peak_lr * (1 - (1 - final_frac) * t)
        return torch.where(step < warmup_steps, warm, lin)
    return fn


def constant(peak_lr: float):
    def fn(step):
        return torch.full((), peak_lr, dtype=torch.float32,
                          device=torch.as_tensor(step).device)
    return fn


def make_schedule(name: str, peak_lr: float, warmup_steps: int,
                  total_steps: int):
    if name == "cosine":
        return warmup_cosine(peak_lr, warmup_steps, total_steps)
    if name == "linear":
        return warmup_linear(peak_lr, warmup_steps, total_steps)
    if name == "constant":
        return constant(peak_lr)
    raise ValueError(f"unknown schedule {name!r}")
