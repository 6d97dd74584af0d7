"""Learning-rate schedules (callables of the step count, a 0-d tensor;
each value is a float32 0-d tensor on the count's device)."""
from __future__ import annotations

import math

import torch


def _device(count):
    return count.device if torch.is_tensor(count) else None


def constant(value: float):
    return lambda count: torch.tensor(value, dtype=torch.float32, device=_device(count))


def cosine_decay(init_value: float, decay_steps: int, alpha: float = 0.0):
    def fn(count):
        count = torch.as_tensor(count)
        frac = torch.clamp(count / max(decay_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * frac))
        return init_value * ((1 - alpha) * cos + alpha)

    return fn


def warmup_cosine(peak: float, warmup_steps: int, decay_steps: int, floor: float = 0.0):
    cd = cosine_decay(peak, max(decay_steps - warmup_steps, 1), alpha=floor / max(peak, 1e-12))

    def fn(count):
        count = torch.as_tensor(count)
        warm = peak * (count + 1) / max(warmup_steps, 1)
        return torch.where(count < warmup_steps, warm, cd(count - warmup_steps))

    return fn
