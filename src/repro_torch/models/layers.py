"""Shared building blocks of the port's models: parameter inits."""
from __future__ import annotations

import math
from typing import Optional

import torch


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale: Optional[float] = None,
               device="cpu") -> torch.Tensor:
    """(d_in, d_out) normal weights scaled by 1/sqrt(d_in) (the JAX
    package's ``dense_init`` layout: ``x @ w``). Drawn on the generator's
    device, then moved to ``device``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator,
                    device=generator.device) * scale
    return w.to(device=device, dtype=dtype)
