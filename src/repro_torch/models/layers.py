"""Shared building blocks of the port's models: parameter inits and RMSNorm."""
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


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype=torch.float32, device="cpu") -> torch.Tensor:
    """(vocab, d) normal embedding rows scaled by 0.02."""
    w = torch.randn((vocab, d), generator=generator, device=generator.device) * 0.02
    return w.to(device=device, dtype=dtype)


def rmsnorm_init(d: int, dtype=torch.float32, device="cpu"):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS normalisation in fp32, cast back to ``x``'s dtype, then scaled
    in that dtype (the JAX package's order of roundings)."""
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * params["scale"].to(x.dtype)
