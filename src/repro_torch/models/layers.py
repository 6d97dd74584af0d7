"""Shared building blocks of the port's models: parameter inits, RMSNorm,
rotary embeddings and the SwiGLU MLP (``layernorm`` and ``gelu_mlp``, which
only the encoder-decoder and VLM families use, are not ported yet)."""
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


# ----------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float = 10000.0, device="cpu") -> torch.Tensor:
    """(head_dim/2,) fp32 inverse frequencies 1 / theta^(2i/head_dim). The
    base is a scalar operand (no tensor is copied from the host, so this
    runs inside a captured CUDA graph)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding in fp32, the JAX package's half-split layout.
    x: (..., seq, heads, head_dim); positions: (..., seq) integers."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)                 # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs          # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]                            # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- mlp
def swiglu_init(generator: torch.Generator, d_model: int, d_ff: int,
                dtype=torch.float32, device="cpu"):
    return {
        "w_gate": dense_init(generator, d_model, d_ff, dtype, device=device),
        "w_up": dense_init(generator, d_model, d_ff, dtype, device=device),
        "w_down": dense_init(generator, d_ff, d_model, dtype, device=device),
    }


def swiglu(params, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """silu(x·W_gate) ⊙ (x·W_up) · W_down, in ``compute_dtype`` (x's by
    default)."""
    dt = compute_dtype or x.dtype
    g = x @ params["w_gate"].to(dt)
    u = x @ params["w_up"].to(dt)
    return (torch.nn.functional.silu(g) * u) @ params["w_down"].to(dt)
