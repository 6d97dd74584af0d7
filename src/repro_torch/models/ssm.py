"""State-space block Mamba1 (falcon-mamba), the port of the JAX package's
``models/ssm.py`` (Mamba2, zamba2's core, is not ported yet).

Train and prefill run the selective scan over the whole sequence: with
``cfg.use_pallas`` and no state needed (training) through ``ops.ssm_scan``
(kernel K5 on CUDA, forward and backward), otherwise through the plain
chunked scan, which also returns the final state. Decode is the one-step
recurrence against a cached state
  {"h": (B, d_inner, d_state) fp32, "conv": (B, conv_width-1, d_inner)}.

Parameters keep the JAX layouts (``x @ w``, ``conv_w`` as (channels,
width)), so the reference's parameters cross over unchanged.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init


def _scan_y(dA, dBx, C, h0, cfg, need_state: bool):
    """y[t] = Σ_n h[t]·C[t] with h[t] = dA[t]h[t-1] + dBx[t]; returns
    ``(y, h_last)``, ``h_last`` None when the kernel ran.

    When the caller does not need the final state (training) and the
    config opts in, the scan is ``ops.ssm_scan`` (h never reaches device
    memory but every 16th step). Otherwise the plain chunked scan runs and
    y is contracted from its states."""
    if cfg.use_pallas and not need_state and h0 is None:
        return ops.ssm_scan(dA, dBx, C), None
    if h0 is None:
        h0 = torch.zeros(dA.shape[:1] + dA.shape[2:], dtype=torch.float32,
                         device=dA.device)
    h_all, h_last = _chunked_scan(dA, dBx, h0, cfg.ssm_chunk)
    y = torch.einsum("bsdn,bsn->bsd", h_all, C.to(torch.float32))
    return y, h_last


def _causal_conv(x, conv_w, conv_b, tail=None):
    """Depthwise causal conv. x: (B,S,ch), conv_w: (ch,W), tail: (B,W-1,ch).
    Returns (out (B,S,ch), new tail)."""
    W = conv_w.shape[1]
    if tail is None:
        tail = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    xp = torch.cat([tail, x], dim=1)                      # (B,S+W-1,ch)
    out = sum(xp[:, i: i + x.shape[1]] * conv_w[:, i] for i in range(W))
    return out + conv_b, xp[:, xp.shape[1] - (W - 1):]


def _chunked_scan(dA, dBx, h0, chunk):
    """h_t = dA_t * h_{t-1} + dBx_t over axis 1 (seq), in chunks as the JAX
    package runs it: within a chunk the running products A_cum and sums
    B_cum of the combine (a, b)·(a', b') = (a·a', a'·b + b') are taken from
    the chunk's start, then h = A_cum·h_in + B_cum. JAX takes them by an
    associative scan, here step by step, so sums round differently (about
    1e-6 relative in fp32).

    dA, dBx: (B, S, ...state dims...); h0: (B, ...state dims...).
    Returns (h_all: (B,S,...), h_last)."""
    S = dA.shape[1]
    n = max(S // chunk, 1)
    chunk = S // n if S else 1
    h, outs = h0, []
    for t0 in range(0, S, chunk):
        a_cum, b_cum, hs = None, None, []
        for t in range(t0, min(t0 + chunk, S)):
            a, b = dA[:, t], dBx[:, t]
            a_cum, b_cum = (a, b) if a_cum is None else (a_cum * a, a * b_cum + b)
            hs.append(a_cum * h + b_cum)
        outs.extend(hs)
        h = hs[-1]
    if not outs:
        return dA.new_zeros(dA.shape), h0
    return torch.stack(outs, 1), h


def mamba1_init(generator: torch.Generator, cfg, dtype=torch.float32, device="cpu"):
    """Random Mamba1 parameters, drawn on the generator's device."""
    d, di, ds = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dtr, W = cfg.resolved_dt_rank, cfg.ssm_conv
    gdev = generator.device
    to = lambda x: x.to(device=device, dtype=dtype)
    A = torch.arange(1, ds + 1, dtype=torch.float32).expand(di, ds)
    dt_bias = torch.rand((di,), generator=generator, device=gdev) * (-2.3 + 4.6) - 4.6
    return {
        "in_proj": dense_init(generator, d, 2 * di, dtype, device=device),
        "conv_w": to(torch.randn((di, W), generator=generator, device=gdev) / math.sqrt(W)),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "x_proj": dense_init(generator, di, dtr + 2 * ds, dtype, device=device),
        "dt_proj": dense_init(generator, dtr, di, dtype, device=device),
        "dt_bias": to(dt_bias),
        "a_log2": to(torch.log(A)),                       # (d_inner, d_state)
        "d_skip": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": dense_init(generator, di, d, dtype, device=device),
    }


def _mamba1_core(params, x, cfg, h0=None, conv_tail=None, need_state=True):
    di, ds, dtr = cfg.d_inner, cfg.ssm_state, cfg.resolved_dt_rank
    dt_ = x.dtype
    f32 = torch.float32
    xz = x @ params["in_proj"].to(dt_)
    x_in, z = torch.split(xz, di, dim=-1)
    x_c, new_tail = _causal_conv(x_in, params["conv_w"].to(dt_),
                                 params["conv_b"].to(dt_), conv_tail)
    x_c = F.silu(x_c)

    dbc = x_c @ params["x_proj"].to(dt_)                  # (B,S,dtr+2ds)
    dt_raw, Bc, Cc = torch.split(dbc, [dtr, ds, ds], dim=-1)
    pre = dt_raw @ params["dt_proj"].to(dt_) + params["dt_bias"].to(dt_)
    delta = torch.logaddexp(pre, torch.zeros_like(pre))  # softplus, as jax.nn's
    delta = delta.to(f32)                                 # (B,S,di)
    A = -torch.exp(params["a_log2"].to(f32))              # (di,ds)
    dA = torch.exp(delta[..., None] * A)                  # (B,S,di,ds)
    dBx = (delta * x_c.to(f32))[..., None] * Bc.to(f32)[:, :, None, :]

    y, h_last = _scan_y(dA, dBx, Cc.to(f32), h0, cfg, need_state=need_state)
    y = y + params["d_skip"].to(f32) * x_c.to(f32)
    y = y.to(dt_) * F.silu(z)
    out = y @ params["out_proj"].to(dt_)
    return out, h_last, new_tail


def mamba1_train(params, x, cfg):
    out, _, _ = _mamba1_core(params, x, cfg, need_state=False)
    return out


def mamba1_prefill(params, x, cfg):
    out, h, tail = _mamba1_core(params, x, cfg)
    return out, {"h": h, "conv": tail}


def mamba1_decode(params, x, cache, cfg):
    """x: (B,1,d). O(1) recurrence against cached (h, conv tail)."""
    out, h, tail = _mamba1_core(params, x, cfg, h0=cache["h"],
                                conv_tail=cache["conv"].to(x.dtype))
    return out, {"h": h, "conv": tail}
