"""State-space blocks: Mamba1 (falcon-mamba) and Mamba2 (zamba2's core),
the port of the JAX package's ``models/ssm.py``.

Mamba1's train and prefill run the selective scan over the whole
sequence: with ``cfg.use_pallas`` and no state needed (training) through
``ops.ssm_scan`` (kernel K5 on CUDA, forward and backward), otherwise
through the plain chunked scan, which also returns the final state.
Mamba2 always takes the plain chunked scan, as the reference's
``_mamba2_core`` does (``use_pallas`` has no effect on it). Decode is the
one-step recurrence against a cached state
  Mamba1: {"h": (B, d_inner, d_state) fp32, "conv": (B, conv_width-1, d_inner)}
  Mamba2: {"h": (B, n_heads, head_dim, d_state) fp32,
           "conv": (B, conv_width-1, d_inner + 2·d_state)}

Parameters keep the JAX layouts (``x @ w``, ``conv_w`` as (channels,
width)), so the reference's parameters cross over unchanged.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init
from repro_torch.sharding.specs import local_channels, shard


def _scan_y(dA, dBx, C, h0, cfg, need_state: bool):
    """y[t] = Σ_n h[t]·C[t] with h[t] = dA[t]h[t-1] + dBx[t]; returns
    ``(y, h_last)``, ``h_last`` None when the kernel ran.

    When the caller does not need the final state (training) and the
    config opts in, the scan is ``ops.ssm_scan`` (h never reaches device
    memory but every 16th step). Under an entered ``ShardCtx`` the kernel
    scans this rank's rows and channels (``sharding.local_channels``), and
    its output is a DTensor again. Otherwise the plain chunked scan runs
    and y is contracted from its states."""
    if cfg.use_pallas and not need_state and h0 is None:
        (dA, dBx, C), wrap = local_channels(dA, dBx, C)
        return wrap(ops.ssm_scan(dA, dBx, C)), None
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
    # each input unbound once (its backward is one stack), not indexed S
    # times (each index's backward fills a zero tensor of the whole input)
    dA_t, dBx_t = torch.unbind(dA, 1), torch.unbind(dBx, 1)
    h, outs = h0, []
    for t0 in range(0, S, chunk):
        a_cum, b_cum, hs = None, None, []
        for t in range(t0, min(t0 + chunk, S)):
            a, b = dA_t[t], dBx_t[t]
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
    x_in = shard(x_in, "batch", None, "tp")
    x_c, new_tail = _causal_conv(x_in, params["conv_w"].to(dt_),
                                 params["conv_b"].to(dt_), conv_tail)
    x_c = F.silu(x_c)

    # the contraction over the tp-split channels is a partial sum: placed
    # whole over tp (an all-reduce) before the small projections read it
    dbc = shard(x_c @ params["x_proj"].to(dt_), "batch", None, None)   # (B,S,dtr+2ds)
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


# ----------------------------------------------------------------- mamba2
def mamba2_init(generator: torch.Generator, cfg, dtype=torch.float32, device="cpu"):
    """Random Mamba2 parameters, drawn on the generator's device. in_proj
    emits [x (di), B (ds), C (ds) | z (di) | dt (nh)]; the decay is one
    scalar per head."""
    d, di, ds = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = di // cfg.ssm_head_dim
    W = cfg.ssm_conv
    gdev = generator.device
    conv_w = torch.randn((di + 2 * ds, W), generator=generator, device=gdev) / math.sqrt(W)

    def full(n, value):
        return torch.full((n,), value, dtype=dtype, device=device)

    return {
        "in_proj": dense_init(generator, d, 2 * di + 2 * ds + nh, dtype, device=device),
        "conv_w": conv_w.to(device=device, dtype=dtype),
        "conv_b": full(di + 2 * ds, 0.0),
        "dt_bias": full(nh, 0.0),
        "a_log": full(nh, 0.0),
        "d_skip": full(nh, 1.0),
        "norm_scale": full(di, 1.0),
        "out_proj": dense_init(generator, di, d, dtype, device=device),
    }


def _mamba2_core(params, x, cfg, h0=None, conv_tail=None):
    B, S, _ = x.shape
    di, ds = cfg.d_inner, cfg.ssm_state
    hd = cfg.ssm_head_dim
    nh = di // hd
    dt_ = x.dtype
    f32 = torch.float32
    proj = x @ params["in_proj"].to(dt_)
    xBC, z, dt_raw = torch.split(proj, [di + 2 * ds, di, nh], dim=-1)
    xBC, new_tail = _causal_conv(xBC, params["conv_w"].to(dt_), params["conv_b"].to(dt_),
                                 conv_tail)
    xBC = F.silu(xBC)
    x_in, Bc, Cc = torch.split(xBC, [di, ds, ds], dim=-1)

    pre = dt_raw.to(f32) + params["dt_bias"].to(f32)
    delta = torch.logaddexp(pre, torch.zeros_like(pre))  # softplus, as jax.nn's (B,S,nh)
    A = -torch.exp(params["a_log"].to(f32))               # (nh,)
    # one decay per head, left at (B,S,nh,1,1): the reference broadcasts it
    # to the state's full shape first; the products are the same
    dA = torch.exp(delta * A)[..., None, None]
    xh = x_in.reshape(B, S, nh, hd).to(f32)
    dBx = (delta[..., None] * xh)[..., None] * Bc.to(f32)[:, :, None, None, :]  # (B,S,nh,hd,ds)

    if h0 is None:
        h0 = torch.zeros((B, nh, hd, ds), dtype=f32, device=x.device)
    # under a mesh: rows on the client axes, heads on tp, the sequence
    # whole (DTensor may otherwise split it, which the scan's per-step
    # unbind cannot take)
    dA = shard(dA, "batch", None, "tp", None, None)
    dBx = shard(dBx, "batch", None, "tp", None, None)
    h_all, h_last = _chunked_scan(dA, dBx, h0, cfg.ssm_chunk)
    y = torch.einsum("bsnhd,bsd->bsnh", h_all, Cc.to(f32))
    y = y + params["d_skip"].to(f32)[:, None] * xh
    y = y.reshape(B, S, di)
    # gated RMSNorm (mamba2), in fp32
    y = y * F.silu(z.to(f32))
    var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-6) * params["norm_scale"].to(f32)
    return y.to(dt_) @ params["out_proj"].to(dt_), h_last, new_tail


def mamba2_train(params, x, cfg):
    out, _, _ = _mamba2_core(params, x, cfg)
    return out


def mamba2_prefill(params, x, cfg):
    out, h, tail = _mamba2_core(params, x, cfg)
    return out, {"h": h, "conv": tail}


def mamba2_decode(params, x, cache, cfg):
    """x: (B,1,d). O(1) recurrence against cached (h, conv tail); the
    tail is cast to x's dtype."""
    out, h, tail = _mamba2_core(params, x, cfg, h0=cache["h"],
                                conv_tail=cache["conv"].to(x.dtype))
    return out, {"h": h, "conv": tail}
