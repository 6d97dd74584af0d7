"""Mixture-of-Experts FFN, GShard-style one-hot dispatch: the port of the
JAX package's ``models/moe.py``.

Top-k routing with a per-group capacity; dispatch and combine are one-hot
einsums, as in the reference (there they let XLA place the expert axis on
a mesh; on one device they are the same arithmetic). Supports
  - phi3.5-moe: 16 experts, top-2
  - deepseek-v2: 160 routed top-6 + 2 shared experts, expert d_ff 1536

Two points where the port takes care to give the reference's values:
  - ``jax.lax.top_k`` puts the lower expert index first among equal gates;
    ``torch.topk`` promises no order, so the choice is a stable descending
    sort (equal gates keep their index order).
  - One-hots are comparisons against ``torch.arange`` (``F.one_hot``
    cannot run under ``torch.func.vmap``, which both the cohort update and
    the serving decode put around this layer), and the capacity comes
    from static shapes only, so a decode step stays capturable.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import dense_init, swiglu, swiglu_init
from repro_torch.sharding.specs import local_experts, shard


def moe_init(generator: torch.Generator, cfg, dtype=torch.float32, device="cpu"):
    """Random router, expert and (deepseek) shared-expert weights, drawn
    on the generator's device, then moved to ``device``."""
    E, d = cfg.n_experts, cfg.d_model
    ff = cfg.moe_d_ff or cfg.d_ff
    gdev = generator.device

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=gdev) / math.sqrt(fan_in)
        return w.to(device=device, dtype=dtype)

    params = {
        "router": {"w": dense_init(generator, d, E, dtype, scale=0.02, device=device)},
        "experts": {
            "w_gate": normal((E, d, ff), d),
            "w_up": normal((E, d, ff), d),
            "w_down": normal((E, ff, d), ff),
        },
    }
    if cfg.n_shared_experts:
        params["shared"] = swiglu_init(generator, d, ff * cfg.n_shared_experts, dtype, device)
    return params


def group_tokens(tokens: int, group_size: int) -> int:
    """The dispatch group size for ``tokens`` tokens: the largest divisor
    of ``tokens`` not above ``group_size``."""
    g = min(group_size, tokens)
    while tokens % g:
        g -= 1
    return g


def _group(x, group_size: int):
    """(B,S,d) -> (G,g,d) with g | B*S."""
    B, S, d = x.shape
    g = group_tokens(B * S, group_size)
    return x.reshape(B * S // g, g, d), (B, S)


def capacity(cfg, g: int) -> int:
    """Each expert's buffer in a group of ``g`` tokens: k·g/E times the
    capacity factor, at least 1, rounded up to a multiple of 4 from 4 on."""
    cap = max(int(cfg.moe_top_k * g / cfg.n_experts * cfg.capacity_factor), 1)
    return -(-cap // 4) * 4 if cap >= 4 else cap


def _one_hot(idx, n: int, dtype):
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def route(params, xg, cfg):
    """The router on grouped tokens xg (G,g,d): returns (top-k gates
    renormalised (G,g,k) fp32, their experts (G,g,k), each choice's
    position in its expert's buffer (G,g,k), the Switch aux loss)."""
    E, k = cfg.n_experts, cfg.moe_top_k
    G, g, _ = xg.shape
    logits = (xg @ params["router"]["w"].to(xg.dtype)).to(torch.float32)   # (G,g,E)
    gates = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_vals, top_idx = vals[..., :k], idx[..., :k]                         # (G,g,k)
    top_vals = top_vals / (torch.sum(top_vals, dim=-1, keepdim=True) + 1e-9)

    # load-balance auxiliary loss (Switch/GShard form) on the first choice
    me = torch.mean(gates, dim=1)                                          # (G,E)
    ce = torch.mean(_one_hot(top_idx[..., 0], E, torch.float32), dim=1)    # (G,E)
    aux = torch.mean(torch.sum(me * ce, dim=-1)) * E

    # position of each (token, choice) within its expert's buffer, slot-major:
    # a count over the whole group, so the choices are placed whole first
    # (the group's tokens may be split over the client axes)
    flat = _one_hot(shard(top_idx, None, None, None), E, torch.int32)
    flat = flat.transpose(1, 2).reshape(G, k * g, E)
    before = torch.cumsum(flat, dim=1) - flat                              # (G,k*g,E)
    pos = torch.sum(flat * before, dim=-1)                                 # (G,k*g)
    pos = pos.reshape(G, k, g).transpose(1, 2)                             # (G,g,k)
    return top_vals, top_idx, pos, aux


def moe_ffn(params, x, cfg, group_size: int = 0):
    """Returns (out, aux). x: (B,S,d). ``group_size`` (default
    ``cfg.moe_group_size``) sets the dispatch granularity: the capacity
    scales with a group's tokens, and a choice past its expert's capacity
    within its group is dropped (its token gets nothing from that
    expert)."""
    dt = x.dtype
    E = cfg.n_experts
    xg, (B, S) = _group(x, group_size or cfg.moe_group_size)
    g, d = xg.shape[1], xg.shape[2]
    cap = capacity(cfg, g)
    top_vals, top_idx, pos, aux = route(params, xg, cfg)
    keep = (pos < cap).to(dt)

    cap_onehot = _one_hot(pos, cap, dt) * keep[..., None]                  # (G,g,k,c)
    exp_onehot = _one_hot(top_idx, E, dt)                                  # (G,g,k,E)
    dispatch = torch.einsum("gske,gskc->gsec", exp_onehot, cap_onehot)     # (G,g,E,c)
    combine = torch.einsum("gsk,gske,gskc->gsec", top_vals.to(dt), exp_onehot, cap_onehot)

    expert_in = torch.einsum("gsec,gsd->egcd", dispatch, xg)               # (E,G,c,d)
    expert_in = shard(expert_in, "expert", None, None, None)
    w = params["experts"]
    h = torch.nn.functional.silu(torch.einsum("egcd,edf->egcf", expert_in, w["w_gate"].to(dt)))
    h = h * torch.einsum("egcd,edf->egcf", expert_in, w["w_up"].to(dt))
    expert_out = torch.einsum("egcf,efd->egcd", h, w["w_down"].to(dt))     # (E,G,c,d)
    expert_out = shard(expert_out, "expert", None, None, None)

    (combine, expert_out), wrap = local_experts(combine, expert_out)
    out = wrap(torch.einsum("gsec,egcd->gsd", combine, expert_out)).reshape(B, S, d)
    if "shared" in params:
        out = out + swiglu(params["shared"], x)
    return out, aux


def dropped(params, x, cfg, group_size: int = 0) -> int:
    """How many (token, choice) assignments ``moe_ffn`` drops on x at this
    group size (a host count, for tests and reports)."""
    xg, _ = _group(x, group_size or cfg.moe_group_size)
    _, _, pos, _ = route(params, xg, cfg)
    return int((pos >= capacity(cfg, xg.shape[1])).sum())
