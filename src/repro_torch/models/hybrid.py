"""Zamba2-style hybrid: a Mamba2 core stack and one *shared* attention
block, the port of the JAX package's ``models/hybrid.py``.

The shared block (a single parameter set, applied after every
``cfg.attn_every`` core layers: Zamba's parameter sharing) takes
concat(embedding, hidden) at 2·d_model, projects it in, runs GQA and
SwiGLU, and adds back to the residual stream. Core layers after the last
full group (``n_layers`` not a multiple of ``attn_every``) run at the end
without an application. Its KV caches are one per application, stacked on
a leading axis A; with a sliding window they are rings of
``min(seq_len, sliding_window)`` entries. The Mamba2 caches carry the
core's leading layer axis. With ``cfg.remat`` each core layer of a
training or prefill pass that takes a gradient is checkpointed
(``layers.remat``), as the reference checkpoints its Mamba2 groups' scan
bodies; the shared block is not, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.layers import (dense_init, embed_init, remat, rmsnorm,
                                       rmsnorm_init, swiglu, swiglu_init)
from repro_torch.models.ssm_lm import dtype_of
from repro_torch.sharding.specs import embed_rows, shard, unshard_fsdp
from repro_torch.utils import trees


def _n_groups(cfg) -> int:
    """Applications of the shared block: one after each full group."""
    return cfg.n_layers // cfg.attn_every


def init(generator: torch.Generator, cfg, device="cpu"):
    """Random parameters in ``cfg.param_dtype``, drawn on the generator's
    device, then moved to ``device``."""
    dtype = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    layers = [ssm.mamba2_init(generator, cfg, dtype, device) for _ in range(cfg.n_layers)]
    return {
        "embed": embed_init(generator, cfg.vocab_size, d, dtype, device),
        "final_norm": rmsnorm_init(d, dtype, device),
        "lm_head": dense_init(generator, d, cfg.vocab_size, dtype, scale=0.02, device=device),
        "mamba_layers": trees.tree_map(lambda *xs: torch.stack(xs), *layers),
        "shared": {
            "in_proj": dense_init(generator, 2 * d, d, dtype, device=device),
            "attn_norm": rmsnorm_init(2 * d, dtype, device),
            "attn": attn.gqa_init(generator, cfg, dtype, device),
            "mlp_norm": rmsnorm_init(d, dtype, device),
            "mlp": swiglu_init(generator, d, cfg.d_ff, dtype, device),
        },
    }


def _group_slices(cfg):
    """The core layers' index ranges: one per full group, then the
    remainder (possibly empty)."""
    g, e = cfg.attn_every, _n_groups(cfg)
    return [range(i * g, (i + 1) * g) for i in range(e)], range(e * g, cfg.n_layers)


def _mamba_group(cfg, mode, h, params, layers, caches=None):
    """Run core layers ``layers`` in ``mode`` (train | prefill | decode).
    Returns (h, their caches in layer order; None in train)."""
    out_caches = []

    def train(h, p):
        return h + ssm.mamba2_train(unshard_fsdp(p), h, cfg)

    def prefill(h, p):
        out, cache = ssm.mamba2_prefill(unshard_fsdp(p), h, cfg)
        return h + out, cache

    for i in layers:
        p = trees.tree_map(lambda x: x[i], params["mamba_layers"])
        if mode == "train":
            h = remat(cfg, train, h, p)
            continue
        if mode == "prefill":
            h, cache = remat(cfg, prefill, h, p)
        else:
            out, cache = ssm.mamba2_decode(unshard_fsdp(p), h,
                                           trees.tree_map(lambda x: x[i], caches), cfg)
            h = h + out
        out_caches.append(cache)
    return h, (out_caches if mode != "train" else None)


def _shared_block(cfg, params, h, h_embed, mode, cache=None, pos=None):
    """The shared attention + MLP block. Returns (h, its new KV cache, or
    None in train)."""
    sp = unshard_fsdp(params["shared"])
    dt = h.dtype
    x2 = rmsnorm(sp["attn_norm"], torch.cat([h_embed, h], dim=-1))
    x = shard(x2 @ sp["in_proj"].to(dt), "batch", None, None)
    new_cache = None
    if mode == "train":
        a = attn.gqa_train(sp["attn"], x, cfg)
    elif mode == "prefill":
        a, new_cache = attn.gqa_prefill(sp["attn"], x, cfg)
    else:
        a, new_cache = attn.gqa_decode(sp["attn"], x, cache, pos, cfg)
    h = h + a
    h = h + swiglu(sp["mlp"], rmsnorm(sp["mlp_norm"], h))
    return h, new_cache


def _stack(caches):
    return trees.tree_map(lambda *xs: torch.stack(xs), *caches)


def forward_train(params, tokens, cfg):
    """tokens (B, S) -> (logits (B, S, V) in ``cfg.dtype``, aux 0.0)."""
    dt = dtype_of(cfg.dtype)
    h = h_embed = shard(embed_rows(tokens, params["embed"].to(dt)), "batch", None, None)
    groups, rem = _group_slices(cfg)
    for layers in groups:
        h, _ = _mamba_group(cfg, "train", h, params, layers)
        h, _ = _shared_block(cfg, params, h, h_embed, "train")
    h, _ = _mamba_group(cfg, "train", h, params, rem)
    logits = shard(rmsnorm(params["final_norm"], h) @ params["lm_head"].to(dt),
                   "batch", None, "tp")
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def prefill(params, tokens, cfg):
    """tokens (B, S) -> (last position's logits (B, V), caches
    ``{"mamba": {"h", "conv"} (L, ...), "attn": {"k", "v"} (A, ...)}``).
    With no application of the shared block the ``attn`` leaves are
    ``make_cache``'s (zero-length on axis A)."""
    dt = dtype_of(cfg.dtype)
    h = h_embed = embed_rows(tokens, params["embed"].to(dt))
    groups, rem = _group_slices(cfg)
    m_caches, a_caches = [], []
    for layers in groups:
        h, c = _mamba_group(cfg, "prefill", h, params, layers)
        m_caches += c
        h, ac = _shared_block(cfg, params, h, h_embed, "prefill")
        a_caches.append(ac)
    h, c = _mamba_group(cfg, "prefill", h, params, rem)
    m_caches += c
    if a_caches:
        attn_cache = _stack(a_caches)
    else:                      # no shared-block application (probe configs)
        attn_cache = make_cache(cfg, h.shape[0], tokens.shape[1], device=h.device)["attn"]
    logits = (rmsnorm(params["final_norm"], h[:, -1:]) @ params["lm_head"].to(dt))[:, 0]
    return logits, {"mamba": _stack(m_caches), "attn": attn_cache}


def decode_step(params, token, caches, pos, cfg):
    """token: (B,) integers; pos: tokens already cached, a scalar or one
    per row (B,), read by the shared block's attention only (the Mamba2
    state is position-free). Returns (logits (B, V), new caches); the
    caches passed in are not modified."""
    dt = dtype_of(cfg.dtype)
    h = h_embed = embed_rows(token, params["embed"].to(dt))[:, None, :]
    groups, rem = _group_slices(cfg)
    new_m, new_a = [], []
    for a, layers in enumerate(groups):
        h, c = _mamba_group(cfg, "decode", h, params, layers, caches["mamba"])
        new_m += c
        ac = trees.tree_map(lambda x: x[a], caches["attn"])
        h, nac = _shared_block(cfg, params, h, h_embed, "decode", ac, pos)
        new_a.append(nac)
    h, c = _mamba_group(cfg, "decode", h, params, rem, caches["mamba"])
    new_m += c
    attn_cache = _stack(new_a) if new_a else caches["attn"]
    logits = (rmsnorm(params["final_norm"], h) @ params["lm_head"].to(dt))[:, 0]
    return logits, {"mamba": _stack(new_m), "attn": attn_cache}


def make_cache(cfg, batch: int, seq_len: int, dtype=None, device="cpu"):
    """An empty decode cache (zeros; on the ``meta`` device, shapes only):
    the Mamba2 states ``h`` (L, batch, nh, head_dim, d_state) fp32 and conv
    tails (L, batch, W-1, d_inner + 2·d_state), and the shared block's
    ``k``/``v`` (A, batch, S, H_kv, hd) with S the sliding window when it
    is shorter than ``seq_len``."""
    dt = dtype or dtype_of(cfg.dtype)
    di, ds, hd_ssm = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    L, A = cfg.n_layers, _n_groups(cfg)
    S = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    kv = (A, batch, S, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {
        "mamba": {
            "h": torch.zeros((L, batch, di // hd_ssm, hd_ssm, ds), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((L, batch, cfg.ssm_conv - 1, di + 2 * ds), dtype=dt,
                                device=device),
        },
        "attn": {"k": torch.zeros(kv, dtype=dt, device=device),
                 "v": torch.zeros(kv, dtype=dt, device=device)},
    }
