"""Decoder-only dense transformer LM (GQA, SwiGLU, RMSNorm, RoPE: qwen2,
llama3, internlm2, granite), the port of the dense part of the JAX
package's ``models/transformer.py``.

Per-layer parameters are stacked on a leading L axis under ``layers``, the
layout of the reference's ``_stack_init``, so ``convert.to_torch`` carries
the reference's parameters across unchanged; the reference's layer
``scan`` is a Python loop over that axis. Caches carry the same leading L
axis. ``cfg.remat`` is not honoured (it changes only what the reference
keeps for its backward, not a value), and the reference's ``shard`` /
``unshard_fsdp`` placements are no-ops on one device. The MoE stack
(``n_experts > 0``) and MLA (``kv_lora_rank > 0``) are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import (dense_init, embed_init, rmsnorm, rmsnorm_init,
                                       swiglu, swiglu_init)
from repro_torch.models.ssm_lm import dtype_of
from repro_torch.utils import trees


def _check(cfg) -> None:
    if cfg.n_experts:
        raise NotImplementedError(f"{cfg.name}: the MoE stack is "
                                  "not ported yet: ROADMAP.md queue 1 item 2")
    if cfg.kv_lora_rank > 0:
        raise NotImplementedError(f"{cfg.name}: MLA attention is "
                                  "not ported yet: ROADMAP.md queue 1 item 2")


def _layer_init(generator, cfg, dtype, device):
    return {
        "attn_norm": rmsnorm_init(cfg.d_model, dtype, device),
        "attn": attn.gqa_init(generator, cfg, dtype, device),
        "mlp_norm": rmsnorm_init(cfg.d_model, dtype, device),
        "mlp": swiglu_init(generator, cfg.d_model, cfg.d_ff, dtype, device),
    }


def init(generator: torch.Generator, cfg, device="cpu"):
    """Random parameters in ``cfg.param_dtype``, drawn on the generator's
    device, then moved to ``device``."""
    _check(cfg)
    dtype = dtype_of(cfg.param_dtype)
    layers = [_layer_init(generator, cfg, dtype, device) for _ in range(cfg.n_layers)]
    return {
        "embed": embed_init(generator, cfg.vocab_size, cfg.d_model, dtype, device),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, device),
        "lm_head": dense_init(generator, cfg.d_model, cfg.vocab_size, dtype,
                              scale=0.02, device=device),
        "layers": trees.tree_map(lambda *xs: torch.stack(xs), *layers),
    }


def _n_layers(params) -> int:
    return int(trees.leaves(params["layers"])[0].shape[0])


def _layer(params, i: int):
    return trees.tree_map(lambda x: x[i], params["layers"])


def _embed(params, tokens, cfg):
    return params["embed"].to(dtype_of(cfg.dtype))[tokens]


def _logits(params, h, cfg):
    h = rmsnorm(params["final_norm"], h)
    return h @ params["lm_head"].to(dtype_of(cfg.dtype))


def forward_train(params, tokens, cfg):
    """tokens (B, S) -> (logits (B, S, V) in ``cfg.dtype``, aux 0.0)."""
    h = _embed(params, tokens, cfg)
    dt = h.dtype
    for i in range(_n_layers(params)):
        p = _layer(params, i)
        h = h + attn.gqa_train(p["attn"], rmsnorm(p["attn_norm"], h), cfg)
        h = (h + swiglu(p["mlp"], rmsnorm(p["mlp_norm"], h))).to(dt)
    logits = _logits(params, h, cfg)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def prefill(params, tokens, cfg):
    """tokens (B, S) -> (last position's logits (B, V), caches
    ``{"layers": {"k", "v": (L, B, S', H_kv, hd)}}``)."""
    h = _embed(params, tokens, cfg)
    caches = []
    for i in range(_n_layers(params)):
        p = _layer(params, i)
        out, cache = attn.gqa_prefill(p["attn"], rmsnorm(p["attn_norm"], h), cfg)
        h = h + out
        h = h + swiglu(p["mlp"], rmsnorm(p["mlp_norm"], h))
        caches.append(cache)
    logits = _logits(params, h[:, -1:], cfg)[:, 0]
    return logits, {"layers": trees.tree_map(lambda *xs: torch.stack(xs), *caches)}


def decode_step(params, token, caches, pos, cfg):
    """token: (B,) integers; pos: tokens already cached, a scalar or one
    per row (B,). Returns (logits (B, V), new caches); the caches passed
    in are not modified."""
    h = _embed(params, token, cfg)[:, None, :]                       # (B,1,d)
    new = []
    for i in range(_n_layers(params)):
        p = _layer(params, i)
        cache = trees.tree_map(lambda x: x[i], caches["layers"])
        out, c = attn.gqa_decode(p["attn"], rmsnorm(p["attn_norm"], h), cache, pos, cfg)
        h = h + out
        h = h + swiglu(p["mlp"], rmsnorm(p["mlp_norm"], h))
        new.append(c)
    logits = _logits(params, h, cfg)[:, 0]
    return logits, {"layers": trees.tree_map(lambda *xs: torch.stack(xs), *new)}


def make_cache(cfg, batch: int, seq_len: int, dtype=None, device="cpu"):
    """An empty decode cache (zeros; on the ``meta`` device, shapes only):
    ``{"layers": {"k", "v": (L, batch, S, H_kv, hd)}}`` with S the
    sliding window when it is shorter than ``seq_len``."""
    _check(cfg)
    dt = dtype or dtype_of(cfg.dtype)
    S = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    shape = (cfg.n_layers, batch, S, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"layers": {"k": torch.zeros(shape, dtype=dt, device=device),
                       "v": torch.zeros(shape, dtype=dt, device=device)}}
