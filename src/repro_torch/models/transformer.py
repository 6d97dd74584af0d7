"""Decoder-only transformer LM: the dense GQA stack (qwen2, llama3,
internlm2, granite) and the MoE stack with GQA (phi3.5-moe) or MLA
attention (deepseek-v2), the port of the JAX package's
``models/transformer.py``.

Per-layer parameters are stacked on a leading L axis, the layout of the
reference's ``_stack_init``, so ``convert.to_torch`` carries the
reference's parameters across unchanged: ``layers`` holds the dense
layers (all of them, or the first ``moe_layer_start`` of an MoE model)
and ``moe_layers`` the MoE layers. The reference's layer ``scan`` is a
Python loop over that axis, and caches carry the same leading axis under
the same two names. With ``cfg.remat`` each layer of a training or prefill
pass that takes a gradient is checkpointed (``layers.remat``), as the
reference wraps it in ``jax.checkpoint``. Each layer body starts with
``unshard_fsdp`` of its parameters and hidden states are placed with
``shard``, at the reference's sites; both are no-ops without an entered
``ShardCtx`` (``launch.steps`` enters one).

MoE routing groups: training and prefill group the batch's B·S tokens by
``cfg.moe_group_size`` (``moe.moe_ffn``), as the reference does. A decode
with one position per row routes each row as its own group of 1, which is
what the reference's serving decode (a ``vmap`` of a batch-1 decode over
its slots) does; a decode with one scalar position groups all B rows, as
the reference's ``decode_step`` does.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (dense_init, embed_init, remat, rmsnorm,
                                       rmsnorm_init, swiglu, swiglu_init)
from repro_torch.models.ssm_lm import dtype_of
from repro_torch.sharding.specs import embed_rows, shard, unshard_fsdp
from repro_torch.utils import trees

STACKS = (("layers", False), ("moe_layers", True))


def _is_mla(cfg) -> bool:
    return cfg.kv_lora_rank > 0


def _depths(cfg):
    """(dense layers, MoE layers) of a config."""
    n_dense = cfg.moe_layer_start if cfg.n_experts else cfg.n_layers
    return n_dense, cfg.n_layers - n_dense


def _layer_init(generator, cfg, moe: bool, dtype, device):
    attn_init = attn.mla_init if _is_mla(cfg) else attn.gqa_init
    mlp = (moe_mod.moe_init(generator, cfg, dtype, device) if moe
           else swiglu_init(generator, cfg.d_model, cfg.d_ff, dtype, device))
    return {
        "attn_norm": rmsnorm_init(cfg.d_model, dtype, device),
        "attn": attn_init(generator, cfg, dtype, device),
        "mlp_norm": rmsnorm_init(cfg.d_model, dtype, device),
        "mlp": mlp,
    }


def init(generator: torch.Generator, cfg, device="cpu"):
    """Random parameters in ``cfg.param_dtype``, drawn on the generator's
    device, then moved to ``device``."""
    dtype = dtype_of(cfg.param_dtype)
    params = {
        "embed": embed_init(generator, cfg.vocab_size, cfg.d_model, dtype, device),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, device),
        "lm_head": dense_init(generator, cfg.d_model, cfg.vocab_size, dtype,
                              scale=0.02, device=device),
    }
    for (name, moe), n in zip(STACKS, _depths(cfg)):
        if n:
            layers = [_layer_init(generator, cfg, moe, dtype, device) for _ in range(n)]
            params[name] = trees.tree_map(lambda *xs: torch.stack(xs), *layers)
    return params


def _stacks(params):
    """(name, is_moe, depth) of each layer stack ``params`` holds, in
    the order they run."""
    return [(name, moe, int(trees.leaves(params[name])[0].shape[0]))
            for name, moe in STACKS if name in params]


def _embed(params, tokens, cfg):
    """The rows of ``tokens`` (``sharding.embed_rows``: an index, shard
    by shard over a vocab-sharded table)."""
    return embed_rows(tokens, params["embed"].to(dtype_of(cfg.dtype)))


def _logits(params, h, cfg):
    h = rmsnorm(params["final_norm"], h)
    return h @ params["lm_head"].to(dtype_of(cfg.dtype))


def _mlp(p, x, cfg, moe: bool, group_size: int = 0):
    """(out, aux) of a layer's MLP: SwiGLU, or the MoE FFN."""
    if moe:
        return moe_mod.moe_ffn(p["mlp"], x, cfg, group_size)
    return swiglu(p["mlp"], x), None


def _layer(stack, i: int):
    """Layer ``i``'s parameters: index ``i`` of every stacked leaf."""
    return trees.tree_map(lambda x: x[i], stack)


def _layer_train(cfg, moe: bool, h, p):
    """One layer of a training pass: h, or (h, aux) for an MoE layer."""
    p = unshard_fsdp(p)
    dt = h.dtype
    train = attn.mla_train if _is_mla(cfg) else attn.gqa_train
    h = h + train(p["attn"], rmsnorm(p["attn_norm"], h), cfg)
    out, a = _mlp(p, rmsnorm(p["mlp_norm"], h), cfg, moe)
    h = shard(h + out, "batch", None, None).to(dt)
    return (h, a) if moe else h


def apply_stack_train(params, h, cfg):
    """Run the layer stack(s) on hidden states h (B, S, d) in training
    mode. Returns (h, the MoE aux loss summed over the MoE layers, 0.0
    without)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for name, moe, n in _stacks(params):
        body = functools.partial(_layer_train, cfg, moe)
        for i in range(n):
            out = remat(cfg, body, h, _layer(params[name], i))
            if moe:
                h, a = out
                aux = aux + a
            else:
                h = out
    return h, aux


def _layer_prefill(cfg, moe: bool, h, p):
    """One layer of a prefill pass: (h, its cache)."""
    p = unshard_fsdp(p)
    pre = attn.mla_prefill if _is_mla(cfg) else attn.gqa_prefill
    out, cache = pre(p["attn"], rmsnorm(p["attn_norm"], h), cfg)
    h = h + out
    return shard(h + _mlp(p, rmsnorm(p["mlp_norm"], h), cfg, moe)[0], "batch", None, None), cache


def apply_stack_prefill(params, h, cfg):
    """Run the layer stack(s) on hidden states h (B, S, d) in prefill
    mode. Returns (h, caches: for each stack, GQA's ``{"k", "v": (L, B,
    S', H_kv, hd)}`` or MLA's ``{"c_kv": (L, B, S', r), "k_rope": (L, B,
    S', rope_dim)}``)."""
    caches = {}
    for name, moe, n in _stacks(params):
        body = functools.partial(_layer_prefill, cfg, moe)
        stack = []
        for i in range(n):
            h, cache = remat(cfg, body, h, _layer(params[name], i))
            stack.append(cache)
        caches[name] = trees.tree_map(lambda *xs: torch.stack(xs), *stack)
    return h, caches


def forward_train(params, tokens, cfg):
    """tokens (B, S) -> (logits (B, S, V) in ``cfg.dtype``, the MoE aux
    loss summed over the MoE layers (0.0 without))."""
    h = shard(_embed(params, tokens, cfg), "batch", None, None)
    h, aux = apply_stack_train(params, h, cfg)
    return shard(_logits(params, h, cfg), "batch", None, "tp"), aux


def prefill(params, tokens, cfg):
    """tokens (B, S) -> (last position's logits (B, V), the caches of
    ``apply_stack_prefill``)."""
    h = shard(_embed(params, tokens, cfg), "batch", None, None)
    h, caches = apply_stack_prefill(params, h, cfg)
    return _logits(params, h[:, -1:], cfg)[:, 0], caches


def decode_step(params, token, caches, pos, cfg):
    """token: (B,) integers; pos: tokens already cached, a scalar or one
    per row (B,). Returns (logits (B, V), new caches); the caches passed
    in are not modified. With one position per row each row's MoE
    routing is a group of its own."""
    h = _embed(params, token, cfg)[:, None, :]                       # (B,1,d)
    dec = attn.mla_decode if _is_mla(cfg) else attn.gqa_decode
    per_row = isinstance(pos, torch.Tensor) and pos.dim() > 0
    new = {}
    for name, moe, n in _stacks(params):
        stack = []
        for i in range(n):
            p = unshard_fsdp(_layer(params[name], i))
            cache = _layer(caches[name], i)
            out, c = dec(p["attn"], rmsnorm(p["attn_norm"], h), cache, pos, cfg)
            h = h + out
            h = h + _mlp(p, rmsnorm(p["mlp_norm"], h), cfg, moe, 1 if per_row else 0)[0]
            stack.append(c)
        new[name] = trees.tree_map(lambda *xs: torch.stack(xs), *stack)
    logits = _logits(params, h, cfg)[:, 0]
    return logits, new


def make_cache(cfg, batch: int, seq_len: int, dtype=None, device="cpu"):
    """An empty decode cache (zeros; on the ``meta`` device, shapes only),
    one entry per layer stack, with S the sliding window when it is
    shorter than ``seq_len``: GQA ``{"k", "v": (L, batch, S, H_kv, hd)}``,
    MLA ``{"c_kv": (L, batch, S, r), "k_rope": (L, batch, S, rope_dim)}``."""
    dt = dtype or dtype_of(cfg.dtype)
    S = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    if _is_mla(cfg):
        shapes = {"c_kv": (batch, S, cfg.kv_lora_rank), "k_rope": (batch, S, cfg.qk_rope_dim)}
    else:
        kv = (batch, S, cfg.n_kv_heads, cfg.resolved_head_dim)
        shapes = {"k": kv, "v": kv}
    return {name: {k: torch.zeros((n,) + s, dtype=dt, device=device)
                   for k, s in shapes.items()}
            for (name, _), n in zip(STACKS, _depths(cfg)) if n}
