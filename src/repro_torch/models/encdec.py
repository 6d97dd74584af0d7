"""Whisper-style encoder-decoder backbone (whisper-medium), the port of the
JAX package's ``models/encdec.py``.

The mel-spectrogram and convolutional frontend is stubbed, as in the
reference: inputs are precomputed frame embeddings (B, enc_seq, d_model),
cast to ``cfg.dtype``. The encoder is pre-LayerNorm bidirectional GQA
self-attention and a GELU MLP; each decoder layer adds cross-attention
over the encoder output between its causal self-attention (with RoPE,
the reference's deviation from whisper's learned positions) and its MLP.

Per-layer parameters are stacked on a leading L axis (``enc_layers``,
``dec_layers``), the layout of the reference's ``_stack_init``; its layer
``scan`` is a Python loop over that axis. The decoder's cross keys and
values are computed once per layer from the encoder output and stacked
(L, B, Se, H_kv, hd). Caches are ``{"self": {"k", "v"}, "cross": {"k",
"v"}}``. With ``cfg.remat`` each encoder layer and each decoder layer of a
training or prefill pass that takes a gradient is checkpointed
(``layers.remat``), where the reference applies ``jax.checkpoint``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import (dense_init, embed_init, gelu_mlp, gelu_mlp_init,
                                       layernorm, layernorm_init, remat)
from repro_torch.models.ssm_lm import dtype_of
from repro_torch.sharding.specs import embed_rows, shard, unshard_fsdp
from repro_torch.utils import trees


def _stacked(make, n: int):
    return trees.tree_map(lambda *xs: torch.stack(xs), *[make() for _ in range(n)])


def _enc_layer_init(generator, cfg, dtype, device):
    return {
        "attn_norm": layernorm_init(cfg.d_model, dtype, device),
        "attn": attn.gqa_init(generator, cfg, dtype, device),
        "mlp_norm": layernorm_init(cfg.d_model, dtype, device),
        "mlp": gelu_mlp_init(generator, cfg.d_model, cfg.d_ff, dtype, device),
    }


def _dec_layer_init(generator, cfg, dtype, device):
    return {
        "attn_norm": layernorm_init(cfg.d_model, dtype, device),
        "attn": attn.gqa_init(generator, cfg, dtype, device),
        "cross_norm": layernorm_init(cfg.d_model, dtype, device),
        "cross": attn.cross_attn_init(generator, cfg, dtype, device),
        "mlp_norm": layernorm_init(cfg.d_model, dtype, device),
        "mlp": gelu_mlp_init(generator, cfg.d_model, cfg.d_ff, dtype, device),
    }


def init(generator: torch.Generator, cfg, device="cpu"):
    """Random parameters in ``cfg.param_dtype``, drawn on the generator's
    device, then moved to ``device``."""
    dtype = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    return {
        "embed": embed_init(generator, cfg.vocab_size, d, dtype, device),
        "enc_layers": _stacked(lambda: _enc_layer_init(generator, cfg, dtype, device),
                               cfg.n_enc_layers),
        "enc_norm": layernorm_init(d, dtype, device),
        "dec_layers": _stacked(lambda: _dec_layer_init(generator, cfg, dtype, device),
                               cfg.n_layers),
        "dec_norm": layernorm_init(d, dtype, device),
        "lm_head": dense_init(generator, d, cfg.vocab_size, dtype, scale=0.02, device=device),
    }


def _layer(stack, i: int):
    return trees.tree_map(lambda x: x[i], stack)


def _n(stack) -> int:
    return int(trees.leaves(stack)[0].shape[0])


def _enc_body(cfg, h, p):
    p = unshard_fsdp(p)
    h = h + attn.bidir_attention(p["attn"], layernorm(p["attn_norm"], h), cfg)
    # under a mesh the residual by rows only: DTensor may split the 1,500
    # encoder positions unevenly, and its product then views a padded shard
    h = shard(h, "batch", None, None)
    return h + gelu_mlp(p["mlp"], layernorm(p["mlp_norm"], h))


def encode(params, frames, cfg):
    """frames (B, enc_seq, d_model) stub embeddings -> the encoder output
    in ``cfg.dtype``."""
    h = shard(frames.to(dtype_of(cfg.dtype)), "batch", None, None)
    body = functools.partial(_enc_body, cfg)
    for i in range(_n(params["enc_layers"])):
        h = remat(cfg, body, h, _layer(params["enc_layers"], i))
    return layernorm(params["enc_norm"], h)


def _dec_body(cfg, mode, h, p, ckv, cache=None, pos=None):
    """One decoder layer. train: h; prefill: (h, its self-attention
    cache); decode (one new position, ``cache`` and ``pos`` given): (h,
    the new cache)."""
    p = unshard_fsdp(p)
    a_in = layernorm(p["attn_norm"], h)
    new_cache = None
    if mode == "train":
        h = h + attn.gqa_train(p["attn"], a_in, cfg)
    elif mode == "prefill":
        a_out, new_cache = attn.gqa_prefill(p["attn"], a_in, cfg)
        h = h + a_out
    else:
        a_out, new_cache = attn.gqa_decode(p["attn"], a_in, cache, pos, cfg)
        h = h + a_out
    h = h + attn.cross_attend(p["cross"], layernorm(p["cross_norm"], h), ckv, cfg)
    h = h + gelu_mlp(p["mlp"], layernorm(p["mlp_norm"], h))
    return h if mode == "train" else (h, new_cache)


def _cross_kvs(params, enc_out, cfg):
    """Every decoder layer's cross keys and values: ``{"k", "v": (L, B,
    Se, H_kv, hd)}``."""
    stack = params["dec_layers"]
    kvs = [attn.cross_kv(_layer(stack, i)["cross"], enc_out, cfg) for i in range(_n(stack))]
    return trees.tree_map(lambda *xs: torch.stack(xs), *kvs)


def _embed(params, tokens, cfg):
    return embed_rows(tokens, params["embed"].to(dtype_of(cfg.dtype)))


def _logits(params, h, cfg):
    return layernorm(params["dec_norm"], h) @ params["lm_head"].to(dtype_of(cfg.dtype))


def forward_train(params, batch, cfg):
    """batch ``{"frames": (B, Se, d), "tokens": (B, S)}`` -> (logits (B,
    S, V) in ``cfg.dtype``, aux 0.0)."""
    ckvs = _cross_kvs(params, encode(params, batch["frames"], cfg), cfg)
    h = _embed(params, batch["tokens"], cfg)
    body = functools.partial(_dec_body, cfg, "train")
    for i in range(_n(params["dec_layers"])):
        h = remat(cfg, body, h, _layer(params["dec_layers"], i), _layer(ckvs, i))
    logits = shard(_logits(params, h, cfg), "batch", None, "tp")
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def prefill(params, batch, cfg):
    """batch as ``forward_train``'s -> (last position's logits (B, V),
    caches ``{"self": {"k", "v": (L, B, S, H_kv, hd)}, "cross": {"k",
    "v": (L, B, Se, H_kv, hd)}}``)."""
    ckvs = _cross_kvs(params, encode(params, batch["frames"], cfg), cfg)
    h = _embed(params, batch["tokens"], cfg)
    body = functools.partial(_dec_body, cfg, "prefill")
    stack = []
    for i in range(_n(params["dec_layers"])):
        h, cache = remat(cfg, body, h, _layer(params["dec_layers"], i), _layer(ckvs, i))
        stack.append(cache)
    self_cache = trees.tree_map(lambda *xs: torch.stack(xs), *stack)
    return _logits(params, h[:, -1:], cfg)[:, 0], {"self": self_cache, "cross": ckvs}


def decode_step(params, token, caches, pos, cfg):
    """token: (B,) integers; pos: tokens already cached, a scalar or one
    per row (B,). Returns (logits (B, V), new caches; the cross keys and
    values are carried over); the caches passed in are not modified."""
    h = _embed(params, token, cfg)[:, None, :]
    new = []
    for i in range(_n(params["dec_layers"])):
        h, c = _dec_body(cfg, "decode", h, _layer(params["dec_layers"], i),
                         _layer(caches["cross"], i), _layer(caches["self"], i), pos)
        new.append(c)
    self_cache = trees.tree_map(lambda *xs: torch.stack(xs), *new)
    return _logits(params, h, cfg)[:, 0], {"self": self_cache, "cross": caches["cross"]}


def make_cache(cfg, batch: int, seq_len: int, dtype=None, device="cpu"):
    """An empty decode cache (zeros; on the ``meta`` device, shapes only):
    ``self`` (L, batch, seq_len, H_kv, hd) and ``cross`` (L, batch,
    enc_seq, H_kv, hd) keys and values."""
    dt = dtype or dtype_of(cfg.dtype)
    hd, L = cfg.resolved_head_dim, cfg.n_layers
    zeros = lambda S: torch.zeros((L, batch, S, cfg.n_kv_heads, hd), dtype=dt, device=device)
    return {"self": {"k": zeros(seq_len), "v": zeros(seq_len)},
            "cross": {"k": zeros(cfg.enc_seq), "v": zeros(cfg.enc_seq)}}
