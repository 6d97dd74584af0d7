"""VLM backbone (InternVL2-style): a vision prefix and a decoder-only LM,
the port of the JAX package's ``models/vlm.py``.

The InternViT vision encoder is stubbed, as in the reference: inputs are
precomputed patch embeddings (B, n_patches, d_model). The patch projector
(``patch_proj``, one d_model × d_model matrix) and the language backbone
(the transformer's stack, ``transformer.apply_stack_train`` /
``apply_stack_prefill``) are real. Logits and the loss are for the text
positions only; decoding is the transformer's, over the cache the prefill
of the whole (patches + text) sequence leaves.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as tf
from repro_torch.models.layers import ce_loss, dense_init, rmsnorm
from repro_torch.models.ssm_lm import dtype_of
from repro_torch.sharding.specs import embed_rows, shard


def init(generator: torch.Generator, cfg, device="cpu"):
    """The transformer's parameters plus ``patch_proj``, in
    ``cfg.param_dtype``."""
    params = tf.init(generator, cfg, device)
    params["patch_proj"] = dense_init(generator, cfg.d_model, cfg.d_model,
                                      dtype_of(cfg.param_dtype), device=device)
    return params


def _assemble(params, batch, cfg):
    """The projected patches followed by the text embeddings: (B, P + S,
    d) in ``cfg.dtype``."""
    dt = dtype_of(cfg.dtype)
    patches = batch["patches"].to(dt) @ params["patch_proj"].to(dt)
    text = embed_rows(batch["tokens"], params["embed"].to(dt))
    return shard(torch.cat([patches, text], dim=1), "batch", None, None)


def forward_train(params, batch, cfg):
    """batch ``{"patches": (B, P, d), "tokens": (B, S_text)}`` -> (text
    logits (B, S_text, V) in ``cfg.dtype``, the MoE aux loss)."""
    P = batch["patches"].shape[1]
    h, aux = tf.apply_stack_train(params, _assemble(params, batch, cfg), cfg)
    h = rmsnorm(params["final_norm"], h[:, P:])
    return shard(h @ params["lm_head"].to(dtype_of(cfg.dtype)), "batch", None, "tp"), aux


def loss_fn(params, batch, cfg):
    """Next-token cross entropy over the text positions plus 0.01·aux."""
    logits, aux = forward_train(params, batch, cfg)
    return ce_loss(logits, batch["tokens"], aux)


def prefill(params, batch, cfg):
    """batch as ``forward_train``'s -> (last position's logits (B, V), the
    transformer's caches over all P + S_text positions)."""
    h, caches = tf.apply_stack_prefill(params, _assemble(params, batch, cfg), cfg)
    h = rmsnorm(params["final_norm"], h[:, -1:])
    return (h @ params["lm_head"].to(dtype_of(cfg.dtype)))[:, 0], caches


decode_step = tf.decode_step
make_cache = tf.make_cache
