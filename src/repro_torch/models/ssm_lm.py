"""Attention-free Mamba1 LM (falcon-mamba-7b family), the port of the JAX
package's ``models/ssm_lm.py``.

Parameters are a nested dict whose ``layers`` leaves carry a leading layer
axis, the layout of the reference's ``_stack_init``; the reference's layer
``scan`` is a Python loop over that axis. With ``cfg.remat`` each layer
of a training or prefill pass that takes a gradient is checkpointed
(``layers.remat``), as the reference wraps it in ``jax.checkpoint``.
"""
from __future__ import annotations

import torch

from repro_torch.models import ssm
from repro_torch.models.layers import dense_init, embed_init, remat, rmsnorm, rmsnorm_init
from repro_torch.sharding.specs import embed_rows, shard, unshard_fsdp
from repro_torch.utils import trees

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (``cfg.dtype``)."""
    return DTYPES[name]


def _layer(params, i: int):
    """Layer ``i``'s parameters: index ``i`` of every stacked leaf."""
    return trees.tree_map(lambda x: x[i], params["layers"])


def init(generator: torch.Generator, cfg, device="cpu"):
    """Random parameters in ``cfg.param_dtype``, drawn on the generator's
    device, then moved to ``device``."""
    dtype = dtype_of(cfg.param_dtype)
    layers = [{"norm": rmsnorm_init(cfg.d_model, dtype, device),
               "mixer": ssm.mamba1_init(generator, cfg, dtype, device)}
              for _ in range(cfg.n_layers)]
    return {
        "embed": embed_init(generator, cfg.vocab_size, cfg.d_model, dtype, device),
        "layers": trees.tree_map(lambda *xs: torch.stack(xs), *layers),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, device),
        "lm_head": dense_init(generator, cfg.d_model, cfg.vocab_size, dtype,
                              scale=0.02, device=device),
    }


def _n_layers(params) -> int:
    return int(trees.leaves(params["layers"])[0].shape[0])


def forward_train(params, tokens, cfg):
    """tokens (B, S) -> (logits (B, S, V) in ``cfg.dtype``, aux 0.0)."""
    dt = dtype_of(cfg.dtype)
    h = shard(embed_rows(tokens, params["embed"].to(dt)), "batch", None, None)

    def body(h, p):
        p = unshard_fsdp(p)
        return h + ssm.mamba1_train(p["mixer"], rmsnorm(p["norm"], h), cfg)

    for i in range(_n_layers(params)):
        h = remat(cfg, body, h, _layer(params, i))
    h = rmsnorm(params["final_norm"], h)
    logits = shard(h @ params["lm_head"].to(dt), "batch", None, "tp")
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def prefill(params, tokens, cfg):
    """tokens (B, S) -> (last position's logits (B, V), per-layer caches
    stacked on a leading layer axis)."""
    dt = dtype_of(cfg.dtype)
    h = shard(embed_rows(tokens, params["embed"].to(dt)), "batch", None, None)
    caches = []

    def body(h, p):
        p = unshard_fsdp(p)
        out, cache = ssm.mamba1_prefill(p["mixer"], rmsnorm(p["norm"], h), cfg)
        return h + out, cache

    for i in range(_n_layers(params)):
        h, cache = remat(cfg, body, h, _layer(params, i))
        caches.append(cache)
    h = rmsnorm(params["final_norm"], h[:, -1:])
    logits = (h @ params["lm_head"].to(dt))[:, 0]
    return logits, trees.tree_map(lambda *xs: torch.stack(xs), *caches)


def decode_step(params, token, caches, pos, cfg):
    """pos is unused for SSMs (state is position-free) but kept for API parity."""
    dt = dtype_of(cfg.dtype)
    h = embed_rows(token, params["embed"].to(dt))[:, None, :]
    new = []
    for i in range(_n_layers(params)):
        p = unshard_fsdp(_layer(params, i))
        cache = trees.tree_map(lambda x: x[i], caches)
        out, c = ssm.mamba1_decode(p["mixer"], rmsnorm(p["norm"], h), cache, cfg)
        h = h + out
        new.append(c)
    h = rmsnorm(params["final_norm"], h)
    logits = (h @ params["lm_head"].to(dt))[:, 0]
    return logits, trees.tree_map(lambda *xs: torch.stack(xs), *new)


def make_cache(cfg, batch, seq_len, dtype=None, device="cpu"):
    """SSM cache is O(1) in seq_len — the long_500k story."""
    dt = dtype or dtype_of(cfg.dtype)
    L, di, ds, W = cfg.n_layers, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {
        "h": torch.zeros((L, batch, di, ds), dtype=torch.float32, device=device),
        "conv": torch.zeros((L, batch, W - 1, di), dtype=dt, device=device),
    }
