"""Model registry: the JAX package's uniform ``Model`` API over all six
arch families.

``build(cfg)`` gives ``loss_fn`` / ``forward_train`` / ``prefill`` /
``decode`` / ``make_cache`` / ``input_specs`` for ``arch_type == "dense"``
and ``"moe"`` (the transformer: qwen2, llama3, internlm2, granite;
phi3.5-moe and deepseek-v2 with MLA), ``"ssm"`` (falcon-mamba),
``"hybrid"`` (zamba2), ``"audio"`` (the whisper encoder-decoder: batches
``{"frames", "tokens"}``) and ``"vlm"`` (internvl2: ``{"patches",
"tokens"}``), with the reference's batch plumbing. ``grow_cache``,
``decode_specs`` and ``serve_cache_specs`` are the reference's cache
helpers; their shapes come from ``make_cache`` on the ``meta`` device,
which allocates nothing.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.models import encdec, hybrid, ssm_lm, transformer, vlm
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.models.layers import ce_loss
from repro_torch.models.ssm_lm import dtype_of
from repro_torch.utils import trees

_MODULES = {"dense": transformer, "moe": transformer, "ssm": ssm_lm, "hybrid": hybrid,
            "audio": encdec, "vlm": vlm}
_TOKEN_ARCHS = ("dense", "moe", "ssm", "hybrid")


class Spec(NamedTuple):
    """A tensor's shape and dtype, without its storage (the port's
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable[..., Any]                         # (generator, device) -> params
    loss_fn: Callable[[Any, Any], Any]               # (params, batch) -> loss
    forward_train: Callable[[Any, Any], Any]         # (params, batch) -> (logits, aux)
    prefill: Callable[[Any, Any], Any]               # (params, batch) -> (logits, cache)
    decode: Callable[[Any, Any, Any, Any], Any]      # (params, token, cache, pos)
    make_cache: Callable[..., Any]                   # (batch, seq_len, device) -> cache
    input_specs: Callable[[InputShape], dict]        # shape -> batch of Specs


def build(cfg: ModelConfig) -> Model:
    if cfg.arch_type not in _MODULES:
        raise ValueError(f"unknown arch_type {cfg.arch_type}")
    mod = _MODULES[cfg.arch_type]
    dt = dtype_of(cfg.dtype)

    if cfg.arch_type in _TOKEN_ARCHS:
        def forward_train(params, batch):
            return mod.forward_train(params, batch["tokens"], cfg)

        def prefill(params, batch):
            return mod.prefill(params, batch["tokens"], cfg)
    else:
        def forward_train(params, batch):
            return mod.forward_train(params, batch, cfg)

        def prefill(params, batch):
            return mod.prefill(params, batch, cfg)

    if cfg.arch_type == "vlm":
        def loss_fn(params, batch):
            return mod.loss_fn(params, batch, cfg)
    else:
        def loss_fn(params, batch):
            logits, aux = forward_train(params, batch)
            return ce_loss(logits, batch["tokens"], aux)

    def input_specs(shape: InputShape):
        B, S = shape.global_batch, shape.seq_len
        if cfg.arch_type == "audio":
            return {"frames": Spec((B, cfg.enc_seq, cfg.d_model), dt),
                    "tokens": Spec((B, S), torch.int32)}
        if cfg.arch_type == "vlm":
            return {"patches": Spec((B, cfg.n_patches, cfg.d_model), dt),
                    "tokens": Spec((B, max(S - cfg.n_patches, 8)), torch.int32)}
        return {"tokens": Spec((B, S), torch.int32)}

    def decode(params, token, cache, pos):
        return mod.decode_step(params, token, cache, pos, cfg)

    def make_cache(batch, seq_len, device="cpu"):
        return mod.make_cache(cfg, batch, seq_len, device=device)

    return Model(
        cfg=cfg,
        init=lambda generator, device="cpu": mod.init(generator, cfg, device),
        loss_fn=loss_fn,
        forward_train=forward_train,
        prefill=prefill,
        decode=decode,
        make_cache=make_cache,
        input_specs=input_specs,
    )


def _specs(tree):
    return trees.tree_map(lambda x: Spec(tuple(x.shape), x.dtype), tree)


def embed_prefix_(full: torch.Tensor, got: torch.Tensor) -> None:
    """Write ``got`` into ``full`` at the origin (each axis of ``got`` no
    longer than ``full``'s), in place, in ``full``'s dtype."""
    full[tuple(slice(0, n) for n in got.shape)].copy_(got)


def grow_cache(model: Model, cache, batch: int, seq_len: int):
    """Embed a prefill cache into a larger zero decode cache of
    ``make_cache(batch, seq_len)``'s shapes on the cache's device
    (prefix-preserving: each leaf lands at the origin)."""
    device = trees.leaves(cache)[0].device
    full = model.make_cache(batch, seq_len, device=device)
    for f, g in zip(trees.leaves(full), trees.leaves(cache)):
        embed_prefix_(f, g)
    return full


def decode_specs(model: Model, shape: InputShape):
    """Shapes and dtypes of a decode step's operands: (token, cache, pos)."""
    B = shape.global_batch
    return {"token": Spec((B,), torch.int32),
            "cache": _specs(model.make_cache(B, shape.seq_len, device="meta")),
            "pos": Spec((), torch.int32)}


def serve_cache_specs(model: Model, clusters: int, slots: int, max_len: int):
    """The serving engine's decode-state cache (``repro_torch.serve``):
    ``make_cache(slots, max_len)`` with a leading routed-cluster-group
    axis, every leaf ``(clusters,) + leaf.shape``, so cluster k's slot s
    lives at ``leaf[k, :, s]`` (the slot axis is the cache's own batch
    axis, axis 1 in every family). Shapes and dtypes only;
    ``serve.slots.alloc_slots`` allocates them."""
    base = model.make_cache(slots, max_len, device="meta")
    return trees.tree_map(lambda x: Spec((clusters,) + tuple(x.shape), x.dtype), base)
