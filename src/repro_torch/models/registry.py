"""Model registry: the JAX package's uniform ``Model`` API over the arch
families the port has.

``build(cfg)`` gives ``loss_fn`` / ``forward_train`` / ``prefill`` /
``decode`` / ``make_cache`` for ``arch_type == "ssm"`` (falcon-mamba).
The other families raise ``NotImplementedError`` naming the ROADMAP.md
item that ports them.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.models import ssm_lm
from repro_torch.models.config import ModelConfig

_NOT_PORTED = {
    "dense": "queue 1 item 15 (transformer)",
    "moe": "queue 1 item 15 (transformer, moe)",
    "hybrid": "queue 1 item 15 (hybrid: zamba2, Mamba2)",
    "audio": "queue 1 item 15 (encdec)",
    "vlm": "queue 1 item 15 (vlm)",
}


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable[..., Any]                         # (generator, device) -> params
    loss_fn: Callable[[Any, Any], Any]               # (params, batch) -> loss
    forward_train: Callable[[Any, Any], Any]         # (params, batch) -> (logits, aux)
    prefill: Callable[[Any, Any], Any]               # (params, batch) -> (logits, cache)
    decode: Callable[[Any, Any, Any, Any], Any]      # (params, token, cache, pos)
    make_cache: Callable[..., Any]                   # (batch, seq_len, device) -> cache


def _ce_loss(logits, tokens, aux):
    """Mean next-token cross entropy in fp32 plus 0.01·aux. The gold logit
    is gathered; the reference contracts with a one-hot, which picks the
    same value exactly (one term times 1, the rest times 0)."""
    logits = logits[:, :-1].to(torch.float32)
    targets = tokens[:, 1:].to(torch.int64)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    return torch.mean(logz - gold) + 0.01 * aux


def build(cfg: ModelConfig) -> Model:
    if cfg.arch_type in _NOT_PORTED:
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r} ({cfg.name}) is not ported yet: "
            f"ROADMAP.md {_NOT_PORTED[cfg.arch_type]}")
    if cfg.arch_type != "ssm":
        raise ValueError(f"unknown arch_type {cfg.arch_type}")
    if cfg.ssm_version != 1:
        raise NotImplementedError("Mamba2 is not ported yet: ROADMAP.md queue 1 "
                                  "item 15 (hybrid: zamba2, Mamba2)")
    mod = ssm_lm

    def forward_train(params, batch):
        return mod.forward_train(params, batch["tokens"], cfg)

    def loss_fn(params, batch):
        logits, aux = forward_train(params, batch)
        return _ce_loss(logits, batch["tokens"], aux)

    def prefill(params, batch):
        return mod.prefill(params, batch["tokens"], cfg)

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
    )
