"""The paper's own task models: MLP (MNIST), CNN (CIFAR10), CNN (FEMNIST).

The port of the JAX package's ``models/simple.py``. Parameters are plain
dicts of tensors in the JAX layouts (``x @ w`` with ``w`` shaped
``(d_in, d_out)``; NHWC activations and HWIO convolution kernels, the
flatten before ``fc1_w`` in (H, W, C) order), so the reference's
parameters cross over through ``repro_torch.convert`` unchanged.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    name: str
    kind: str            # mlp | cnn
    input_shape: tuple   # e.g. (784,) or (32,32,3)
    n_classes: int = 10
    hidden: int = 2048
    conv_channels: tuple = (32, 64)
    fc_hidden: int = 128


MNIST_MLP = TaskConfig("mnist_mlp", "mlp", (784,), 10, hidden=2048)
CIFAR_CNN = TaskConfig("cifar_cnn", "cnn", (32, 32, 3), 10)
FEMNIST_CNN = TaskConfig("femnist_cnn", "cnn", (28, 28, 1), 62)
SYNTH_MLP = TaskConfig("synth_mlp", "mlp", (64,), 10, hidden=256)


def init(generator: torch.Generator, cfg: TaskConfig, device="cpu"):
    """Random parameters drawn from ``generator`` (the JAX package draws
    with ``jax.random``; the two give different numbers for one seed)."""
    zeros = lambda n: torch.zeros((n,), dtype=torch.float32, device=device)
    if cfg.kind == "mlp":
        d_in = math.prod(cfg.input_shape)
        return {
            "w1": dense_init(generator, d_in, cfg.hidden, device=device),
            "b1": zeros(cfg.hidden),
            "w2": dense_init(generator, cfg.hidden, cfg.n_classes, device=device),
            "b2": zeros(cfg.n_classes),
        }
    c1, c2 = cfg.conv_channels
    in_ch = cfg.input_shape[-1]
    h, w = cfg.input_shape[0] // 4, cfg.input_shape[1] // 4   # two 2x2 maxpools
    flat = h * w * c2

    def conv(cin, cout):
        k = torch.randn((3, 3, cin, cout), generator=generator,
                        device=generator.device) * math.sqrt(2.0 / (9 * cin))
        return k.to(device)

    return {
        "conv1_w": conv(in_ch, c1),
        "conv1_b": zeros(c1),
        "conv2_w": conv(c1, c2),
        "conv2_b": zeros(c2),
        "fc1_w": dense_init(generator, flat, cfg.fc_hidden, device=device),
        "fc1_b": zeros(cfg.fc_hidden),
        "fc2_w": dense_init(generator, cfg.fc_hidden, cfg.n_classes, device=device),
        "fc2_b": zeros(cfg.n_classes),
    }


def _conv_same(h_nchw, w_hwio, b):
    """3x3 "SAME" convolution of an NCHW activation with an HWIO kernel."""
    return F.conv2d(h_nchw, w_hwio.permute(3, 2, 0, 1), padding="same") \
        + b[:, None, None]


def apply(params, x, cfg: TaskConfig):
    """x: (B, *input_shape) -> logits (B, n_classes)."""
    if cfg.kind == "mlp":
        x = x.reshape(x.shape[0], -1)
        h = torch.relu(x @ params["w1"] + params["b1"])
        return h @ params["w2"] + params["b2"]
    h = x.permute(0, 3, 1, 2)                                   # NHWC -> NCHW
    h = F.max_pool2d(torch.relu(_conv_same(h, params["conv1_w"],
                                           params["conv1_b"])), 2)
    h = F.max_pool2d(torch.relu(_conv_same(h, params["conv2_w"],
                                           params["conv2_b"])), 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)           # (H, W, C) order
    h = torch.relu(h @ params["fc1_w"] + params["fc1_b"])
    return h @ params["fc2_w"] + params["fc2_b"]


def loss_fn(params, batch, cfg: TaskConfig):
    """batch: {"x": (B,...), "y": (B,) int} -> mean CE loss.

    An optional ``"mask"`` leaf ((B,) validity weights of a ragged,
    pad-and-masked shard) turns the mean into a masked mean."""
    logits = apply(params, batch["x"], cfg).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["y"].long()[:, None])[:, 0]
    per = logz - gold
    mask = batch.get("mask")
    if mask is None:
        return torch.mean(per)
    m = mask.to(torch.float32)
    return torch.sum(per * m) / torch.clamp(torch.sum(m), min=1.0)


def accuracy(params, batch, cfg: TaskConfig):
    logits = apply(params, batch["x"], cfg)
    hit = (torch.argmax(logits, -1) == batch["y"].long()).to(torch.float32)
    mask = batch.get("mask")
    if mask is None:
        return torch.mean(hit)
    m = mask.to(torch.float32)
    return torch.sum(hit * m) / torch.clamp(torch.sum(m), min=1.0)
