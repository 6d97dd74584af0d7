"""SGD optimizers as (init, update) pure-function pairs.

The paper's clients run plain SGD (Algorithm 1, lines 21-22); momentum is
provided for the substrate's standalone training paths.

API (optax-like but dependency-free):
    opt = sgd(lr)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

``lr`` is a number or a schedule (``optim.schedules``), a callable of the
step count; the count is an int32 0-d tensor on the parameters' device,
so a schedule's value is computed there too.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils.trees import leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def _lr_at(lr, count):
    return lr(count) if callable(lr) else lr


def _count(params) -> torch.Tensor:
    """A zero step count on the device of ``params``' leaves."""
    ls = leaves(params) if params is not None else []
    return torch.zeros((), dtype=torch.int32, device=ls[0].device if ls else None)


def _scaled(s, g):
    """``s * g`` as the reference computes it: a 0-d float32 tensor ``s``
    (a schedule's value, a norm's scale) promotes a bf16 ``g`` to
    float32, as a JAX float32 array does; a Python number is weakly typed
    there, so it is first rounded to ``g``'s dtype (0.9 is 0.8984375 in
    bf16)."""
    if torch.is_tensor(s):
        return s * g.to(torch.promote_types(s.dtype, g.dtype))
    return float(torch.tensor(s, dtype=g.dtype)) * g


def sgd(lr) -> Optimizer:
    def init(params):
        return {"count": _count(params)}

    def update(grads, state, params=None):
        step_lr = _lr_at(lr, state["count"])
        updates = tree_map(lambda g: _scaled(-step_lr, g), grads)
        return updates, {"count": state["count"] + 1}

    return Optimizer(init, update)


def sgd_momentum(lr, momentum: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"count": _count(params), "mu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params=None):
        step_lr = _lr_at(lr, state["count"])
        mu = tree_map(lambda m, g: _scaled(momentum, m) + g, state["mu"], grads)
        if nesterov:
            upd = tree_map(lambda m, g: _scaled(-step_lr, _scaled(momentum, m) + g), mu, grads)
        else:
            upd = tree_map(lambda m: _scaled(-step_lr, m), mu)
        return upd, {"count": state["count"] + 1, "mu": mu}

    return Optimizer(init, update)


def clip_by_global_norm(grads, max_norm: float):
    """(the tree scaled so its global norm is at most ``max_norm``, the
    norm before clipping as a 0-d float32 tensor)."""
    sq = [torch.sum(g.to(torch.float32) ** 2) for g in leaves(grads)]
    gnorm = torch.sqrt(torch.sum(torch.stack(sq)))
    scale = torch.clamp(max_norm / (gnorm + 1e-12), max=1.0)
    return tree_map(lambda g: _scaled(scale, g), grads), gnorm
