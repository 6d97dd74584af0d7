"""Adam/AdamW for the substrate training paths (non-FL standalone runs).

The moments ``m`` and ``v`` are float32 whatever the parameters' dtype,
and the bias correction reads the int32 step count on the device."""
from __future__ import annotations

import torch

from repro_torch.optim.sgd import Optimizer, _count, _lr_at
from repro_torch.utils.trees import tree_map


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"count": _count(params), "m": tree_map(zeros, params),
                "v": tree_map(zeros, params)}

    def update(grads, state, params=None):
        count = state["count"] + 1
        step_lr = _lr_at(lr, state["count"])
        m = tree_map(lambda mi, g: b1 * mi + (1 - b1) * g.to(torch.float32), state["m"], grads)
        v = tree_map(lambda vi, g: b2 * vi + (1 - b2) * torch.square(g.to(torch.float32)),
                     state["v"], grads)
        bc1 = 1 - b1 ** count.to(torch.float32)
        bc2 = 1 - b2 ** count.to(torch.float32)

        def upd(mi, vi, p):
            u = -step_lr * (mi / bc1) / (torch.sqrt(vi / bc2) + eps)
            if weight_decay:
                u = u - step_lr * weight_decay * p.to(torch.float32)
            return u.to(p.dtype) if p is not None else u

        if params is None:
            # the reference's branch as it is: m stands in for the
            # parameters, weight decay included
            updates = tree_map(lambda mi, vi: upd(mi, vi, mi), m, v)
        else:
            updates = tree_map(upd, m, v, params)
        return updates, {"count": count, "m": m, "v": v}

    return Optimizer(init, update)
