"""Distribution extractor Ψ (paper §3.1).

Ψ(D) = Normalize(∂ℓ(ψ; D)/∂ψ): the L2-normalised gradient of a frozen
anchor model ψ over a client's local dataset. The anchor is never
optimised; the paper sets ψ = ω₀, the FL initialisation.

The JAX package can also sketch Ψ to ``project_dim`` dimensions with a
Johnson-Lindenstrauss projection drawn from ``jax.random``; the port does
not have that sketch yet, so its Ψ is always the full gradient.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.utils import trees


def make_extractor(loss_fn: Callable, anchor_params) -> Callable:
    """Returns Ψ: batch -> normalised fp32 representation vector, on the
    anchor's device, in sorted-leaf order.

    loss_fn(params, batch) -> scalar tensor."""
    anchor = trees.tree_map(lambda x: x.detach(), anchor_params)

    def psi(batch) -> torch.Tensor:
        params = trees.tree_map(lambda x: x.clone().requires_grad_(True), anchor)
        with torch.enable_grad():
            loss = loss_fn(params, batch)
            leaves = trees.leaves(params)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss never reads has gradient 0, as under jax.grad
        vec = torch.cat([(torch.zeros_like(p) if g is None else g)
                         .reshape(-1).to(torch.float32)
                         for p, g in zip(leaves, grads)])
        norm = torch.linalg.vector_norm(vec)
        return torch.where(norm > 0, vec / norm, vec)

    return psi
