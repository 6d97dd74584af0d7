"""Plain PyTorch versions of the port's kernels (the allclose ground truth).

Each mirrors its counterpart in the JAX package's ``kernels/ref.py``; the
wrappers run these on CPU tensors, and ``chip_smoke.py`` holds every CUDA
kernel against them on the card.
"""
from __future__ import annotations

import torch


def cosine_sim_ref(x: torch.Tensor) -> torch.Tensor:
    """x: (N, D) -> (N, N) fp32 cosine similarity (zero rows give 0)."""
    x32 = x.to(torch.float32)
    norms = torch.linalg.vector_norm(x32, dim=1, keepdim=True)
    xn = torch.where(norms > 0, x32 / norms, torch.zeros_like(x32))
    return xn @ xn.T


def merge_candidates_ref(x: torch.Tensor, live: torch.Tensor, tau: float) -> torch.Tensor:
    """(K, D) means + (K,) live -> (K, K) fp32 0/1 merge-pair adjacency
    (cos ≥ τ, both rows live, diagonal off)."""
    m = cosine_sim_ref(x)
    lv = live.to(torch.bool)
    ids = torch.arange(x.shape[0], device=x.device)
    ok = (m >= tau) & lv[:, None] & lv[None, :] & (ids[:, None] != ids[None, :])
    return ok.to(torch.float32)


def resolve_roots_ref(parent: torch.Tensor) -> torch.Tensor:
    """(N,) union-find parent pointers -> (N,) roots by iterated pointer
    halving ``p <- p[p]``, ``max(N.bit_length(), 1)`` steps (each halves
    every path). Returns a new tensor of ``parent``'s dtype."""
    p = parent
    for _ in range(max(int(parent.shape[0]).bit_length(), 1)):
        p = p[p.long()]
    return p


def prox_update_ref(theta, omega, g_theta, g_omega, eta: float, lam: float):
    """θ' = θ − η(g_θ + λ(θ − ω)), ω' = ω − η g_ω, in fp32, cast back to
    each operand's dtype. Returns new tensors."""
    th = theta.to(torch.float32)
    om = omega.to(torch.float32)
    theta_new = th - eta * (g_theta.to(torch.float32) + lam * (th - om))
    omega_new = om - eta * g_omega.to(torch.float32)
    return theta_new.to(theta.dtype), omega_new.to(omega.dtype)


def prox_update_ref_(theta, omega, g_theta, g_omega, eta: float, lam: float):
    """``prox_update_ref`` written into ``theta`` and ``omega``, the
    kernel's in-place contract; returns ``(theta, omega)``."""
    th, om = prox_update_ref(theta, omega, g_theta, g_omega, eta, lam)
    theta.copy_(th)
    omega.copy_(om)
    return theta, omega
