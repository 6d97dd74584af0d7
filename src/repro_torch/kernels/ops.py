"""Public kernel entry points with backend selection.

``backend="auto"`` hands the tensors to the kernel wrapper, which launches
the CUDA kernel for a CUDA tensor and runs the plain version for a CPU
tensor; ``backend="torch"`` forces the plain version on any device (the
counterpart of the JAX package's ``backend="jnp"``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.cosine_sim import cosine_sim as _cosine_kernel
from repro_torch.kernels.cosine_sim import merge_candidates as _candidates_kernel
from repro_torch.kernels.cosine_sim import row_padded  # noqa: F401  (the callers' layout)
from repro_torch.kernels.prox_update import prox_theta_flat as _theta_kernel
from repro_torch.kernels.prox_update import prox_update_flat as _prox_kernel
from repro_torch.kernels.resolve_roots import component_labels as _labels_kernel
from repro_torch.kernels.resolve_roots import resolve_roots as _resolve_kernel
from repro_torch.kernels.ssm_scan import ssm_scan as _scan_kernel
from repro_torch.utils import trees

BACKENDS = ("auto", "torch")


def _plain(backend: str) -> bool:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
    return backend == "torch"


def pairwise_cosine(x: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """(N, D) representation matrix -> (N, N) cosine similarity."""
    if _plain(backend):
        return ref.cosine_sim_ref(x)
    return _cosine_kernel(x)


def merge_pairs(means: torch.Tensor, live: torch.Tensor, tau: float,
                backend: str = "auto") -> torch.Tensor:
    """(K, D) cluster means + (K,) live mask -> (K, K) fp32 0/1 adjacency
    of mergeable pairs (cos ≥ τ, both live, diagonal off): Algorithm 1
    line 10 as one fused device op (K3, ``cosine_sim.merge_candidates``)."""
    if _plain(backend):
        return ref.merge_candidates_ref(means, live, tau)
    return _candidates_kernel(means, live, tau)


def resolve_roots(parent: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """(N,) union-find parent array (``parent[i] == i`` at roots) -> (N,)
    fully resolved roots by ``max(N.bit_length(), 1)`` pointer-halving
    steps (K4): the device replacement for the host ``UnionFind.find``."""
    if _plain(backend):
        return ref.resolve_roots_ref(parent)
    return _resolve_kernel(parent)


def component_labels(adj: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """(k, k) 0/1 adjacency -> (k,) int32 connected-component labels, each
    the smallest node id of its component: min-label propagation with
    pointer jumping run to its fixed point, in one launch on the card with
    no host sync (``resolve_roots.component_labels``)."""
    if _plain(backend):
        return ref.component_labels_ref(adj)
    return _labels_kernel(adj)


def prox_update_tree(theta, omega, g_theta, g_omega, eta, lam,
                     backend: str = "auto"):
    """Bi-level update applied leaf by leaf over parameter dicts; returns
    new dicts ``(theta', omega')`` and leaves the inputs untouched."""
    plain = _plain(backend)

    def leaf(t, o, gt, go):
        if plain:
            return ref.prox_update_ref(t, o, gt, go, eta, lam)
        t = t.clone(memory_format=torch.contiguous_format)
        o = o.clone(memory_format=torch.contiguous_format)
        _prox_kernel(t.view(-1), o.view(-1), gt.contiguous().view(-1),
                     go.contiguous().view(-1), eta, lam)
        return t, o

    pairs = trees.tree_map(leaf, theta, omega, g_theta, g_omega)
    return (trees.tree_map(lambda p: p[0], pairs),
            trees.tree_map(lambda p: p[1], pairs))


def prox_update_flat(theta, omega, g_theta, g_omega, eta, lam,
                     backend: str = "auto"):
    """Bi-level update on flat 1-D vectors (Algorithm 1 l.21-22), written
    in place into ``theta`` and ``omega``; returns ``(theta, omega)``."""
    if _plain(backend):
        return ref.prox_update_ref_(theta, omega, g_theta, g_omega, eta, lam)
    return _prox_kernel(theta, omega, g_theta, g_omega, eta, lam)


def prox_theta_flat(theta, anchor, grad, eta, lam, backend: str = "auto"):
    """The local-SGD step θ ← θ − η(g + λ(θ − a)) on a flat θ, written in
    place; the anchor is read only (θ itself with λ = 0, or a period of θ
    broadcast over its rows). What the reference's ``local_sgd`` computes
    through ``prox_update_flat``, keeping only θ. Returns ``theta``."""
    if _plain(backend):
        return ref.prox_theta_ref_(theta, anchor, grad, eta, lam)
    return _theta_kernel(theta, anchor, grad, eta, lam)


def ssm_scan(dA, dBx, C, backend: str = "auto") -> torch.Tensor:
    """Selective scan y[t] = Σₙ h[t]·C[t], h[t] = dA[t]⊙h[t−1] + dBx[t]
    (K5). ``"auto"`` is the ``SSMScan`` autograd op: on CUDA its forward
    and backward are kernels, on the CPU their plain versions;
    ``"torch"`` is the plain sequential scan, differentiated by autograd."""
    if _plain(backend):
        return ref.ssm_scan_ref(dA, dBx, C)
    return _scan_kernel(dA, dBx, C)
