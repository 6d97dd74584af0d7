"""Plain PyTorch versions of the port's kernels (the allclose ground truth).

Each mirrors its counterpart in the JAX package's ``kernels/ref.py``; the
wrappers run these on CPU tensors, and ``chip_smoke.py`` holds every CUDA
kernel against them on the card. A plain version that reads the host
(``component_labels_ref``'s pass loop) is marked ``events.plain_version``:
on CPU tensors ``analysis.sanitize.no_transfer`` lets its reads through,
since on the card the kernel runs in its place.
"""
from __future__ import annotations

import torch

from repro_torch.utils import events


def cosine_sim_ref(x: torch.Tensor) -> torch.Tensor:
    """x: (N, D) -> (N, N) fp32 cosine similarity (zero rows give 0)."""
    x32 = x.to(torch.float32)
    norms = torch.linalg.vector_norm(x32, dim=1, keepdim=True)
    # a zero row divides by 1, not 0: no masked-out NaN (``nan_guard`` checks
    # every op's values)
    xn = torch.where(norms > 0, x32 / torch.where(norms > 0, norms, 1.0),
                     torch.zeros_like(x32))
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


@events.plain_version
def component_labels_ref(adj: torch.Tensor) -> torch.Tensor:
    """Connected-component labels of a 0/1 adjacency matrix: each node's
    label converges to the smallest node id in its component (the JAX
    package's ``core/device_clustering.py`` ``component_labels``).

    Min-label propagation with pointer jumping, run to a FIXED POINT: per
    pass every node takes the min over its neighbours' labels, then follows
    its own label's label. At a fixed point adjacent nodes hold equal
    labels, labels never leave their component, and the common value must
    be the component minimum, so the exit condition is the proof. A fixed
    pass count alone is NOT safe (an adversarially permuted chain needs
    more), which is why the loop compares the labels before and after each
    pass and stops when nothing changed: one host sync a pass."""
    n = adj.shape[0]
    label = torch.arange(n, dtype=torch.int32, device=adj.device)
    linked = adj > 0
    fill = torch.full((n, n), n, dtype=torch.int32, device=adj.device)

    def one_pass(lab):
        neigh = torch.where(linked, lab[None, :], fill).amin(dim=1)
        lab = torch.minimum(lab, neigh)
        return lab[lab.long()]

    while True:
        nxt = one_pass(label)
        if torch.equal(nxt, label):
            return nxt
        label = nxt


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


def prox_theta_ref(theta, anchor, grad, eta: float, lam: float):
    """θ' = θ − η(g + λ(θ − a)) in fp32, cast back to θ's dtype: the θ output
    of ``prox_update_ref`` with ``grad`` as g_θ and the anchor as ω, the
    reference's local-SGD step. ``anchor`` has θ's length (θ itself when
    λ = 0) or a period P dividing it, broadcast over the rows. Returns a new
    tensor."""
    th = theta.to(torch.float32).reshape(-1, anchor.numel())
    a = anchor.to(torch.float32).reshape(-1, anchor.numel())
    out = th - eta * (grad.to(torch.float32).reshape(th.shape) + lam * (th - a))
    return out.reshape(theta.shape).to(theta.dtype)


def prox_theta_ref_(theta, anchor, grad, eta: float, lam: float):
    """``prox_theta_ref`` written into ``theta``, the kernel's contract;
    returns ``theta``."""
    return theta.copy_(prox_theta_ref(theta, anchor, grad, eta, lam))


def ssm_scan_states_ref(dA, dBx, C, chunk: int):
    """Sequential selective scan, h[t] = dA[t]⊙h[t−1] + dBx[t] from h = 0,
    y[t] = Σₙ h[t, d, n]·C[t, n]. dA, dBx: (B, S, D, N); C: (B, S, N).
    Returns ``(y, hs)``: y (B, S, D) fp32 and hs (B, ⌈S/chunk⌉, D, N), the
    state entering each ``chunk`` of steps (h[k·chunk − 1]; zeros for
    k = 0), which is what the backward restarts from."""
    dA = dA.to(torch.float32)
    dBx = dBx.to(torch.float32)
    C = C.to(torch.float32)
    B, S, D, N = dA.shape
    h = dA.new_zeros((B, D, N))
    ys, hs = [], []
    for t in range(S):
        if t % chunk == 0:
            hs.append(h)
        h = dA[:, t] * h + dBx[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]))
    y = torch.stack(ys, 1) if ys else dA.new_zeros((B, 0, D))
    hs = torch.stack(hs, 1) if hs else dA.new_zeros((B, 0, D, N))
    return y, hs


def ssm_scan_ref(dA, dBx, C):
    """The selective scan's output y (B, S, D) fp32 (the JAX package's
    ``ssm_scan_ref``); differentiable by autograd."""
    return ssm_scan_states_ref(dA, dBx, C, max(int(dA.shape[1]), 1))[0]


def ssm_scan_bwd_ref(dA, dBx, C, hs, g_y, chunk: int):
    """Gradient of the selective scan, the backward kernel's arithmetic.

    For each chunk of steps, last first: recompute the chunk's states from
    its entering state ``hs[:, k]``, then run the reverse recurrence
    g_h[t] = g_y[t]·C[t] + dA[t+1]⊙g_h[t+1] and write g_dA[t] =
    g_h[t]⊙h[t−1], g_dBx[t] = g_h[t], g_C[t, n] = Σ_d h[t, d, n]·g_y[t, d].
    Returns ``(g_dA, g_dBx, g_C)`` in fp32."""
    dA = dA.to(torch.float32)
    dBx = dBx.to(torch.float32)
    C = C.to(torch.float32)
    g_y = g_y.to(torch.float32)
    B, S, D, N = dA.shape
    g_dA, g_dBx = torch.empty_like(dA), torch.empty_like(dA)
    g_C = C.new_empty((B, S, N))
    carry = dA.new_zeros((B, D, N))              # dA[t+1]⊙g_h[t+1]
    for k in reversed(range(-(-S // chunk))):
        t0, t1 = k * chunk, min((k + 1) * chunk, S)
        hist = [hs[:, k]]
        for t in range(t0, t1):
            hist.append(dA[:, t] * hist[-1] + dBx[:, t])
        for t in reversed(range(t0, t1)):
            gh = g_y[:, t, :, None] * C[:, t, None, :] + carry
            g_dA[:, t] = gh * hist[t - t0]
            g_dBx[:, t] = gh
            g_C[:, t] = torch.einsum("bdn,bd->bn", hist[t - t0 + 1], g_y[:, t])
            carry = dA[:, t] * gh
    return g_dA, g_dBx, g_C
