"""Pluggable global-objective aggregators for ω (paper §3.4).

All operate on a stacked client-update tree (leading client axis) and a
weight vector, like the JAX package's ``core/aggregators.py``.
"""
from __future__ import annotations

import torch

from repro_torch.utils import trees


def _weights(weights, like: torch.Tensor) -> torch.Tensor:
    w = torch.as_tensor(weights, dtype=torch.float32, device=like.device)
    return w / torch.sum(w)


def mean_aggregate(stacked, weights, split=None):
    """FedAvg: sample-size-weighted mean (the paper's default G).

    Under a mesh, ``split`` (``sharding.RowSplit``) names the cohort rows
    ``stacked`` holds, this rank's, and ``weights`` stays full length: the
    weights' total and each leaf's weighted sum are local partial sums,
    each summed over the ranks by one ``all_reduce``."""
    if split is None:
        w = _weights(weights, trees.leaves(stacked)[0])
    else:
        like = trees.leaves(stacked)[0]
        w = split.take(torch.as_tensor(weights, dtype=torch.float32, device=like.device))
        w = w / split.reduce_(torch.sum(w))

    def leaf(x):
        wb = w.reshape((-1,) + (1,) * (x.dim() - 1))
        out = torch.sum(x * wb, dim=0)
        if split is not None:
            split.reduce_(out)
        return out.to(x.dtype)

    return trees.tree_map(leaf, stacked)


def median_aggregate(stacked, weights=None):
    """Coordinate-wise median — robust to < 50% arbitrary clients. An even
    count averages the two middle values, as ``jnp.median`` does."""
    def leaf(x):
        xs = torch.sort(x, dim=0).values
        n = x.shape[0]
        mid = xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2
        return mid.to(x.dtype)

    return trees.tree_map(leaf, stacked)


def trimmed_mean_aggregate(stacked, weights=None, trim_frac: float = 0.2):
    """Coordinate-wise α-trimmed mean."""
    def leaf(x):
        n = x.shape[0]
        k = min(int(n * trim_frac), (n - 1) // 2)
        xs = torch.sort(x, dim=0).values
        sel = xs[k: n - k] if n - 2 * k > 0 else xs
        return torch.mean(sel, dim=0).to(x.dtype)

    return trees.tree_map(leaf, stacked)


def krum_select(stacked, weights=None, f: int = 1):
    """Krum: the single client update closest to its n−f−2 nearest
    neighbours (Blanchard et al.) — Byzantine-tolerant selection."""
    leaves = trees.leaves(stacked)
    n = leaves[0].shape[0]
    flats = torch.cat([l.reshape(n, -1).to(torch.float32) for l in leaves], 1)
    d2 = torch.sum((flats[:, None, :] - flats[None, :, :]) ** 2, dim=-1)
    d2 = d2 + torch.eye(n, device=d2.device) * 1e30
    m = max(n - f - 2, 1)
    scores = torch.sum(torch.sort(d2, dim=1).values[:, :m], dim=1)
    best = torch.argmin(scores).reshape(1)     # stays on the device: no host read
    return trees.tree_map(lambda x: torch.index_select(x, 0, best)[0], stacked)


AGGREGATORS = {
    "mean": mean_aggregate,
    "median": median_aggregate,
    "trimmed_mean": trimmed_mean_aggregate,
    "krum": krum_select,
}


def byzantine_distance_screen(reps, tau_screen: float = 0.0):
    """§5 future-work sketch: flag clients whose Ψ is anomalously far from
    EVERY cluster mean (cosine below tau_screen to all clusters) — those
    join no benign cluster and can be quarantined. Returns
    ``screen(means)``, a bool keep mask over the rows of ``reps``, computed
    on ``reps``' device (``means`` may be ``DeviceClusters.cluster_means``'
    device tensor or a host array)."""
    reps = torch.as_tensor(reps)

    def screen(means):
        means = torch.as_tensor(means, device=reps.device)
        rn = reps / (torch.linalg.vector_norm(reps, dim=1, keepdim=True) + 1e-12)
        mn = means / (torch.linalg.vector_norm(means, dim=1, keepdim=True) + 1e-12)
        sims = rn @ mn.T                                  # (n, K)
        return sims.amax(dim=1) >= tau_screen

    return screen


def aggregate_omega(name: str, stacked, weights, split=None):
    """``AGGREGATORS[name](stacked, weights)`` over a cohort whose rows may
    be split over a mesh's ranks (``split``, this rank's rows in
    ``stacked``): the mean as partial sums and an ``all_reduce``; the
    order statistics (median, trimmed mean, Krum) on the full stack,
    gathered to every rank."""
    if split is None:
        return AGGREGATORS[name](stacked, weights)
    if name == "mean":
        return mean_aggregate(stacked, weights, split)
    return AGGREGATORS[name](split.gather(stacked), weights)
