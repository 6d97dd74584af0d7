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


def mean_aggregate(stacked, weights):
    """FedAvg: sample-size-weighted mean (the paper's default G)."""
    w = _weights(weights, trees.leaves(stacked)[0])

    def leaf(x):
        wb = w.reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.sum(x * wb, dim=0).to(x.dtype)

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
