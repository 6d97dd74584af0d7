"""Standard FL benchmark partitions beyond the paper's four settings:
Dirichlet label skew (Hsu et al.) and quantity skew, a numpy copy of the
JAX package's ``data/dirichlet.py`` (same rng consumption order, so the
same seed gives byte-identical federations)."""
from __future__ import annotations

import numpy as np

from repro_torch.data.synthetic import N_CLASSES, _batch, _protos, _sample


def dirichlet_label_skew(n_clients=100, n_per=128, alpha=0.5, seed=0):
    """Each client's label marginal ~ Dir(α). Small α ⇒ extreme skew.

    Returns (clients, label_marginals, test_set): no ground-truth cluster
    ids (there are none)."""
    rng = np.random.default_rng(seed)
    protos = _protos(rng)
    clients, marginals = [], []
    for _ in range(n_clients):
        p = rng.dirichlet(np.full(N_CLASSES, alpha))
        y = rng.choice(N_CLASSES, size=n_per, p=p)
        clients.append(_batch(_sample(rng, protos, y), y))
        marginals.append(p)
    y = rng.integers(0, N_CLASSES, size=1024)
    test = _batch(_sample(rng, protos, y), y)
    return clients, np.stack(marginals), test


def quantity_skew(n_clients=100, alpha=1.0, base=32, cap=512, seed=0):
    """Client dataset sizes ~ power law; the same distribution otherwise.
    Returns (clients, sizes, test_set)."""
    rng = np.random.default_rng(seed)
    protos = _protos(rng)
    sizes = np.clip((rng.pareto(alpha, n_clients) + 1) * base, base, cap).astype(int)
    clients = []
    for n in sizes:
        y = rng.integers(0, N_CLASSES, size=int(n))
        clients.append(_batch(_sample(rng, protos, y), y))
    y = rng.integers(0, N_CLASSES, size=1024)
    return clients, sizes, _batch(_sample(rng, protos, y), y)
