"""Synthetic Non-IID federations reproducing the paper's four skews (§4.1).

A numpy copy of the JAX package's ``data/synthetic.py`` settings (same
rng consumption order, so the same seed gives byte-identical federations):

  pathological — label-distribution skew: clients only hold the label
                 subset of their group ({0,1,2},{3,4},{5,6},{7,8,9});
  rotated      — feature-distribution skew: per-cluster fixed orthogonal
                 transform of the feature space;
  shifted      — label-concept skew: ȳ = (y + s) mod 10, s ∈ {0,3,6,9};
  hybrid       — feature-concept skew: same labels, disjoint generative
                 domains;
  femnist      — latent writer-style mixture with per-client jitter;
  rotated_partial — clusters differ only in a rotated subspace, scarce data;
  rotated_pathological — the §4.3 τ study: 2 rotations × 4 label groups.

Plus the churn hooks of the simulator (``repro_torch.sim``):
``rotated_factory`` draws fresh clients from ``rotated``'s latent
clusters, ``drift_batch`` rotates a client's feature space a little.

Each builder returns (clients, true_cluster, test_sets):
  clients:      list of {"x": (n, dim) f32, "y": (n,) i32} numpy dicts
  true_cluster: list[int] per client
  test_sets:    dict true_cluster_id -> {"x","y"} held-out batch
"""
from __future__ import annotations

import numpy as np

DIM = 64
N_CLASSES = 10


def _protos(rng, n_classes=N_CLASSES, dim=DIM, sep=3.0):
    p = rng.normal(size=(n_classes, dim))
    return sep * p / np.linalg.norm(p, axis=1, keepdims=True)


def _sample(rng, protos, labels, noise=0.5):
    x = protos[labels] + rng.normal(size=(len(labels), protos.shape[1])) * noise
    return x.astype(np.float32)


def _orthogonal(rng, dim):
    q, _ = np.linalg.qr(rng.normal(size=(dim, dim)))
    return q.astype(np.float32)


def _batch(x, y):
    return {"x": np.asarray(x, np.float32), "y": np.asarray(y, np.int32)}


def _make_clients(rng, protos, transform_x, transform_y, n_clients, n_per,
                  labels_allowed=None, dim=DIM):
    clients = []
    for _ in range(n_clients):
        pool = labels_allowed if labels_allowed is not None else np.arange(N_CLASSES)
        y = rng.choice(pool, size=n_per)
        x = _sample(rng, protos, y)
        clients.append(_batch(transform_x(x), transform_y(y)))
    return clients


def pathological(n_clients=400, n_per=128, seed=0):
    """4 clusters by disjoint label groups (McMahan-style sort-and-split)."""
    rng = np.random.default_rng(seed)
    protos = _protos(rng)
    groups = [[0, 1, 2], [3, 4], [5, 6], [7, 8, 9]]
    per = n_clients // len(groups)
    clients, true_cluster = [], []
    for k, g in enumerate(groups):
        clients += _make_clients(rng, protos, lambda x: x, lambda y: y, per, n_per,
                                 labels_allowed=np.array(g))
        true_cluster += [k] * per
    test_sets = {}
    for k, g in enumerate(groups):
        y = rng.choice(np.array(g), size=512)
        test_sets[k] = _batch(_sample(rng, protos, y), y)
    return clients, true_cluster, test_sets


def rotated(n_clusters=4, n_clients=400, n_per=128, seed=0):
    """Per-cluster orthogonal feature transform (rotation analogue)."""
    rng = np.random.default_rng(seed)
    protos = _protos(rng)
    qs = [np.eye(DIM, dtype=np.float32)] + [_orthogonal(rng, DIM) for _ in range(n_clusters - 1)]
    per = n_clients // n_clusters
    clients, true_cluster = [], []
    for k in range(n_clusters):
        clients += _make_clients(rng, protos, lambda x, q=qs[k]: x @ q, lambda y: y, per, n_per)
        true_cluster += [k] * per
    test_sets = {}
    for k in range(n_clusters):
        y = rng.integers(0, N_CLASSES, size=512)
        test_sets[k] = _batch(_sample(rng, protos, y) @ qs[k], y)
    return clients, true_cluster, test_sets


def shifted(n_clusters=4, n_clients=400, n_per=128, seed=0, shifts=(0, 3, 6, 9)):
    """ȳ = (y + s) mod 10 per cluster (label-concept skew, Sattler-style)."""
    rng = np.random.default_rng(seed)
    protos = _protos(rng)
    per = n_clients // n_clusters
    clients, true_cluster = [], []
    for k in range(n_clusters):
        s = shifts[k % len(shifts)]
        clients += _make_clients(rng, protos, lambda x: x,
                                 lambda y, s=s: (y + s) % N_CLASSES, per, n_per)
        true_cluster += [k] * per
    test_sets = {}
    for k in range(n_clusters):
        s = shifts[k % len(shifts)]
        y = rng.integers(0, N_CLASSES, size=512)
        test_sets[k] = _batch(_sample(rng, protos, y), (y + s) % N_CLASSES)
    return clients, true_cluster, test_sets


def hybrid(n_clients=200, n_per=128, seed=0):
    """Two disjoint generative domains, same label space (MNIST vs F-MNIST)."""
    rng = np.random.default_rng(seed)
    protos_a = _protos(rng)
    protos_b = _protos(rng)                     # independent domain
    per = n_clients // 2
    clients, true_cluster = [], []
    for k, protos in enumerate([protos_a, protos_b]):
        clients += _make_clients(rng, protos, lambda x: x, lambda y: y, per, n_per)
        true_cluster += [k] * per
    test_sets = {}
    for k, protos in enumerate([protos_a, protos_b]):
        y = rng.integers(0, N_CLASSES, size=512)
        test_sets[k] = _batch(_sample(rng, protos, y), y)
    return clients, true_cluster, test_sets


def femnist_like(n_clients=300, n_per=128, seed=0, n_styles=2):
    """Latent writer-style mixture: n_styles generative styles, per-client
    jitter, the paper's 'no clear clusters but styles cluster' setting."""
    rng = np.random.default_rng(seed)
    protos = _protos(rng, n_classes=N_CLASSES)
    styles = [np.eye(DIM, dtype=np.float32)] + [_orthogonal(rng, DIM) for _ in range(n_styles - 1)]
    clients, true_cluster = [], []
    for i in range(n_clients):
        k = int(rng.integers(0, n_styles))
        y = rng.integers(0, N_CLASSES, size=n_per)
        jitter = rng.normal(size=(DIM, DIM)).astype(np.float32) * 0.02
        x = _sample(rng, protos, y) @ (styles[k] + jitter)
        clients.append(_batch(x, y))
        true_cluster.append(k)
    test_sets = {}
    for k in range(n_styles):
        y = rng.integers(0, N_CLASSES, size=512)
        test_sets[k] = _batch(_sample(rng, protos, y) @ styles[k], y)
    return clients, true_cluster, test_sets


def rotated_partial(n_clusters=4, n_clients=40, n_per=12, seed=1, rot_dims=16):
    """Partially-shared structure: clusters differ only in a rotated
    ``rot_dims``-dim subspace (48/64 dims shared) with SCARCE per-client
    data — the regime where the paper's λ knowledge-transfer term matters
    (rotated digits share stroke features)."""
    rng = np.random.default_rng(seed)
    protos = _protos(rng)
    qs = []
    for _ in range(n_clusters):
        q = np.eye(DIM, dtype=np.float32)
        q[:rot_dims, :rot_dims] = _orthogonal(rng, rot_dims)
        qs.append(q)
    per = n_clients // n_clusters
    clients, true_cluster = [], []
    for k in range(n_clusters):
        clients += _make_clients(rng, protos, lambda x, q=qs[k]: x @ q,
                                 lambda y: y, per, n_per)
        true_cluster += [k] * per
    test_sets = {}
    for k in range(n_clusters):
        y = rng.integers(0, N_CLASSES, size=512)
        test_sets[k] = _batch(_sample(rng, protos, y) @ qs[k], y)
    return clients, true_cluster, test_sets


def rotated_pathological(n_clients=400, n_per=128, seed=0):
    """§4.3 τ-study setting: 2 rotations × 4 label groups = 8 fine clusters."""
    rng = np.random.default_rng(seed)
    protos = _protos(rng)
    qs = [np.eye(DIM, dtype=np.float32), _orthogonal(rng, DIM)]
    groups = [[0, 1, 2], [3, 4], [5, 6], [7, 8, 9]]
    per = n_clients // (len(qs) * len(groups))
    clients, true_fine, true_rot, true_label = [], [], [], []
    for r, q in enumerate(qs):
        for gidx, g in enumerate(groups):
            clients += _make_clients(rng, protos, lambda x, q=q: x @ q, lambda y: y,
                                     per, n_per, labels_allowed=np.array(g))
            true_fine += [r * len(groups) + gidx] * per
            true_rot += [r] * per
            true_label += [gidx] * per
    return clients, {"fine": true_fine, "rotation": true_rot, "label": true_label}


SETTINGS = {
    "pathological": pathological,
    "rotated": rotated,
    "shifted": shifted,
    "hybrid": hybrid,
    "femnist": femnist_like,
    "rotated_partial": rotated_partial,
}


def make_federation(setting: str, **kw):
    return SETTINGS[setting](**kw)


# ----------------------------------------------------------- churn hooks
def rotated_factory(n_clusters=4, n_per=128, seed=0):
    """Client factory for §5 churn simulations over the ``rotated``
    setting: fresh clients from the same latent distributions as
    ``rotated(n_clusters=..., seed=...)`` (the class prototypes and the
    per-cluster orthogonal transforms are rebuilt with the same rng
    consumption order), so a client made for ``cluster=k`` is a new draw
    from the distribution incumbent cluster k trained on.

    Returns ``factory(cluster, rng, n=n_per) -> {"x", "y"}``, the
    ``client_factory`` signature ``repro_torch.sim.simulate`` expects."""
    rng = np.random.default_rng(seed)
    protos = _protos(rng)
    qs = [np.eye(DIM, dtype=np.float32)] + [_orthogonal(rng, DIM)
                                            for _ in range(n_clusters - 1)]

    def factory(cluster, rng2, n=n_per):
        k = int(cluster) % n_clusters if cluster is not None else \
            int(rng2.integers(n_clusters))
        y = rng2.integers(0, N_CLASSES, size=n)
        return _batch(_sample(rng2, protos, y) @ qs[k], y)

    return factory


SETTING_FACTORIES = {
    "rotated": rotated_factory,
}


def drift_batch(batch, rng, strength: float = 0.05):
    """Distribution-drift hook (the simulator's ``Drift`` events): rotate a
    client's feature space by a small random orthogonal transform
    ``Q = qr(I + strength·G)``. Labels and shard length are kept, so arena
    rows are rewritten in place (``ClientArena.update``). ``batch`` holds
    numpy arrays."""
    x = np.asarray(batch["x"], np.float32)
    d = x.shape[1]
    g = rng.normal(size=(d, d)).astype(np.float32)
    q, _ = np.linalg.qr(np.eye(d, dtype=np.float32) + strength * g)
    out = {k: np.asarray(v) for k, v in batch.items() if k not in ("x",)}
    out["x"] = (x @ q.astype(np.float32)).astype(np.float32)
    return out
