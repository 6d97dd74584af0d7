"""StoCFL trainer: a deprecated class shim over ``repro_torch.engine``.

New code uses the functional engine API directly:

    from repro_torch import engine
    state = engine.init("stocfl", loss_fn, params, clients,
                        engine.EngineConfig(tau=0.5, lam=0.05), eval_fn=acc)
    state, rec = engine.run_round(state)

This class keeps the JAX package's object surface (``.round()``,
``.fit()``, ``.state``, ``.models``, ``.omega``, join/leave/infer) for
existing callers; every method delegates to the engine's pure transitions,
with the ``ServerState`` held as the single source of truth. ``device`` is
passed through to ``engine.init`` (``None`` = cuda).

Degenerations (paper §3.4): τ=1 → Ditto; τ=−1 → FedProx-family;
λ=0 → conventional CFL; λ=0 ∧ τ=−1 → FedAvg.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

# Module-object import only: repro_torch.engine imports repro_torch.core
# (clustering, bilevel), which imports this shim; binding the module and
# resolving attributes at call time keeps the cycle harmless.
from repro_torch import engine


@dataclasses.dataclass
class StoCFLConfig:
    tau: float = 0.5
    lam: float = 0.05
    lr: float = 0.1
    local_steps: int = 5
    sample_rate: float = 0.1
    project_dim: Optional[int] = None
    seed: int = 0
    aggregator: str = "mean"      # G(·): mean | median | trimmed_mean | krum


class StoCFL:
    """loss_fn(params, batch)->scalar; clients: list of batch dicts
    (equal-shaped local datasets; the cohort update is vmapped)."""

    def __init__(self, loss_fn: Callable, init_params, clients: Sequence[dict],
                 cfg: StoCFLConfig, eval_fn: Optional[Callable] = None,
                 leaf_filter: Optional[Callable] = None, device=None):
        self.cfg = cfg
        ecfg = engine.EngineConfig(
            tau=cfg.tau, lam=cfg.lam, lr=cfg.lr, local_steps=cfg.local_steps,
            sample_rate=cfg.sample_rate, seed=cfg.seed,
            aggregator=cfg.aggregator, project_dim=cfg.project_dim)
        self._st = engine.init("stocfl", loss_fn, init_params, clients, ecfg,
                               eval_fn=eval_fn, device=device,
                               leaf_filter=leaf_filter)

    # ---------------------------------------------------------- state views
    @property
    def server_state(self) -> engine.ServerState:
        """The underlying engine state."""
        return self._st

    @property
    def omega(self):
        """The global model ω."""
        return self._st.omega

    @omega.setter
    def omega(self, value):
        self._st = self._st.replace(omega=value)

    @property
    def models(self):
        """Cluster models (``ClusterBank``, Mapping-compatible)."""
        return self._st.models

    @models.setter
    def models(self, value):
        self._st = self._st.replace(models=engine.ClusterBank.from_dict(dict(value)))

    @property
    def state(self):
        """The Ψ-clustering bookkeeping (``ClusterState``-shaped)."""
        return self._st.clusters

    @property
    def history(self):
        """Per-round metric records."""
        return list(self._st.history)

    @history.setter
    def history(self, value):
        self._st = self._st.replace(history=tuple(value))

    @property
    def clients(self):
        """The registered client datasets (the context's world)."""
        return self._st.ctx.clients

    @property
    def n(self) -> int:
        """Registered client count (departed included)."""
        return self._st.n_clients

    @property
    def sizes(self) -> np.ndarray:
        """Per-client sample counts (aggregation weights)."""
        return np.asarray(self._st.sizes)

    @property
    def init_params(self):
        """ω₀: initialization and lazy cluster-model default."""
        return self._st.ctx.init_params

    @property
    def anchor(self):
        """The frozen Ψ anchor ψ = ω₀ (paper §4.2)."""
        return self._st.ctx.init_params

    @property
    def loss_fn(self):
        """The local objective f_i(params, batch) -> scalar."""
        return self._st.ctx.loss_fn

    @property
    def eval_fn(self):
        """Optional accuracy fn used by ``evaluate``."""
        return self._st.ctx.eval_fn

    @property
    def extractor(self):
        """The Ψ distribution extractor (§3.1)."""
        return self._st.ctx.extractor

    # ------------------------------------------------------------- models
    def cluster_model(self, root: int):
        """θ_k for a cluster root (ω₀ until first aggregate)."""
        return self._st.cluster_model(root)

    # ------------------------------------------------------------- rounds
    def round(self, client_ids: Optional[Sequence[int]] = None) -> dict:
        """One server round (sampled cohort unless ``client_ids``)."""
        self._st, rec = engine.run_round(self._st, client_ids)
        return rec

    def fit(self, rounds: int, log_every: int = 0):
        """Run ``rounds`` rounds with optional progress printing."""
        for t in range(rounds):
            rec = self.round()
            if log_every and t % log_every == 0:
                print(f"round {t}: clusters={rec['n_clusters']} obj={rec['objective']:.3f}")
        return self

    # ------------------------------------------------------------- eval
    def client_root(self, cid: int) -> int:
        """Union-find root (= cluster id) of an observed client."""
        return self._st.client_root(cid)

    def evaluate(self, test_sets, true_cluster):
        """Paper §4.2 held-out evaluation via the learned partition."""
        return engine.evaluate(self._st, test_sets, true_cluster)

    # ------------------------------------------------------------- §4.4 / §5
    def join_client(self, batch) -> int:
        """§5 dynamic join (Ψ-inference placement); returns the new id."""
        self._st, cid = engine.join(self._st, batch)
        return cid

    def leave_client(self, cid: int) -> None:
        """§5 departure: stop sampling ``cid``, repair the partition."""
        self._st = engine.leave(self._st, cid)

    def sample_clients(self) -> np.ndarray:
        """Draw one round's cohort (advances the stored rng)."""
        adv, ids = engine.sample_clients(self._st)
        self._st = engine.advance_rng(self._st, adv)
        return ids

    def infer_new_client(self, batch):
        """Cluster inference for a newly-joined client (§4.4)."""
        return engine.infer(self._st, batch)
