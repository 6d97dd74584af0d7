"""Baselines the paper compares against (§4.2): deprecated class shims.

The methods live in ``repro_torch.engine.strategies`` as registry entries
("fedavg", "fedprox", "ditto", "ifca", "cfl") over the same cohort
primitives as StoCFL. These classes keep the JAX package's object surface
for existing callers; new code uses the functional engine API:

    state = engine.init("fedavg", loss_fn, params, clients, cfg, eval_fn=acc)
    state, rec = engine.run_round(state)

Each shim passes ``device`` through to ``engine.init`` (``None`` = cuda).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

# Module-object import only (see stocfl.py: the engine <-> core import cycle).
from repro_torch import engine


@dataclasses.dataclass
class FLConfig:
    lr: float = 0.1
    local_steps: int = 5
    sample_rate: float = 0.1
    seed: int = 0
    mu: float = 0.05          # FedProx / Ditto prox weight


class _EngineShim:
    """Common shell: holds one ``ServerState``, delegates every method."""

    strategy: str = ""

    def __init__(self, loss_fn, init_params, clients, cfg: FLConfig,
                 eval_fn=None, device=None, **extra):
        self.cfg = cfg
        ecfg = engine.EngineConfig(lr=cfg.lr, local_steps=cfg.local_steps,
                                   sample_rate=cfg.sample_rate, seed=cfg.seed,
                                   mu=cfg.mu, **extra)
        self._st = engine.init(self.strategy, loss_fn, init_params, clients,
                               ecfg, eval_fn=eval_fn, device=device)

    # ---------------------------------------------------------- state views
    @property
    def server_state(self) -> engine.ServerState:
        return self._st

    @property
    def clients(self):
        return self._st.ctx.clients

    @property
    def n(self) -> int:
        return self._st.n_clients

    @property
    def sizes(self) -> np.ndarray:
        return np.asarray(self._st.sizes)

    @property
    def init_params(self):
        return self._st.ctx.init_params

    @property
    def loss_fn(self):
        return self._st.ctx.loss_fn

    @property
    def eval_fn(self):
        return self._st.ctx.eval_fn

    # ------------------------------------------------------------- driving
    def sample(self) -> np.ndarray:
        adv, ids = engine.sample_clients(self._st)
        self._st = engine.advance_rng(self._st, adv)
        return ids

    def round(self, ids: Optional[Sequence[int]] = None):
        self._st, rec = engine.run_round(self._st, ids)
        return rec

    def fit(self, rounds: int):
        for _ in range(rounds):
            self.round()
        return self

    def evaluate(self, test_sets, true_cluster=None):
        return engine.evaluate(self._st, test_sets, true_cluster)


class FedAvg(_EngineShim):
    """Single-global-model FedAvg (the λ=0 ∧ τ=−1 degeneration)."""
    strategy = "fedavg"

    @property
    def global_params(self):
        """The global model ω."""
        return self._st.omega

    @global_params.setter
    def global_params(self, value):
        self._st = self._st.replace(omega=value)


class FedProx(FedAvg):
    """FedAvg with a prox term to the broadcast global (μ = cfg.mu)."""
    strategy = "fedprox"


class Ditto(FedAvg):
    """Global FedAvg + per-client personal models with prox to global."""
    strategy = "ditto"

    @property
    def personal(self):
        """{client id: personal model} (prox-to-global, τ=1 regime)."""
        return self._st.personal


class IFCA(_EngineShim):
    """Ghosh et al. 2020: M̃ hypothesis models, clients pick argmin loss."""
    strategy = "ifca"

    def __init__(self, loss_fn, init_params, clients, cfg, eval_fn=None,
                 n_models: int = 4, init_key: int = 0, device=None):
        super().__init__(loss_fn, init_params, clients, cfg, eval_fn=eval_fn,
                         device=device, n_models=n_models, init_key=init_key)
        self.n_models = n_models

    @property
    def models(self):
        """The M̃ hypothesis models, index-ordered."""
        return [self._st.models[m] for m in range(self.n_models)]


class CFLSattler(_EngineShim):
    """Sattler et al. 2020a recursive bi-partitioning (full participation)."""
    strategy = "cfl"

    def __init__(self, loss_fn, init_params, clients, cfg, eval_fn=None,
                 eps_rel: float = 0.35, eps2: float = 0.01, device=None):
        super().__init__(loss_fn, init_params, clients, cfg, eval_fn=eval_fn,
                         device=device, eps_rel=eps_rel, eps2=eps2)
        self.eps_rel, self.eps2 = eps_rel, eps2

    @property
    def clusters(self):
        """Member client-id lists, one per current cluster."""
        return [list(m) for m in self._st.members]

    @property
    def models(self):
        """Per-cluster models, index-aligned with ``clusters``."""
        return [self._st.models[k] for k in range(len(self._st.members))]

    def cluster_of(self, cid: int) -> int:
        """Index of the cluster client ``cid`` belongs to."""
        return engine.get_strategy("cfl").cluster_of(self._st, cid)
