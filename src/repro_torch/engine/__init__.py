"""Functional federated engine of the port (see ``engine.api``): StoCFL
and the paper's baselines (``fedavg``, ``fedprox``, ``ditto``, ``ifca``,
``cfl``) as registered ``Strategy`` objects over pure ``ServerState``
transitions."""
from repro_torch.engine import strategies  # noqa: F401  (installs the registry)
from repro_torch.engine.api import (advance_rng, evaluate, infer, infer_batch,
                                    init, join, leave, run, run_round,
                                    sample_clients)
from repro_torch.engine.bank import ClusterBank
from repro_torch.engine.registry import (STRATEGIES, get_strategy,
                                         list_strategies, register)
from repro_torch.engine.state import (EngineConfig, EngineContext, ServerState,
                                      resolve_device)
from repro_torch.engine.strategies import Strategy

__all__ = ["ClusterBank", "EngineConfig", "EngineContext", "STRATEGIES",
           "ServerState", "Strategy", "advance_rng", "evaluate", "get_strategy",
           "infer", "infer_batch", "init", "join", "leave", "list_strategies",
           "register", "resolve_device", "run", "run_round", "sample_clients"]
