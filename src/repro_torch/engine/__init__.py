"""Functional federated engine of the port (see ``engine.api``)."""
from repro_torch.engine import strategies  # noqa: F401  (registers "stocfl")
from repro_torch.engine.api import (evaluate, infer, infer_batch, init, join,
                                    leave, run, run_round, sample_clients)
from repro_torch.engine.registry import get_strategy, list_strategies
from repro_torch.engine.state import (EngineConfig, EngineContext, ServerState,
                                      resolve_device)

__all__ = ["EngineConfig", "EngineContext", "ServerState", "evaluate",
           "get_strategy", "infer", "infer_batch", "init", "join", "leave",
           "list_strategies", "resolve_device", "run", "run_round",
           "sample_clients"]
