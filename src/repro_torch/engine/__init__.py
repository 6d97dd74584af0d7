"""Functional federated engine of the port (see ``engine.api``): StoCFL
and the paper's baselines (``fedavg``, ``fedprox``, ``ditto``, ``ifca``,
``cfl``) as registered ``Strategy`` objects over pure ``ServerState``
transitions, with ``run_rounds`` running a span of rounds as one
captured round body on the card. ``run_round_async`` removes the round
barrier: deltas report back late through an ``AsyncBuffer`` and merge
staleness-weighted, bitwise ``run_round`` at zero delay
(``repro_torch.engine.async_agg``)."""
from repro_torch.engine import sampler, strategies  # noqa: F401  (installs the registry)
from repro_torch.engine.api import (AsyncConfig, advance_rng, evaluate, infer,
                                    infer_batch, init, join, leave, run, run_round,
                                    run_round_async, run_rounds, sample_clients,
                                    scan_blockers, scan_history, scan_program)
from repro_torch.engine.async_agg import AsyncBuffer, FlushBatch, staleness_weights
from repro_torch.engine.bank import ClusterBank
from repro_torch.engine.registry import (STRATEGIES, get_strategy,
                                         list_strategies, register)
from repro_torch.engine.state import (EngineConfig, EngineContext, ServerState,
                                      fresh_rng_key, resolve_device)
from repro_torch.engine.strategies import Strategy

__all__ = ["AsyncBuffer", "AsyncConfig", "ClusterBank", "EngineConfig", "EngineContext",
           "FlushBatch", "STRATEGIES", "ServerState", "Strategy", "advance_rng",
           "evaluate", "fresh_rng_key", "get_strategy", "infer", "infer_batch", "init",
           "join", "leave", "list_strategies", "register", "resolve_device", "run",
           "run_round", "run_round_async", "run_rounds", "sample_clients", "sampler",
           "scan_blockers", "scan_history", "scan_program", "staleness_weights"]
