"""Functional engine API: pure transitions over ``ServerState``.

    state = engine.init("stocfl", loss_fn, params, clients, cfg, eval_fn=acc)
    state, rec = engine.run_round(state)            # samples internally
    state, rec = engine.run_round(state, [0, 3, 7]) # or explicit cohort
    state, cid = engine.join(state, new_batch)      # §5 dynamic membership
    state = engine.leave(state, cid)
    engine.evaluate(state, test_sets, true_cluster)
    engine.infer(state, unseen_batch)               # §4.4 cluster inference
    engine.infer_batch(state, [b1, b2, b3])         # many at once

The engine runs on ``cuda`` unless ``init`` is given another device
(``device="cpu"``); with no GPU and no device given, ``init`` raises.
Every transition returns a NEW state; ``join`` also appends to the
context's client list (the context is the world, not the state). Client
sampling draws from the numpy bit-generator state stored in the state, so
cohorts equal the JAX package's for the same seed.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.extractor import make_extractor
from repro_torch.data.arena import ClientArena
from repro_torch.engine.registry import get_strategy
from repro_torch.engine.state import (EngineConfig, EngineContext, ServerState,
                                      resolve_device)
from repro_torch.utils import trees


def _on_device(tree, device: torch.device):
    """Arrays or tensors -> tensors on ``device`` (dtypes kept)."""
    def leaf(x):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.array(x))
        return x.to(device)

    return trees.tree_map(leaf, tree)


def init(strategy: str, loss_fn, init_params, clients,
         cfg: Optional[EngineConfig] = None, eval_fn=None,
         device=None, arena: bool = False, leaf_filter=None) -> ServerState:
    """Build the static context and the strategy's initial ``ServerState``.

    Args:
      strategy: registered strategy name (``engine.list_strategies()``):
        ``"stocfl"`` (Algorithm 1) or one of the paper's §4 baselines,
        ``"fedavg"``, ``"fedprox"``, ``"ditto"``, ``"ifca"``, ``"cfl"``.
      loss_fn: ``(params, batch) -> scalar tensor`` local objective f_i,
        written for one client (the engine vmaps it over the cohort).
      init_params: ω₀ — also the frozen Ψ anchor (§3.1) and the lazy
        cluster-model default θ_k. A tree of arrays or tensors.
      clients: list of client datasets (trees with a shared leading
        example axis), numpy or tensors; copied onto the device.
      cfg: ``EngineConfig`` hyperparameters.
      eval_fn: optional ``(params, batch) -> accuracy`` for ``evaluate``.
      device: where the engine runs; ``None`` means ``cuda`` and raises
        when no GPU is present.
      arena: pack all client shards into a device-resident ``ClientArena``
        so each round's cohort is one gather instead of a restack (ragged
        shard sizes are pad-and-masked; the loss must then honour the
        batch's ``"mask"`` leaf). ``cfg.cohort_chunk`` bounds how many
        clients one cohort step runs (``bilevel.chunk_map``).
      leaf_filter: optional Ψ restriction to a parameter subset, called
        with each leaf's ``/``-joined path (LLM anchors:
        ``extractor.llm_leaf_filter``).
    """
    cfg = cfg or EngineConfig()
    dev = resolve_device(device)
    params = _on_device(init_params, dev)
    ctx = EngineContext(loss_fn=loss_fn, init_params=params,
                        clients=[_on_device(c, dev) for c in clients],
                        cfg=cfg, device=dev, eval_fn=eval_fn,
                        leaf_filter=leaf_filter)
    if arena:
        ctx.arena = ClientArena.from_clients(ctx.clients, device=dev)
    strat = get_strategy(strategy)
    if strat.needs_extractor:
        ctx.extractor = make_extractor(loss_fn, params, cfg.project_dim,
                                       leaf_filter=leaf_filter)
    return strat.init_state(ctx)


def sample_clients(state: ServerState, unavailable=frozenset()):
    """Draw one round's cohort without replacement (§3.3): ``sample_rate``
    × the live population, from the rng stored in ``state`` — the same
    draw as the JAX package's numpy backend. Returns (advanced
    bit-generator state, sampled client id array)."""
    cfg = state.ctx.cfg
    rng = state.rng()
    pool = np.array([i for i in range(state.n_clients)
                     if i not in state.left and i not in unavailable])
    live = state.n_clients - len(state.left)
    m = max(int(round(cfg.sample_rate * live)), 1)
    ids = rng.choice(pool, size=min(m, len(pool)), replace=False)
    return rng.bit_generator.state, ids


def advance_rng(state: ServerState, rng_state: dict) -> ServerState:
    """Store an advanced sampling rng (the bit-generator state that
    ``sample_clients`` returned first) back into the state."""
    return state.replace(rng_state=rng_state)


def run_round(state: ServerState, client_ids: Optional[Sequence[int]] = None):
    """One server round: ``(state, client_ids?) -> (state', metrics)``.

    With ``client_ids=None`` the cohort is sampled internally (advancing
    the state's rng; full-participation strategies take every live client
    and leave the rng untouched); an explicit cohort leaves the rng
    untouched."""
    strat = get_strategy(state.strategy)
    rng_state = state.rng_state
    if client_ids is None:
        if strat.full_participation:
            client_ids = np.array([i for i in range(state.n_clients)
                                   if i not in state.left])
        else:
            rng_state, client_ids = sample_clients(state)
    client_ids = np.asarray(client_ids)
    if client_ids.size == 0:
        raise ValueError("run_round needs a non-empty cohort "
                         "(no clients sampled — all departed?)")
    state, rec = strat.round(state.ctx, state, client_ids)
    state = state.replace(round=state.round + 1, rng_state=rng_state,
                          history=state.history + (dict(rec),))
    return state, rec


def run(state: ServerState, rounds: int, log_every: int = 0) -> ServerState:
    """``rounds`` × ``run_round`` with optional progress printing every
    ``log_every`` rounds. Returns the final state."""
    for t in range(rounds):
        state, rec = run_round(state)
        if log_every and t % log_every == 0:
            extras = "".join(f" {k}={v:.3f}" if isinstance(v, float) else f" {k}={v}"
                             for k, v in rec.items())
            print(f"round {t}:{extras}")
    return state


def evaluate(state: ServerState, test_sets, true_cluster=None) -> dict:
    """Strategy-appropriate held-out evaluation (paper §4.2 protocol):
    ``{latent cluster id: batch}`` test sets, routed through the learned
    cluster holding most of each latent cluster's clients."""
    dev = state.ctx.device
    test_sets = {k: _on_device(b, dev) for k, b in test_sets.items()}
    return get_strategy(state.strategy).evaluate(state.ctx, state,
                                                 test_sets, true_cluster)


def join(state: ServerState, batch):
    """Register a newly-arrived client (§5); StoCFL places it by Ψ
    inference against the existing partition. Returns (state', new id)."""
    batch = _on_device(batch, state.ctx.device)
    return get_strategy(state.strategy).join(state.ctx, state, batch)


def leave(state: ServerState, cid: int) -> ServerState:
    """Remove a client from the federation (§5 departures)."""
    return get_strategy(state.strategy).leave(state.ctx, state, cid)


def infer(state: ServerState, batch) -> dict:
    """Cluster inference for an UNSEEN client (§4.4), without joining:
    ``{"cluster", "seed_from", "similarity", "model"}``."""
    batch = _on_device(batch, state.ctx.device)
    return get_strategy(state.strategy).infer(state.ctx, state, batch)


def infer_batch(state: ServerState, batches) -> list:
    """Batched §4.4 cluster inference: Ψ of each unseen-client batch, then
    one nearest pass for all of them. Returns one ``infer``-shaped dict per
    batch, in order."""
    dev = state.ctx.device
    return get_strategy(state.strategy).infer_many(
        state.ctx, state, [_on_device(b, dev) for b in batches])
