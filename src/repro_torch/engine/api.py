"""Functional engine API: pure transitions over ``ServerState``.

    state = engine.init("stocfl", loss_fn, params, clients, cfg, eval_fn=acc)
    state, rec = engine.run_round(state)            # samples internally
    state, rec = engine.run_round(state, [0, 3, 7]) # or explicit cohort
    state, cid = engine.join(state, new_batch)      # §5 dynamic membership
    state = engine.leave(state, cid)
    engine.evaluate(state, test_sets, true_cluster)
    engine.infer(state, unseen_batch)               # §4.4 cluster inference
    engine.infer_batch(state, [b1, b2, b3])         # many at once

    state = engine.run_rounds(state, 20)            # a captured multi-round span
    state, rec = engine.run_round_async(state, delays=[0, 2, 1])  # buffered, late

The engine runs on ``cuda`` unless ``init`` is given another device
(``device="cpu"``); with no GPU and no device given, ``init`` raises.
Every transition returns a NEW state; ``join`` also appends to the
context's client list (the context is the world, not the state). Client
sampling draws from the rng stored in the state: the numpy bit-generator
under ``rng_backend="numpy"``, a threefry key on the device under
``rng_backend="device"`` (``engine.sampler``); either way the cohorts
equal the JAX package's for the same seed.

``run_rounds`` runs a span of rounds with no host round trip between
them: on the card it captures one round body (the strategy's
``scan_round`` step) in a CUDA graph and replays it once a round; on the
CPU the same step runs as a plain loop. It matches the eager
``run_round`` loop.
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.extractor import make_extractor
from repro_torch.data.arena import ClientArena
from repro_torch.engine import sampler
from repro_torch.engine.async_agg import AsyncConfig, run_round_async  # noqa: F401
from repro_torch.engine.registry import get_strategy
from repro_torch.engine.state import (EngineConfig, EngineContext, ServerState,
                                      cast_floating, compute_dtype, on_device,
                                      resolve_device)
from repro_torch.kernels import _build
from repro_torch.sharding import specs as shard_specs


def init(strategy: str, loss_fn, init_params, clients,
         cfg: Optional[EngineConfig] = None, eval_fn=None,
         device=None, arena: bool = False, leaf_filter=None,
         mesh=None) -> ServerState:
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
      mesh: optional client-axis ``DeviceMesh`` (``launch.mesh.
        make_client_mesh``), one process per rank. Each rank trains its
        contiguous slice of every cohort (the whole cohort where its size
        does not divide the ranks), every cross-client reduction is a
        local partial sum plus one ``all_reduce``, and everything else is
        computed on every rank, so after every round the state is the
        same on every rank. The engine runs on the mesh's device
        (``sharding.mesh_device``); the arena's row capacity is aligned
        to the mesh. Every rank must make the same calls with the same
        arguments. A mesh of one rank gives the results of no mesh, bit
        for bit.

    With ``cfg.dtype`` other than "float32" the floating leaves of the
    parameters and of every client batch are cast to it; Ψ stays anchored
    at the fp32 parameters, so the representations, cluster means and the
    objective keep full precision.
    """
    cfg = cfg or EngineConfig()
    dev = _mesh_device(mesh, device) if mesh is not None else resolve_device(device)
    params = psi_anchor = on_device(init_params, dev)
    if cfg.dtype != "float32":
        params = cast_floating(params, compute_dtype(cfg.dtype))
    ctx = EngineContext(loss_fn=loss_fn, init_params=params, clients=[],
                        cfg=cfg, device=dev, eval_fn=eval_fn,
                        leaf_filter=leaf_filter, mesh=mesh)
    ctx.clients = [ctx.client_batch(c) for c in clients]
    if arena:
        # the row capacity aligned to the mesh, as the reference aligns it
        # for its row-split arena; pow2 growth keeps the alignment
        cap = (shard_specs.align_cohort_chunk(len(ctx.clients), mesh)
               if mesh is not None else None)
        ctx.arena = ClientArena.from_clients(ctx.clients, capacity=cap,
                                             device=dev).place(mesh)
    strat = get_strategy(strategy)
    if strat.needs_extractor:
        ctx.extractor = make_extractor(loss_fn, psi_anchor, cfg.project_dim,
                                       leaf_filter=leaf_filter)
    return strat.init_state(ctx)


def _mesh_device(mesh, device) -> torch.device:
    """The engine's device under a mesh: the mesh's (this rank's), which a
    given ``device`` must agree with in type."""
    dev = shard_specs.mesh_device(mesh)
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"device {device!r} does not match the mesh's {dev.type!r} ranks")
    return dev


def sample_clients(state: ServerState, unavailable=frozenset()):
    """Draw one round's cohort without replacement (§3.3): ``sample_rate``
    × the live population, from the rng stored in ``state``.
    ``unavailable`` removes clients from the pool for this draw only.
    Under ``rng_backend="numpy"`` this is the JAX package's numpy draw
    (size ``round(rate·live)``); under ``rng_backend="device"`` it is the
    threefry draw (``engine.sampler``, size ⌈rate·live⌉) that a captured
    round body makes too. Returns (advanced rng: bit-generator state or
    device key, sampled client id array); thread the first element back
    with ``advance_rng``."""
    cfg = state.ctx.cfg
    live = state.n_clients - len(state.left)
    if cfg.rng_backend == "device":
        pool = sampler.cohort_pool(state.n_clients, state.left, unavailable,
                                   capacity=sampler.pool_capacity(state.n_clients))
        m = sampler.cohort_size(cfg.sample_rate, live, int(pool.sum()))
        if m == 0:
            return state.rng_key, np.zeros(0, np.int64)
        key, ids = sampler.draw_cohort(state.rng_key, pool, m)
        return key, ids.cpu().numpy().astype(np.int64)
    rng = state.rng()
    pool = np.array([i for i in range(state.n_clients)
                     if i not in state.left and i not in unavailable])
    m = max(int(round(cfg.sample_rate * live)), 1)
    ids = rng.choice(pool, size=min(m, len(pool)), replace=False)
    return rng.bit_generator.state, ids


def advance_rng(state: ServerState, rng) -> ServerState:
    """Store an advanced sampling rng back into the state: the
    bit-generator state (numpy backend) or the split device key (device
    backend), whichever ``sample_clients`` returned first."""
    if state.ctx.cfg.rng_backend == "device":
        return state.replace(rng_key=rng)
    return state.replace(rng_state=rng)


def run_round(state: ServerState, client_ids: Optional[Sequence[int]] = None):
    """One server round: ``(state, client_ids?) -> (state', metrics)``.

    With ``client_ids=None`` the cohort is sampled internally (advancing
    the state's rng; full-participation strategies take every live client
    and leave the rng untouched); an explicit cohort leaves the rng
    untouched."""
    strat = get_strategy(state.strategy)
    rng_state, rng_key = state.rng_state, state.rng_key
    if client_ids is None:
        if strat.full_participation:
            client_ids = np.array([i for i in range(state.n_clients)
                                   if i not in state.left])
        elif state.ctx.cfg.rng_backend == "device":
            rng_key, client_ids = sample_clients(state)
        else:
            rng_state, client_ids = sample_clients(state)
    client_ids = np.asarray(client_ids)
    if client_ids.size == 0:
        raise ValueError("run_round needs a non-empty cohort "
                         "(no clients sampled — all departed or "
                         "unavailable?); the scanned loop handles this "
                         "as a skipped no-op round instead "
                         "(see run_rounds)")
    state, rec = strat.round(state.ctx, state, client_ids)
    state = state.replace(round=state.round + 1, rng_state=rng_state,
                          rng_key=rng_key, history=state.history + (dict(rec),))
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


def scan_blockers(state: ServerState) -> Optional[str]:
    """Why this state cannot run through ``run_rounds``: a readable reason,
    or None when it can. The step needs a device arena (cohort gathers by
    device ids), device rng for sampled strategies, the device clustering
    backend for StoCFL, and every live client resident in the arena."""
    from repro_torch.engine.strategies import Strategy

    strat = get_strategy(state.strategy)
    ctx = state.ctx
    if type(strat).scan_round is Strategy.scan_round:
        return (f"strategy {state.strategy!r} has no scannable round "
                "step (Strategy.scan_round not implemented) — use the "
                "eager run_round loop")
    if ctx.arena is None:
        return ("run_rounds needs engine.init(..., arena=True): "
                "the scanned round body gathers cohorts on device")
    if not strat.full_participation and state.rng_key is None:
        return ("run_rounds needs EngineConfig(rng_backend='device'): "
                "the scan samples cohorts from the threefry key in "
                "ServerState.rng_key (the numpy bit-generator cannot "
                "be traced)")
    if state.strategy == "stocfl" and ctx.cfg.cluster_backend != "device":
        return ("run_rounds('stocfl') needs "
                "EngineConfig(cluster_backend='device'): the host "
                "ClusterState cannot ride a lax.scan carry")
    bad = [c for c in range(state.n_clients) if c not in state.left
           and ctx.arena.rows[c] < 0]
    if bad:
        return (f"live clients {bad} were compacted out of the arena — "
                "rebuild it before scanning")
    if (ctx.mesh is not None and ctx.device.type == "cuda"
            and shard_specs.mesh_backend(ctx.mesh) != "nccl"):
        return (f"run_rounds on the card captures the round, collectives "
                f"included, in a CUDA graph, and a "
                f"{shard_specs.mesh_backend(ctx.mesh)!r} group cannot be captured "
                "(it synchronises the host); use an 'nccl' group, or the eager "
                "run_round loop")
    return None


def run_rounds(state: ServerState, rounds: int, unavailable=frozenset()) -> ServerState:
    """``rounds`` × ``run_round`` as one span with no host round trip
    between rounds: each round samples its cohort on the device
    (``engine.sampler.draw``), gathers it from the arena, runs the
    strategy's round step (``Strategy.scan_round``) and aggregates. On the
    card the step is captured once in a CUDA graph and replayed once a
    round; on the CPU it runs as a plain loop. The records land in
    ``state.history`` as the eager loop records them (StoCFL's without
    the eager ``merges`` key).

    Requirements (``scan_blockers``): ``arena=True``,
    ``rng_backend="device"`` for sampled strategies and
    ``cluster_backend="device"`` for StoCFL. ``join`` / ``leave`` go
    between calls. ``unavailable`` holds a constant set of clients out of
    every draw; if that empties the pool the rounds are recorded as
    skipped no-ops (``{"skipped": True, "sampled": 0}``) where the eager
    loop raises. Full-participation strategies (CFL) ignore it."""
    rounds = int(rounds)
    if rounds <= 0:
        return state
    program = scan_program(state, rounds, unavailable)
    if program is None:
        recs = tuple({"skipped": True, "sampled": 0} for _ in range(rounds))
        return state.replace(round=state.round + rounds, history=state.history + recs)
    fn, carry0, consts, finalize = program
    carry, ys = fn(carry0, consts)
    return finalize(state, carry, ys, rounds)


def scan_program(state: ServerState, rounds: int, unavailable=frozenset()):
    """Prepare (but do not run) ``run_rounds``' span: returns ``(fn,
    carry0, consts, finalize)``, or None when the pool is empty.
    ``fn(carry0, consts) -> (carry, ys)`` runs the ``rounds`` rounds, all
    operands and results on the device (``ys``: ``{key: (rounds,)
    tensor}``); ``finalize(state, carry, ys, rounds)`` is the only host
    hand-off. The round program (on the card: the captured graph) is
    cached on the context under the strategy, the cohort size, the carry
    and const shapes and the step's statics; the span length is not part
    of the key, since the graph holds one round. Raises ``ValueError``
    (``scan_blockers``) when the state cannot scan."""
    strat = get_strategy(state.strategy)
    ctx = state.ctx
    rounds = int(rounds)
    blocker = scan_blockers(state)
    if blocker is not None:
        raise ValueError(blocker)
    live = state.n_clients - len(state.left)
    # the pool is pow2-padded exactly like the eager device draw, so both
    # paths draw from the same uniform shape
    capw = sampler.pool_capacity(state.n_clients)
    if strat.full_participation:
        pool = sampler.cohort_pool(state.n_clients, state.left, (), capacity=capw)
        m = int(pool.sum())
    else:
        pool = sampler.cohort_pool(state.n_clients, state.left, unavailable,
                                   capacity=capw)
        m = sampler.cohort_size(ctx.cfg.sample_rate, live, int(pool.sum()))
    if m == 0:
        return None
    carry0, consts, step, finalize, statics = strat.scan_round(ctx, state, pool, m)
    # a program captured under one mesh (or none) is never replayed under
    # another: its collectives are baked into the graph
    statics = statics + (shard_specs.mesh_fingerprint(ctx.mesh),)
    shapes = tuple((tuple(x.shape), str(x.dtype)) for x in _leaves((carry0, consts)))
    cache_key = (f"scan:{state.strategy}:{m}:"
                 f"{hash((_structure((carry0, consts)), shapes, statics))}")
    program = ctx.cached(cache_key, lambda: RoundProgram(step, ctx.device, ctx.mesh))
    return (lambda c0, cs: program(c0, cs, rounds)), carry0, consts, finalize


def scan_history(ys, rounds: int):
    """Stacked step records (``{key: (rounds,) tensor}``) -> the eager
    loop's history records (one ``{key: int | float}`` dict a round)."""
    host = {k: v.cpu().numpy() for k, v in ys.items()}
    recs = []
    for t in range(rounds):
        rec = {}
        for k, v in host.items():
            x = v[t]
            rec[k] = int(x) if np.issubdtype(x.dtype, np.integer) else float(x)
        recs.append(rec)
    return tuple(recs)


def _leaves(tree) -> list:
    """Tensors of a carry / consts tree (tuples, lists and dicts, keys
    sorted), in order."""
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _structure(tree):
    if isinstance(tree, (tuple, list)):
        return tuple(_structure(t) for t in tree)
    if isinstance(tree, dict):
        return tuple((k, _structure(tree[k])) for k in sorted(tree))
    return "*"


def _rebuild(tree, leaves):
    """``tree``'s structure holding ``leaves`` (in ``_leaves`` order)."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, (tuple, list)):
            return type(node)(walk(t) for t in node)
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return next(it)

    return walk(tree)


@contextlib.contextmanager
def _sync_errors():
    """``torch.cuda.set_sync_debug_mode("error")`` for the block: any host
    sync raises."""
    was = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(was)


def capture_graph(stream, fn):
    """Capture ``fn()`` into a new CUDA graph on ``stream`` under sync-debug
    mode "error". The kernels' launch counters count at capture, so the
    launches the capture recorded are taken back off and returned for the
    caller to add once per replay. Returns (graph, ``fn``'s result, the
    launches of one replay, the capture's host seconds)."""
    before = _build.launch_counts()
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        with _sync_errors():
            out = fn()
    seconds = time.perf_counter() - t0
    after = _build.launch_counts()
    per_replay = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    _build.add_launches(per_replay, -1)
    return graph, out, per_replay, seconds


class RoundProgram:
    """A strategy's round step run ``rounds`` times: ``program(carry0,
    consts, rounds) -> (carry, ys)``.

    On the CPU the step runs as a plain loop. On the card the program owns
    static carry and const tensors, into which each call copies its
    operands. The first call runs round 0 eagerly on a side stream (the
    warm-up: autograd, ``vmap`` and the kernels' arrival counters are set
    up there), then captures one step into a ``torch.cuda.CUDAGraph`` on
    that stream, the step writing its new carry into the static carry with
    ``copy_``; every later round is one replay, followed by a queued
    device-to-device copy of its record into a (rounds, ...) buffer. Both
    the warm-up and the capture run under sync-debug mode "error", so a
    host sync left in the step raises, and a capture that fails raises:
    there is no eager fallback. The kernels' launch counters are kept
    true under capture (``_build.add_launches``): ``per_round`` holds the
    launches one replay makes. The returned carry is a copy, so the
    states it goes into never alias the program's buffers. Under a
    ``mesh`` (an NCCL group on the card) the step's all-reduces are
    captured too; one all-reduce before the warm-up makes the
    communicator, which must exist before a capture."""

    def __init__(self, step, device: torch.device, mesh=None):
        self.step = step
        self.device = torch.device(device)
        self.mesh = mesh
        self.graph = None
        self.stream = None
        self.carry = self.consts = self.record = None
        self.per_round: dict = {}
        self.capture_s: Optional[float] = None   # host seconds of the capture

    def __call__(self, carry0, consts, rounds: int):
        if rounds < 1:
            raise ValueError(f"a span runs at least one round, got {rounds}")
        if self.device.type != "cuda":
            carry, recs = carry0, []
            for _ in range(rounds):
                carry, rec = self.step(carry, consts)
                recs.append(rec)
            return carry, {k: torch.stack([r[k] for r in recs]) for k in recs[0]}
        return self._replay(carry0, consts, rounds)

    @staticmethod
    def _copy_into(static, values) -> None:
        for dst, src in zip(_leaves(static), _leaves(values)):
            if dst is not src:
                dst.copy_(src)

    def _replay(self, carry0, consts, rounds):
        main = torch.cuda.current_stream(self.device)
        if self.carry is None:
            if self.mesh is not None:
                shard_specs.barrier(self.mesh, self.device)
            self.stream = torch.cuda.Stream(self.device)
            self.carry = _rebuild(carry0, [x.clone() for x in _leaves(carry0)])
            self.consts = _rebuild(consts, [x.clone() for x in _leaves(consts)])
        else:
            self._copy_into(self.carry, carry0)
            self._copy_into(self.consts, consts)
        self.stream.wait_stream(main)
        done = 0
        with torch.cuda.stream(self.stream):
            if self.graph is None:
                with _sync_errors():
                    new, rec = self.step(self.carry, self.consts)
                    self._copy_into(self.carry, new)
                ys = {k: v.new_empty((rounds,) + tuple(v.shape)) for k, v in rec.items()}
                for k, v in rec.items():
                    ys[k][0].copy_(v)
                del new, rec
                done = 1
                if rounds > 1:
                    self._capture()
            else:
                ys = {k: v.new_empty((rounds,) + tuple(v.shape))
                      for k, v in self.record.items()}
        main.wait_stream(self.stream)
        for y in ys.values():
            y.record_stream(main)
        for t in range(done, rounds):
            self.graph.replay()
            for k, v in self.record.items():
                ys[k][t].copy_(v)
            _build.add_launches(self.per_round)
        return _rebuild(self.carry, [x.clone() for x in _leaves(self.carry)]), ys

    def _capture(self) -> None:
        def body():
            new, rec = self.step(self.carry, self.consts)
            self._copy_into(self.carry, new)
            return rec

        self.graph, self.record, self.per_round, self.capture_s = \
            capture_graph(self.stream, body)


def evaluate(state: ServerState, test_sets, true_cluster=None) -> dict:
    """Strategy-appropriate held-out evaluation (paper §4.2 protocol):
    ``{latent cluster id: batch}`` test sets, routed through the learned
    cluster holding most of each latent cluster's clients."""
    dev = state.ctx.device
    test_sets = {k: on_device(b, dev) for k, b in test_sets.items()}
    return get_strategy(state.strategy).evaluate(state.ctx, state,
                                                 test_sets, true_cluster)


def join(state: ServerState, batch):
    """Register a newly-arrived client (§5); StoCFL places it by Ψ
    inference against the existing partition. Returns (state', new id)."""
    batch = on_device(batch, state.ctx.device)
    return get_strategy(state.strategy).join(state.ctx, state, batch)


def leave(state: ServerState, cid: int) -> ServerState:
    """Remove a client from the federation (§5 departures)."""
    return get_strategy(state.strategy).leave(state.ctx, state, cid)


def infer(state: ServerState, batch) -> dict:
    """Cluster inference for an UNSEEN client (§4.4), without joining:
    ``{"cluster", "seed_from", "similarity", "model"}``."""
    batch = on_device(batch, state.ctx.device)
    return get_strategy(state.strategy).infer(state.ctx, state, batch)


def infer_batch(state: ServerState, batches) -> list:
    """Batched §4.4 cluster inference: Ψ of each unseen-client batch, then
    one nearest pass for all of them. Returns one ``infer``-shaped dict per
    batch, in order."""
    dev = state.ctx.device
    return get_strategy(state.strategy).infer_many(
        state.ctx, state, [on_device(b, dev) for b in batches])
