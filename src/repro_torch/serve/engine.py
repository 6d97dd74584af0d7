"""The continuous-batching cluster-routed serving engine.

``ServeEngine`` glues the three layers together: the ``Router`` decides
WHICH cluster serves a client (Ψ-cosine, cached per client), the
``SlotScheduler`` decides WHEN (FIFO admission into a fixed
``clusters × slots`` lane grid, free-on-finish), and the ``DecodeSlots``
transitions from ``serve.slots`` do the work (grouped prefill → insert →
ONE decode step advancing every lane of every cluster model together).

The loop shape is continuous batching: admit everything that fits, run
decode bursts exactly until the next slot frees (the scheduler's host
mirror knows when — greedy decode with a fixed ``gen`` budget finishes
deterministically, so no device polling), harvest the finished lanes
(ONE device→host copy per request), re-admit, repeat. A prefill group
runs exactly its own rows: the reference pads groups to pow2 sizes to
bound its jit compile set, and the port's eager prefill has none. An MoE
model routes each request of a prefill group in groups of its own
(``slots.request_grouped``) and each decode lane as a group of one, so
capacity drops never depend on which requests share a step and the
tokens equal ``SequentialLoop``'s.

Heterogeneous cluster models are served from ONE decode step: the
per-cluster personalized params are stacked on a leading axis and the
step ``vmap``s over it, so a batch window mixes clusters freely — each
lane attends with its own cluster's weights. On the card the step is a
CUDA graph captured once over the engine's buffers (``slots.DecodeGraph``)
and a burst of n steps is n replays; on the CPU it runs eagerly. The port
of the JAX package's ``serve/engine.py``.

Under a client-axis mesh (``ServeEngine(mesh=make_client_mesh())``, one
process per rank) each rank serves its ``row_split`` of the K cluster
groups (the reference's ``place_decode_state``): its decode lanes are those
groups' alone, and its decode step runs over their stacked parameters
alone. Those parameters are the rows of the ``ServerState``'s bank
placed on the mesh (``ClusterBank.place``), with no copy: a state built
placed (``launch.serve.build_server_state(..., mesh=...)``,
``checkpoint.load_server_state(..., mesh=...)``) holds only the rank's
groups' weights, so both the lanes' memory and the weights' a rank holds
fall as ranks are added; a whole bank is placed here as views of its
rows. The router, the scheduler and the routes stay replicated: every
rank routes the same requests to the same groups and keeps the same
bookkeeping, but prefills and inserts only the requests of its own
groups. At each harvest (and at ``evict``)
the lanes' output tokens are gathered to every rank in one collective
(``RowSplit.gather``), so ``run`` returns the same results on every
rank. Where K does not divide the ranks,
nothing is split and no collective runs (the reference's relaxation).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.engine.bank import ClusterBank
from repro_torch.serve.router import Route, Router
from repro_torch.serve.scheduler import Request, SlotScheduler
from repro_torch.serve.slots import (DecodeGraph, alloc_slots, clear_slots, harvest,
                                     make_decode_step, make_insert, make_prefill)
from repro_torch.sharding.specs import row_split
from repro_torch.utils import trees

__all__ = ["ServeConfig", "RequestResult", "ServeEngine"]

_TOKEN_ARCHS = ("dense", "moe", "ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving knobs: ``slots`` concurrent lanes per cluster group,
    ``max_len`` cache context budget per lane (prompt + generated),
    ``max_gen`` output-buffer budget (tokens emitted per request). (The
    reference's ``bucket`` and ``donate`` have no counterparts: the
    port's prefill is eager, so pow2 padding bounds no compile set, and
    it always writes its lanes in place.)"""
    slots: int = 8
    max_len: int = 128
    max_gen: int = 32


@dataclasses.dataclass
class RequestResult:
    """What a finished request gets back: the serving ``cluster`` root,
    the routing ``similarity``, ``accepted`` (cleared τ), the emitted
    ``tokens`` (host int32, length ``gen`` — or fewer if ``evicted``).
    ``gaps`` is set by ``SequentialLoop`` only: each token's top-2 logit
    gap (``baseline.near_tie_compare``)."""
    rid: Any
    cluster: int
    similarity: float
    accepted: bool
    tokens: np.ndarray
    evicted: bool = False
    gaps: Optional[np.ndarray] = None


def stack_cluster_models(state, roots):
    """The cluster models of ``roots`` stacked on a leading axis, in that
    order: views of the bank's rows when the bank holds exactly those
    roots first (a placed bank: first among the rows it holds; no copy: a
    bank's tensors are never written), else a stack of
    ``state.cluster_model`` (which raises ``RemoteRowError`` for a root
    whose row another rank holds)."""
    bank = state.models
    if isinstance(bank, ClusterBank) and all(bank.holds(r) for r in roots):
        lo = 0 if bank.split is None else bank.split.lo
        if bank.roots[lo:lo + len(roots)] == tuple(roots):
            return trees.tree_map(lambda x: x[:len(roots)], bank.stacked)
    return trees.tree_map(lambda *xs: torch.stack(xs),
                          *[state.cluster_model(r) for r in roots])


class ServeEngine:
    """Continuous-batching serving over a trained ``ServerState``.

    ``submit``/``submit_many`` route and enqueue requests; ``run``
    drives admission + decode bursts until everything queued has
    finished and returns ``{rid: RequestResult}`` for the requests that
    completed during the call; ``evict`` force-finishes a running
    request (partial tokens, lane freed); ``reset`` drops all lane and
    scheduler state but keeps the captured graph (the buffers are zeroed
    in place) and the routing cache; ``stats`` reports counters
    (admissions, prefill groups, decode steps, router hits/misses).
    ``captures`` counts the CUDA graphs this engine has captured; a
    ``reset`` keeps it, so a second capture shows. ``mesh``: a client-axis
    mesh (module docstring); ``split`` is this rank's share of the groups."""

    def __init__(self, model, state, cfg: ServeConfig = ServeConfig(), mesh=None):
        if model.cfg.arch_type not in _TOKEN_ARCHS:
            raise ValueError(
                f"serve engine is token-LM only (dense/moe/ssm/hybrid), "
                f"got arch_type={model.cfg.arch_type!r}")
        window = getattr(model.cfg, "sliding_window", None)
        if window and cfg.max_len > window:
            raise ValueError(
                f"max_len={cfg.max_len} exceeds the model's sliding "
                f"window ({window}); the modular cache layout would wrap")
        if not state.models:
            raise ValueError("ServerState has no cluster models to serve")
        self.model = model
        self.cfg = cfg
        self.device = state.ctx.device
        self.roots = sorted(state.models.keys())
        self._root_to_k = {r: k for k, r in enumerate(self.roots)}
        self.mesh = mesh
        self.split = row_split(len(self.roots), mesh)
        local = self.split.take(self.roots)
        if isinstance(state.models, ClusterBank) and self.split.sharded:
            # this rank's groups' rows: views where the bank is placed or
            # holds its roots in order
            state = state.replace(models=state.models.place(mesh))
        self._stacked = stack_cluster_models(state, local)
        self.router = Router(state)
        self._params_list = [state.cluster_model(r) for r in local]
        self._prefill = make_prefill(model)
        self._insert = make_insert(model)
        self._step = make_decode_step(model)
        self.sl = alloc_slots(model, len(local), cfg.slots, cfg.max_len,
                              cfg.max_gen, device=self.device)
        self._decode_graph: Optional[DecodeGraph] = None
        self.captures = 0
        self.sched = SlotScheduler(len(self.roots), cfg.slots)
        self._routes: Dict[Any, Route] = {}
        self.results: Dict[Any, RequestResult] = {}
        self.stats_ = {"admitted": 0, "prefill_groups": 0,
                       "decode_steps": 0, "harvested": 0, "evicted": 0}

    # ---- intake -------------------------------------------------------
    def submit(self, req: Request) -> Route:
        """Route one request and enqueue it on its cluster's queue."""
        return self.submit_many([req])[0]

    def submit_many(self, reqs: List[Request]) -> List[Route]:
        """Route an admission wave (cache misses batched through ONE
        ``engine.infer_batch`` pass) and enqueue every request on its
        routed cluster group's FIFO."""
        for req in reqs:
            if req.gen < 1 or req.gen > self.cfg.max_gen:
                raise ValueError(f"req {req.rid}: gen={req.gen} outside "
                                 f"[1, max_gen={self.cfg.max_gen}]")
            if len(req.prompt) + req.gen - 1 > self.cfg.max_len:
                raise ValueError(
                    f"req {req.rid}: prompt {len(req.prompt)} + gen "
                    f"{req.gen} - 1 exceeds max_len={self.cfg.max_len}")
        routes = self.router.route_many([(r.client_id, r.history) for r in reqs])
        for req, rt in zip(reqs, routes):
            if rt.root is None:
                raise ValueError(
                    f"req {req.rid}: no cluster to serve from "
                    "(empty clustering state)")
            self._routes[req.rid] = rt
            self.sched.enqueue(self._root_to_k[rt.root], req)
        return routes

    # ---- serving loop -------------------------------------------------
    def _local(self, k: int) -> Optional[int]:
        """Group ``k``'s index among this rank's groups, or None when
        another rank holds it."""
        return k - self.split.lo if self.split.lo <= k < self.split.hi else None

    def _admit_all(self) -> None:
        """Fill every free lane: grouped prefill per (cluster, prompt
        length) off the queue heads, then one insert per admitted
        request (only for this rank's groups under a mesh; the
        scheduler's bookkeeping runs for all of them)."""
        for k in range(len(self.roots)):
            lk = self._local(k)
            while True:
                group, slot_ids = self.sched.next_group(k)
                if not group:
                    break
                if lk is not None:
                    plen = len(group[0].prompt)
                    toks = np.stack([np.asarray(r.prompt, np.int32) for r in group])
                    gtok, gcache = self._prefill(
                        self._params_list[lk],
                        {"tokens": torch.as_tensor(toks, device=self.device)})
                    for j, (req, s) in enumerate(zip(group, slot_ids)):
                        self.sl = self._insert(self.sl, gcache, gtok, j, lk, s, plen, req.gen)
                for req, s in zip(group, slot_ids):
                    self.sched.occupy(k, s, req)
                self.stats_["prefill_groups"] += 1
                self.stats_["admitted"] += len(group)

    def _graph(self) -> DecodeGraph:
        """The decode step over this engine's buffers (its one shape:
        K, slots, max_len), captured at the first burst on the card."""
        if self._decode_graph is None:
            k, slots = self.sl.token.shape
            self._decode_graph = DecodeGraph(
                self._step, self._stacked, self.sl,
                name=f"DecodeGraph ({k}, {slots}, {self.cfg.max_len})")
        return self._decode_graph

    def _decode_burst(self, n: int) -> None:
        """Run ``n`` decode steps back to back — the sync-free inner loop:
        nothing here reads the device (on the card: n replays of the
        captured step)."""
        if self.device.type == "cuda":
            graph = self._graph()
            self.captures += int(graph.graph is None and n > 0)
            graph.run(n)
        else:
            for _ in range(n):
                self._step(self._stacked, self.sl)
        self.stats_["decode_steps"] += n

    def _outputs(self):
        """Every group's output rows on the host, (K, slots, max_gen),
        gathered from the ranks in one collective; None when the groups
        are not split (each lane is then read where it lies)."""
        if not self.split.sharded:
            return None
        return self.split.gather(self.sl.out).to("cpu", copy=True).numpy()

    def _harvest_lanes(self, lanes, out: Dict[Any, RequestResult]) -> None:
        """Harvest finished lanes ``(k, s, req)`` at their full ``gen``."""
        if not lanes:
            return
        rows = self._outputs()
        for k, s, req in lanes:
            out[req.rid] = self._harvest_lane(k, s, req, req.gen, rows=rows)

    def _harvest_lane(self, k: int, s: int, req: Request, emitted: int,
                      evicted: bool = False, rows=None) -> RequestResult:
        rt = self._routes[req.rid]
        if rows is None:
            row = harvest(self.sl, k, s)[:emitted]
        else:
            row = rows[k, s, :emitted].copy()
        res = RequestResult(rid=req.rid, cluster=rt.root,
                            similarity=rt.similarity, accepted=rt.accepted,
                            tokens=row, evicted=evicted)
        self.results[req.rid] = res
        self.sched.release(k, s)
        self.stats_["harvested" if not evicted else "evicted"] += 1
        return res

    def run(self) -> Dict[Any, RequestResult]:
        """Drain the queues: admit → decode until the next finish →
        harvest → re-admit, until nothing is queued or running. Returns
        the results that finished during THIS call (also accumulated in
        ``self.results``)."""
        out: Dict[Any, RequestResult] = {}
        while self.sched.pending() or self.sched.running:
            self._admit_all()
            self._harvest_lanes(self.sched.tick(0), out)      # gen == 1 finishes
            n = self.sched.min_remaining()
            if n == 0:
                continue
            self._decode_burst(n)
            self._harvest_lanes(self.sched.tick(n), out)
        return out

    def evict(self, rid: Any) -> Optional[RequestResult]:
        """Force-finish request ``rid``: a running request is harvested
        at its current emit count (partial tokens, ``evicted=True``) and
        its lane is deactivated and freed; a queued request is dropped
        with zero tokens. Returns None when ``rid`` is unknown or
        already finished."""
        loc = self.sched.find(rid)
        if loc is not None:
            k, s = loc
            req = self.sched.running[(k, s)].req
            emitted = self.sched.emitted(k, s)
            lk = self._local(k)
            if lk is not None:
                self.sl.active[lk, s] = False
                self.sl.remaining[lk, s] = 0
            return self._harvest_lane(k, s, req, emitted, evicted=True, rows=self._outputs())
        for k, q in enumerate(self.sched.queues):
            for req in list(q):
                if req.rid == rid:
                    q.remove(req)
                    rt = self._routes[req.rid]
                    res = RequestResult(
                        rid=rid, cluster=rt.root, similarity=rt.similarity,
                        accepted=rt.accepted,
                        tokens=np.zeros((0,), np.int32), evicted=True)
                    self.results[rid] = res
                    self.stats_["evicted"] += 1
                    return res
        return None

    def reset(self) -> None:
        """Drop lane + scheduler + result state but KEEP the captured
        graph and the routing cache: the lane buffers are zeroed in place,
        so the graph's addresses stay valid — a warmup wave pays the
        capture, then ``reset()`` + the timed wave pays none."""
        clear_slots(self.sl)
        self.sched = SlotScheduler(len(self.roots), self.cfg.slots)
        self._routes = {}
        self.results = {}
        for key in self.stats_:
            self.stats_[key] = 0

    def stats(self) -> dict:
        """Counters for the serve loop + router cache behavior."""
        return dict(self.stats_, router_hits=self.router.hits,
                    router_misses=self.router.misses,
                    clusters=len(self.roots), slots=self.cfg.slots)
