"""Ψ-routing with a per-client routing cache.

StoCFL §4.4 serving routes an unseen client to the nearest cluster by
Ψ-cosine and serves that cluster's personalized model. Routing costs a
gradient-based Ψ extraction over the client's history — far too much to
pay per request — so the ``Router`` computes it ONCE per client and
caches the decision: a reconnecting client hits the cache and goes
straight to its cluster's queue; only genuinely new clients run the
extractor, and those go through ONE ``engine.infer_batch`` call (Ψ of
each history, then one ``(J, K̃)`` similarity product for the whole
admission wave). The port of the JAX package's ``serve/router.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch import engine as _engine

__all__ = ["Route", "Router"]


@dataclasses.dataclass(frozen=True)
class Route:
    """A routing decision for one client: ``root`` is the cluster the
    client is served from (§4.4: the τ-accepted cluster when similarity
    clears ``tau``, else still the nearest root — serving always picks
    SOME personalized model), ``similarity`` the Ψ-cosine against that
    cluster's mean, ``accepted`` whether it cleared τ (below-τ clients
    are served best-effort from the nearest cluster, exactly like
    ``engine.infer``'s ``seed_from``)."""
    root: Optional[int]
    similarity: float
    accepted: bool


class Router:
    """Per-client route cache over ``engine.infer`` / ``infer_batch``.

    ``route(client_id, history)`` returns the cached ``Route`` when the
    client has been seen (``history`` may then be ``None``);
    ``route_many`` routes a whole admission wave, running the Ψ
    extractor only for the cache misses — in one batched call.
    ``hits``/``misses`` count cache behavior for the serve stats."""

    def __init__(self, state):
        self.state = state
        self._cache: Dict[Any, Route] = {}
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _to_route(inf: dict) -> Route:
        root = inf["cluster"] if inf["cluster"] is not None else inf["seed_from"]
        return Route(root=root, similarity=float(inf["similarity"]),
                     accepted=inf["cluster"] is not None)

    def route(self, client_id, history=None) -> Route:
        """Route one client: cache hit returns instantly; a miss runs
        ``engine.infer_batch`` on ``history`` and caches the decision."""
        return self.route_many([(client_id, history)])[0]

    def route_many(self, items: Sequence[Tuple[Any, Any]]) -> List[Route]:
        """Route ``[(client_id, history), ...]``: cached clients are
        served from the cache; the misses (which MUST carry a history
        batch) go through ONE ``engine.infer_batch`` call."""
        routes: List[Optional[Route]] = []
        miss_idx, miss_hist = [], []
        for i, (cid, hist) in enumerate(items):
            cached = self._cache.get(cid)
            if cached is not None:
                self.hits += 1
                routes.append(cached)
                continue
            if hist is None:
                raise ValueError(
                    f"client {cid!r} has no cached route and no history "
                    "batch to route on")
            self.misses += 1
            routes.append(None)
            miss_idx.append(i)
            miss_hist.append(hist)
        if miss_idx:
            for i, inf in zip(miss_idx, _engine.infer_batch(self.state, miss_hist)):
                r = self._to_route(inf)
                self._cache[items[i][0]] = r
                routes[i] = r
        return routes
