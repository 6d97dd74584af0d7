"""Request scheduler: per-cluster FIFO queues + a host mirror of every
slot's emit budget. The port's copy of the JAX package's
``serve/scheduler.py``, line for line (pure host code).

The scheduler owns NO device state — it is the pure-host bookkeeping
half of the serving engine. Each routed cluster group gets a FIFO queue
and a free-slot list; ``next_group`` carves the head of a queue into an
admissible prefill group (equal prompt length, at most the free-slot
count); ``occupy``/``release`` track lane ownership.

The host mirror is what makes the data plane sync-free: greedy decode
with a known ``gen`` budget finishes at a PREDICTABLE step, so the
scheduler counts each active slot's remaining tokens down host-side
(``tick``) and knows exactly when a slot finishes without ever reading a
device tensor. The only device→host transfer a request causes is its
final ``harvest``.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Request", "SlotScheduler"]


@dataclasses.dataclass
class Request:
    """One serving request: ``rid`` (unique id), ``client_id`` (routing
    -cache key), ``prompt`` (1-D int32 token array), ``gen`` (tokens to
    emit, ≥1, including the prefill's first token), and optionally
    ``history`` — the client's Ψ-routing batch, required only the first
    time a ``client_id`` is seen (reconnects route from the cache)."""
    rid: Any
    client_id: Any
    prompt: np.ndarray
    gen: int
    history: Optional[dict] = None


@dataclasses.dataclass
class _Running:
    req: Request
    remaining: int          # decode steps left (gen - 1 at admission)


class SlotScheduler:
    """Host-side admission + slot bookkeeping for ``clusters × slots``
    lanes. Invariant: every lane is in exactly one of ``free[k]`` or
    ``running[(k, s)]``; queued requests are in ``queues[k]``."""

    def __init__(self, clusters: int, slots: int):
        self.clusters = clusters
        self.slots = slots
        self.queues: List[Deque[Request]] = [deque() for _ in range(clusters)]
        self.free: List[List[int]] = [list(range(slots))
                                      for _ in range(clusters)]
        self.running: Dict[Tuple[int, int], _Running] = {}

    # ---- admission ----------------------------------------------------
    def enqueue(self, k: int, req: Request) -> None:
        """Queue ``req`` on cluster group ``k`` (FIFO)."""
        self.queues[k].append(req)

    def next_group(self, k: int) -> Tuple[List[Request], List[int]]:
        """Carve the next admissible prefill group off queue ``k``:
        the longest head-run of equal-prompt-length requests that fits
        in the free slots (equal lengths keep the grouped prefill
        un-padded and exact; FIFO order is preserved — a different
        prompt length ends the group rather than jumping the queue).
        Returns ``(requests, slot_ids)`` — empty when nothing fits."""
        q, free = self.queues[k], self.free[k]
        if not q or not free:
            return [], []
        plen = len(q[0].prompt)
        group: List[Request] = []
        while q and len(group) < len(free) and len(q[0].prompt) == plen:
            group.append(q.popleft())
        slots = [free.pop(0) for _ in group]
        return group, slots

    def occupy(self, k: int, s: int, req: Request) -> None:
        """Record ``req`` as running on lane ``(k, s)`` with
        ``gen - 1`` decode steps left in its host-mirror counter."""
        self.running[(k, s)] = _Running(req, req.gen - 1)

    # ---- progress -----------------------------------------------------
    def pending(self) -> int:
        """Requests still queued (all clusters)."""
        return sum(len(q) for q in self.queues)

    def min_remaining(self) -> int:
        """Decode steps until the NEXT slot finishes — the burst size
        the engine runs before it re-checks admission. 0 when idle."""
        if not self.running:
            return 0
        return min(r.remaining for r in self.running.values())

    def tick(self, n: int) -> List[Tuple[int, int, Request]]:
        """Advance the host mirror by ``n`` decode steps and return the
        lanes that finished — the engine harvests exactly these. No
        device reads: the mirror alone decides completion."""
        done = []
        for (k, s), r in list(self.running.items()):
            r.remaining -= n
            if r.remaining <= 0:
                done.append((k, s, r.req))
        return done

    def release(self, k: int, s: int) -> None:
        """Return lane ``(k, s)`` to the free list (free-on-finish)."""
        self.running.pop((k, s), None)
        self.free[k].append(s)

    def find(self, rid: Any) -> Optional[Tuple[int, int]]:
        """Locate the lane running request ``rid`` (None if not
        running — queued or already finished)."""
        for (k, s), r in self.running.items():
            if r.req.rid == rid:
                return (k, s)
        return None

    def emitted(self, k: int, s: int) -> int:
        """Tokens lane ``(k, s)`` has emitted so far, from the host
        mirror (``gen - remaining``) — what an eviction harvests."""
        r = self.running[(k, s)]
        return r.req.gen - r.remaining
