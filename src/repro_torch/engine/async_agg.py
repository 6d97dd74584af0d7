"""Async buffered aggregation with staleness-weighted cluster merges.

The synchronous round (``engine.run_round``) is a barrier: every sampled
client trains and reports back inside one round. Here clients drawn at
round *t* DISPATCH at once (Ψ handshake and local training) and their
trained contribution lands in a delta buffer with an arrival round
``t + delay``; every round the server FLUSHES the arrived entries as one
staleness-weighted merge (weight ``count · γ^staleness``) through the
aggregation functions the synchronous round calls.

The contract (``tests/test_torch_async.py``):

    zero delay + flush every round  ≡  engine.run_round, bitwise,

for every strategy with async hooks (stocfl, fedavg, fedprox):

* dispatch runs the synchronous round's pre-aggregation half (StoCFL's
  observe, merge pass, bank merge and bi-level cohort step; FedAvg's
  broadcast and local SGD) through the same cohort updates, so the
  buffered rows are the rows the synchronous round aggregates;
* the buffer is pure memory movement: rows scattered in by slot at
  dispatch (``index_copy_``) and gathered out at flush
  (``index_select``), both bit-preserving;
* a flush merges entries in dispatch (seq) order, the draw order, at
  exact width, through ``bilevel.aggregate_stacked`` /
  ``aggregate_segments`` / ``AGGREGATORS[cfg.aggregator]``; and
  ``γ^0 · w = w`` holds bitwise.

The Ψ handshake is instantaneous at dispatch: a new client's embedding is
written into the buffer's Ψ rows and the partition's ``observe`` / merge
pass read it back there, so clustering never waits on a delta. Only the
training result is delayed; at its flush the delta re-roots through the
CURRENT partition, so merges made while it was in flight are honoured.

The buffer's rows are device tensors with a power-of-two row capacity
that doubles on overflow; its entry bookkeeping stays on the host. Every
transition returns a new buffer: a write copies the row bank it scatters
into (once per dispatch, 0.31 GB at 256 rows of the 153,610-parameter
MLP, θ and ω), so a state a transition started from keeps its rows.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.utils import trees

__all__ = ["AsyncConfig", "AsyncBuffer", "FlushBatch", "run_round_async",
           "staleness_weights"]


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Knobs of the async buffered loop (``EngineConfig.async_cfg``).

    ``staleness_decay`` is γ: a delta dispatched at round ``t_d`` and
    merged at round ``t`` weighs ``count · γ^(t - t_d)``. ``staleness_cap``
    bounds how stale a merged delta may be: older arrived entries, and
    entries whose delay alone exceeds the cap, are dropped, never merged.
    ``buffer_capacity`` fixes the row count (0: the power of two of
    ``cohort · (cap + 2)``); it doubles on overflow either way.
    ``flush_every`` merges the arrived entries every N rounds (1, the
    default, is what the synchronous limit needs)."""
    staleness_decay: float = 1.0
    staleness_cap: int = 4
    buffer_capacity: int = 0
    flush_every: int = 1


class _Entry(NamedTuple):
    """Host bookkeeping of one in-flight contribution: slot row, client id,
    dispatch and arrival rounds, the sequence number that fixes merge
    order, and the f32 sample-count weight."""
    slot: int
    cid: int
    dispatch: int
    arrival: int
    seq: int
    weight: float


@dataclasses.dataclass(frozen=True)
class FlushBatch:
    """One flush's merged entries in dispatch (seq) order, the draw order.

    ``payload`` / ``aux`` are the gathered device rows (leading axis =
    entries); ``weight`` is the host f32 sample-count vector;
    ``staleness[i] = flush round - dispatch round`` of entry i."""
    payload: Any
    aux: Any
    cids: np.ndarray
    weight: np.ndarray
    staleness: np.ndarray

    @property
    def n(self) -> int:
        """Number of merged entries."""
        return int(len(self.cids))


def _pow2(n: int) -> int:
    n = int(n)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def staleness_weights(weight, staleness, decay) -> np.ndarray:
    """Effective merge weights ``w · γ^s`` as host f32 (at ``s = 0`` the
    factor is exactly 1.0, so the weight keeps its bits)."""
    w = np.asarray(weight, np.float32)
    s = np.asarray(staleness, np.float32)
    return (w * np.float32(decay) ** s).astype(np.float32)


# ------------------------------------------------------------ row movement
def _slots(slots, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(slots, np.int64), device=like.device)


def _zeros_rows(updates, capacity: int):
    return trees.tree_map(
        lambda u: u.new_zeros((capacity,) + tuple(u.shape[1:])), updates)


def _grow_rows(rows, capacity: int):
    def leaf(r):
        out = r.new_zeros((capacity,) + tuple(r.shape[1:]))
        out[: r.shape[0]].copy_(r)
        return out

    return trees.tree_map(leaf, rows)


def _scatter_rows(rows, slots, updates):
    """A copy of ``rows`` with ``updates`` written at ``slots``."""
    idx = _slots(slots, trees.leaves(rows)[0])
    return trees.tree_map(
        lambda r, u: r.clone().index_copy_(0, idx, u.to(r.dtype)), rows, updates)


def _gather_rows(rows, slots):
    idx = _slots(slots, trees.leaves(rows)[0])
    return trees.tree_map(lambda r: torch.index_select(r, 0, idx), rows)


@dataclasses.dataclass(frozen=True)
class AsyncBuffer:
    """The delta buffer.

    Device rows: ``payload`` (trained per-client model rows: StoCFL's θᵢ,
    FedAvg's local params), ``aux`` (StoCFL's ωᵢ rows) and ``psi`` (fp32
    Ψ rows, the handshake the partition observes from), each a tree of
    ``(capacity, ...)`` tensors made at the first write. Host
    bookkeeping: the in-flight entries (seq order) and the insertion
    counter."""
    capacity: int
    payload: Any = None
    aux: Any = None
    psi: Any = None
    entries: Tuple[_Entry, ...] = ()
    next_seq: int = 0

    @classmethod
    def fresh(cls, capacity: int) -> "AsyncBuffer":
        """An empty buffer of power-of-two ``capacity``; the rows take
        their shapes from the first contribution."""
        return cls(capacity=_pow2(capacity))

    def replace(self, **kw) -> "AsyncBuffer":
        return dataclasses.replace(self, **kw)

    @property
    def in_flight(self) -> int:
        """Entries dispatched and not yet flushed."""
        return len(self.entries)

    def reserve(self, cids: Sequence[int], dispatch: int,
                arrivals: Sequence[int], weights: Sequence[float]):
        """One row per dispatched client; returns ``(buffer', slots)``.
        Slots are the lowest free rows in ascending order and entries are
        appended in cohort (draw) order, so on an empty buffer the slots
        are ``0..m-1``. Doubles the capacity when the free rows run out."""
        m = len(cids)
        occupied = {e.slot for e in self.entries}
        cap = self.capacity
        while cap - len(occupied) < m:
            cap *= 2
        buf = self if cap == self.capacity else self._grow(cap)
        free = [s for s in range(cap) if s not in occupied][:m]
        new = tuple(_Entry(slot=int(s), cid=int(c), dispatch=int(dispatch),
                           arrival=int(a), seq=self.next_seq + i, weight=float(w))
                    for i, (s, c, a, w) in enumerate(zip(free, cids, arrivals, weights)))
        return (buf.replace(entries=buf.entries + new, next_seq=self.next_seq + m),
                np.asarray(free, np.int32))

    def _grow(self, capacity: int) -> "AsyncBuffer":
        grow = lambda t: None if t is None else _grow_rows(t, capacity)
        return self.replace(capacity=capacity, payload=grow(self.payload),
                            aux=grow(self.aux), psi=grow(self.psi))

    def write_psi(self, slots, rows: torch.Tensor) -> "AsyncBuffer":
        """Scatter the handshake's Ψ rows (fp32) into the Ψ bank."""
        rows = rows.to(torch.float32)
        psi = self.psi if self.psi is not None else _zeros_rows(rows, self.capacity)
        return self.replace(psi=_scatter_rows(psi, slots, rows))

    def read_psi(self, slots) -> torch.Tensor:
        """The Ψ rows at ``slots``, bit for bit what ``write_psi`` stored."""
        return _gather_rows(self.psi, slots)

    def write(self, slots, payload, aux=None) -> "AsyncBuffer":
        """Scatter a dispatch's trained rows (leading axis = cohort) into
        the buffer; the flush gathers them back bit for bit."""
        p = self.payload if self.payload is not None else _zeros_rows(payload, self.capacity)
        p = _scatter_rows(p, slots, payload)
        a = self.aux
        if aux is not None:
            a = _scatter_rows(a if a is not None else _zeros_rows(aux, self.capacity),
                              slots, aux)
        return self.replace(payload=p, aux=a)

    def place(self, mesh) -> "AsyncBuffer":
        """The buffer on a client-axis mesh's rank. Every rank keeps every
        row (each dispatch writes every rank's rows, gathered), so the row
        banks only move to the rank's device; a flush's rows are split
        over the ranks where they are merged (``run_round_async``,
        ``sharding.place_buffer_rows``). No-op without a mesh."""
        if mesh is None:
            return self
        from repro_torch.sharding import specs
        pl = lambda t: None if t is None else specs.place_replicated(t, mesh)
        return self.replace(payload=pl(self.payload), aux=pl(self.aux), psi=pl(self.psi))

    def flush(self, t: int, staleness_cap: int, left=frozenset()):
        """Split the in-flight entries at round ``t`` into merged, kept and
        dropped; returns ``(buffer', FlushBatch | None, drops)``.

        Merged: arrived (``arrival <= t``), not departed, staleness
        ``t - dispatch <= staleness_cap``, gathered in seq order. Dropped
        stale: arrived entries over the cap, and entries whose delay alone
        exceeds it. Dropped left: entries of departed clients. Everything
        else stays buffered."""
        merge, keep, stale, gone = [], [], [], []
        for e in self.entries:                   # seq order == draw order
            if e.arrival <= t:
                if int(e.cid) in left:
                    gone.append(e)
                elif t - e.dispatch > staleness_cap:
                    stale.append(e)
                else:
                    merge.append(e)
            elif e.arrival - e.dispatch > staleness_cap:
                stale.append(e)                  # its delay alone exceeds the cap
            elif int(e.cid) in left:
                gone.append(e)
            else:
                keep.append(e)
        drops = {"stale": len(stale), "left": len(gone)}
        buf = self.replace(entries=tuple(keep))
        if not merge:
            return buf, None, drops
        idx = [e.slot for e in merge]
        batch = FlushBatch(
            payload=_gather_rows(self.payload, idx),
            aux=None if self.aux is None else _gather_rows(self.aux, idx),
            cids=np.asarray([e.cid for e in merge], np.int64),
            weight=np.asarray([e.weight for e in merge], np.float32),
            staleness=np.asarray([t - e.dispatch for e in merge], np.int64))
        return buf, batch, drops


# =================================================================== loop
def _auto_capacity(m: int, acfg: AsyncConfig) -> int:
    if acfg.buffer_capacity:
        return _pow2(acfg.buffer_capacity)
    return _pow2(max(m * (int(acfg.staleness_cap) + 2), 1))


def run_round_async(state, client_ids: Optional[Sequence[int]] = None, delays=None):
    """One async server round: dispatch the cohort, buffer its delayed
    contributions, flush what has arrived.

    ``run_round``'s signature plus ``delays``, each cohort member's
    report-back latency in rounds (a scalar broadcasts; default 0). The
    rng is threaded as ``run_round`` threads it. Per round, with
    ``t = state.round``: reserve one buffer row per member;
    ``strategy.async_dispatch`` (the pre-aggregation half, the trained
    rows scattered into the buffer with arrival ``t + delay``); then,
    every ``flush_every``-th round, the entries with ``arrival <= t`` and
    staleness ``<= staleness_cap`` go to ``strategy.async_merge`` in
    dispatch order with weights ``count · γ^staleness``.

    The record adds ``merged``, ``dropped_stale``, ``dropped_left``,
    ``in_flight`` and ``max_staleness`` to the strategy's metrics. Under a
    client-axis mesh every rank keeps the whole buffer and merges its
    slice of each flush (``AsyncBuffer.place``). Raises
    ``NotImplementedError`` for strategies without async hooks (ditto,
    ifca, cfl) and ``ValueError`` on an empty cohort."""
    from repro_torch.engine.api import sample_clients
    from repro_torch.engine.registry import get_strategy

    ctx = state.ctx
    acfg = ctx.cfg.async_cfg or AsyncConfig()
    strat = get_strategy(state.strategy)
    if not strat.supports_async:
        raise NotImplementedError(
            f"strategy {state.strategy!r} has no async hooks "
            "(async_dispatch/async_merge); async buffered aggregation "
            "supports stocfl, fedavg and fedprox")
    rng_state, rng_key = state.rng_state, state.rng_key
    if client_ids is None:
        if ctx.cfg.rng_backend == "device":
            rng_key, client_ids = sample_clients(state)
        else:
            rng_state, client_ids = sample_clients(state)
    client_ids = np.asarray(client_ids)
    if client_ids.size == 0:
        raise ValueError("run_round_async needs a non-empty cohort "
                         "(no clients sampled — all departed or unavailable?)")
    m = int(client_ids.size)
    delays = (np.zeros(m, np.int64) if delays is None
              else np.broadcast_to(np.asarray(delays, np.int64), (m,)))
    t = int(state.round)

    weights = np.asarray(state.sizes, np.float32)[client_ids]
    buf = state.buffer
    if buf is None:
        buf = AsyncBuffer.fresh(_auto_capacity(m, acfg)).place(ctx.mesh)
    buf, slots = buf.reserve(client_ids, t, t + delays, weights)
    state, buf = strat.async_dispatch(ctx, state, client_ids, buf, slots)

    rec: dict = {"sampled": m}
    if (t + 1) % max(int(acfg.flush_every), 1) == 0:
        buf, batch, drops = buf.flush(t, int(acfg.staleness_cap), state.left)
        if batch is not None:
            if ctx.mesh is not None:
                # this rank's slice of the flushed rows: the merge sums it
                # and all-reduces the partial sums
                from repro_torch.sharding import specs
                batch = dataclasses.replace(
                    batch, payload=specs.place_buffer_rows(batch.payload, ctx.mesh),
                    aux=specs.place_buffer_rows(batch.aux, ctx.mesh))
            w_eff = staleness_weights(batch.weight, batch.staleness, acfg.staleness_decay)
            state, srec = strat.async_merge(ctx, state, batch, w_eff)
            rec.update(srec)
        rec.update(merged=0 if batch is None else batch.n,
                   dropped_stale=drops["stale"], dropped_left=drops["left"],
                   max_staleness=(0 if batch is None
                                  else int(batch.staleness.max(initial=0))))
    rec["in_flight"] = buf.in_flight
    state = state.replace(buffer=buf, round=t + 1, rng_state=rng_state, rng_key=rng_key,
                          history=state.history + (dict(rec),))
    return state, rec
