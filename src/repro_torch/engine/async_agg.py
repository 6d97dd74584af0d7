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

Under a client-axis mesh (``AsyncBuffer.place``) the row banks live on
their owners, the client arena's layout (``sharding.RowOwners``): slot
``s`` on rank ``s % N`` only, as its local row ``s // N``, so a rank
holds ``capacity / N`` rows and copies only those at a write. A write
sends each cohort row from the rank whose slice of the cohort trained it
to the slot's owner; a flush and the handshake's read gather their slots
with one byte-sum ``all_reduce`` a leaf, bit for bit; a doubling is a
zero-extension of every rank's own rows. Where the capacity does not
divide the ranks, every rank keeps the whole bank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.sharding.specs import RowOwners, place_buffer_rows, place_cohort, row_owners
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
    """Row indices on ``like``'s device: a device tensor as it is (no host
    read), host ints uploaded."""
    if isinstance(slots, torch.Tensor):
        return slots.to(device=like.device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(slots, np.int64), device=like.device)


def _zeros_rows(updates, rows: int):
    return trees.tree_map(
        lambda u: u.new_zeros((rows,) + tuple(u.shape[1:])), updates)


def _grow_rows(rows, n: int):
    def leaf(r):
        out = r.new_zeros((n,) + tuple(r.shape[1:]))
        out[: r.shape[0]].copy_(r)
        return out

    return trees.tree_map(leaf, rows)


def _gather_rows(rows, slots, owners: RowOwners = RowOwners()):
    """The rows at ``slots`` of a bank held as ``owners`` gives, whole on
    every rank and bit for bit (``RowOwners.gather``)."""
    return owners.gather(rows, _slots(slots, trees.leaves(rows)[0]))


@dataclasses.dataclass(frozen=True)
class AsyncBuffer:
    """The delta buffer.

    Device rows: ``payload`` (trained per-client model rows: StoCFL's θᵢ,
    FedAvg's local params), ``aux`` (StoCFL's ωᵢ rows) and ``psi`` (fp32
    Ψ rows, the handshake the partition observes from), each a tree of
    ``(capacity, ...)`` tensors made at the first write, or of ``(capacity
    / N, ...)`` on a mesh's rank (``owners``, set by ``place``). Host
    bookkeeping: the in-flight entries (seq order) and the insertion
    counter."""
    capacity: int
    payload: Any = None
    aux: Any = None
    psi: Any = None
    entries: Tuple[_Entry, ...] = ()
    next_seq: int = 0
    owners: RowOwners = RowOwners()

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

    @property
    def held(self) -> int:
        """The rows of each bank this rank holds."""
        return self.owners.held(self.capacity)

    @property
    def nbytes(self) -> int:
        """The bytes of the row banks this rank holds."""
        return sum(x.numel() * x.element_size() for t in (self.payload, self.aux, self.psi)
                   if t is not None for x in trees.leaves(t))

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
        """The buffer at ``capacity`` rows. On its owners every rank
        zero-extends its own rows (slot s stays at local row s // N); a
        whole bank stays whole."""
        grow = lambda t: None if t is None else _grow_rows(t, self.owners.held(capacity))
        return self.replace(capacity=capacity, payload=grow(self.payload),
                            aux=grow(self.aux), psi=grow(self.psi))

    def _bank(self, rows, like):
        return rows if rows is not None else _zeros_rows(like, self.held)

    def write_psi(self, slots, rows: torch.Tensor) -> "AsyncBuffer":
        """Scatter the handshake's Ψ rows (fp32, every slot's row on every
        rank) into the Ψ bank, each on its owner."""
        rows = rows.to(torch.float32)
        return self.replace(psi=self.owners.scatter(self._bank(self.psi, rows), slots, rows))

    def read_psi(self, slots) -> torch.Tensor:
        """The Ψ rows at ``slots`` on every rank, bit for bit what
        ``write_psi`` stored."""
        return _gather_rows(self.psi, slots, self.owners)

    def write(self, slots, payload, aux=None, split=None) -> "AsyncBuffer":
        """Scatter a dispatch's trained rows (leading axis = cohort) into
        the buffer; the flush gathers them back bit for bit. Under a mesh
        ``payload`` / ``aux`` hold the rows of ``split``, this rank's
        ``row_split`` of the cohort (``RowOwners.scatter`` sends each to its
        slot's owner)."""
        p = self.owners.scatter(self._bank(self.payload, payload), slots, payload, split)
        a = self.aux
        if aux is not None:
            a = self.owners.scatter(self._bank(a, aux), slots, aux, split)
        return self.replace(payload=p, aux=a)

    def place(self, mesh) -> "AsyncBuffer":
        """A whole buffer (fresh, or loaded from a checkpoint) on a
        client-axis mesh's rank: each row bank on its owners
        (``sharding.place_buffer_rows``: slot s on rank s mod N, capacity /
        N rows a rank, on the rank's device), or whole where the capacity
        does not divide the ranks. A flush's rows are split over the ranks
        where they are merged (``run_round_async``). No-op without a
        mesh."""
        if mesh is None:
            return self
        pl = lambda t: None if t is None else trees.tree_map(
            lambda x: x.contiguous(), place_buffer_rows(t, mesh))
        return self.replace(payload=pl(self.payload), aux=pl(self.aux), psi=pl(self.psi),
                            owners=row_owners(self.capacity, mesh))

    def gathered(self) -> "AsyncBuffer":
        """This buffer with every row bank whole on every rank, bit for bit
        (one ``RowOwners.gather`` a leaf; every rank calls it), as a
        checkpoint writes it."""
        if not self.owners.sharded:
            return self
        every = np.arange(self.capacity)
        whole = lambda t: None if t is None else _gather_rows(t, every, self.owners)
        return self.replace(payload=whole(self.payload), aux=whole(self.aux),
                            psi=whole(self.psi), owners=RowOwners())

    def flush(self, t: int, staleness_cap: int, left=frozenset()):
        """Split the in-flight entries at round ``t`` into merged, kept and
        dropped; returns ``(buffer', FlushBatch | None, drops)``.

        Merged: arrived (``arrival <= t``), not departed, staleness
        ``t - dispatch <= staleness_cap``, gathered in seq order. Dropped
        stale: arrived entries over the cap, and entries whose delay alone
        exceeds it. Dropped left: entries of departed clients. Everything
        else stays buffered. On a mesh every rank receives the merged rows
        whole (a byte-sum gather from their owners)."""
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
            payload=_gather_rows(self.payload, idx, self.owners),
            aux=None if self.aux is None else _gather_rows(self.aux, idx, self.owners),
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
    client-axis mesh a fresh buffer is placed on its owners (each rank
    holds capacity / N rows, ``AsyncBuffer.place``) and every rank merges
    its slice of each flush. Raises
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
                batch = dataclasses.replace(
                    batch, payload=place_cohort(batch.payload, ctx.mesh),
                    aux=place_cohort(batch.aux, ctx.mesh))
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
