"""Device-resident client arena: pack every shard once, gather per round.

Without an arena the engine restacks the sampled cohort from the context's
client list every round. The arena packs ALL client shards into one
stacked tree of device tensors up front, so a cohort is one
``index_select`` per leaf whatever the cohort size (the port of the JAX
package's ``data/arena.py``).

Ragged client sizes are handled by pad-and-mask: every client's arrays are
zero-padded to the longest shard and the gathered batch carries a
``"mask"`` row-validity leaf; the mask-aware loss (``models/simple``)
weights per-example terms by it, so pad rows contribute nothing.
Equal-size federations pack without padding and gather batches that are
bitwise identical to the restack.

Dynamic membership (§5): the packed tensors carry spare row capacity that
doubles on demand (``grow``), so ``append`` is one row write; departures
``tombstone`` their row (the data stays resident, so older states can
still gather it) until enough rows die that ``compact`` reclaims them in
one gather. Client ids stay stable: gathers translate cid -> physical row
through a host-side index.

A captured round body cannot translate cids on the host: ``take_rows``
gathers a cohort from a device id tensor through ``device_rows``, the
cid -> row map as a cached device vector.

Writes in place. ``append`` writes the new client into a spare row of the
shared tensors: no older arena or state reads that row, since it lies past
their ``n_rows``. ``update`` rewrites a resident row in place, as the
reference does, whose row writer donates its buffer: the arena it was
called on must not be used afterwards (rebind: ``arena = arena.update(...)``).
Every other method builds new tensors or none.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.utils import trees


def _n_examples(batch) -> int:
    return int(trees.leaves(batch)[0].shape[0])


class ClientArena:
    """All client shards as one stacked tree with a leading client axis.

    Layout: ``packed`` leaves are ``(capacity, n_max, ...)`` tensors of
    which rows ``[0, n_rows)`` are occupied and the rest are zeroed spare
    capacity; ``mask`` is the ``(capacity, n_max)`` float32 row-validity
    companion. Host bookkeeping maps stable client ids to physical rows:
    ``sizes[cid]`` is the true shard length, ``rows[cid]`` the physical row
    (−1 once ``compact`` reclaimed it), ``dead`` the tombstoned cids whose
    rows are still resident. ``ragged`` is true when any live shard is
    shorter than ``n_max`` (gathers then carry the ``"mask"`` leaf)."""

    def __init__(self, packed, mask, sizes: np.ndarray, ragged: bool,
                 rows: Optional[np.ndarray] = None, n_rows: Optional[int] = None,
                 dead: frozenset = frozenset(), mesh=None):
        self.packed = packed
        self.mask = mask
        self.sizes = np.asarray(sizes)
        self.ragged = bool(ragged)
        self.rows = (np.arange(len(self.sizes), dtype=np.int64)
                     if rows is None else np.asarray(rows, np.int64))
        self.n_rows = int(len(self.sizes) if n_rows is None else n_rows)
        self.dead = frozenset(int(c) for c in dead)
        self.mesh = mesh
        self._device_rows = None

    # ------------------------------------------------------------- builders
    @classmethod
    def from_clients(cls, clients: Sequence[Any], capacity: Optional[int] = None,
                     device=None) -> "ClientArena":
        """Pack a client list (trees of tensors) into a fresh arena on
        ``device`` (default: the clients' own device). ``capacity``
        pre-allocates spare rows for expected joins (default: exactly
        ``len(clients)`` rows)."""
        if not clients:
            raise ValueError("ClientArena needs at least one client")
        sizes = np.array([_n_examples(c) for c in clients])
        for c, n in zip(clients, sizes):
            if any(leaf.shape[0] != n for leaf in trees.leaves(c)):
                raise ValueError("every client leaf must share the leading example axis")
        n_max = int(sizes.max())
        ragged = bool((sizes != n_max).any())
        cap = max(int(capacity or 0), len(clients))
        dev = torch.device(device) if device is not None else trees.leaves(clients[0])[0].device

        def pack(*xs):
            xs = [torch.as_tensor(x).to(dev) for x in xs]
            if not ragged and cap == len(xs):
                return torch.stack(xs)
            out = xs[0].new_zeros((cap, n_max) + tuple(xs[0].shape[1:]))
            for i, x in enumerate(xs):
                out[i, : x.shape[0]] = x
            return out

        packed = trees.tree_map(pack, *clients)
        if ragged and not isinstance(packed, dict):
            raise TypeError("ragged arenas need dict batches (for the gathered "
                            f"'mask' key); got {type(clients[0]).__name__}")
        mask = np.zeros((cap, n_max), np.float32)
        mask[: len(sizes)] = np.arange(n_max)[None, :] < sizes[:, None]
        return cls(packed, torch.as_tensor(mask, device=dev), sizes, ragged,
                   n_rows=len(clients))

    # --------------------------------------------------------------- views
    @property
    def n_max(self) -> int:
        """Example-axis length every shard is padded to."""
        return int(trees.leaves(self.packed)[0].shape[1])

    @property
    def capacity(self) -> int:
        """Allocated rows (``n_rows`` occupied, the rest spare)."""
        return int(trees.leaves(self.packed)[0].shape[0])

    @property
    def device(self) -> torch.device:
        return self.mask.device

    @property
    def device_rows(self) -> torch.Tensor:
        """``rows`` (cid -> physical row) as an int64 device vector padded
        to a power of two (pad slots map to row 0 and belong to
        unregistered cids, which no cohort draws), built once per arena.
        Every change builds a new ``ClientArena``, so it is never stale."""
        if self._device_rows is None:
            n = len(self.rows)
            cap = 1 if n <= 1 else 1 << (n - 1).bit_length()
            padded = np.zeros(cap, np.int64)
            padded[:n] = self.rows
            self._device_rows = torch.as_tensor(padded, device=self.device)
        return self._device_rows

    def _live(self) -> np.ndarray:
        """Cids that are resident and not tombstoned."""
        alive = self.rows >= 0
        alive[list(self.dead & set(range(len(self.sizes))))] = False
        return np.nonzero(alive)[0]

    def _recompute_ragged(self, sizes: np.ndarray, rows: np.ndarray,
                          dead: frozenset) -> bool:
        alive = rows >= 0
        if dead:
            alive[list(dead)] = False
        live_sizes = sizes[alive]
        return bool(live_sizes.size and (live_sizes != self.n_max).any())

    def _with(self, **kw) -> "ClientArena":
        args = dict(packed=self.packed, mask=self.mask, sizes=self.sizes,
                    ragged=self.ragged, rows=self.rows, n_rows=self.n_rows,
                    dead=self.dead, mesh=self.mesh)
        args.update(kw)
        return ClientArena(**args)

    # ------------------------------------------------------------- growth
    def grow(self, min_capacity: int) -> "ClientArena":
        """New arena with row capacity >= ``min_capacity``: capacity
        doubles and the new rows are zeroed spare space (one concat per
        leaf, paid O(log N) times over N joins)."""
        cap = self.capacity
        if min_capacity <= cap:
            return self
        new_cap = cap
        while new_cap < min_capacity:
            new_cap *= 2

        def one(x):
            return torch.cat([x, x.new_zeros((new_cap - cap,) + tuple(x.shape[1:]))])

        return self._with(packed=trees.tree_map(one, self.packed), mask=one(self.mask))

    def _grow_example_axis(self, n: int) -> "ClientArena":
        """Re-pad every row to a longer example axis (a newcomer longer
        than every resident shard: rare, full copy)."""
        n_max = self.n_max
        if n <= n_max:
            return self

        def one(x):
            out = x.new_zeros((x.shape[0], n) + tuple(x.shape[2:]))
            out[:, :n_max] = x
            return out

        live = self.sizes[self._live()]
        return self._with(packed=trees.tree_map(one, self.packed), mask=one(self.mask),
                          ragged=bool(live.size and (live != n).any()))

    def _write_row(self, row: int, batch, n: int) -> None:
        """Write one shard (padded to ``n_max``) and its mask into ``row``
        of the shared tensors."""
        def one(x, b):
            x[row].zero_()
            x[row, :n] = torch.as_tensor(b).to(device=x.device, dtype=x.dtype)

        trees.tree_map(one, self.packed, batch)
        self.mask[row] = (torch.arange(self.n_max, device=self.device) < n).to(torch.float32)

    # ------------------------------------------------------------- append
    def append(self, batch) -> "ClientArena":
        """New arena with one more client, written into a spare row
        (``grow`` doubles the row axis when full). Only a newcomer longer
        than every resident shard re-pads the example axis."""
        n = _n_examples(batch)
        ar = self._grow_example_axis(n)
        ar = ar.grow(ar.n_rows + 1)
        ragged = ar.ragged or n < ar.n_max
        if ragged and not isinstance(ar.packed, dict):
            raise TypeError("ragged arenas need dict batches (for the gathered 'mask' key)")
        ar._write_row(ar.n_rows, batch, n)
        return ar._with(sizes=np.append(ar.sizes, n), ragged=ragged,
                        rows=np.append(ar.rows, ar.n_rows), n_rows=ar.n_rows + 1)

    def update(self, cid: int, batch) -> "ClientArena":
        """Rewrite one resident client's shard in place (distribution drift,
        §5). The new shard must fit the example axis (``n <= n_max``)."""
        row = int(self.rows[cid])
        if row < 0:
            raise KeyError(f"client {cid} was compacted away")
        n = _n_examples(batch)
        if n > self.n_max:
            raise ValueError(f"update shard len {n} > arena n_max {self.n_max}")
        sizes = self.sizes.copy()
        sizes[cid] = n
        ragged = self._recompute_ragged(sizes, self.rows, self.dead)
        if ragged and not isinstance(self.packed, dict):
            raise TypeError("ragged arenas need dict batches (for the gathered 'mask' key)")
        self._write_row(row, batch, n)
        return self._with(sizes=sizes, ragged=ragged)

    # ---------------------------------------------------------- departures
    def tombstone(self, cid: int, compact_frac: float = 0.5) -> "ClientArena":
        """Mark a departed client's row dead, with no device op; the data
        stays gatherable until dead rows exceed ``compact_frac`` of the
        occupied rows, when the arena compacts itself. ``compact_frac <= 0``
        disables that."""
        cid = int(cid)
        if cid in self.dead or not 0 <= cid < len(self.sizes):
            return self
        dead = self.dead | {cid}
        ar = self._with(ragged=self._recompute_ragged(self.sizes, self.rows, dead),
                        dead=dead)
        n_dead_resident = sum(1 for c in dead if ar.rows[c] >= 0)
        if compact_frac > 0 and n_dead_resident > compact_frac * ar.n_rows:
            return ar.compact()
        return ar

    def compact(self) -> "ClientArena":
        """Reclaim tombstoned rows: one gather per leaf keeps the live rows
        (registered order kept), dead cids' rows become −1 and capacity
        shrinks to the live count."""
        live = self._live()
        if not live.size:
            raise ValueError("compact would empty the arena")
        src = torch.as_tensor(self.rows[live], device=self.device)
        packed = trees.tree_map(lambda x: torch.index_select(x, 0, src), self.packed)
        mask = torch.index_select(self.mask, 0, src)
        rows = np.full(len(self.sizes), -1, np.int64)
        rows[live] = np.arange(live.size)
        return self._with(packed=packed, mask=mask,
                          ragged=self._recompute_ragged(self.sizes, rows, self.dead),
                          rows=rows, n_rows=int(live.size))

    # ------------------------------------------------------------- gather
    def gather(self, client_ids) -> Any:
        """Stacked cohort batch for ``client_ids``: one ``index_select``
        per leaf, cids translated to physical rows. Ragged arenas add a
        ``"mask"`` leaf."""
        cids = np.asarray(client_ids, np.int64)
        rows = self.rows[cids]
        if (rows < 0).any():
            bad = cids[rows < 0].tolist()
            raise KeyError(f"clients {bad} were compacted out of the arena")
        idx = torch.as_tensor(rows, device=self.device)
        batch = trees.tree_map(lambda x: torch.index_select(x, 0, idx), self.packed)
        if self.ragged:
            batch = dict(batch)
            batch["mask"] = torch.index_select(self.mask, 0, idx)
        return batch

    def take(self, ids: torch.Tensor) -> Any:
        """``gather`` for a device tensor of cids, with no host read (the
        rows must be resident)."""
        return take_rows(self.packed, self.mask, self.device_rows, ids, self.ragged)

    def client(self, cid: int) -> Any:
        """One client's unpadded shard (views into the packed tensors)."""
        row = int(self.rows[cid])
        if row < 0:
            raise KeyError(f"client {cid} was compacted away")
        n = int(self.sizes[cid])
        return trees.tree_map(lambda x: x[row, :n], self.packed)

    # ----------------------------------------------------------- sharding
    def place(self, mesh) -> "ClientArena":
        """This arena attached to a client-axis mesh (``engine.init``
        calls it once). Every rank keeps every row, so a cohort gather
        stays local; the rows a rank trains are its slice of the cohort
        (``sharding.place_cohort``). The reference splits the rows over
        its devices instead; per GPU this arena costs what the arena
        without a mesh costs. The mesh rides every arena derived from
        this one."""
        if mesh is None:
            return self
        return self._with(mesh=mesh)

    # ------------------------------------------------------------- stats
    @property
    def n_clients(self) -> int:
        """Registered clients (tombstoned included: ids are stable)."""
        return len(self.sizes)

    @property
    def n_live(self) -> int:
        """Registered minus tombstoned."""
        return len(self.sizes) - len(self.dead)

    @property
    def nbytes(self) -> int:
        return sum(x.numel() * x.element_size() for x in trees.leaves(self.packed))

    def __repr__(self) -> str:
        return (f"ClientArena(n={self.n_clients}, live={self.n_live}, "
                f"capacity={self.capacity}, n_max={self.n_max}, "
                f"ragged={self.ragged}, mb={self.nbytes / 2**20:.1f})")


def take_rows(packed, mask, rowmap: torch.Tensor, ids: torch.Tensor, ragged: bool):
    """The cohort batch of the cids in device tensor ``ids``: rows
    ``rowmap[ids]`` of every packed leaf, plus the ``"mask"`` leaf when
    ``ragged``; the same gathers as ``ClientArena.gather``, so the batch is
    bitwise the same."""
    idx = torch.index_select(rowmap, 0, ids)
    batch = trees.tree_map(lambda x: torch.index_select(x, 0, idx), packed)
    if ragged:
        batch = dict(batch)
        batch["mask"] = torch.index_select(mask, 0, idx)
    return batch
