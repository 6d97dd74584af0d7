"""Stacked cluster-model bank: ``{root: tree}`` as ONE device tree.

All cluster models are stacked on a leading row axis next to a host-side
root tuple, so the per-round model path is batched tensor ops:

    thetas = bank.take(roots, init)   # one index_select per leaf
    ...cohort update...
    bank   = bank.put(uroots, agg)    # one index_copy per leaf

and cluster merges (Algorithm 1 l.10-13) are a single count-weighted
segment sum over rows (``bank.merge``). Rows carry power-of-two capacity
(occupied rows first, zero rows after), and ``put`` takes a power-of-two
update count, as in the JAX package, writing only the rows that belong to
roots (the JAX package sends the rest to a scratch row; here the new bank
is built at its final capacity in one copy, which matters at LLM width).
Every update returns a NEW bank; the tensors of the old one are never
written (``__setitem__``, for the legacy checkpoint surface, re-points the
bank itself).

Serving over a client-axis mesh places the bank (``place``, ``placed``):
each rank keeps the rows of its ``row_split`` of the sorted roots, the
reference's ``place_decode_state`` of the stacked models, while ``roots``
stays whole, so routing still sees every cluster. A row another rank
holds raises ``RemoteRowError`` naming that rank. Training keeps its
banks whole on every rank, as the reference's scan does; a placed bank
takes no update.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.sharding.specs import RowSplit, row_split
from repro_torch.utils import trees


class RemoteRowError(LookupError):
    """A placed bank's row that another rank holds (not a ``KeyError``, so
    ``Mapping.get`` does not take it for a missing root)."""


def _pow2(n: int) -> int:
    """Smallest power of two >= n (capacity / scatter-width quantum)."""
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


class ClusterBank(Mapping):
    """K cluster models stacked on the leading axis.

    ``stacked``: tree whose leaves are ``(capacity, ...)`` tensors with the
    K occupied rows first and zero rows after (``None`` when empty);
    ``roots``: tuple of int keys, position i ↔ row i. A placed bank
    (``split``, a ``RowSplit`` over the sorted ``roots``) holds only the
    rows ``[split.lo, split.hi)`` of them, as ``stacked``'s rows 0 ..
    hi - lo - 1, with no spare rows."""

    def __init__(self, stacked, roots: Sequence[int] = (), split: Optional[RowSplit] = None):
        self.roots: Tuple[int, ...] = tuple(int(r) for r in roots)
        self.stacked = stacked if self.roots else None
        self.split = split
        self._index = {r: i for i, r in enumerate(self.roots)}
        assert len(self._index) == len(self.roots), "duplicate bank roots"

    # ------------------------------------------------------------ builders
    @classmethod
    def empty(cls) -> "ClusterBank":
        return cls(None, ())

    @classmethod
    def from_dict(cls, models) -> "ClusterBank":
        """Stack a ``{root: tree}`` dict into a bank (rows in sorted root
        order, zero rows up to a power-of-two capacity)."""
        roots = sorted(int(k) for k in models)
        if not roots:
            return cls.empty()
        cap = _pow2(len(roots))

        def leaf(*xs):
            pad = [xs[0].new_zeros(xs[0].shape)] * (cap - len(xs))
            return torch.stack(list(xs) + pad)

        return cls(trees.tree_map(leaf, *[models[r] for r in roots]), roots)

    @classmethod
    def placed(cls, models, roots: Sequence[int], mesh) -> "ClusterBank":
        """A bank of ``roots`` placed on ``mesh`` from ``models``, which
        holds (at least) this rank's roots: those of its ``row_split`` of
        the sorted roots, or every root where the split does not divide."""
        roots = sorted({int(r) for r in roots})
        split = row_split(len(roots), mesh)
        if not split.sharded or not roots:
            return cls.from_dict({r: models[r] for r in roots})
        mine = roots[split.lo:split.hi]
        stacked = trees.tree_map(lambda *xs: torch.stack(xs), *[models[r] for r in mine])
        return cls(stacked, roots, split)

    def place(self, mesh) -> "ClusterBank":
        """This bank on a client-axis mesh: the rows of this rank's
        ``row_split`` of the sorted roots (views of this bank's rows when
        they lie in order, else a copy of them), every root still listed.
        The bank itself where it is placed already, has no mesh, or its
        roots do not divide the ranks."""
        if self.split is not None or not self.roots:
            return self
        split = row_split(len(self.roots), mesh)
        if not split.sharded:
            return self
        order = sorted(self.roots)
        if tuple(order) == self.roots:
            stacked = split.take(self.stacked)
        else:
            idx = [self._index[r] for r in order[split.lo:split.hi]]
            j = torch.as_tensor(idx, device=trees.leaves(self.stacked)[0].device)
            stacked = trees.tree_map(lambda x: torch.index_select(x, 0, j), self.stacked)
        return ClusterBank(stacked, order, split)

    def holds(self, root) -> bool:
        """False only where a placed bank's row of ``root`` is another
        rank's."""
        i = self._index.get(int(root))
        return self.split is None or i is None or self.split.lo <= i < self.split.hi

    def _row(self, root) -> int:
        """``root``'s row of ``stacked`` (``KeyError`` for an unknown root,
        ``RemoteRowError`` for another rank's)."""
        i = self._index[int(root)]
        if self.split is None:
            return i
        if not self.split.lo <= i < self.split.hi:
            share = self.split.hi - self.split.lo
            raise RemoteRowError(
                f"cluster {int(root)}'s model is held by rank {i // share} of the mesh, "
                f"not by this rank {self.split.lo // share}")
        return i - self.split.lo

    def _whole(self, what: str) -> None:
        if self.split is not None:
            raise RuntimeError(f"ClusterBank.{what} on a bank placed over a mesh: a "
                               "placed bank serves; training keeps its bank whole")

    def to_dict(self) -> Dict[int, object]:
        """The bank as a plain ``{root: tree}`` dict (views of its rows)."""
        return {r: self[r] for r in self.roots}

    @property
    def capacity(self) -> int:
        """Allocated rows (>= ``len(self)``, a power of two)."""
        if self.stacked is None:
            return 0
        return int(trees.leaves(self.stacked)[0].shape[0])

    # ------------------------------------------------------------ mapping
    def __getitem__(self, root):
        i = self._row(root)
        return trees.tree_map(lambda x: x[i], self.stacked)

    def __iter__(self):
        return iter(self.roots)

    def __len__(self) -> int:
        return len(self.roots)

    def __contains__(self, root) -> bool:
        try:
            return int(root) in self._index
        except (TypeError, ValueError):
            return False

    def __eq__(self, other) -> bool:
        """Same roots and, root by root, equal leaves (values and shapes);
        any ``{root: tree}`` mapping compares."""
        if not isinstance(other, Mapping):
            return NotImplemented
        if set(self.roots) != {int(k) for k in other.keys()}:
            return False
        for r in self.roots:
            mine, theirs = trees.leaves(self[r]), trees.leaves(other[r])
            if len(mine) != len(theirs) or not all(
                    torch.equal(a, torch.as_tensor(b, device=a.device))
                    for a, b in zip(mine, theirs)):
                return False
        return True

    __hash__ = None

    def __repr__(self) -> str:
        if self.split is not None:
            return (f"ClusterBank(roots={self.roots}, rows "
                    f"[{self.split.lo}, {self.split.hi}) on this rank)")
        return f"ClusterBank(roots={self.roots})"

    # ------------------------------------------------------------ gathers
    def take(self, roots, default):  # torchlint: hot-path
        """Batched model gather: the row of each requested root, ``default``
        for roots with no model yet (lazy θ_k = ω₀)."""
        # torchlint: disable=R2 — roots are host ints by contract (union-find roots)
        roots = np.atleast_1d(np.asarray(roots)).astype(np.int64)
        self._whole("take")
        cap = self.capacity
        idx = np.fromiter((self._index.get(int(r), cap) for r in roots),
                          np.int64, len(roots))
        if self.stacked is None:
            ext = trees.tree_map(lambda d: d[None], default)
            idx = np.zeros(len(roots), np.int64)
        elif (idx == cap).any():
            ext = trees.tree_map(
                lambda x, d: torch.cat([x, d[None].to(x.dtype)]),
                self.stacked, default)
        else:
            ext = self.stacked
        j = torch.as_tensor(idx, device=trees.leaves(ext)[0].device)
        return trees.tree_map(lambda x: torch.index_select(x, 0, j), ext)

    # ------------------------------------------------------------ scatters
    def put(self, roots, updates) -> "ClusterBank":  # torchlint: hot-path
        """Scatter stacked ``updates`` (leading axis ↔ ``roots``) into a
        new bank; unknown roots grow new rows (capacity doubles when
        full). ``updates`` may carry more rows than ``len(roots)``: the
        rest are discarded."""
        # torchlint: disable=R2 — roots are host ints by contract (union-find roots)
        roots = [int(r) for r in np.atleast_1d(np.asarray(roots))]
        self._whole("put")
        n = len(roots)
        assert len(set(roots)) == len(roots), "put() roots must be unique"
        n_rows = int(trees.leaves(updates)[0].shape[0])
        assert n_rows >= n, "updates carry fewer rows than roots"
        novel = [r for r in roots if r not in self._index]
        all_roots = self.roots + tuple(novel)
        index = {r: i for i, r in enumerate(all_roots)}
        cap = max(self.capacity, _pow2(len(all_roots)))
        base = (self.stacked if self.stacked is not None
                else trees.tree_map(lambda u: u[:0], updates))
        idx = torch.as_tensor([index[r] for r in roots],
                              device=trees.leaves(updates)[0].device)

        def leaf(b, u):
            # the old rows and the zero rows of the new capacity, in one copy
            ext = torch.cat([b, b.new_zeros((cap - b.shape[0],) + tuple(b.shape[1:]))])
            return ext.index_copy_(0, idx, u[:n].to(b.dtype))

        return ClusterBank(trees.tree_map(leaf, base, updates), all_roots)

    def set(self, root: int, model) -> "ClusterBank":
        """Write one root's model (grows a row if the root is new)."""
        return self.put([root], trees.tree_map(lambda x: x[None], model))

    def __setitem__(self, root, model) -> None:
        """In-place ``set``, for the legacy checkpoint surface
        (``checkpoint.load_stocfl``): the bank object is re-pointed at the
        new rows; the tensors of the old ones are not written."""
        nb = self.set(int(root), model)
        self.stacked, self.roots, self._index = nb.stacked, nb.roots, nb._index

    def drop(self, roots) -> "ClusterBank":  # torchlint: hot-path
        """Remove rows for ``roots`` (one keep-gather per leaf, re-padded
        to a power-of-two capacity)."""
        rm = {int(r) for r in roots} & set(self.roots)
        if not rm:
            return self
        self._whole("drop")
        keep = [r for r in self.roots if r not in rm]
        if not keep:
            return ClusterBank.empty()
        cap = _pow2(len(keep))
        idx_np = np.full(cap, self.capacity, np.int64)   # spare rows: zeros
        idx_np[: len(keep)] = [self._index[r] for r in keep]
        idx = torch.as_tensor(idx_np,
                              device=trees.leaves(self.stacked)[0].device)
        stacked = trees.tree_map(
            lambda x: torch.index_select(
                torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))]), 0, idx),
            self.stacked)
        return ClusterBank(stacked, keep)

    def rename(self, remap: Dict[int, int]) -> "ClusterBank":
        """Re-key rows (after a departure re-roots a cluster) — host only."""
        self._whole("rename")
        return ClusterBank(self.stacked,
                           [int(remap.get(r, r)) for r in self.roots])

    # ------------------------------------------------------------ merging
    def merge(self, merges, counts, init_params, mesh=None) -> "ClusterBank":  # torchlint: hot-path
        """Batched Algorithm-1 model merge: θ of each merged group is the
        member-count-weighted mean of its pre-merge models (one gather and
        one weighted segment sum per leaf). ``merges`` is the (keep,
        absorb) list from ``ClusterState.merge_round``; ``counts`` the
        pre-merge {root: members} snapshot; missing models default to
        ``init_params`` (lazy θ_k = ω₀). Under a client-axis ``mesh`` each
        rank gathers its slice of the merged rows and the segment sums are
        partial sums plus an ``all_reduce``
        (``sharding.row_split``)."""
        if not merges:  # torchlint: disable=R3 — merges is the host (keep, absorb) list
            return self
        self._whole("merge")
        parent: Dict[int, int] = {}

        def find(r: int) -> int:
            while parent.get(r, r) != r:
                parent[r] = parent.get(parent[r], parent[r])
                r = parent[r]
            return r

        for keep, absorb in merges:
            parent[find(int(absorb))] = find(int(keep))
        groups: Dict[int, list] = {}
        for r in sorted({int(x) for pair in merges for x in pair}):
            groups.setdefault(find(r), []).append(r)

        from repro_torch.core.bilevel import aggregate_segments
        from repro_torch.sharding import specs

        finals = sorted(groups)
        members = [r for f in finals for r in groups[f]]
        seg = np.repeat(np.arange(len(finals), dtype=np.int64),
                        [len(groups[f]) for f in finals])
        w = np.fromiter((counts.get(r, 1) for r in members),
                        np.float32, len(members))
        if mesh is None:
            gathered = self.take(members, init_params)
            agg = aggregate_segments(gathered, w, seg, len(finals))
        else:
            split = specs.row_split(len(members), mesh)
            gathered = self.take(split.take(np.asarray(members)), init_params)
            agg = aggregate_segments(gathered, w, seg, len(finals), split)
        absorbed = [r for r in members if r not in groups]
        return self.drop(absorbed).put(finals, agg)
