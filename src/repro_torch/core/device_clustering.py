"""Device-resident stochastic clustering core (Algorithm 1 on the device).

The host ``ClusterState`` keeps the partition in a Python ``UnionFind``
dict and pays a device→host sync plus an O(K̃²) Python pair scan every
``merge_round``. This module is the same math as a few device ops a round,
the port of the JAX package's ``core/device_clustering.py``:

  ``DeviceClusterState``  three pow2-capacity-padded tensors:
      ``parent``  (capacity,) int32  union-find pointers, row i ↔ client
                  id i; kept FULLY path-compressed (every entry is a
                  root), so root lookup is one gather
      ``live``    (capacity,) bool   observed and not departed; a
                  departure clears the bit (a tombstone), the row is
                  reused on re-join
      ``rep``     (capacity, D) f32  the Ψ(D_i) bank (dead rows zero)

  transitions:
      ``observe``      scatter new Ψ rows + self-rooted parents (update
                       count pow2-quantized through a scratch row)
      ``merge_round``  cluster means by a segment sum over roots (K4
                       resolves the roots) → fused masked-cosine-τ
                       candidates (K3, ``ops.merge_pairs``) → connected
                       components of the candidate graph (one launch,
                       ``ops.component_labels``) → new fully compressed
                       ``parent``
      ``union`` / ``remove``   the §5 join/leave repairs
      ``nearest`` / ``objective`` / ``objective_closed``   §4.4 inference
                       and the Eq. 2 metric

The partition semantics are exactly the host path's: a merge pass unions
every pair of live clusters with cos(Ψ̃_i, Ψ̃_j) ≥ τ transitively, and
every root is its cluster's smallest member id.

Purity. JAX arrays are immutable, so the reference forks a state for free.
Tensors are not: every transition here builds NEW tensors for what it
changes and shares the tensors it does not change, and no tensor reachable
from a state is ever written after the state is built. ``merge_round`` and
``union`` therefore share ``live`` and the Ψ bank and write only a new
(capacity,) int32 ``parent``; ``observe`` and ``remove`` copy the bank
(one (capacity + 1, D) copy, 315 MB at capacity 512) because they change
rows of it. That copy is the reference's own cost (``.at[].set`` on an
undonated array copies too) and is cheaper than the alternative of copying
the bank whenever a state is forked.

Determinism. ``index_add_`` on CUDA adds floats with atomics in an order
that changes from run to run, so the segment sum behind the cluster means
is ``sharding.ordered_index_add_`` (``index_put_`` with ``accumulate``,
after a stable sort): the means of a state are bitwise the same every
time, and two runs of the same rounds, or two ranks of a mesh, take the
same merge decisions.

Scatters with the reference's ``mode="drop"`` write into a buffer with one
scratch row at index ``capacity`` that is sliced off, because ``index_put_``
raises on an out-of-range index; gathers with ``mode="clip"`` only ever see
in-range indices here.

``DeviceClusters`` wraps the tensors in the host-facing ``ClusterState``
API (``observe`` / ``merge_round`` / ``nearest`` / ``infer`` / ``remove`` /
``clusters`` / ``assignment`` / ``uf.find``) with host mirrors of
``parent`` and of the live set, refreshed from the small integer outputs
of each transition, so reads never touch the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.clustering import ClusterState
from repro_torch.kernels import ops, ref
from repro_torch.sharding.specs import ordered_index_add_


def _pow2(n: int) -> int:
    """Smallest power of two >= n (capacity quantum, as in ClusterBank)."""
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class DeviceClusterState:
    """The clustering server as device tensors (row i ↔ client id i).
    Never written in place once built."""

    parent: torch.Tensor   # (capacity,) int32, fully compressed union-find
    live: torch.Tensor     # (capacity,) bool, observed ∧ not departed
    rep: torch.Tensor      # (capacity, D) float32 Ψ bank (dead rows zeroed)

    @property
    def capacity(self) -> int:
        return int(self.parent.shape[0])

    def _replace(self, **kw) -> "DeviceClusterState":
        return dataclasses.replace(self, **kw)


def init_state(capacity: int, dim: int, device="cpu") -> DeviceClusterState:
    """Fresh all-singleton state: every row self-rooted, nothing live."""
    cap = _pow2(capacity)
    return DeviceClusterState(
        parent=torch.arange(cap, dtype=torch.int32, device=device),
        live=torch.zeros((cap,), dtype=torch.bool, device=device),
        rep=torch.zeros((cap, dim), dtype=torch.float32, device=device))


def grow(state: DeviceClusterState, capacity: int) -> DeviceClusterState:
    """Pow2 row capacity >= ``capacity``: new rows are self-rooted, dead,
    zero-Ψ."""
    old = state.capacity
    cap = _pow2(max(capacity, old))
    if cap == old:
        return state
    dev = state.parent.device
    return DeviceClusterState(
        parent=torch.cat([state.parent,
                          torch.arange(old, cap, dtype=torch.int32, device=dev)]),
        live=torch.cat([state.live, state.live.new_zeros((cap - old,))]),
        rep=torch.cat([state.rep, state.rep.new_zeros((cap - old, state.rep.shape[1]))]))


def _scatter_drop(x: torch.Tensor, idx: torch.Tensor, values) -> torch.Tensor:
    """New tensor: ``x`` with rows ``idx`` set to ``values``; rows equal to
    ``len(x)`` land in a scratch row that is sliced off (the reference's
    ``mode="drop"``). A scalar ``values`` is filled on ``x``'s device, so
    the write makes no host copy."""
    ext = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    if not torch.is_tensor(values):
        values = ext.new_full((), values)
    ext[idx] = values
    return ext[: x.shape[0]]


# ------------------------------------------------------------------ math
def _segment_means(state: DeviceClusterState):
    """(root, means_ext, counts_ext): per-row resolved root (K4), and
    (capacity + 1)-row member means and counts per root row, the last row
    the scratch segment of the dead rows, always zero."""
    cap = state.capacity
    root = ops.resolve_roots(state.parent)
    cap_t = torch.full_like(root, cap)
    seg = torch.where(state.live, root, cap_t).long()
    d = state.rep.shape[1]
    dev = state.rep.device
    sums = ordered_index_add_(torch.zeros((cap + 1, d), dtype=torch.float32, device=dev),
                              seg, state.rep)
    counts = ordered_index_add_(torch.zeros((cap + 1,), dtype=torch.float32, device=dev),
                                seg, state.live.to(torch.float32))
    sums[cap] = 0.0                       # dead rows' scratch segment
    means = sums.div_(torch.clamp_min(counts, 1.0)[:, None])
    return root, means, counts


def _cluster_means(state: DeviceClusterState):
    """(root, means, counts): per-row resolved root, per-root-row member
    mean Ψ̃ and member count (zero for non-root rows)."""
    root, means, counts = _segment_means(state)
    cap = state.capacity
    return root, means[:cap], counts[:cap]


def component_labels(adj: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """Connected-component labels of a 0/1 adjacency matrix: each node's
    label converges to the smallest node id in its component.

    Min-label propagation with pointer jumping, run to a FIXED POINT: per
    pass every node takes the min over its neighbours' labels, then follows
    its own label's label, until a pass changes nothing. At a fixed point
    adjacent nodes hold equal labels, labels never leave their component,
    and the common value must be the component minimum, so the exit
    condition is the proof (a fixed pass count alone is NOT safe: an
    adversarially permuted chain needs more). On the card the loop runs
    inside one launch with no host sync; ``backend="torch"`` forces the
    plain loop, which syncs once a pass."""
    return ops.component_labels(adj, backend)


def _live_rows(counts_ext: torch.Tensor, cap: int, k_max: int) -> torch.Tensor:
    """Rows whose count is positive, ascending, cut or padded with ``cap``
    to ``k_max`` entries (the reference's ``jnp.nonzero(size=k_max,
    fill_value=cap)``); ascending order makes the min row the min root id.
    A stable sort that puts the live rows first, so no host read sizes it."""
    live = counts_ext[:cap] > 0
    order = torch.sort((~live).to(torch.int32), stable=True).indices[:k_max]
    return torch.where(live[order], order, torch.full_like(order, cap)).to(torch.int32)


def merge_round_impl(state: DeviceClusterState, tau: float, k_max: int):
    """One merge pass: ``(state, tau, k_max) -> (state', roots (k_max,),
    new_roots (k_max,), counts (k_max,))``.

    Algorithm 1 lines 10-13: means → live-root compaction → fused
    masked-cosine-τ candidates (K3) → components → compressed parents.
    ``k_max`` (≥ the live-cluster count, ≤ capacity) sizes the candidate
    matrix, so the pairwise work is O(k_max²), not O(capacity²). The three
    returned k_max-row tensors (pre-merge live roots ascending, their
    post-merge roots, their member counts; pads = capacity / 0) are all
    the host needs to re-key the bank and refresh its mirror."""
    cap = state.capacity
    dev = state.parent.device
    ids = torch.arange(cap, dtype=torch.int32, device=dev)
    root, means_ext, counts_ext = _segment_means(state)
    rows = _live_rows(counts_ext, cap, k_max)
    rows_l = rows.long()
    counts_c = counts_ext[rows_l]
    # the compacted means, gathered into rows D rounded up to 32 floats
    # apart: a layout the K3 kernel maps as it is
    means_c = torch.index_select(means_ext, 0, rows_l,
                                 out=ops.row_padded(k_max, means_ext.shape[1], dev))
    adj = ops.merge_pairs(means_c, counts_c > 0, tau)
    # with no candidate pair (the steady state) the first pass changes
    # nothing and the labels are arange(k_max), the reference's lax.cond
    # branch, with no host sync to decide it
    label = component_labels(adj)
    # back to root-id space: compact row i's cluster re-roots at the root
    # id of its component's min row
    new_root_c = torch.where(rows < cap, rows[label.long()], rows.new_full((), cap))
    mapped = _scatter_drop(ids, rows_l, new_root_c)
    new_root = mapped[root.long()]
    parent = torch.where(state.live, new_root, ids)
    return state._replace(parent=parent), rows, new_root_c, counts_c


def observe(state: DeviceClusterState, idx: torch.Tensor, reps: torch.Tensor):
    """Record Ψ rows for client ids ``idx`` (pad entries = capacity are
    dropped); the rows become live, self-rooted singletons."""
    idx_l = idx.long()
    return DeviceClusterState(
        parent=_scatter_drop(state.parent, idx_l, idx.to(torch.int32)),
        live=_scatter_drop(state.live, idx_l, True),
        rep=_scatter_drop(state.rep, idx_l, reps.to(torch.float32)))


def union(state: DeviceClusterState, a: int, b: int) -> DeviceClusterState:
    """Merge a's and b's clusters, the smaller root wins (the §4.4 join
    placement)."""
    root = ops.resolve_roots(state.parent)
    ra, rb = root[a], root[b]
    keep, absorb = torch.minimum(ra, rb), torch.maximum(ra, rb)
    return state._replace(parent=torch.where(root == absorb, keep, root))


def remove(state: DeviceClusterState, cid: int):
    """(state', old_root, new_root, n_left): tombstone a departed client's
    row and re-root its cluster at the smallest remaining member
    (``new_root == capacity`` when none remain)."""
    cap = state.capacity
    ids = torch.arange(cap, dtype=torch.int32, device=state.parent.device)
    root = ops.resolve_roots(state.parent)
    r = root[cid]
    stay = state.live & (root == r) & (ids != cid)
    n_left = stay.sum()
    new_root = torch.where(stay, ids, torch.full_like(ids, cap)).amin()
    parent = torch.where(stay, new_root, root)
    parent[cid] = cid                     # parent is a new tensor
    live = state.live.clone()
    live[cid] = False
    rep = state.rep.clone()
    rep[cid] = 0.0
    return DeviceClusterState(parent=parent, live=live, rep=rep), r, new_root, n_left


def nearest(state: DeviceClusterState, query: torch.Tensor):
    """(best root row, best cosine, live-cluster count): §4.4
    nearest-cluster-by-Ψ, dead rows masked to −inf."""
    _, means, counts = _cluster_means(state)
    qn = query / (torch.linalg.vector_norm(query) + 1e-12)
    mn = means / (torch.linalg.vector_norm(means, dim=1, keepdim=True) + 1e-12)
    sims = torch.where(counts > 0, mn @ qn,
                       torch.full_like(counts, float("-inf")))
    best = torch.argmax(sims)
    return best, sims[best], (counts > 0).sum()


def objective_impl(state: DeviceClusterState, k_max: int) -> torch.Tensor:
    """Eq. 2, Σ_{i<j} cos(Ψ̃_i, Ψ̃_j) over live clusters (0 with fewer than
    two), compacted to O(k_max²) pairwise work like the merge pass."""
    cap = state.capacity
    _, means_ext, counts_ext = _segment_means(state)
    rows = _live_rows(counts_ext, cap, k_max).long()
    mc = means_ext[rows]
    live_c = counts_ext[rows] > 0
    norms = torch.linalg.vector_norm(mc, dim=1, keepdim=True)
    mn = torch.where(norms > 0, mc / norms, torch.zeros_like(mc))
    m = mn @ mn.T
    k_ids = torch.arange(k_max, device=mc.device)
    pairs = live_c[:, None] & live_c[None, :] & (k_ids[:, None] < k_ids[None, :])
    return torch.where(pairs, m, torch.zeros_like(m)).sum()


def objective_closed_impl(state: DeviceClusterState) -> torch.Tensor:
    """Eq. 2 as the closed form ``(‖Σ m̂‖² − Σ ‖m̂‖²)/2`` over the live
    clusters' normalized means: O(capacity·D), no pairwise matrix and no
    compaction (the engine's per-round metric on the device backend).
    Exactly 0.0 with fewer than two clusters."""
    _, means, counts = _cluster_means(state)
    norms = torch.linalg.vector_norm(means, dim=1, keepdim=True)
    keep = (counts[:, None] > 0) & (norms > 0)
    mn = torch.where(keep, means / norms, torch.zeros_like(means))
    s = mn.sum(dim=0)
    return ((s * s).sum() - (mn * mn).sum()) / 2.0


def objective_closed(state: DeviceClusterState) -> float:
    """Host value of ``objective_closed_impl`` (the engine's metric call)."""
    return float(objective_closed_impl(state))


def merge_round(state: DeviceClusterState, tau: float, k_max: Optional[int] = None):
    """One merge pass; returns (state', pre-merge live roots, their
    post-merge roots, their member counts), three k_max-row tensors (pads
    = capacity / 0). ``k_max`` bounds the live-cluster count (default: the
    capacity, always safe); callers that track K̃ pass it."""
    cap = state.capacity
    k_max = cap if k_max is None else min(_pow2(k_max), cap)
    return merge_round_impl(state, float(tau), k_max)


# ================================================================ wrapper
class _RepsView:
    """Read-only mapping view of the Ψ bank keyed by live client id, the
    ``ClusterState.reps`` surface."""

    def __init__(self, owner: "DeviceClusters"):
        self._o = owner

    def __contains__(self, cid) -> bool:
        return int(cid) in self._o.seen

    def __iter__(self):
        return iter(sorted(self._o.seen))

    def __len__(self) -> int:
        return len(self._o.seen)

    def __getitem__(self, cid) -> torch.Tensor:
        if int(cid) not in self._o.seen:
            raise KeyError(cid)
        return self._o._state.rep[int(cid)]


class _UFView:
    """``ClusterState.uf``-shaped view: ``find`` reads the host parent
    mirror (the device array is always fully compressed, so the mirror is
    the root table); ``union`` runs the device transition."""

    def __init__(self, owner: "DeviceClusters"):
        self._o = owner

    def find(self, i: int) -> int:
        return int(self._o._parent[int(i)])

    def union(self, a: int, b: int) -> bool:
        return self._o._union(int(a), int(b))

    @property
    def parent(self) -> Dict[int, int]:
        """{observed client id: root} (host mirror)."""
        return {int(c): int(self._o._parent[c]) for c in sorted(self._o.seen)}


class DeviceClusters:
    """Host-facing wrapper: the ``ClusterState`` API over a
    ``DeviceClusterState`` on ``device``.

    Mutating methods replace ``self._state`` with the transition's output;
    the tensors of the old state are never written, so ``copy()`` shares
    them and a forked ``ServerState`` keeps its clustering. The host
    mirrors (``_parent`` ndarray, ``seen`` set) are refreshed from each
    transition's small integer outputs."""

    def __init__(self, tau: float, capacity: int = 0, dim: int = 0, device="cpu"):
        self.tau = float(tau)
        self.device = torch.device(device)
        self._capacity_hint = max(int(capacity), 1)
        self._state: Optional[DeviceClusterState] = None
        if dim:
            self._state = init_state(self._capacity_hint, int(dim), self.device)
        self.seen: set = set()
        self._parent = np.arange(self.capacity, dtype=np.int64)

    # ----------------------------------------------------------- plumbing
    @property
    def capacity(self) -> int:
        """Allocated union-find rows (power of two; grows on demand)."""
        if self._state is None:
            return _pow2(self._capacity_hint)
        return self._state.capacity

    @property
    def state(self) -> Optional[DeviceClusterState]:
        """The device tensors (None until the first ``observe``)."""
        return self._state

    @property
    def uf(self) -> _UFView:
        return _UFView(self)

    @property
    def reps(self) -> _RepsView:
        return _RepsView(self)

    def copy(self) -> "DeviceClusters":
        """Fork: device tensors shared (never written), host mirrors
        duplicated."""
        new = object.__new__(DeviceClusters)
        new.tau = self.tau
        new.device = self.device
        new._capacity_hint = self._capacity_hint
        new._state = self._state
        new.seen = set(self.seen)
        new._parent = self._parent.copy()
        return new

    def _ensure(self, n_ids: int, dim: int) -> None:
        """Allocate/grow so row ``n_ids - 1`` exists (pow2 capacity)."""
        if self._state is None:
            self._state = init_state(max(self._capacity_hint, n_ids), int(dim),
                                     self.device)
        elif n_ids > self.capacity:
            self._state = grow(self._state, n_ids)
        if len(self._parent) < self.capacity:
            self._parent = np.concatenate(
                [self._parent, np.arange(len(self._parent), self.capacity)])

    def _union(self, a: int, b: int) -> bool:
        ra, rb = int(self._parent[a]), int(self._parent[b])
        if ra == rb:
            return False
        self._state = union(self._state, a, b)
        keep, absorb = min(ra, rb), max(ra, rb)
        self._parent[self._parent == absorb] = keep
        return True

    def _as_rep(self, rep) -> torch.Tensor:
        if not isinstance(rep, torch.Tensor):
            rep = torch.from_numpy(np.array(rep, dtype=np.float32))
        return rep.to(device=self.device, dtype=torch.float32)

    # ------------------------------------------------------------ observe
    def observe(self, client_ids: Sequence[int], reps) -> List[int]:
        """Record Ψ for newly seen clients (one quantized scatter;
        already-seen ids are skipped). Returns the new ids."""
        new, take, batch_seen = [], [], set()
        for i, cid in enumerate(client_ids):
            cid = int(cid)
            if cid not in self.seen and cid not in batch_seen:
                new.append(cid)
                take.append(i)
                batch_seen.add(cid)
        if not new:
            return []
        reps = list(reps)
        stacked = torch.stack([self._as_rep(reps[i]) for i in take])
        self._ensure(max(new) + 1, stacked.shape[1])
        cap = self.capacity
        p = _pow2(len(new))
        idx = np.full(p, cap, np.int64)          # pad writes are dropped
        idx[: len(new)] = new
        if p > len(new):
            stacked = torch.cat([stacked, stacked.new_zeros(
                (p - len(new), stacked.shape[1]))])
        self._state = observe(self._state, torch.as_tensor(idx, device=self.device),
                              stacked)
        self.seen.update(new)
        self._parent[new] = new
        return new

    # -------------------------------------------------------------- views
    def clusters(self) -> Dict[int, List[int]]:
        """root -> sorted member client ids (live clients only)."""
        out: Dict[int, List[int]] = {}
        for cid in sorted(self.seen):
            out.setdefault(int(self._parent[cid]), []).append(cid)
        return out

    def assignment(self) -> Dict[int, int]:
        """{client id: root} over live observed clients."""
        return {cid: int(self._parent[cid]) for cid in self.seen}

    def n_clusters(self) -> int:
        return len({int(self._parent[c]) for c in self.seen})

    def cluster_means(self) -> Tuple[List[int], torch.Tensor]:
        """(sorted roots, (K̃, D) member-mean tensor on the device)."""
        roots = sorted({int(self._parent[c]) for c in self.seen})
        _, means, _ = _cluster_means(self._state)
        return roots, means[torch.as_tensor(roots, dtype=torch.long, device=self.device)]

    def similarity_matrix(self) -> Tuple[List[int], np.ndarray]:
        """(sorted roots, K̃×K̃ host cosine matrix over cluster means)."""
        roots, means = self.cluster_means()
        return roots, ref.cosine_sim_ref(means).cpu().numpy()

    # ------------------------------------------------------------- merging
    def merge_round(self) -> List[Tuple[int, int]]:
        """One device merge pass (Algorithm 1 lines 10-13).

        Returns (root_kept, root_absorbed) merges in the NORMALIZED form
        (component_min, member): the same final partition as the host scan
        (both are the τ-graph's transitive closure) and the same bank
        merge, though the list itself can differ from the host scan's visit
        order on chain topologies. Host traffic: the two k_max-row root
        tensors of the pass."""
        if len(self.seen) < 2:
            return []
        st, rows, new_roots, _counts = merge_round(self._state, self.tau,
                                                   k_max=self.n_clusters())
        self._state = st
        cap = self.capacity
        rows = rows.cpu().numpy().astype(np.int64)
        new_roots = new_roots.cpu().numpy().astype(np.int64)
        valid = rows < cap
        rows, new_roots = rows[valid], new_roots[valid]
        merges = [(int(f), int(r)) for r, f in zip(rows, new_roots) if f != r]
        # every live client's pre-merge root is one of ``rows`` (ascending)
        live = np.fromiter(self.seen, np.int64, len(self.seen))
        pre = self._parent[live]
        self._parent[live] = new_roots[np.searchsorted(rows, pre)]
        return sorted(merges)

    # ------------------------------------------------------------- metrics
    def objective(self) -> float:
        """Eq. 2 over live clusters (pairwise form, compacted to the pow2
        live-cluster count; the engine's round metric uses
        ``objective_closed``)."""
        k = self.n_clusters()
        if k < 2:
            return 0.0
        return float(objective_impl(self._state, min(_pow2(k), self.capacity)))

    # ----------------------------------------------------------- departure
    def remove(self, cid: int) -> Dict[int, int]:
        """Tombstone a departed client's row (§5) and re-root its cluster
        at the smallest remaining member. Returns {old_root: new_root}
        when the root changed (the bank re-key)."""
        cid = int(cid)
        if cid not in self.seen:
            return {}
        st, r, new_root, n_left = remove(self._state, cid)
        self._state = st
        self.seen.discard(cid)
        r, new_root, n_left = int(r), int(new_root), int(n_left)
        remap = {}
        if n_left and new_root != r:
            self._parent[self._parent == r] = new_root
            remap = {r: new_root}
        # the departed row re-roots to itself after the remap mask, as on
        # the device
        self._parent[cid] = cid
        return remap

    # ----------------------------------------------------------- inference
    def nearest(self, rep) -> Tuple[Optional[int], Optional[int], float]:
        """§4.4: (root above τ or None, nearest root regardless, cosine)."""
        if not self.seen:
            return None, None, 0.0
        best, sim, _n = nearest(self._state, self._as_rep(rep))
        best, sim = int(best), float(sim)
        return (best if sim >= self.tau else None), best, sim

    def infer(self, rep) -> Tuple[Optional[int], float]:
        root, _, sim = self.nearest(rep)
        return root, sim

    # -------------------------------------------------------- serialization
    def arrays(self) -> Dict[str, np.ndarray]:
        """Host copies of the tensors; an empty state gives zero-capacity
        arrays."""
        if self._state is None:
            return {"parent": np.zeros(0, np.int32),
                    "live": np.zeros(0, bool),
                    "rep": np.zeros((0, 0), np.float32)}
        return {"parent": self._state.parent.cpu().numpy(),
                "live": self._state.live.cpu().numpy(),
                "rep": self._state.rep.cpu().numpy()}

    @classmethod
    def from_arrays(cls, tau: float, parent, live, rep, device="cpu") -> "DeviceClusters":
        """Rebuild from ``arrays()`` output (exact mirror restore). Tensors
        already on ``device`` are kept as they are (a captured span's final
        state, which nothing else holds); arrays are copied."""
        out = cls(tau, capacity=max(len(parent), 1), device=device)
        if len(parent):
            dev = out.device

            def own(x, dtype):
                if torch.is_tensor(x):
                    return x.to(device=dev, dtype=dtype)
                return torch.tensor(np.asarray(x), dtype=dtype, device=dev)

            out._state = DeviceClusterState(parent=own(parent, torch.int32),
                                            live=own(live, torch.bool),
                                            rep=own(rep, torch.float32))
            host = lambda x: x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
            out.seen = {int(i) for i in np.nonzero(host(live))[0]}
            out._parent = host(parent).astype(np.int64).copy()
        return out

    def __repr__(self) -> str:
        return (f"DeviceClusters(tau={self.tau}, capacity={self.capacity}, "
                f"live={len(self.seen)}, k={self.n_clusters()})")


def make_cluster_state(tau: float, backend: str = "numpy", capacity: int = 0,
                       device="cpu"):
    """Factory for the engine: ``"numpy"`` → host ``ClusterState``,
    ``"device"`` → ``DeviceClusters``, both on ``device``."""
    if backend == "device":
        return DeviceClusters(tau, capacity=capacity, device=device)
    if backend == "numpy":
        return ClusterState(tau, device)
    raise ValueError(f"unknown cluster_backend {backend!r} "
                     "(expected 'numpy' or 'device')")
