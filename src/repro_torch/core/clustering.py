"""Stochastic federated client clustering (paper §3.2, Algorithm 1 l.4-13).

Server-side state over client distribution representations Ψ(D_i):
  - partition C (union-find over client ids), initially singletons;
  - per round: observe Ψ of newly-participating clients, recompute cluster
    mean representations, build the pairwise cosine matrix M (the CUDA
    ``cosine_sim`` kernel on the card), greedily merge every pair with
    M_ij ≥ τ (transitively, via union-find);
  - objective (Eq. 2): Σ_{i<j} cos(Ψ̃_i, Ψ̃_j);
  - new-client inference (§4.4): nearest cluster if best cosine ≥ τ, else
    a fresh cluster seeded from the nearest cluster's model.

The partition bookkeeping is host Python; the Ψ bank, the cluster means
and the similarity matrix live on the state's device.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.sharding.specs import ordered_index_add_


class UnionFind:
    """Host union-find over client ids (path-halving find, smaller-root-
    wins union)."""

    def __init__(self):
        self.parent: Dict[int, int] = {}

    def add(self, i: int):
        """Register ``i`` as a singleton (no-op when already present)."""
        self.parent.setdefault(i, i)

    def find(self, i: int) -> int:
        """Root of ``i``'s cluster, compressing the path as it walks."""
        p = self.parent
        while p[i] != i:
            p[i] = p[p[i]]
            i = p[i]
        return i

    def union(self, a: int, b: int) -> bool:
        """Merge a's and b's clusters; returns True when they were
        distinct. The smaller root id always wins, so every root is its
        cluster's minimum member id."""
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        if rb < ra:
            ra, rb = rb, ra
        self.parent[rb] = ra
        return True


class ClusterState:
    """The StoCFL server's clustering bookkeeping; Ψ rows on ``device``."""

    def __init__(self, tau: float, device="cpu"):
        self.tau = float(tau)
        self.device = torch.device(device)
        self.uf = UnionFind()
        self.reps: Dict[int, torch.Tensor] = {}     # client id -> Ψ(D_i)
        self.seen: set = set()                      # P in Algorithm 1

    def copy(self) -> "ClusterState":
        """Structural copy (Ψ tensors shared — never mutated in place), so
        the engine's pure transitions can fork the bookkeeping."""
        new = ClusterState(self.tau, self.device)
        new.uf.parent = dict(self.uf.parent)
        new.reps = dict(self.reps)
        new.seen = set(self.seen)
        return new

    def _as_rep(self, rep) -> torch.Tensor:
        """A Ψ vector (tensor or array) as an fp32 tensor on the device."""
        if not isinstance(rep, torch.Tensor):
            # torchlint: disable=R2 — rep is a host array in this branch: no device read
            rep = torch.from_numpy(np.array(rep, dtype=np.float32))
        return rep.to(device=self.device, dtype=torch.float32)

    # ------------------------------------------------------------- observe
    def observe(self, client_ids: Sequence[int], reps) -> List[int]:  # torchlint: hot-path
        """Record Ψ for newly-seen clients. Returns the new ids."""
        new = []
        for cid, rep in zip(client_ids, reps):
            cid = int(cid)
            self.uf.add(cid)
            if cid not in self.seen:
                self.reps[cid] = self._as_rep(rep)
                self.seen.add(cid)
                new.append(cid)
        return new

    # ------------------------------------------------------------- views
    def clusters(self) -> Dict[int, List[int]]:
        """root -> sorted member client ids (only observed clients)."""
        out: Dict[int, List[int]] = {}
        for cid in sorted(self.reps):
            out.setdefault(self.uf.find(cid), []).append(cid)
        return out

    def cluster_means(self) -> Tuple[List[int], torch.Tensor]:
        """Ψ̃ per cluster: (roots, (K̃, D) tensor of member means), one
        segment sum over the stacked Ψ rows, in one fixed order
        (``sharding.ordered_index_add_``; the card's ``index_add_`` adds
        with atomics, in an order that changes from run to run), so the
        means of a state are bitwise the same every time, and every rank
        of a mesh, each computing them on its own, takes the same merge
        decisions."""
        cids = sorted(self.reps)
        per = np.fromiter((self.uf.find(c) for c in cids), np.int64, len(cids))
        roots, inv = np.unique(per, return_inverse=True)
        R = torch.stack([self.reps[c] for c in cids])
        idx = torch.as_tensor(inv, device=self.device)
        mat = ordered_index_add_(torch.zeros((len(roots), R.shape[1]), dtype=torch.float32,
                                             device=self.device), idx, R)
        counts = torch.as_tensor(np.bincount(inv).astype(np.float32),
                                 device=self.device)
        return [int(r) for r in roots], mat / counts[:, None]

    def assignment(self) -> Dict[int, int]:
        """{client id: cluster root} over observed clients."""
        return {cid: self.uf.find(cid) for cid in self.reps}

    def n_clusters(self) -> int:
        """Current cluster count K̃."""
        return len(self.clusters())

    # ------------------------------------------------------------- merging
    def padded_means(self, pad_to: int = 64) -> Tuple[List[int], torch.Tensor]:
        """(roots, cluster means padded with zero rows to a multiple of
        ``pad_to``): the matrix ``similarity_matrix`` hands to the cosine
        kernel, so the kernel sees few distinct shapes as K̃ drifts. Its rows
        lie D rounded up to 32 floats apart (``ops.row_padded``), a layout
        the kernel maps as it is."""
        roots, means = self.cluster_means()
        k = len(roots)
        kp = -(-k // pad_to) * pad_to if pad_to and k % pad_to else k
        x = ops.row_padded(kp, means.shape[1], means.device, means.dtype)
        x[:k] = means
        x[k:] = 0.0
        return roots, x

    def similarity_matrix(self, pad_to: int = 64) -> Tuple[List[int], np.ndarray]:
        """(roots, K̃×K̃ host cosine matrix over cluster means), computed
        on ``padded_means``; the zero pad rows, whose similarities the
        kernel makes exactly 0, are sliced off before return."""
        roots, means = self.padded_means(pad_to)
        k = len(roots)
        # torchlint: disable=R2 — the host backend reads the cosines by design
        M = ops.pairwise_cosine(means).cpu().numpy()
        if M.shape[0] > k and (M[k:, :].any() or M[:k, k:].any()):
            # pad rows are zero-Ψ ghosts whose similarities must be exact
            # 0; should a kernel ever leak a nonzero value into the pad
            # block, scrub it so no scan can turn a ghost into a merge
            M = M.copy()
            M[k:, :] = 0.0
            M[:, k:] = 0.0
        return roots, M[:k, :k]

    def merge_round(self) -> List[Tuple[int, int]]:  # torchlint: hot-path
        """One greedy merge pass (Algorithm 1, lines 10-13).

        Returns the (root_kept, root_absorbed) merges performed, in the
        row-major order of the qualifying pairs."""
        if len(self.reps) < 2:
            return []
        roots, M = self.similarity_matrix()
        iu, ju = np.nonzero(np.triu(M >= self.tau, k=1))
        merges = []
        for i, j in zip(iu.tolist(), ju.tolist()):
            ra, rb = self.uf.find(roots[i]), self.uf.find(roots[j])
            if ra != rb:
                keep, absorb = min(ra, rb), max(ra, rb)
                self.uf.union(keep, absorb)
                merges.append((keep, absorb))
        return merges

    # ------------------------------------------------------------- metrics
    def objective(self) -> float:
        """Eq. 2: Σ_{i<j} cos(Ψ̃^{(i)}, Ψ̃^{(j)}) over current clusters."""
        if self.n_clusters() < 2:
            return 0.0
        _, M = self.similarity_matrix()
        iu = np.triu_indices(M.shape[0], k=1)
        return float(np.sum(M[iu]))

    # ------------------------------------------------------------- departure
    def remove(self, cid: int) -> Dict[int, int]:
        """Drop a departed client from reps/seen AND the union-find. Each
        affected cluster is re-rooted at its smallest remaining member;
        returns {old_root: new_root} for clusters whose root changed."""
        cid = int(cid)
        groups: Dict[int, List[int]] = {}
        for i in self.uf.parent:
            groups.setdefault(self.uf.find(i), []).append(i)
        self.reps.pop(cid, None)
        self.seen.discard(cid)
        if cid not in self.uf.parent:
            return {}
        parent: Dict[int, int] = {}
        remap: Dict[int, int] = {}
        for root, members in groups.items():
            members = [m for m in members if m != cid]
            if not members:
                continue
            new_root = min(members)
            if new_root != root:
                remap[root] = new_root
            for m in members:
                parent[m] = new_root
        self.uf.parent = parent
        return remap

    # ------------------------------------------------------------- inference
    def nearest(self, rep) -> Tuple[Optional[int], Optional[int], float]:
        """Nearest cluster by Ψ cosine (§4.4): (root or None, nearest root,
        best cosine). ``root`` is set iff the cosine clears τ; both are
        None when no client has been observed yet."""
        if not self.reps:
            return None, None, 0.0
        roots, means = self.cluster_means()
        rep = self._as_rep(rep)
        rn = rep / (torch.linalg.vector_norm(rep) + 1e-12)
        mn = means / (torch.linalg.vector_norm(means, dim=1, keepdim=True) + 1e-12)
        sims = (mn @ rn).cpu().numpy()
        best = int(np.argmax(sims))
        root = roots[best] if sims[best] >= self.tau else None
        return root, roots[best], float(sims[best])

    def infer(self, rep) -> Tuple[Optional[int], float]:
        """§4.4: (nearest root if its cosine clears τ else None, cosine)."""
        root, _, sim = self.nearest(rep)
        return root, sim


def adjusted_rand_index(labels_a: Sequence[int], labels_b: Sequence[int]) -> float:
    """ARI between two clusterings (for validating cluster recovery)."""
    a = np.asarray(labels_a)
    b = np.asarray(labels_b)
    n = len(a)
    ua, ia = np.unique(a, return_inverse=True)
    ub, ib = np.unique(b, return_inverse=True)
    cont = np.zeros((len(ua), len(ub)), dtype=np.int64)
    np.add.at(cont, (ia, ib), 1)
    comb = lambda x: x * (x - 1) // 2
    sum_ij = comb(cont).sum()
    sum_a = comb(cont.sum(axis=1)).sum()
    sum_b = comb(cont.sum(axis=0)).sum()
    total = comb(n)
    expected = sum_a * sum_b / total if total else 0.0
    max_idx = (sum_a + sum_b) / 2
    if max_idx == expected:
        return 1.0
    return float((sum_ij - expected) / (max_idx - expected))
