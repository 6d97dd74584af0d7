"""Federated strategies over shared machinery — so far StoCFL.

A ``Strategy`` turns ``(ctx, state, client_ids)`` into ``(state', metrics)``
without mutating its input. When the context carries a ``ClientArena``
the cohort's data is one device gather (``arena.gather``); without one it
is restacked from the context's client list every round. Cluster models
are batched through the stacked ``ClusterBank`` (gather in, segment-sum
aggregate out). Cohorts larger than ``cfg.cohort_chunk`` run in chunks
(``bilevel.chunk_map``). The phases of a StoCFL round are named
``torch.profiler`` ranges (``stocfl.*``), which only a recording profiler
reads.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bilevel
from repro_torch.core import device_clustering as devclust
from repro_torch.core.aggregators import AGGREGATORS
from repro_torch.engine.bank import ClusterBank, _pow2 as bank_pow2
from repro_torch.engine.registry import register
from repro_torch.engine.state import EngineContext, ServerState, fresh_rng_state
from repro_torch.utils import trees

_span = torch.profiler.record_function


# --------------------------------------------------------------------- shared
def client_sizes(clients) -> tuple:
    return tuple(int(trees.leaves(c)[0].shape[0]) for c in clients)


def _stack(ctx: EngineContext, ids) -> dict:
    """Arena-less cohort data: the clients' batches stacked on a new
    leading axis."""
    return trees.tree_map(lambda *xs: torch.stack(xs),
                          *[ctx.clients[int(c)] for c in ids])


def _batches(ctx: EngineContext, ids):
    """Cohort data: one arena gather, or the per-round restack."""
    if ctx.arena is not None:
        return ctx.arena.gather(ids)
    return _stack(ctx, ids)


def _append_to_arena(ctx: EngineContext, batch) -> None:
    if ctx.arena is not None:
        ctx.arena = ctx.arena.append(batch)


def _retire_from_arena(ctx: EngineContext, cid: int) -> None:
    """Tombstone a departed client's arena row (compacted in bulk once
    enough rows die, see ``ClientArena.tombstone``)."""
    if ctx.arena is not None:
        ctx.arena = ctx.arena.tombstone(int(cid))


def _psi(ctx: EngineContext, cid: int):
    """Ψ of one client, from its arena row (padded and masked, the same
    source the reference reads with an arena) or from the client list."""
    if ctx.arena is not None:
        return ctx.extractor(trees.tree_map(lambda x: x[0], ctx.arena.gather([cid])))
    return ctx.extractor(ctx.clients[cid])


def _weights(state: ServerState, ids) -> torch.Tensor:
    """Per-client sample counts of the cohort, f32 on the engine device."""
    w = np.asarray(state.sizes, np.float32)[np.asarray(ids)]
    return torch.as_tensor(w, device=state.ctx.device)


def merge_cluster_models(models, merges, counts, init_params):
    """Merge θ along partition merges, each side weighted by its member
    count. ``counts`` is the pre-merge {root: n_members} snapshot.
    ``ClusterBank`` inputs take the batched path (``bank.merge``); plain
    dicts the sequential pairwise means (the same math)."""
    if isinstance(models, ClusterBank):
        return models.merge(merges, counts, init_params)
    models = dict(models)
    counts = dict(counts)
    for keep, absorb in merges:
        m_keep = models.pop(keep, init_params)
        m_abs = models.pop(absorb, init_params)
        n_k = float(counts.get(keep, 1))
        n_a = float(counts.get(absorb, 1))
        models[keep] = trees.tree_weighted_mean([m_keep, m_abs], [n_k, n_a])
        counts[keep] = n_k + n_a
    return models


class Strategy:
    """Protocol every federated method implements: ``init_state(ctx)``,
    ``round(ctx, state, client_ids)``, and the serving-side ``evaluate`` /
    ``join`` / ``leave`` / ``infer``. Register with ``@register("name")``."""

    name = "base"
    needs_extractor = False

    def init_state(self, ctx: EngineContext) -> ServerState:
        """Round-0 state: ω = ω₀, empty bank, fresh sampling rng."""
        return ServerState(ctx=ctx, strategy=self.name, round=0,
                           rng_state=fresh_rng_state(ctx.cfg.seed),
                           sizes=client_sizes(ctx.clients), left=frozenset(),
                           omega=ctx.init_params, models=ClusterBank.empty())

    def round(self, ctx: EngineContext, state: ServerState, client_ids):
        raise NotImplementedError

    def evaluate(self, ctx, state, test_sets, true_cluster=None) -> dict:
        """Held-out evaluation; the base serves every test set with ω."""
        accs = {k: float(ctx.eval_fn(state.omega, b)) for k, b in test_sets.items()}
        return {"cluster_avg": float(np.mean(list(accs.values()))), "per": accs}

    def join(self, ctx, state, batch):
        """Register a new client (§5): append its data to the world (client
        list and arena) and its size to the state; returns
        ``(state', cid)``."""
        cid = len(ctx.clients)
        ctx.clients.append(batch)
        _append_to_arena(ctx, batch)
        sizes = state.sizes + (int(trees.leaves(batch)[0].shape[0]),)
        return state.replace(sizes=sizes), cid

    def leave(self, ctx, state, cid):
        """Departure (§5): stop sampling ``cid`` and tombstone its arena
        row."""
        _retire_from_arena(ctx, cid)
        return state.replace(left=state.left | {int(cid)})

    def infer(self, ctx, state, batch) -> dict:
        raise NotImplementedError(f"strategy {self.name!r} has no cluster inference")

    def infer_many(self, ctx, state, batches) -> list:
        """Batched ``infer``: one result dict per batch, in order."""
        return [self.infer(ctx, state, b) for b in batches]


# --------------------------------------------------------------------- stocfl
@register("stocfl")
class StoCFLStrategy(Strategy):
    """Algorithm 1: stochastic Ψ-clustering + bi-level cohort update."""

    needs_extractor = True

    def init_state(self, ctx):
        """Adds the Ψ-clustering bookkeeping: the host ``ClusterState`` or,
        with ``cfg.cluster_backend="device"``, the ``DeviceClusters``
        union-find (same partition semantics, see
        ``core.device_clustering``)."""
        clusters = devclust.make_cluster_state(ctx.cfg.tau, ctx.cfg.cluster_backend,
                                               capacity=len(ctx.clients),
                                               device=ctx.device)
        return super().init_state(ctx).replace(clusters=clusters)

    def _cohort(self, ctx):
        cfg = ctx.cfg
        fused = bool(cfg.fused_step)
        # the fused path reaches the prox_update kernel on CUDA; the tree
        # path pins the plain version, as the JAX package pins "jnp"
        return ctx.cached(f"stocfl_cohort:{fused}", lambda: bilevel.chunk_map(
            bilevel.make_cohort_update(ctx.loss_fn, cfg.lr, cfg.lam, cfg.local_steps,
                                       backend="auto" if fused else "torch",
                                       fused=fused),
            (0, None, 0), cfg.cohort_chunk))

    def round(self, ctx, state, client_ids):
        """One server round. The metrics add ``merges``, the (kept,
        absorbed) root pairs of this round's merge pass, to the JAX
        package's ``n_clusters`` / ``objective`` / ``sampled``."""
        cfg = ctx.cfg
        client_ids = np.asarray(client_ids)
        clusters = state.clusters.copy()

        # --- stochastic client clustering (Algorithm 1 lines 5-13)
        new_ids = [int(c) for c in client_ids if c not in clusters.seen]
        with _span("stocfl.psi_extract"):
            if new_ids:
                clusters.observe(new_ids, [_psi(ctx, c) for c in new_ids])
        counts = {r: len(m) for r, m in clusters.clusters().items()}
        with _span("stocfl.merge_pass"):
            merges = clusters.merge_round()
        with _span("stocfl.bank_merge"):
            models = merge_cluster_models(state.models, merges, counts,
                                          ctx.init_params)

        # --- bi-level CFL (lines 14-19): one cohort step
        roots = np.fromiter((clusters.uf.find(int(c)) for c in client_ids),
                            np.int64, len(client_ids))
        with _span("stocfl.gather"):
            thetas = models.take(roots, ctx.init_params)
            if cfg.fused_step:
                # one (C, P) buffer, which the fused update takes over; the
                # gathered tree is freed here
                thetas = bilevel.flatten_tree(thetas, batch_dims=1)
            batches = _batches(ctx, client_ids)
        with _span("stocfl.cohort_update"):
            thetas_i, omegas_i = self._cohort(ctx)(thetas, state.omega, batches)

        with _span("stocfl.aggregate"):
            w = _weights(state, client_ids)
            omega = AGGREGATORS[cfg.aggregator](omegas_i, w)
            uroots, seg = np.unique(roots, return_inverse=True)
            agg = bilevel.aggregate_segments(thetas_i, w, seg,
                                             bank_pow2(len(uroots)))
            models = models.put([int(r) for r in uroots], agg)

        with _span("stocfl.objective"):
            if isinstance(clusters, devclust.DeviceClusters):
                # the closed form, the reference's device-backend metric
                objective = devclust.objective_closed(clusters.state)
            else:
                objective = clusters.objective()
        rec = {"n_clusters": clusters.n_clusters(),
               "objective": objective,
               "sampled": len(client_ids),
               "merges": tuple(merges)}
        return state.replace(omega=omega, models=models, clusters=clusters), rec

    def evaluate(self, ctx, state, test_sets, true_cluster=None):
        """Each true cluster is evaluated with the model of the learned
        cluster holding most of its clients; ω is evaluated on everything."""
        assert ctx.eval_fn is not None
        assign = state.clusters.assignment()
        out, glob = {}, {}
        for tc, batch in test_sets.items():
            roots = [assign[c] for c in assign if true_cluster[c] == tc]
            if roots:
                root = max(set(roots), key=roots.count)
                model = state.cluster_model(root)
            else:
                model = state.omega
            out[tc] = float(ctx.eval_fn(model, batch))
            glob[tc] = float(ctx.eval_fn(state.omega, batch))
        return {"cluster": out, "cluster_avg": float(np.mean(list(out.values()))),
                "global": glob, "global_avg": float(np.mean(list(glob.values())))}

    def join(self, ctx, state, batch):
        """Dynamic join (§5): register the client, infer its cluster via Ψ
        against the pre-existing clusters, or open a fresh cluster seeded
        from the nearest one's model."""
        state, cid = super().join(ctx, state, batch)
        clusters = state.clusters.copy()
        models = state.models
        rep = ctx.extractor(batch)
        root, near, _sim = clusters.nearest(rep)
        clusters.observe([cid], [rep])
        if root is not None:
            clusters.uf.union(min(root, cid), max(root, cid))
        elif near is not None:
            models = models.set(clusters.uf.find(cid),
                                models.get(near, ctx.init_params))
        return state.replace(clusters=clusters, models=models), cid

    def leave(self, ctx, state, cid):
        """Dynamic leave: drop the client from Ψ and the union-find; the
        cluster keeps its model, re-keyed if its root changed."""
        state = super().leave(ctx, state, cid)
        clusters = state.clusters.copy()
        remap = clusters.remove(cid)
        return state.replace(clusters=clusters,
                             models=state.models.rename(remap))

    def infer(self, ctx, state, batch):
        """Cluster inference for an unseen client (§4.4), without joining."""
        rep = ctx.extractor(batch)
        root, near, sim = state.clusters.nearest(rep)
        src = root if root is not None else near
        model = state.cluster_model(src) if src is not None else state.omega
        return {"cluster": root, "seed_from": src, "similarity": sim, "model": model}

    def infer_many(self, ctx, state, batches):
        """§4.4 for many unseen batches in one pass: Ψ of each batch by the
        engine's one extractor (the reference vmaps it; here one autograd
        call each, the round's own Ψ), then one cluster-means snapshot and
        every (rep, cluster) pair scored as one (J, K̃) cosine matrix.
        Routing decisions match per-batch ``infer``."""
        if not batches:
            return []
        reps = torch.stack([ctx.extractor(b) for b in batches])
        if state.clusters is None or state.clusters.n_clusters() == 0:
            return [{"cluster": None, "seed_from": None, "similarity": 0.0,
                     "model": state.omega} for _ in batches]
        roots, means = state.clusters.cluster_means()
        mn = means / (torch.linalg.vector_norm(means, dim=1, keepdim=True) + 1e-12)
        rn = reps / (torch.linalg.vector_norm(reps, dim=1, keepdim=True) + 1e-12)
        sims = (rn @ mn.T).cpu().numpy()                   # (J, K̃)
        tau = state.clusters.tau
        out = []
        for j in range(len(batches)):
            best = int(np.argmax(sims[j]))
            sim = float(sims[j][best])
            root = int(roots[best])
            out.append({"cluster": root if sim >= tau else None,
                        "seed_from": root, "similarity": sim,
                        "model": state.cluster_model(root)})
        return out
