"""The six federated strategies over shared machinery: StoCFL and the
paper's baselines (FedAvg, FedProx, Ditto, IFCA, CFL).

The paper frames StoCFL as a family that degenerates into the baselines
(§3.4: τ=1 → Ditto, λ=0 → CFL, λ=0 ∧ τ=−1 → FedAvg); every method here is
a ``Strategy`` over the same cohort primitives (``bilevel.make_cohort_update``
for StoCFL, ``bilevel.make_cohort_sgd`` for the baselines), the same
weighted aggregation and the same ``ServerState`` transitions.

A ``Strategy`` turns ``(ctx, state, client_ids)`` into ``(state', metrics)``
without mutating its input. When the context carries a ``ClientArena``
the cohort's data is one device gather (``arena.gather``); without one it
is restacked from the context's client list every round. Cluster models
are batched through the stacked ``ClusterBank`` (gather in, segment-sum
aggregate out). Cohorts larger than ``cfg.cohort_chunk`` run in chunks
(``bilevel.chunk_map``). The phases of a StoCFL round are named
``torch.profiler`` ranges (``stocfl.*``), which only a recording profiler
reads.

Every strategy also has ``scan_round``: its round as one step over
fixed-shape device tensors, with the cohort drawn on the device
(``engine.sampler``) and gathered from the arena by a device id tensor,
and no host read anywhere in it, which ``engine.run_rounds`` runs as a
plain loop on the CPU and captures in a CUDA graph on the card. Where the
reference's scanned step skips work with ``lax.cond`` (StoCFL's observe,
merge pass, bank merge and objective; CFL's split seeds), the step does
the work every round, masked: on the rounds the reference skips, that
work changes nothing.

Under a client-axis mesh (``EngineContext.mesh``, one process per rank)
each rank trains its contiguous slice of the cohort (``_split``: a
``sharding.RowSplit``, the whole cohort when its size does not divide the
ranks). With an arena, whose rows live on their owners
(``ClientArena.place``), every rank gathers the whole cohort's data in
one collective and keeps its slice (``_cohort_data``); without one it
stacks its own rows. Each new client's Ψ is taken by the rank whose slice
holds it, and the rows go to every rank bit for bit before ``observe``
(``_new_reps``; the scanned step likewise, over its slice). ω's mean, the
per-cluster ``aggregate_segments`` and the eager bank merge are local
partial sums plus one ``all_reduce``; rows every rank needs (Ditto's
personal rows, IFCA's losses, CFL's update vectors) come back whole
through ``RowSplit.gather``; the rest (the partition, the bank) is
computed on every rank from the same inputs, so the state stays the
same on every rank. The float segment sums every rank makes on its own
(the row-keyed bank merge, CFL's mean update, a cohort that is not
split) run in one fixed order (``sharding.ordered_index_add_``): the
card's ``index_add_`` would sum them in another order on each rank.
Without a mesh no split is made and the code is the single-process path.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from repro_torch.core import bilevel
from repro_torch.core import device_clustering as devclust
from repro_torch.core.aggregators import aggregate_omega
from repro_torch.core.extractor import leaf_paths
from repro_torch.data.arena import take_rows
from repro_torch.engine import sampler
from repro_torch.engine.bank import ClusterBank, _pow2 as bank_pow2
from repro_torch.engine.registry import register
from repro_torch.engine.state import (EngineContext, ServerState, fresh_rng_key,
                                      fresh_rng_state)
from repro_torch.sharding import specs as shard_specs
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


def _split_arena(ctx: EngineContext) -> bool:
    """Whether the arena's rows live on their owners (a collective gather)."""
    return ctx.arena is not None and ctx.arena.owners.sharded


def _cohort_data(ctx: EngineContext, split, ids, whole=None):
    """This rank's rows of the cohort ``ids``' data. From a split arena
    every rank gathers the whole cohort (``whole``, if the caller has it
    already) and narrows; otherwise the rank gathers or stacks its own
    rows."""
    if _split_arena(ctx):
        return _local(split, ctx.arena.gather(ids) if whole is None else whole)
    return _batches(ctx, _local(split, ids))


def _scan_data(cs: dict, split, ids: torch.Tensor, ragged: bool, owners):
    """``_cohort_data`` in a round step: this rank's rows of the cohort
    of the device ids ``ids``, from ``_arena_consts`` operands."""
    if owners.sharded:  # torchlint: disable=R3 — the arena's host-side row layout
        return _local(split, _gather_scan(cs, ids, ragged, owners))
    return _gather_scan(cs, _local(split, ids), ragged, owners)


def _split(ctx: EngineContext, n: int):
    """This rank's share of an ``n``-row cohort under the context's mesh
    (``sharding.row_split``); None without a mesh."""
    return None if ctx.mesh is None else shard_specs.row_split(n, ctx.mesh)


def _local(split, x):
    """This rank's rows of a full-length cohort value (ids, roots, a
    batch); ``x`` itself without a split."""
    return x if split is None else split.take(x)


def _gather(split, tree):
    """Every rank's rows of a split cohort output, whole on every rank."""
    return tree if split is None else split.gather(tree)


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


def _new_reps(ctx: EngineContext, client_ids, new_ids, split, whole=None):
    """Ψ of the cohort's new clients ``new_ids``, in order, the same bits
    on every rank. Split over the ranks, each rank takes the Ψ of the new
    clients in its slice of the cohort (from ``whole``, the cohort's data
    gathered from a split arena, or from the client's own row), writes
    them at their cohort positions and one ``RowSplit.gather`` sends them
    to every rank; otherwise every rank takes them all."""
    pos = {int(c): i for i, c in enumerate(client_ids)}

    def psi(c):
        if whole is None:
            return _psi(ctx, c)
        return ctx.extractor(trees.tree_map(lambda x: x[pos[c]].clone(), whole))

    if split is None or not split.sharded:
        return [psi(c) for c in new_ids]
    rows = torch.zeros((split.hi - split.lo, ctx.psi_dim), dtype=torch.float32,
                       device=ctx.device)
    for c in new_ids:
        if split.lo <= pos[c] < split.hi:
            rows[pos[c] - split.lo] = psi(c)
    full = split.gather(rows)
    return [full[pos[c]] for c in new_ids]


def _join_rep(ctx: EngineContext, cid: int, batch):
    """Ψ of a newcomer's ``batch``: every rank takes it, or over a split
    arena the owner of the newcomer's row alone, and the row reaches every
    rank bit for bit (``RowOwners.send``)."""
    if not _split_arena(ctx):
        return ctx.extractor(batch)
    owners = ctx.arena.owners
    src = owners.owner(ctx.arena.rows[cid])
    mine = ctx.extractor(batch) if owners.rank == src else None
    return owners.send(mine, src, torch.empty((ctx.psi_dim,), dtype=torch.float32,
                                              device=ctx.device))


def _held_model(state: ServerState, root: int):
    """θ of cluster ``root``, or None where a placed bank holds it on
    another rank."""
    holds = getattr(state.models, "holds", None)
    return state.cluster_model(root) if holds is None or holds(root) else None


def stack_batches(batches):
    """Batches of one tree structure stacked on a new leading axis; raises
    ``ValueError`` naming the first leaf that a batch lacks, adds or holds
    in another shape than the first batch."""
    paths0 = leaf_paths(batches[0])
    shapes0 = [tuple(x.shape) for x in trees.leaves(batches[0])]
    for j, b in enumerate(batches[1:], 1):
        paths = leaf_paths(b)
        if paths != paths0:
            odd = sorted(set(paths) ^ set(paths0)) or paths
            raise ValueError(f"batch {j} has another tree structure than batch 0: "
                             f"leaf {odd[0]!r} differs ({paths} against {paths0})")
        for p, x, want in zip(paths, trees.leaves(b), shapes0):
            if tuple(x.shape) != want:
                raise ValueError(f"leaf {p!r} of batch {j} has shape {tuple(x.shape)}, "
                                 f"batch 0's {want}")
    return trees.tree_map(lambda *xs: torch.stack(xs), *batches)


def eval_model(ctx: EngineContext, model, batch) -> float:
    """``ctx.eval_fn(model, batch)`` as a float, computed as the JAX
    package computes it when the dtypes differ: JAX promotes a bf16 ×
    fp32 product to fp32, so under ``EngineConfig(dtype="bfloat16")`` the
    model's floating leaves are up-cast (exactly) to the batch's floating
    dtype for the forward pass. The batch is never down-cast."""
    xs = [x for x in trees.leaves(batch) if x.is_floating_point()]
    if xs:
        want = xs[0].dtype
        model = trees.tree_map(
            lambda p: p.to(want) if p.is_floating_point() and
            torch.finfo(p.dtype).bits < torch.finfo(want).bits else p, model)
    return float(ctx.eval_fn(model, batch))


def _weights(state: ServerState, ids) -> torch.Tensor:  # torchlint: hot-path
    """Per-client sample counts of the cohort, f32 on the engine device."""
    # torchlint: disable=R2 — the eager round's weights are host-side by design
    w = np.asarray(state.sizes, np.float32)[np.asarray(ids)]
    return torch.as_tensor(w, device=state.ctx.device)


# ------------------------------------------------------- scan scaffolding
def _arena_consts(ctx: EngineContext) -> dict:  # torchlint: hot-path
    """The arena's device operands for a round step: packed shards, the
    row mask and the cid -> row map. Passed to the step as consts, so a
    captured step is fed the arena as it stands at each call."""
    ar = ctx.arena
    return {"packed": ar.packed, "amask": ar.mask, "rowmap": ar.device_rows}


def _gather_scan(consts: dict, ids: torch.Tensor, ragged: bool, owners):
    """Cohort batch of the device ids ``ids`` from ``_arena_consts``
    operands (the rows ``owners`` gives this rank): the same gathers (and
    ragged ``"mask"`` leaf) as ``ClientArena.gather``, so the batch is
    bitwise the eager round's."""
    return take_rows(consts["packed"], consts["amask"], consts["rowmap"], ids, ragged,
                     owners)


def _sizes_f32(state: ServerState) -> torch.Tensor:  # torchlint: hot-path
    """Per-client sample counts as a device f32 vector padded to the pool's
    power-of-two capacity (``sampler.pool_capacity``; pad slots weigh 0
    and are never drawn): the step's counterpart of ``_weights``, uploaded
    once per distinct size tuple and kept on the context."""
    ctx = state.ctx
    hit = ctx.cache.get("sizes_f32")
    if hit is None or hit[0] != state.sizes:
        arr = np.zeros(sampler.pool_capacity(len(state.sizes)), np.float32)
        arr[: len(state.sizes)] = state.sizes
        hit = (state.sizes, torch.as_tensor(arr, device=ctx.device))
        ctx.cache["sizes_f32"] = hit
    return hit[1]


def _row_mask(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Broadcast a (rows,) mask against a (rows, ...) leaf."""
    return mask.reshape((-1,) + (1,) * (leaf.dim() - 1))


def _count(n: int, device) -> torch.Tensor:
    """A step record's constant count as a 0-d int32 device tensor."""
    return torch.full((), n, dtype=torch.int32, device=device)


def _scan_history(ys, rounds: int) -> tuple:
    """Stacked step records -> eager-style history records (``engine.api.
    scan_history``; imported here to keep the module import order)."""
    from repro_torch.engine.api import scan_history
    return scan_history(ys, rounds)


def merge_bound(state: ServerState, cap: int) -> int:
    """The live-cluster bound of a span's merge passes (``k_max`` of
    ``merge_round_impl``): the current clusters plus every still-unseen
    live client, each of which could open a singleton, as a power of two
    at most ``cap``; it only shrinks during the span."""
    clusters = state.clusters
    n_live = state.n_clients - len(state.left)
    k_now = clusters.n_clusters() if clusters.state is not None else 0
    unseen = max(n_live - len(clusters.seen), 0)
    return min(bank_pow2(max(k_now + unseen, 1)), cap)


def row_bank_merge(rows, has, init, ids, rows_live, new_roots, counts, ordered=False):
    """``ClusterBank.merge`` over a row-keyed bank (``rows[r]`` the model
    of the cluster rooted at r, ``has[r]`` whether it has one, ``init``
    otherwise): each merged group's rows become their member-count-weighted
    mean, the absorbed rows lose ``has``, every other row is kept. The
    merge is given by a merge pass's outputs (``rows_live`` pre-merge live
    roots, ``new_roots`` their post-merge roots, ``counts`` their member
    counts; pads = capacity / 0); ``ids`` is ``arange(capacity)``. Segment
    sums run over ascending rows, ``ClusterBank.merge``'s order; with
    ``ordered`` (under a mesh, where every rank merges its own copy of the
    bank) the float sums run in one fixed order
    (``sharding.ordered_index_add_``). Without a merge it changes
    nothing: the masked form of the reference's ``lax.cond``. Returns
    ``(rows, has)``."""
    cap = ids.numel()
    dev = ids.device
    rl = rows_live.long()
    mapped = devclust._scatter_drop(ids, rl, new_roots).long()
    w_full = devclust._scatter_drop(torch.zeros((cap,), dtype=torch.float32, device=dev),
                                    rl, counts.to(torch.float32))
    counted = w_full > 0
    gsize = torch.zeros((cap,), dtype=torch.int32, device=dev).index_add_(
        0, mapped, counted.to(torch.int32))
    merged = gsize > 1
    absorbed = counted & (mapped != ids)
    add = shard_specs.ordered_index_add_ if ordered else (
        lambda out, idx, src: out.index_add_(0, idx, src))
    denom = add(torch.zeros((cap,), dtype=torch.float32, device=dev), mapped, w_full)[mapped]
    wn = torch.where(denom > 0, w_full / torch.where(denom > 0, denom, 1.0),
                     torch.zeros_like(w_full))

    def leaf(r, i):
        full = torch.where(_row_mask(has, r), r, i[None].to(r.dtype))
        contrib = full * _row_mask(wn, full)
        agg = add(torch.zeros_like(contrib), mapped, contrib)
        return torch.where(_row_mask(merged, r), agg.to(r.dtype), r)

    return trees.tree_map(leaf, rows, init), (has & ~absorbed) | merged


def merge_cluster_models(models, merges, counts, init_params, mesh=None):
    """Merge θ along partition merges, each side weighted by its member
    count. ``counts`` is the pre-merge {root: n_members} snapshot.
    ``ClusterBank`` inputs take the batched path (``bank.merge``, its rows
    split over ``mesh``'s ranks); plain dicts the sequential pairwise
    means (the same math)."""
    if isinstance(models, ClusterBank):
        return models.merge(merges, counts, init_params, mesh)
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
    full_participation = False        # run_round trains every live client
    supports_async = False            # async_dispatch / async_merge exist

    def init_state(self, ctx: EngineContext) -> ServerState:
        """Round-0 state: ω = ω₀, empty bank, fresh sampling rng (the numpy
        bit-generator, plus a device threefry key under
        ``rng_backend="device"``)."""
        key = (fresh_rng_key(ctx.cfg.seed, ctx.device)
               if ctx.cfg.rng_backend == "device" else None)
        return ServerState(ctx=ctx, strategy=self.name, round=0,
                           rng_state=fresh_rng_state(ctx.cfg.seed),
                           sizes=client_sizes(ctx.clients), left=frozenset(),
                           omega=ctx.init_params, models=ClusterBank.empty(),
                           rng_key=key)

    def round(self, ctx: EngineContext, state: ServerState, client_ids):
        raise NotImplementedError

    def scan_round(self, ctx: EngineContext, state: ServerState,
                   pool: np.ndarray, m: int):
        """The strategy's round as a step for ``engine.run_rounds``.

        Returns ``(carry0, consts, step, finalize, statics)``: ``carry0``
        is a tuple of tensors and trees built from ``state`` (key, models,
        banks, partition), ``consts`` a dict of the round-invariant device
        operands (arena, pool, sample counts), ``step(carry, consts) ->
        (carry', record)`` one round with no host read and no input
        written (the eager ``round``'s results), ``finalize(state, carry,
        ys, rounds)`` the host conversion back to a ``ServerState``, and
        ``statics`` a hashable tuple of every value the step bakes in
        beyond the carry and const shapes. ``pool`` is the boolean draw
        pool, ``m`` the cohort size."""
        raise NotImplementedError(
            f"strategy {self.name!r} has no scannable round step")

    def evaluate(self, ctx, state, test_sets, true_cluster=None) -> dict:
        """Held-out evaluation; the base serves every test set with ω."""
        accs = {k: eval_model(ctx, state.omega, b) for k, b in test_sets.items()}
        return {"cluster_avg": float(np.mean(list(accs.values()))), "per": accs}

    def join(self, ctx, state, batch):
        """Register a new client (§5): append its data to the world (client
        list and arena) and its size to the state; returns
        ``(state', cid)``. The stored batch's floating leaves take the
        compute dtype, as ``engine.init`` casts every client's; the caller
        keeps the batch as given (StoCFL's Ψ of the newcomer reads it)."""
        cid = len(ctx.clients)
        batch = ctx.client_batch(batch)
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

    def async_dispatch(self, ctx, state, client_ids, buf, slots):
        """The async round's pre-aggregation half: this strategy's
        clustering and local training for the dispatched cohort, the
        trained rows scattered into the buffer's ``slots``;
        ``-> (state', buf')``. Only strategies with ``supports_async``."""
        raise NotImplementedError(f"strategy {self.name!r} has no async dispatch hook")

    def async_merge(self, ctx, state, batch, weights):
        """The async round's aggregation half: merge one ``FlushBatch``
        under the staleness-effective ``weights`` (host f32, dispatch
        order) through the synchronous round's aggregation;
        ``-> (state', metrics)``."""
        raise NotImplementedError(f"strategy {self.name!r} has no async merge hook")


# --------------------------------------------------------------------- stocfl
@register("stocfl")
class StoCFLStrategy(Strategy):
    """Algorithm 1: stochastic Ψ-clustering + bi-level cohort update."""

    needs_extractor = True
    supports_async = True

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

    def _train(self, ctx, state, client_ids, handshake=None):
        """The round's pre-aggregation half (Algorithm 1 lines 5-16): Ψ of
        the new clients and ``observe``, the merge pass, the bank merge,
        the gather and the bi-level cohort step. ``handshake(new_ids,
        reps) -> reps`` routes the new clients' Ψ on its way to
        ``observe`` (the async round's buffer rows). Returns ``(clusters,
        models, merges, thetas_i, omegas_i)``, the last two this rank's
        rows under a mesh; ``state`` is not touched."""
        cfg = ctx.cfg
        clusters = state.clusters.copy()
        split = _split(ctx, len(client_ids))
        whole = None
        if _split_arena(ctx):
            # the cohort's data from the arena's owners, for Ψ and the step
            with _span("stocfl.gather"):
                whole = ctx.arena.gather(client_ids)

        # --- stochastic client clustering (Algorithm 1 lines 5-13)
        new_ids = [int(c) for c in client_ids if c not in clusters.seen]
        with _span("stocfl.psi_extract"):
            if new_ids:
                reps = _new_reps(ctx, client_ids, new_ids, split, whole)
                if handshake is not None:
                    reps = handshake(new_ids, reps)
                clusters.observe(new_ids, reps)
        counts = {r: len(m) for r, m in clusters.clusters().items()}
        with _span("stocfl.merge_pass"):
            merges = clusters.merge_round()
        with _span("stocfl.bank_merge"):
            models = merge_cluster_models(state.models, merges, counts,
                                          ctx.init_params, ctx.mesh)

        # --- bi-level CFL (lines 14-16): one cohort step, over this rank's
        # rows of the cohort under a mesh
        roots = np.fromiter((clusters.uf.find(int(c)) for c in client_ids),
                            np.int64, len(client_ids))
        with _span("stocfl.gather"):
            thetas = models.take(_local(split, roots), ctx.init_params)
            if cfg.fused_step:
                # one (C, P) buffer, which the fused update takes over; the
                # gathered tree is freed here
                thetas = bilevel.flatten_tree(thetas, batch_dims=1)
            batches = _cohort_data(ctx, split, client_ids, whole)
        with _span("stocfl.cohort_update"):
            thetas_i, omegas_i = self._cohort(ctx)(thetas, state.omega, batches)
        return clusters, models, merges, thetas_i, omegas_i

    def _aggregate(self, ctx, state, clusters, models, cids, thetas_i, omegas_i, w):
        """The round's aggregation half (lines 17-19): ω by the configured
        aggregator, each cluster's θ by a segment FedAvg over the rows of
        ``cids``, each rooted through ``clusters`` as it stands now; then
        the metrics. Under a mesh ``thetas_i`` / ``omegas_i`` hold this
        rank's rows of ``cids`` (``_split``). Returns ``(state',
        {n_clusters, objective})``."""
        split = _split(ctx, len(cids))
        with _span("stocfl.aggregate"):
            omega = aggregate_omega(ctx.cfg.aggregator, omegas_i, w, split)
            roots = np.fromiter((clusters.uf.find(int(c)) for c in cids), np.int64, len(cids))
            uroots, seg = np.unique(roots, return_inverse=True)
            agg = bilevel.aggregate_segments(thetas_i, w, seg, bank_pow2(len(uroots)),
                                             split)
            models = models.put([int(r) for r in uroots], agg)

        with _span("stocfl.objective"):
            if isinstance(clusters, devclust.DeviceClusters):
                # the closed form, the reference's device-backend metric
                objective = devclust.objective_closed(clusters.state)
            else:
                objective = clusters.objective()
        rec = {"n_clusters": clusters.n_clusters(), "objective": objective}
        return state.replace(omega=omega, models=models, clusters=clusters), rec

    def round(self, ctx, state, client_ids):
        """One server round. The metrics add ``merges``, the (kept,
        absorbed) root pairs of this round's merge pass, to the JAX
        package's ``n_clusters`` / ``objective`` / ``sampled``."""
        client_ids = np.asarray(client_ids)
        clusters, models, merges, thetas_i, omegas_i = self._train(ctx, state, client_ids)
        state, rec = self._aggregate(ctx, state, clusters, models, client_ids, thetas_i,
                                     omegas_i, _weights(state, client_ids))
        rec.update(sampled=len(client_ids), merges=tuple(merges))
        return state, rec

    def async_dispatch(self, ctx, state, client_ids, buf, slots):
        """``_train`` with the Ψ handshake routed through the buffer: the
        new clients' Ψ rows are scattered into its Ψ bank and ``observe``
        reads them back from there; the cohort's (θᵢ, ωᵢ) rows land in
        ``slots``. With ``fused_step`` those rows are views of the flat
        (C, P) buffer K1 wrote; the write copies them out. Under a mesh
        each rank passes its slice's rows and the buffer sends each to its
        slot's owner (``AsyncBuffer.write``); the Ψ rows, which every rank
        has, are written on their owners and read back gathered."""
        client_ids = np.asarray(client_ids)
        at = {int(c): int(s) for c, s in zip(client_ids, slots)}

        def handshake(new_ids, reps):
            nonlocal buf
            new_slots = [at[c] for c in new_ids]
            buf = buf.write_psi(new_slots, torch.stack(reps))
            back = buf.read_psi(new_slots)
            return [back[i] for i in range(len(new_ids))]

        clusters, models, _merges, thetas_i, omegas_i = self._train(
            ctx, state, client_ids, handshake)
        split = _split(ctx, len(client_ids))
        buf = buf.write(slots, thetas_i, omegas_i, split)
        return state.replace(models=models, clusters=clusters), buf

    def async_merge(self, ctx, state, batch, weights):
        """``_aggregate`` over one flush: each delta re-roots through the
        current partition, so merges made while it was in flight count.
        Under a mesh the batch's rows are this rank's slice of the flush
        (``run_round_async``)."""
        w = torch.as_tensor(weights, device=ctx.device)
        return self._aggregate(ctx, state, state.clusters, state.models, batch.cids,
                               batch.payload, batch.aux, w)

    def _cold_carry(self, ctx, state, clusters):
        """The step's partition and row-keyed bank built from ``state``:
        ``(DeviceClusterState grown to the population, row-keyed model
        rows (cap, ...), has (cap,))``. The warm-resume path in
        ``scan_round`` skips this for back-to-back ``run_rounds`` calls on
        an untouched state."""
        dev = ctx.device
        if clusters.state is None:
            dcs0 = devclust.init_state(max(clusters._capacity_hint, state.n_clients),
                                       ctx.psi_dim, dev)
        else:
            dcs0 = devclust.grow(clusters.state, state.n_clients)
        cap = dcs0.capacity
        has0 = torch.zeros((cap,), dtype=torch.bool, device=dev)
        roots0 = state.models.roots
        if roots0:
            idx = torch.as_tensor(roots0, dtype=torch.int64, device=dev)
            rows0 = trees.tree_map(
                lambda i, b: torch.zeros((cap,) + tuple(i.shape), dtype=i.dtype,
                                         device=dev).index_copy_(
                    0, idx, b[: len(roots0)].to(i.dtype)),
                ctx.init_params, state.models.stacked)
            has0[idx] = True
        else:
            rows0 = trees.tree_map(
                lambda i: torch.zeros((cap,) + tuple(i.shape), dtype=i.dtype, device=dev),
                ctx.init_params)
        return dcs0, rows0, has0

    def scan_round(self, ctx, state, pool, m):
        """StoCFL's whole round (Ψ of the new clients, observe, merge pass,
        count-weighted bank merge, bi-level cohort step, per-cluster
        aggregation) as one step with no host read (``cluster_backend=
        "device"``; ``run_rounds`` checks it).

        The carry holds the partition as the three ``DeviceClusterState``
        tensors and the cluster models as a row-keyed bank: ``rows[r]``
        is the model of the cluster rooted at client r, ``has[r]`` whether
        it has one (lazy θ_k = ω₀ otherwise); ``finalize`` rebuilds the
        ``DeviceClusters`` and the ``ClusterBank``. The reference's
        ``lax.cond`` skips run every round here, masked: Ψ of every
        cohort member (one per-client call each, kept for the new ones;
        under a mesh each rank takes its slice's, and one
        ``RowSplit.gather`` sends the rows to every rank), a merge pass (a
        no-op on a settled partition), the bank merge (a no-op without
        merges) and the objective. Segment sums run over
        ascending rows and cohort positions, the eager round's order."""
        cfg = ctx.cfg
        dev = ctx.device
        tau = float(cfg.tau)
        ragged = ctx.arena.ragged
        owners = ctx.arena.owners
        clusters = state.clusters
        # warm resume: finalize stashes the final carry under the exact
        # models / clusters objects it returned; any transition between
        # spans replaces those objects, so identity is a sound staleness key
        resume = ctx.cache.get("stocfl_scan_resume")
        if (resume is not None and resume["models"] is state.models
                and resume["clusters"] is state.clusters
                and state.n_clients <= resume["dcs"].capacity):
            dcs0, rows0, has0 = resume["dcs"], resume["rows"], resume["has"]
        else:
            dcs0, rows0, has0 = self._cold_carry(ctx, state, clusters)
        cap = dcs0.capacity
        consts = dict(_arena_consts(ctx), pool=torch.as_tensor(pool, device=dev),
                      sizes=_sizes_f32(state), init=ctx.init_params,
                      ids=torch.arange(cap, dtype=torch.int32, device=dev))
        carry0 = (state.rng_key, state.omega, dcs0.parent, dcs0.live, dcs0.rep,
                  rows0, has0)
        cohort = self._cohort(ctx)
        psi = ctx.extractor
        aggregator = cfg.aggregator
        fused = bool(cfg.fused_step)
        k_bound = merge_bound(state, cap)
        # under a mesh: this rank's cohort rows and their Ψ; the partition
        # and the row-keyed bank (its masked merge included, its sums in a
        # fixed order) run on every rank, as the reference's scan keeps them
        # replicated
        split, mesh = _split(ctx, m), ctx.mesh
        mine = range(m) if split is None else range(split.lo, split.hi)

        def step(carry, cs):
            key, omega, parent, live, rep, rows, has = carry
            ids_arr = cs["ids"]
            key, ids = sampler.draw(key, cs["pool"], m)
            batches = _gather_scan(cs, ids, ragged, owners)
            new = ~live[ids]
            with _span("stocfl.psi_extract"):
                reps = _gather(split, torch.stack(
                    [psi(trees.tree_map(lambda x, i=i: x[i], batches)) for i in mine]))
                idx = torch.where(new, ids.to(torch.int32), cap)
                dcs = devclust.observe(devclust.DeviceClusterState(parent, live, rep),
                                       idx, reps)
            with _span("stocfl.merge_pass"):
                dcs, rows_live, new_roots, counts_c = devclust.merge_round_impl(
                    dcs, tau, k_bound)
            with _span("stocfl.bank_merge"):
                rows, has = row_bank_merge(rows, has, cs["init"], ids_arr, rows_live,
                                           new_roots, counts_c, ordered=mesh is not None)
            with _span("stocfl.gather"):
                r_ids = dcs.parent[ids].long()      # fully compressed roots
                r_loc = _local(split, r_ids)
                has_r = has[r_loc]
                thetas = trees.tree_map(
                    lambda r, init: torch.where(_row_mask(has_r, r),
                                                torch.index_select(r, 0, r_loc),
                                                init[None].to(r.dtype)),
                    rows, cs["init"])
                if fused:
                    thetas = bilevel.flatten_tree(thetas, batch_dims=1)
            with _span("stocfl.cohort_update"):
                thetas_i, omegas_i = cohort(thetas, omega, _local(split, batches))
            with _span("stocfl.aggregate"):
                w = cs["sizes"][ids]
                omega = aggregate_omega(aggregator, omegas_i, w, split)
                # per-cluster FedAvg over compact cohort slots (the first
                # position of each root), then a scatter of the touched rows
                pos = torch.arange(m, device=dev)
                firsts = torch.argmax((r_ids[:, None] == r_ids[None, :]).to(torch.int32),
                                      dim=1)
                is_first = firsts == pos
                slot = (torch.cumsum(is_first.to(torch.int64), 0) - 1)[firsts]
                agg = bilevel.aggregate_segments(thetas_i, w, slot, m, split)
                target = torch.where(is_first, r_ids, cap)
                rows = trees.tree_map(
                    lambda r, a: devclust._scatter_drop(r, target, a[slot].to(r.dtype)),
                    rows, agg)
                has = devclust._scatter_drop(has, target, True)
            with _span("stocfl.objective"):
                n_clusters = (dcs.live & (dcs.parent == ids_arr)).sum().to(torch.int32)
                objective = devclust.objective_closed_impl(dcs).to(torch.float32)
            rec = {"n_clusters": n_clusters, "objective": objective,
                   "sampled": _count(m, dev)}
            return (key, omega, dcs.parent, dcs.live, dcs.rep, rows, has), rec

        def finalize(state, carry, ys, rounds):
            key, omega, parent, live, rep, rows, has = carry
            clusters = devclust.DeviceClusters.from_arrays(tau, parent, live, rep,
                                                           device=dev)
            roots = [int(r) for r in torch.nonzero(has).flatten().tolist()]
            models = ClusterBank.from_dict(
                {r: trees.tree_map(lambda x, rr=r: x[rr], rows) for r in roots})
            # the warm-resume stash, keyed by the objects returned below
            ctx.cache["stocfl_scan_resume"] = dict(
                models=models, clusters=clusters, dcs=clusters.state, rows=rows, has=has)
            return state.replace(omega=omega, rng_key=key, clusters=clusters,
                                 models=models, round=state.round + rounds,
                                 history=state.history + _scan_history(ys, rounds))

        return carry0, consts, step, finalize, (ragged, cap, k_bound)

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
            out[tc] = eval_model(ctx, model, batch)
            glob[tc] = eval_model(ctx, state.omega, batch)
        return {"cluster": out, "cluster_avg": float(np.mean(list(out.values()))),
                "global": glob, "global_avg": float(np.mean(list(glob.values())))}

    def join(self, ctx, state, batch):
        """Dynamic join (§5): register the client, infer its cluster via Ψ
        against the pre-existing clusters, or open a fresh cluster seeded
        from the nearest one's model. Over a split arena the owner of the
        newcomer's row takes its Ψ and sends it to every rank."""
        state, cid = super().join(ctx, state, batch)
        clusters = state.clusters.copy()
        models = state.models
        rep = _join_rep(ctx, cid, batch)
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
        """Cluster inference for an unseen client (§4.4), without joining.
        ``model`` is None where a placed bank (``ClusterBank.place``) holds
        the cluster's model on another rank."""
        rep = ctx.extractor(batch)
        root, near, sim = state.clusters.nearest(rep)
        src = root if root is not None else near
        model = _held_model(state, src) if src is not None else state.omega
        return {"cluster": root, "seed_from": src, "similarity": sim, "model": model}

    def infer_many(self, ctx, state, batches):
        """§4.4 for many unseen batches in one pass: stack the batches on
        a new leading axis, take their Ψ with the engine's batched
        extractor (one ``vmap`` a ``cfg.cohort_chunk`` chunk), pull one
        cluster-means snapshot, and score every (rep, cluster) pair as
        one (J, K̃) cosine matrix. Routing decisions match per-batch
        ``infer``. Raises ``ValueError`` naming the leaf where the
        batches' structures or shapes differ."""
        if not batches:
            return []
        reps = ctx.batched_extractor(stack_batches(batches))
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
                        "model": _held_model(state, root)})
        return out


# ------------------------------------------------------------------ baselines
def _cohort_sgd(ctx: EngineContext, lam: float = 0.0, shared: bool = False):
    """The baselines' cohort local SGD (``bilevel.make_cohort_sgd``): with
    ``fused_step`` one launch of K1's local-SGD form a step on CUDA."""
    cfg = ctx.cfg
    return bilevel.make_cohort_sgd(ctx.loss_fn, cfg.lr, cfg.local_steps, lam,
                                   shared=shared, fused=bool(cfg.fused_step))


@register("fedavg")
class FedAvgStrategy(Strategy):
    """Single global model; λ=0 ∧ τ=−1 degeneration of StoCFL."""

    prox = False
    supports_async = True

    def _upd(self, ctx):
        cfg = ctx.cfg

        def build():
            sgd = _cohort_sgd(ctx, cfg.mu if self.prox else 0.0, shared=True)
            # FedProx: the prox anchor is the broadcast global itself
            fn = (lambda p, b: sgd(p, b, p)) if self.prox else sgd
            return bilevel.chunk_map(fn, (None, 0), cfg.cohort_chunk)

        return ctx.cached(f"{self.name}_upd:{bool(cfg.fused_step)}", build)

    def round(self, ctx, state, client_ids):
        ids = np.asarray(client_ids)
        split = _split(ctx, len(ids))
        outs = self._upd(ctx)(state.omega, _cohort_data(ctx, split, ids))
        omega = bilevel.aggregate_stacked(outs, _weights(state, ids), split)
        return state.replace(omega=omega), {"sampled": len(ids)}

    def async_dispatch(self, ctx, state, client_ids, buf, slots):
        """Broadcast ω and run the cohort's local SGD (the round's update),
        the local params scattered into ``slots`` (under a mesh, this
        rank's slice of them, sent to the slots' owners)."""
        ids = np.asarray(client_ids)
        split = _split(ctx, len(ids))
        outs = self._upd(ctx)(state.omega, _cohort_data(ctx, split, ids))
        return state, buf.write(slots, outs, split=split)

    def async_merge(self, ctx, state, batch, weights):
        """The weighted mean of the flushed local params under the
        staleness-effective weights (the round's ``aggregate_stacked``),
        over this rank's slice of them under a mesh."""
        w = torch.as_tensor(weights, device=ctx.device)
        omega = bilevel.aggregate_stacked(batch.payload, w, _split(ctx, batch.n))
        return state.replace(omega=omega), {}

    def scan_round(self, ctx, state, pool, m):
        """FedAvg / FedProx as a step: draw, gather, the eager round's local
        SGD, weighted mean; the carry is ``(key, ω)``."""
        ragged = ctx.arena.ragged
        owners = ctx.arena.owners
        upd = self._upd(ctx)
        dev = ctx.device
        consts = dict(_arena_consts(ctx), pool=torch.as_tensor(pool, device=dev),
                      sizes=_sizes_f32(state))

        split = _split(ctx, m)

        def step(carry, cs):
            key, omega = carry
            key, ids = sampler.draw(key, cs["pool"], m)
            outs = upd(omega, _scan_data(cs, split, ids, ragged, owners))
            omega = bilevel.aggregate_stacked(outs, cs["sizes"][ids], split)
            return (key, omega), {"sampled": _count(m, dev)}

        def finalize(state, carry, ys, rounds):
            key, omega = carry
            return state.replace(omega=omega, rng_key=key, round=state.round + rounds,
                                 history=state.history + _scan_history(ys, rounds))

        return (state.rng_key, state.omega), consts, step, finalize, (ragged,)


@register("fedprox")
class FedProxStrategy(FedAvgStrategy):
    """FedAvg + prox to the broadcast global (constant through the local
    steps)."""
    prox = True


@register("ditto")
class DittoStrategy(Strategy):
    """Global FedAvg + per-client personal models with prox to global
    (τ=1 degeneration: every client is its own cluster)."""

    def init_state(self, ctx):
        personal = {i: ctx.init_params for i in range(len(ctx.clients))}
        return super().init_state(ctx).replace(personal=personal)

    def _upds(self, ctx):
        cfg = ctx.cfg
        fused = bool(cfg.fused_step)
        gupd = ctx.cached(f"ditto_g:{fused}", lambda: bilevel.chunk_map(
            _cohort_sgd(ctx, shared=True), (None, 0), cfg.cohort_chunk))

        def build_p():
            sgd = _cohort_sgd(ctx, cfg.mu)
            return bilevel.chunk_map(lambda v, g, b: sgd(v, b, g), (0, None, 0),
                                     cfg.cohort_chunk)

        return gupd, ctx.cached(f"ditto_p:{fused}", build_p)

    def round(self, ctx, state, client_ids):
        """The global step and the personal step read the same cohort
        batch; each personal row is copied out of the cohort's output, so a
        client's row does not hold its round's whole buffer alive. Under a
        mesh each rank trains its rows and the personal rows are gathered
        to every rank."""
        ids = np.asarray(client_ids)
        gupd, pupd = self._upds(ctx)
        split = _split(ctx, len(ids))
        loc = _local(split, ids)
        batches = _cohort_data(ctx, split, ids)
        g_outs = gupd(state.omega, batches)
        v_stack = trees.tree_map(lambda *xs: torch.stack(xs),
                                 *[state.personal[int(c)] for c in loc])
        v_outs = _gather(split, pupd(v_stack, state.omega, batches))
        omega = bilevel.aggregate_stacked(g_outs, _weights(state, ids), split)
        personal = dict(state.personal)
        for j, c in enumerate(ids):
            personal[int(c)] = trees.tree_map(lambda x: x[j].clone(), v_outs)
        return state.replace(omega=omega, personal=personal), {"sampled": len(ids)}

    def scan_round(self, ctx, state, pool, m):
        """Ditto as a step. The personal models ride the carry as one
        stacked (capacity, ...) tree, cid ↔ row, capacity the pool's power
        of two (pad rows repeat row 0 and are never drawn); a round gathers
        the cohort's rows, proxes them to the broadcast ω and writes them
        back. ``finalize`` hands out the rows as the per-cid dict."""
        ragged = ctx.arena.ragged
        owners = ctx.arena.owners
        gupd, pupd = self._upds(ctx)
        dev = ctx.device
        n = state.n_clients
        capn = sampler.pool_capacity(n)
        personal0 = trees.tree_map(
            lambda *xs: torch.stack(xs),
            *[state.personal[i if i < n else 0] for i in range(capn)])
        consts = dict(_arena_consts(ctx), pool=torch.as_tensor(pool, device=dev),
                      sizes=_sizes_f32(state))
        split = _split(ctx, m)

        def step(carry, cs):
            key, omega, personal = carry
            key, ids = sampler.draw(key, cs["pool"], m)
            loc = _local(split, ids)
            batches = _scan_data(cs, split, ids, ragged, owners)
            g_outs = gupd(omega, batches)
            v = trees.tree_map(lambda p: torch.index_select(p, 0, loc), personal)
            v_outs = _gather(split, pupd(v, omega, batches))
            omega = bilevel.aggregate_stacked(g_outs, cs["sizes"][ids], split)
            personal = trees.tree_map(lambda p, x: p.index_copy(0, ids, x.to(p.dtype)),
                                      personal, v_outs)
            return (key, omega, personal), {"sampled": _count(m, dev)}

        def finalize(state, carry, ys, rounds):
            key, omega, personal = carry
            rows = {i: trees.tree_map(lambda p, ii=i: p[ii], personal) for i in range(n)}
            return state.replace(omega=omega, rng_key=key, personal=rows,
                                 round=state.round + rounds,
                                 history=state.history + _scan_history(ys, rounds))

        return (state.rng_key, state.omega, personal0), consts, step, finalize, (ragged,)

    def evaluate(self, ctx, state, test_sets, true_cluster=None):
        """Per true cluster: the mean accuracy of its first 8 clients'
        personal models (ω where it has none)."""
        out = {}
        n = state.n_clients
        for tc, batch in test_sets.items():
            members = [i for i in range(n) if true_cluster[i] == tc]
            accs = [eval_model(ctx, state.personal[i], batch) for i in members[:8]]
            out[tc] = (float(np.mean(accs)) if accs
                       else eval_model(ctx, state.omega, batch))
        return {"cluster_avg": float(np.mean(list(out.values()))), "per": out}

    def join(self, ctx, state, batch):
        state, cid = super().join(ctx, state, batch)
        personal = dict(state.personal)
        personal[cid] = ctx.init_params
        return state.replace(personal=personal), cid


@register("ifca")
class IFCAStrategy(Strategy):
    """Ghosh et al. 2020: M̃ hypothesis models, clients pick argmin loss."""

    def init_state(self, ctx):
        """M̃ hypotheses, each ω₀ plus 0.1 · N(0, 1) noise on its floating
        leaves. The noise comes from a ``torch.Generator`` seeded by
        ``init_key`` (the reference draws it with ``jax.random``, which
        torch cannot reproduce: a difference by design)."""
        cfg = ctx.cfg
        gen = torch.Generator().manual_seed(int(cfg.init_key))

        def perturb(x):
            if not x.is_floating_point():
                return x
            noise = torch.randn(tuple(x.shape), generator=gen)
            return x + 0.1 * noise.to(device=x.device, dtype=x.dtype)

        init = ctx.init_params
        models = {m: trees.from_leaves(init, [perturb(x) for x in trees.leaves(init)])
                  for m in range(cfg.n_models)}
        return super().init_state(ctx).replace(models=ClusterBank.from_dict(models))

    def _upd(self, ctx):
        cfg = ctx.cfg
        return ctx.cached(f"ifca_upd:{bool(cfg.fused_step)}", lambda: bilevel.chunk_map(
            _cohort_sgd(ctx), (0, 0), cfg.cohort_chunk))

    def _choice(self, ctx):
        """(M, ...) models × (C, ...) batches -> (C, M) losses: a vmap over
        the cohort of a vmap over the models, chunked like the cohort so
        it never holds M·C activations beyond a chunk's."""
        loss_fn = ctx.loss_fn

        def losses(ms, bs):
            with torch.no_grad():
                return vmap(lambda b: vmap(lambda m: loss_fn(m, b))(ms))(bs)

        return ctx.cached("ifca_choice", lambda: bilevel.chunk_map(
            losses, (None, 0), ctx.cfg.cohort_chunk))

    def choices(self, ctx, state, client_ids, batches=None) -> np.ndarray:
        """Each client's hypothesis: the first argmin of its losses. Under
        a mesh ``batches`` holds this rank's rows of the cohort and the
        losses are gathered to every rank."""
        split = _split(ctx, len(client_ids))
        if batches is None:
            batches = _cohort_data(ctx, split, np.asarray(client_ids))
        hyps = state.models.take(np.arange(ctx.cfg.n_models), ctx.init_params)
        losses = _gather(split, self._choice(ctx)(hyps, batches))
        return np.argmin(losses.cpu().numpy(), axis=1)

    def round(self, ctx, state, client_ids):
        ids = np.asarray(client_ids)
        split = _split(ctx, len(ids))
        batches = _cohort_data(ctx, split, ids)
        choices = self.choices(ctx, state, ids, batches)
        thetas = state.models.take(_local(split, choices), ctx.init_params)
        outs = self._upd(ctx)(thetas, batches)
        w = _weights(state, ids)
        um, seg = np.unique(choices, return_inverse=True)
        agg = bilevel.aggregate_segments(outs, w, seg, bank_pow2(len(um)), split)
        models = state.models.put([int(m) for m in um], agg)
        return state.replace(models=models), {"sampled": len(ids)}

    def scan_round(self, ctx, state, pool, m):
        """IFCA as a step: the M̃ hypotheses ride the carry stacked; the
        choice is a device argmin of the batched losses (the first
        minimum, as ``choices``), the update local SGD from the chosen
        hypothesis, the write-back a full-M̃ segment mean that keeps the
        hypotheses no client chose."""
        ragged = ctx.arena.ragged
        owners = ctx.arena.owners
        n_models = int(ctx.cfg.n_models)
        choice, upd = self._choice(ctx), self._upd(ctx)
        dev = ctx.device
        rows0 = state.models.take(np.arange(n_models), ctx.init_params)
        consts = dict(_arena_consts(ctx), pool=torch.as_tensor(pool, device=dev),
                      sizes=_sizes_f32(state))
        split = _split(ctx, m)

        def step(carry, cs):
            key, rows = carry
            key, ids = sampler.draw(key, cs["pool"], m)
            batches = _scan_data(cs, split, ids, ragged, owners)
            choices = torch.argmin(_gather(split, choice(rows, batches)), dim=1)
            c_loc = _local(split, choices)
            thetas = trees.tree_map(lambda r: torch.index_select(r, 0, c_loc), rows)
            outs = upd(thetas, batches)
            w = cs["sizes"][ids]
            agg = bilevel.aggregate_segments(outs, w, choices, n_models, split)
            present = torch.zeros((n_models,), dtype=torch.int32, device=dev).index_add_(
                0, choices, torch.ones_like(choices, dtype=torch.int32)) > 0
            rows = trees.tree_map(
                lambda r, a: torch.where(_row_mask(present, r), a.to(r.dtype), r), rows, agg)
            return (key, rows), {"sampled": _count(m, dev)}

        def finalize(state, carry, ys, rounds):
            key, rows = carry
            models = ClusterBank.from_dict(
                {i: trees.tree_map(lambda r, ii=i: r[ii], rows) for i in range(n_models)})
            return state.replace(models=models, rng_key=key, round=state.round + rounds,
                                 history=state.history + _scan_history(ys, rounds))

        return (state.rng_key, rows0), consts, step, finalize, (ragged, n_models)

    def evaluate(self, ctx, state, test_sets, true_cluster=None):
        """Each test set with its best hypothesis (oracle assignment)."""
        out = {}
        for tc, batch in test_sets.items():
            accs = [eval_model(ctx, state.models[m], batch)
                    for m in range(ctx.cfg.n_models)]
            out[tc] = float(np.max(accs))
        return {"cluster_avg": float(np.mean(list(out.values()))), "per": out}


@register("cfl")
class CFLStrategy(Strategy):
    """Sattler et al. 2020a: full participation; recursively bi-partition a
    cluster near stationarity (relative-norm criterion); split seeds are
    the least-similar update pair, greedy assignment to the closer seed."""

    full_participation = True

    def init_state(self, ctx):
        state = super().init_state(ctx)
        return state.replace(members=(tuple(range(len(ctx.clients))),),
                             models=ClusterBank.from_dict({0: ctx.init_params}))

    def _core(self, ctx):
        """The whole CFL round over a fixed L-client layout: ``(assign
        (L,), k, model rows (L, ...), batches, sizes, split) -> (assign',
        k', rows')``, the reference's jitted ``_core``; ``k`` and ``k'``
        are 0-d device tensors (``k`` may be an int). The eager round and
        the ``run_rounds`` step both call it. Under a mesh ``batches``
        holds this rank's rows (``split``): each rank trains those, the
        update vectors are gathered to every rank for the split
        statistics, and the per-cluster FedAvg is a partial sum plus an
        ``all_reduce``.

        Every client trains from its cluster's model; per-cluster FedAvg
        and the Sattler split statistics are segment reductions over the
        client axis (within a segment in ascending cid, the member-tuple
        order); split emission renumbers clusters by cumulative-split
        offset (split cluster j → slots j+off and j+off+1). The split
        seeds of every cluster (the least similar member pair, the first
        minimum in row-major order, as ``np.unravel_index`` finds it) come
        from one masked segment minimum over the L × L similarity matrix,
        every round, where the reference's ``lax.cond`` skips them on
        rounds with no split candidate; only the candidates' seeds are
        used. No host read."""
        cfg, mesh = ctx.cfg, ctx.mesh

        def build():
            upd = bilevel.chunk_map(_cohort_sgd(ctx), (0, 0), cfg.cohort_chunk)

            def core(assign, k, rows, batches, sizes, split=None):
                L, dev = assign.numel(), assign.device
                a_loc = _local(split, assign)
                thetas = trees.tree_map(lambda R: torch.index_select(R, 0, a_loc), rows)
                outs = upd(thetas, batches)
                deltas = trees.tree_map(torch.sub, outs, thetas)
                flat = _gather(split, vmap(trees.tree_flatten_vector)(deltas))   # (L, d)
                norms = torch.linalg.vector_norm(flat, dim=1)
                ks = torch.arange(L, device=dev)
                cnt = torch.zeros(L, dtype=torch.int64, device=dev).index_add_(
                    0, assign, torch.ones_like(assign))
                new_models = bilevel.aggregate_segments(outs, sizes, assign, L, split)
                g_sum = torch.zeros_like(flat)
                if mesh is None:
                    g_sum.index_add_(0, assign, flat)
                else:                                   # every rank sums it
                    shard_specs.ordered_index_add_(g_sum, assign, flat)
                mean_g = g_sum / cnt.clamp(min=1)[:, None]
                mean_norm = torch.linalg.vector_norm(mean_g, dim=1)
                # empty segments stay -inf, as jax.ops.segment_max leaves them
                max_norm = torch.full((L,), -torch.inf, device=dev).scatter_reduce_(
                    0, assign, norms, "amax", include_self=True)
                candidate = ((ks < k) & (cnt > 2) & (max_norm > cfg.eps2)
                             & (mean_norm < cfg.eps_rel * max_norm))

                # split seeds: per cluster the least cosine over its member
                # pairs, then the first pair (row-major) holding it
                sims = flat / (norms[:, None] + 1e-12)
                m = sims @ sims.T
                same = assign[:, None] == assign[None, :]
                seg = assign[:, None].expand(L, L).reshape(-1)
                least = torch.full((L,), torch.inf, device=dev).scatter_reduce_(
                    0, seg, torch.where(same, m, torch.inf).reshape(-1), "amin",
                    include_self=True)
                pair = torch.arange(L * L, device=dev).view(L, L)
                at_least = same & (m == least[assign][:, None])
                first = torch.full((L,), L * L, dtype=torch.int64, device=dev)
                first = first.scatter_reduce_(
                    0, seg, torch.where(at_least, pair, L * L).reshape(-1), "amin",
                    include_self=True)
                first = torch.where(first < L * L, first, 0)      # empty clusters
                gi, gj = first // L, first % L
                member = assign[None, :] == ks[:, None]           # (cluster, client)
                c1 = member & (m[:, gi].T >= m[:, gj].T)
                c2 = member & ~c1
                split = candidate & c1.any(dim=1) & c2.any(dim=1)
                s = split.to(torch.int64)
                new_pos = ks + torch.cumsum(s, 0) - s
                base = new_pos[assign]
                assign2 = torch.where(c2[assign, ks] & split[assign], base + 1, base)
                # the reference's .at[idx].set(mode="drop") with idx = L for
                # the rows it drops: here row L is a scratch row, cut off
                idx1 = torch.where(ks < k, new_pos, L)
                idx2 = torch.where(split, new_pos + 1, L)

                def leaf(r, nm):
                    ext = torch.cat([r, r.new_zeros((1,) + tuple(r.shape[1:]))])
                    nm = nm.to(r.dtype)
                    return ext.index_copy_(0, idx1, nm).index_copy_(0, idx2, nm)[:L]

                rows2 = trees.tree_map(leaf, rows, new_models)
                return assign2, k + torch.where(ks < k, s, 0).sum(), rows2

            return core

        return ctx.cached("cfl_core", build)

    def _matrix(self, ctx, state):
        """Host matrix form of the CFL state: ``(live cids asc, assign per
        live position, k, (L, ...) model rows)``, the layout ``_core`` runs
        on; member tuples keep clients ascending, so matrix ↔ tuples
        round-trips exactly."""
        live = np.array([i for i in range(state.n_clients)
                         if i not in state.left], np.int64)
        pos = {int(c): p for p, c in enumerate(live)}
        assign = np.zeros(len(live), np.int64)
        for j, grp in enumerate(state.members):
            for c in grp:
                assign[pos[int(c)]] = j
        k = len(state.members)
        stacked = state.models.take(np.arange(k), ctx.init_params)
        rows = trees.tree_map(
            lambda x: torch.cat([x, x.new_zeros((len(live) - k,) + tuple(x.shape[1:]))]),
            stacked)
        return live, assign, k, rows

    @staticmethod
    def _untangle(live, assign, k, rows):
        """Matrix form back to the tuple partition + ``ClusterBank``."""
        members = tuple(tuple(int(c) for c in live[assign == j]) for j in range(k))
        models = ClusterBank.from_dict(
            {j: trees.tree_map(lambda r, jj=j: r[jj], rows) for j in range(k)})
        return members, models

    def round(self, ctx, state, client_ids):
        """One round over every live client (CFL trains on its members,
        whatever cohort it is handed)."""
        live, assign, k, rows = self._matrix(ctx, state)
        sizes = torch.as_tensor(np.asarray(state.sizes, np.float32)[live],
                                device=ctx.device)
        split = _split(ctx, len(live))
        assign2, k2, rows2 = self._core(ctx)(
            torch.as_tensor(assign, device=ctx.device), k, rows,
            _cohort_data(ctx, split, live), sizes, split)
        members, models = self._untangle(live, assign2.cpu().numpy(), int(k2), rows2)
        state = state.replace(members=members, models=models)
        return state, {"n_clusters": len(members),
                       "sampled": sum(len(m) for m in members)}

    def scan_round(self, ctx, state, pool, m):
        """CFL as a step: the carry is the matrix partition (``assign``,
        ``k``, model rows) and each step is one ``_core`` over the whole
        live population (availability does not apply to full
        participation, as in the eager loop)."""
        ragged = ctx.arena.ragged
        owners = ctx.arena.owners
        live, assign, k, rows = self._matrix(ctx, state)
        L = len(live)
        core = self._core(ctx)
        dev = ctx.device
        consts = dict(_arena_consts(ctx), live=torch.as_tensor(live, device=dev),
                      sizes=torch.as_tensor(np.asarray(state.sizes, np.float32)[live],
                                            device=dev))
        carry0 = (torch.as_tensor(assign, device=dev),
                  torch.tensor(k, dtype=torch.int64, device=dev), rows)
        split = _split(ctx, L)

        def step(carry, cs):
            assign, k, rows = carry
            batches = _scan_data(cs, split, cs["live"], ragged, owners)
            assign, k, rows = core(assign, k, rows, batches, cs["sizes"], split)
            return (assign, k, rows), {"n_clusters": k.to(torch.int32),
                                       "sampled": _count(L, dev)}

        def finalize(state, carry, ys, rounds):
            assign, k, rows = carry
            members, models = self._untangle(live, assign.cpu().numpy(), int(k), rows)
            return state.replace(members=members, models=models,
                                 round=state.round + rounds,
                                 history=state.history + _scan_history(ys, rounds))

        return carry0, consts, step, finalize, (ragged, L)

    def cluster_of(self, state, cid: int) -> int:
        for k, c in enumerate(state.members):
            if cid in c:
                return k
        return 0

    def join(self, ctx, state, batch):
        """CFL has no Ψ inference: the newcomer joins the cluster whose
        model fits its data best (argmin loss, IFCA-style) and trains and
        splits with it from the next round on."""
        state, cid = super().join(ctx, state, batch)
        with torch.no_grad():
            k = int(np.argmin([float(ctx.loss_fn(state.models[m], batch))
                               for m in range(len(state.members))]))
        members = list(state.members)
        members[k] = members[k] + (cid,)
        return state.replace(members=tuple(members)), cid

    def leave(self, ctx, state, cid):
        """Full participation trains on ``members``, so departure rewrites
        the partition: drop the client everywhere, discard any cluster it
        leaves empty, and re-index the model table to match."""
        state = super().leave(ctx, state, cid)
        cid = int(cid)
        members, models = [], {}
        for k, group in enumerate(state.members):
            group = tuple(m for m in group if m != cid)
            if group:
                models[len(members)] = state.models[k]
                members.append(group)
        if not members:                       # last client left: keep the
            members = [()]                    # root cluster's model around
            models = {0: state.models.get(0, ctx.init_params)}
        return state.replace(members=tuple(members),
                             models=ClusterBank.from_dict(models))

    def evaluate(self, ctx, state, test_sets, true_cluster=None):
        """Each true cluster with the model of the cluster holding most of
        its clients (ties broken as ``max(set(ks), key=ks.count)``)."""
        out = {}
        for tc, batch in test_sets.items():
            ks = [self.cluster_of(state, i) for i in range(state.n_clients)
                  if true_cluster[i] == tc]
            k = max(set(ks), key=ks.count)
            out[tc] = eval_model(ctx, state.models[k], batch)
        return {"cluster_avg": float(np.mean(list(out.values()))), "per": out,
                "n_clusters": len(state.members)}
