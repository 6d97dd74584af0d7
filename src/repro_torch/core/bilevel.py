"""Bi-level clustered FL optimisation (paper §3.3, Algorithm 1 l.14-23).

Client procedure (lines 20-23), E local steps:
    θ ← θ − η (∇f_i(θ) + λ (θ − ω))
    ω ← ω − η ∇f_i(ω)
Server (lines 17-19): ω ← Aggregate([ωᵢ]) over all sampled clients;
θ_k ← FedAvg([θᵢ], i ∈ c_k) per cluster.

The cohort is the unit of work: clients are stacked on a leading axis, the
per-client loss runs under ``torch.func.vmap``, and one ``autograd.grad``
of the summed losses gives every client's gradient at once (client c's
loss reads only client c's parameters). In the fused form θ and ω live in
two contiguous (C, P) buffers, the gradients are taken with respect to
those buffers directly, so they arrive flat, and one ``prox_update`` launch
per local step updates the whole cohort in place.

The baselines (FedAvg, FedProx, Ditto, IFCA, CFL) run plain local SGD,
optionally with a prox term to a shared anchor (``make_cohort_sgd``,
``local_sgd``): the same cohort machinery with one (C, P) buffer and one
launch of K1's local-SGD form (``ops.prox_theta_flat``) per step.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
from torch.func import vmap

from repro_torch.core.aggregators import mean_aggregate
from repro_torch.kernels import ops
from repro_torch.sharding.specs import segment_sum
from repro_torch.utils import trees


# ----------------------------------------------------------- flat views
def flat_spec(tree):
    """Unflatten recipe of a (per-client) tree: leaf paths, shapes and
    sizes in sorted-key order."""
    paths, shapes = [], []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        else:
            paths.append(path)
            shapes.append(tuple(node.shape))

    walk(tree, ())
    return tuple(paths), tuple(shapes), tuple(math.prod(s) for s in shapes)


def flatten_tree(tree, batch_dims: int = 0) -> torch.Tensor:
    """Concatenate the leaves into a new ``(*lead, P)`` buffer, keeping the
    first ``batch_dims`` axes (the client axis of a stacked cohort)."""
    leaves = trees.leaves(tree)
    lead = tuple(leaves[0].shape[:batch_dims])
    return torch.cat([l.reshape(*lead, -1) for l in leaves], dim=-1)


def unflatten_tree(vec: torch.Tensor, spec):
    """Views of a ``(*lead, P)`` buffer as the tree ``spec`` describes, each
    leaf shaped ``(*lead, *shape)``."""
    paths, shapes, sizes = spec
    lead = tuple(vec.shape[:-1])
    out: dict = {}
    for path, shape, part in zip(paths, shapes, torch.split(vec, sizes, dim=-1)):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = part.reshape(*lead, *shape)
    return out


def _cohort_loss(loss_fn, thetas, omegas, batches):
    """Σ_c f_c(θ_c) + Σ_c f_c(ω_c) over the stacked cohort."""
    per = vmap(loss_fn)
    return per(thetas, batches).sum() + per(omegas, batches).sum()


# ----------------------------------------------------------- client update
def make_cohort_update(loss_fn: Callable, lr: float, lam: float,
                       local_steps: int = 1, backend: str = "auto",
                       fused: bool = False):
    """Returns cohort_update(thetas, omega, batches) -> (thetas_i, omegas_i).

    ``thetas`` and ``batches`` carry a leading client axis; ``omega`` is
    shared and every client updates its own copy. E = ``local_steps``
    full-batch SGD steps of the bi-level objective. ``fused=True`` runs
    the flat (C, P) path with one ``ops.prox_update_flat`` call a step
    (the kernel on CUDA under ``backend="auto"``); ``fused=False`` applies
    ``ops.prox_update_tree`` leaf by leaf.

    The fused path also takes ``thetas`` already flat, as one (C, P)
    buffer in ``flat_spec(omega)``'s leaf order (``flatten_tree``): it then
    owns that buffer, writes it in place and returns views of it, so the
    cohort's θ is held once. A stacked tree is copied and left untouched."""

    def fused_update(thetas, omega, batches):
        spec = flat_spec(omega)
        th = thetas if torch.is_tensor(thetas) else flatten_tree(thetas, batch_dims=1)
        om = flatten_tree(omega).expand(th.shape[0], -1).contiguous()
        for _ in range(local_steps):
            th_v = th.detach().requires_grad_(True)
            om_v = om.detach().requires_grad_(True)
            with torch.enable_grad():
                loss = _cohort_loss(loss_fn, unflatten_tree(th_v, spec),
                                    unflatten_tree(om_v, spec), batches)
                g_t, g_o = torch.autograd.grad(loss, (th_v, om_v))
            ops.prox_update_flat(th.view(-1), om.view(-1), g_t.reshape(-1),
                                 g_o.reshape(-1), lr, lam, backend=backend)
        return unflatten_tree(th, spec), unflatten_tree(om, spec)

    def tree_update(thetas, omega, batches):
        c = trees.leaves(thetas)[0].shape[0]
        th = trees.tree_map(lambda x: x.detach(), thetas)
        om = trees.tree_map(lambda x: x.detach().expand(c, *x.shape), omega)
        for _ in range(local_steps):
            th_v = trees.tree_map(lambda x: x.detach().requires_grad_(True), th)
            om_v = trees.tree_map(
                lambda x: x.detach().contiguous().requires_grad_(True), om)
            with torch.enable_grad():
                loss = _cohort_loss(loss_fn, th_v, om_v, batches)
                th_leaves, om_leaves = trees.leaves(th_v), trees.leaves(om_v)
                grads = torch.autograd.grad(loss, th_leaves + om_leaves)
            g_t = trees.from_leaves(th_v, grads[:len(th_leaves)])
            g_o = trees.from_leaves(om_v, grads[len(th_leaves):])
            th, om = ops.prox_update_tree(th, om, g_t, g_o, lr, lam,
                                          backend=backend)
        return th, om

    return fused_update if fused else tree_update


def make_client_update(loss_fn: Callable, lr: float, lam: float,
                       local_steps: int = 1, backend: str = "auto",
                       fused: bool = False):
    """Returns client_update(theta, omega, batch) -> (theta_i, omega_i) for
    one client: the cohort update over a cohort of one."""
    cohort = make_cohort_update(loss_fn, lr, lam, local_steps, backend, fused)

    def client_update(theta, omega, batch):
        th, om = cohort(trees.tree_map(lambda x: x[None], theta), omega,
                        trees.tree_map(lambda x: x[None], batch))
        return (trees.tree_map(lambda x: x[0], th),
                trees.tree_map(lambda x: x[0], om))

    return client_update


def make_cohort_sgd(loss_fn: Callable, lr: float, steps: int, lam: float = 0.0,
                    shared: bool = False, backend: str = "auto",
                    fused: bool = False):
    """Returns cohort_sgd(params, batches, prox_to=None) -> stacked params:
    E = ``steps`` full-batch local SGD steps for every client of the cohort,
    the reference's ``vmap(local_sgd)``.

    ``params`` carries a leading client axis, or with ``shared=True`` is
    one tree every client starts from (the reference's ``in_axes=None``);
    ``prox_to`` is an optional tree of the per-client shape, the prox
    anchor shared by every client (FedProx's broadcast global, Ditto's ω),
    constant through the steps. ``fused=True`` runs the flat (C, P) path:
    one ``ops.prox_theta_flat`` call a step (the kernel on CUDA under
    ``backend="auto"``), with the anchor broadcast over the rows or, with
    no anchor, θ itself at λ = 0, as the reference's fused ``local_sgd``
    passes it. ``fused=False`` applies the reference's per-leaf expression,
    ``p − lr·(g + λ(p − r))``, or ``p − lr·g`` with no anchor. Both give
    the same floats in fp32. ``params`` is copied and left untouched."""

    def fused_sgd(params, batches, prox_to=None):
        c = trees.leaves(batches)[0].shape[0]
        spec = flat_spec(params if shared else trees.tree_map(lambda x: x[0], params))
        th = (flatten_tree(params).expand(c, -1).contiguous() if shared
              else flatten_tree(params, batch_dims=1))
        anchor = None if prox_to is None else flatten_tree(prox_to)
        lam_eff = 0.0 if anchor is None else lam
        for _ in range(steps):
            th_v = th.detach().requires_grad_(True)
            with torch.enable_grad():
                loss = vmap(loss_fn)(unflatten_tree(th_v, spec), batches).sum()
                (g,) = torch.autograd.grad(loss, (th_v,))
            flat = th.view(-1)
            ops.prox_theta_flat(flat, flat if anchor is None else anchor,
                                g.reshape(-1), lr, lam_eff, backend=backend)
        return unflatten_tree(th, spec)

    def tree_sgd(params, batches, prox_to=None):
        c = trees.leaves(batches)[0].shape[0]
        p = (trees.tree_map(lambda x: x.detach().expand(c, *x.shape), params)
             if shared else trees.tree_map(lambda x: x.detach(), params))
        for _ in range(steps):
            p_v = trees.tree_map(
                lambda x: x.detach().contiguous().requires_grad_(True), p)
            with torch.enable_grad():
                loss = vmap(loss_fn)(p_v, batches).sum()
                grads = torch.autograd.grad(loss, trees.leaves(p_v))
            g = trees.from_leaves(p_v, grads)
            if prox_to is not None:
                g = trees.tree_map(lambda gi, pi, ri: gi + lam * (pi - ri),
                                   g, p, prox_to)
            p = trees.tree_map(lambda pi, gi: (pi - lr * gi).to(pi.dtype), p, g)
        return p

    return fused_sgd if fused else tree_sgd


def local_sgd(loss_fn: Callable, params, batch, lr: float, steps: int,
              prox_to=None, lam: float = 0.0, fused: bool = False,
              backend: str = "auto"):
    """Generic E-step local SGD for one client (shared by FedAvg, FedProx,
    Ditto, IFCA and CFL): the cohort form over a cohort of one.
    ``prox_to``: optional reference params for a FedProx/Ditto prox term
    of weight ``lam``."""
    out = make_cohort_sgd(loss_fn, lr, steps, lam, shared=True, backend=backend,
                          fused=fused)(params, trees.tree_map(lambda x: x[None], batch),
                                       prox_to)
    return trees.tree_map(lambda x: x[0], out)


def chunk_map(fn: Callable, in_axes, chunk: int) -> Callable:
    """Memory-flat cohort execution: run a cohort-stacked ``fn`` over the
    cohort in fixed-size chunks, one call per chunk.

    ``in_axes`` mirrors the reference's vmap spec (0 = stacked per-client
    arg, None = shared arg). Cohorts of ≤ ``chunk`` clients run
    unchunked; larger ones are padded to a chunk multiple by repeating
    leading rows (the pad outputs are sliced off), so every call sees the
    same ``chunk``-row shapes and peak activation memory is O(chunk), not
    O(cohort). The reference's ``lax.map`` becomes a Python loop; the
    outputs are concatenated on the client axis. ``chunk <= 0`` returns
    ``fn`` unchanged."""
    if not chunk or chunk <= 0:
        return fn
    mapped_pos = tuple(i for i, ax in enumerate(in_axes) if ax == 0)

    def wrapper(*args):
        c = trees.leaves(args[mapped_pos[0]])[0].shape[0]
        if c <= chunk:
            return fn(*args)
        n_chunks = -(-c // chunk)
        pad = n_chunks * chunk - c

        def padded(x):
            return torch.cat([x, x[:pad]]) if pad else x

        stacked = {i: trees.tree_map(padded, args[i]) for i in mapped_pos}
        outs = []
        for k in range(n_chunks):
            full = list(args)
            for i in mapped_pos:
                full[i] = trees.tree_map(lambda x: x[k * chunk:(k + 1) * chunk],
                                         stacked[i])
            outs.append(fn(*full))
        return _cat_outputs(outs, c)

    return wrapper


def _cat_outputs(outs, c: int):
    """Concatenate per-chunk outputs (tensors, dicts or tuples of them) on
    the leading axis and keep the first ``c`` rows."""
    first = outs[0]
    if isinstance(first, tuple):
        return tuple(_cat_outputs([o[i] for o in outs], c) for i in range(len(first)))
    return trees.tree_map(lambda *xs: torch.cat(xs)[:c], *outs)


# ----------------------------------------------------------- server side
def aggregate(trees_list, weights):
    """Server Aggregate/FedAvg: sample-count weighted mean of a list of
    trees."""
    return trees.tree_weighted_mean(trees_list, weights)


# the weighted mean over a stacked tree's client axis, weights normalised
# before the one sum (the reference's order): the mean aggregator itself
aggregate_stacked = mean_aggregate


def aggregate_segments(stacked, weights, segment_ids, num_segments: int,
                       split=None):
    """Per-cluster FedAvg as one batched op: the weighted mean over rows of
    a stacked tree grouped by ``segment_ids`` (cohort row -> cluster
    index). Segments with no rows come out as zero rows.

    Under a mesh, ``split`` (``sharding.RowSplit``) names the cohort rows
    ``stacked`` holds, this rank's, and ``weights`` / ``segment_ids`` stay
    full length: the denominators and then each leaf's numerators are
    ``sharding.segment_sum``'s partial sums, each summed over the ranks by
    one ``all_reduce``."""
    x0 = trees.leaves(stacked)[0]
    w = torch.as_tensor(weights, dtype=torch.float32, device=x0.device)
    seg = torch.as_tensor(segment_ids, device=x0.device).long()
    local_w = w if split is None else split.take(w)
    denom = segment_sum(local_w, None, seg, num_segments, split)
    wn = w / denom[seg]
    agg = segment_sum(stacked, wn, seg, num_segments, split)
    return trees.tree_map(lambda a, x: a.to(x.dtype), agg, stacked)
