"""Mesh-aware step builders: the LLM steps the reference lowers for a
``(data, model)`` mesh, as eager torch over DTensors.

``stocfl_train_step`` is the PAPER-FAITHFUL StoCFL round step: both
bi-level gradients are taken, then the fused prox update (K1) applies.
``lm_train_step`` is the plain data-parallel LM step; ``prefill_step``,
``decode_step`` and ``repr_step`` are cluster-model serving and Ψ.

Each step is a function of parameter, batch and cache trees. Without a
mesh the trees hold plain tensors and the step is the model's own math.
Under ``lower_step`` the trees hold DTensors placed by the reference's
rule table (``sharding.param_shardings``, ``batch_shardings``,
``cache_shardings``), the step runs inside a ``ShardCtx`` (so the
models' ``shard`` / ``unshard_fsdp`` hooks place activations and
weights), plain tensors the models make on the way (positions, masks)
count as replicated, and every output is redistributed to the
placement the reference's ``out_shardings`` give it.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.registry import Model, Spec, decode_specs
from repro_torch.sharding.specs import (DTensor, NamedSharding, ShardCtx, _distribute,
                                        _map_paths, _redistribute, _size, param_shardings,
                                        relax, replicated, to_local, wrap_like)
from repro_torch.utils import trees

# ---------------------------------------------------------------- helpers
def batch_shardings(specs, mesh, ctx: ShardCtx):
    """Every batch leaf's leading (batch) dim over the client axes, or
    replicated where they do not divide it."""
    def one(x):
        nd = len(x.shape)
        spec = ctx.resolve(["batch"] + [None] * (nd - 1))
        axes = spec[0] if isinstance(spec[0], tuple) else (spec[0],)
        n = 1
        for a in axes:
            if a:
                n *= _size(mesh, a)
        if x.shape[0] % n != 0:
            spec = (None,) * nd
        return NamedSharding(mesh, spec)

    return trees.tree_map(one, specs)


def cache_shardings(cache_specs, mesh, ctx: ShardCtx):
    """Cache layout: leading layer axis replicated, batch over the client
    axes, the *sequence* dim of attention caches over the model axis
    (each model rank holds a contiguous slab of the cache), SSM states'
    channels over the model axis; relaxed where an axis does not divide."""
    def one(path, x):
        nd = len(x.shape)
        name = path.split("/")[-1]
        if name in ("k", "v", "c_kv", "k_rope", "h"):
            logical = [None, "batch", "tp"] + [None] * (nd - 3)
        elif name == "conv":
            logical = [None, "batch", None, "tp"][:nd]
        else:
            logical = [None, "batch"] + [None] * (nd - 2)
        return NamedSharding(mesh, relax(x.shape, ctx.resolve(logical), mesh))

    return _map_paths(one, cache_specs)


def param_specs(model: Model):
    """The shapes and dtypes of ``model.init``'s parameters, with no
    storage (the counterpart of ``jax.eval_shape(model.init, key)``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        params = model.init(torch.Generator())
    return trees.tree_map(lambda x: Spec(tuple(x.shape), x.dtype), params)


def _value_and_grad(loss_fn, params, batch):
    """(loss, d loss / d params) by reverse mode; the gradient tree has
    ``params``' structure, zeros for a leaf the loss does not read (as
    ``jax.grad`` gives: a hybrid cut below its first shared block)."""
    leaves = [x.detach().requires_grad_(True) for x in trees.leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(trees.from_leaves(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    return loss.detach(), trees.from_leaves(params, grads)


def _like(g, p):
    """A gradient in its parameter's placements (a ``Partial`` one is
    reduced there); a plain tensor as it is."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _grads_like(grads, params):
    return trees.tree_map(_like, grads, params)


# ---------------------------------------------------------------- steps
def stocfl_train_step(model: Model, lr: float = 0.1, lam: float = 0.05):
    """One bi-level StoCFL round over the client cohort: returns (θ', ω',
    {"loss_theta", "loss_omega"})."""

    def step(theta, omega, batch):
        loss_t, g_t = _value_and_grad(model.loss_fn, theta, batch)
        loss_o, g_o = _value_and_grad(model.loss_fn, omega, batch)
        g_t, g_o = _grads_like(g_t, theta), _grads_like(g_o, omega)
        # The reference passes backend="jnp" here only because GSPMD cannot
        # partition a Pallas call. K1 is elementwise and the four trees
        # share one layout, so it runs on each rank's local shards (the
        # kernel on the card, its plain version on the CPU), exactly.
        local = lambda tree: trees.tree_map(to_local, tree)
        t2, o2 = ops.prox_update_tree(local(theta), local(omega), local(g_t), local(g_o),
                                      lr, lam)
        return (trees.tree_map(wrap_like, t2, theta), trees.tree_map(wrap_like, o2, omega),
                {"loss_theta": loss_t, "loss_omega": loss_o})

    return step


def lm_train_step(model: Model, lr: float = 1e-3):
    """Plain data-parallel LM step (baseline / non-FL substrate path)."""

    def step(params, batch):
        loss, grads = _value_and_grad(model.loss_fn, params, batch)
        grads = _grads_like(grads, params)
        with torch.no_grad():
            params = trees.tree_map(lambda p, g: (p - lr * g).to(p.dtype), params, grads)
        return params, {"loss": loss}

    return step


def prefill_step(model: Model):
    def step(params, batch):
        with torch.no_grad():
            return model.prefill(params, batch)

    return step


def decode_step(model: Model):
    def step(params, token, cache, pos):
        with torch.no_grad():
            return model.decode(params, token, cache, pos)

    return step


def repr_step(model: Model):
    """Ψ: the anchor's gradient, L2-normalised over all leaves together
    (one global norm), as a parameter-shaped fp32 tree."""

    def step(anchor, batch):
        _, g = _value_and_grad(model.loss_fn, anchor, batch)
        g = _grads_like(g, anchor)
        with torch.no_grad():
            sq = torch.zeros((), dtype=torch.float32, device=trees.leaves(g)[0].device)
            for x in trees.leaves(g):
                sq = sq + torch.sum(torch.square(x.to(torch.float32)))
            inv = torch.rsqrt(sq + 1e-24)
            return trees.tree_map(lambda x: x.to(torch.float32) * inv, g)

    return step


# ---------------------------------------------------------------- binding
class Bound(NamedTuple):
    """A step bound to a mesh: ``fn(*args)`` places its arguments, runs the
    step under the mesh's ``ShardCtx`` and returns outputs in their
    placements; ``in_shardings`` holds one tree of ``NamedSharding`` per
    argument, ``out_shardings`` one per output."""
    fn: Callable
    in_shardings: Tuple
    out_shardings: Tuple


def _put(x, sharding):
    """``x`` in ``sharding``: a DTensor redistributed, a tensor distributed
    from the full value every rank holds; anything else (a host int) as
    it is."""
    if isinstance(x, DTensor):
        return _redistribute(x, sharding.mesh, sharding.spec)
    if isinstance(x, torch.Tensor):
        return _distribute(x, sharding.mesh, sharding.placements)
    return x


def _put_tree(tree, shardings):
    if isinstance(shardings, NamedSharding):
        return trees.tree_map(lambda x: _put(x, shardings), tree)
    return trees.tree_map(_put, tree, shardings)


def _bind(fn, ctx, in_sh, out_sh) -> Bound:
    def run(*args):
        placed = [_put_tree(a, s) for a, s in zip(args, in_sh)]
        with ctx:
            out = fn(*placed)
        if len(out_sh) == 1:
            return _put_tree(out, out_sh[0])
        return tuple(_put_tree(o, s) for o, s in zip(out, out_sh))

    return Bound(run, tuple(in_sh), tuple(out_sh))


def lower_step(model: Model, shape, mesh, kind: str, lr=0.1, lam=0.05,
               serve_params_tp_only: bool = False) -> Bound:
    """The step of ``kind`` ("train", "prefill", "decode", "repr") for
    (model, shape, mesh), bound to its placements (``Bound``).

    Eager torch has nothing to lower: the reference returns a lowered
    program, this returns the step itself, which places its arguments by
    the reference's ``in_shardings`` and its outputs by its
    ``out_shardings``. The reference's buffer donation has no
    counterpart in eager torch. ``serve_params_tp_only``: the serving
    layout, parameters on the model axis only (``fsdp`` replicated)."""
    ctx = ShardCtx(mesh)
    pspecs = param_specs(model)
    pctx = ShardCtx(mesh, {**ctx.logical_map, "fsdp": None}) if serve_params_tp_only else ctx
    pshard = param_shardings(pspecs, mesh, pctx)
    rep = replicated(mesh)

    if kind == "train":
        bshard = batch_shardings(model.input_specs(shape), mesh, ctx)
        return _bind(stocfl_train_step(model, lr, lam), ctx, (pshard, pshard, bshard),
                     (pshard, pshard, rep))
    if kind == "prefill":
        bshard = batch_shardings(model.input_specs(shape), mesh, ctx)
        cache = model.make_cache(shape.global_batch, shape.seq_len, device="meta")
        return _bind(prefill_step(model), ctx, (pshard, bshard),
                     (rep, cache_shardings(cache, mesh, ctx)))
    if kind == "decode":
        dspecs = decode_specs(model, shape)
        cshard = cache_shardings(dspecs["cache"], mesh, ctx)
        tshard = batch_shardings({"token": dspecs["token"]}, mesh, ctx)["token"]
        return _bind(decode_step(model), ctx, (pshard, tshard, cshard, rep), (rep, cshard))
    if kind == "repr":
        bshard = batch_shardings(model.input_specs(shape), mesh, ctx)
        return _bind(repr_step(model), ctx, (pshard, bshard), (pshard,))
    raise ValueError(f"unknown step kind {kind}")


__all__ = ["Bound", "batch_shardings", "cache_shardings", "decode_step", "lm_train_step",
           "lower_step", "param_specs", "prefill_step", "repr_step", "stocfl_train_step"]

