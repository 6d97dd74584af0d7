"""Shared building blocks of the port's models: parameter inits, RMSNorm
and LayerNorm, rotary embeddings, the SwiGLU and GELU MLPs, the
next-token loss, and ``remat``, the layer checkpoint that stands for the
reference's ``jax.checkpoint``. The MLPs place their hidden activation
with ``sharding.shard`` where the reference does (a no-op without an
entered ``ShardCtx``)."""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.sharding.specs import current_ctx, shard
from repro_torch.utils import trees


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale: Optional[float] = None,
               device="cpu") -> torch.Tensor:
    """(d_in, d_out) normal weights scaled by 1/sqrt(d_in) (the JAX
    package's ``dense_init`` layout: ``x @ w``). Drawn on the generator's
    device, then moved to ``device``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator,
                    device=generator.device) * scale
    return w.to(device=device, dtype=dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype=torch.float32, device="cpu") -> torch.Tensor:
    """(vocab, d) normal embedding rows scaled by 0.02."""
    w = torch.randn((vocab, d), generator=generator, device=generator.device) * 0.02
    return w.to(device=device, dtype=dtype)


def rmsnorm_init(d: int, dtype=torch.float32, device="cpu"):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS normalisation in fp32, cast back to ``x``'s dtype, then scaled
    in that dtype (the JAX package's order of roundings)."""
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * params["scale"].to(x.dtype)


def layernorm_init(d: int, dtype=torch.float32, device="cpu"):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Layer normalisation with the population variance (``jnp.var``'s) in
    fp32, cast back to ``x``'s dtype, then scaled and shifted in that
    dtype."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * params["scale"].to(dt) + params["bias"].to(dt)


# ----------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float = 10000.0, device="cpu") -> torch.Tensor:
    """(head_dim/2,) fp32 inverse frequencies 1 / theta^(2i/head_dim). The
    base is a scalar operand (no tensor is copied from the host, so this
    runs inside a captured CUDA graph)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding in fp32, the JAX package's half-split layout.
    x: (..., seq, heads, head_dim); positions: (..., seq) integers."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)                 # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs          # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]                            # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- mlp
def swiglu_init(generator: torch.Generator, d_model: int, d_ff: int,
                dtype=torch.float32, device="cpu"):
    return {
        "w_gate": dense_init(generator, d_model, d_ff, dtype, device=device),
        "w_up": dense_init(generator, d_model, d_ff, dtype, device=device),
        "w_down": dense_init(generator, d_ff, d_model, dtype, device=device),
    }


def swiglu(params, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """silu(x·W_gate) ⊙ (x·W_up) · W_down, in ``compute_dtype`` (x's by
    default)."""
    dt = compute_dtype or x.dtype
    g = x @ params["w_gate"].to(dt)
    u = x @ params["w_up"].to(dt)
    h = shard(torch.nn.functional.silu(g) * u, "batch", None, "tp")
    return h @ params["w_down"].to(dt)


def gelu_mlp_init(generator: torch.Generator, d_model: int, d_ff: int,
                  dtype=torch.float32, device="cpu"):
    return {
        "w_up": dense_init(generator, d_model, d_ff, dtype, device=device),
        "b_up": torch.zeros((d_ff,), dtype=dtype, device=device),
        "w_down": dense_init(generator, d_ff, d_model, dtype, device=device),
        "b_down": torch.zeros((d_model,), dtype=dtype, device=device),
    }


def gelu_mlp(params, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """gelu(x·W_up + b_up)·W_down + b_down in ``compute_dtype`` (x's by
    default), with the tanh approximation, ``jax.nn.gelu``'s default."""
    dt = compute_dtype or x.dtype
    h = torch.nn.functional.gelu(x @ params["w_up"].to(dt) + params["b_up"].to(dt),
                                 approximate="tanh")
    h = shard(h, "batch", None, "tp")
    return h @ params["w_down"].to(dt) + params["b_down"].to(dt)


def ce_loss(logits: torch.Tensor, tokens: torch.Tensor, aux) -> torch.Tensor:
    """Mean next-token cross entropy in fp32 plus 0.01·aux. The gold logit
    is gathered; the reference contracts with a one-hot, which picks the
    same value exactly (one term times 1, the rest times 0). Under an
    entered ``ShardCtx`` the loss takes the reference's one-hot
    contraction, which a vocab-sharded DTensor sums shard by shard (its
    gather over a sharded vocab gives wrong shapes)."""
    logits = logits[:, :-1].to(torch.float32)
    targets = tokens[:, 1:].to(torch.int64)
    logz = torch.logsumexp(logits, dim=-1)
    if current_ctx() is not None:
        onehot = torch.nn.functional.one_hot(targets, logits.shape[-1]).to(logits.dtype)
        gold = torch.einsum("bsv,bsv->bs", logits, onehot)
    else:
        gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    return torch.mean(logz - gold) + 0.01 * aux


# ----------------------------------------------------------------- remat
class _Remat(torch.autograd.Function):
    """``body(*inputs)`` -> a tuple of tensors, keeping only the inputs for
    the backward, which runs ``body`` again through ``torch.func.vjp``.
    It has a generated vmap rule, so it runs inside the cohort update's
    ``torch.func.vmap`` (``torch.utils.checkpoint`` does not: its
    non-reentrant form lets a tensor escape the vmap, and its reentrant
    form has no ``setup_context``). Under a ``ShardCtx`` (DTensors, never
    under ``vmap``) the backward recomputes with plain autograd instead,
    within the forward's context: it may run on another thread
    (autograd's, on the card), whose stack of contexts is its own, and
    ``torch.func``'s wrappers would hide the DTensors from the models'
    hooks."""
    generate_vmap_rule = True

    @staticmethod
    def forward(body, *inputs):
        return body(*inputs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.body = inputs[0]
        ctx.shard_ctx = current_ctx()
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *grads):
        if ctx.shard_ctx is None:
            _, pullback = torch.func.vjp(ctx.body, *ctx.saved_tensors)
            return (None,) + tuple(pullback(grads))
        with ctx.shard_ctx, torch.enable_grad():
            xs = [x.detach().requires_grad_(x.is_floating_point()) for x in ctx.saved_tensors]
            pairs = [(o, g) for o, g in zip(ctx.body(*xs), grads)
                     if g is not None and o.requires_grad]
            got = torch.autograd.grad([o for o, _ in pairs], xs, [g for _, g in pairs],
                                      allow_unused=True) if pairs else [None] * len(xs)
        return (None,) + tuple(got)


def remat(cfg, fn, *args):
    """``fn(*args)``, checkpointed as the reference's ``jax.checkpoint``
    checkpoints a layer: when ``cfg.remat`` is set and a gradient may be
    taken, only the layer's inputs are kept and its backward recomputes it.
    Otherwise (serving, evaluation, ``no_grad`` losses) ``fn`` runs as is.

    ``args`` are tensors or dicts of them (a layer's hidden state and
    parameters); every tensor a gradient should reach must be among them,
    not captured by ``fn``. ``fn`` returns a tree of the same kinds, or a
    tuple of such trees (an MoE layer's ``(h, aux)``)."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn(*args)
    skeleton = lambda tree: trees.tree_map(lambda _: None, tree)      # structure only
    ins = [skeleton(a) for a in args]
    sizes = [len(trees.leaves(a)) for a in args]
    out_tree = []

    def body(*xs):
        it = iter(xs)
        out = fn(*(trees.from_leaves(a, [next(it) for _ in range(n)])
                   for a, n in zip(ins, sizes)))
        parts = out if isinstance(out, tuple) else (out,)
        out_tree[:] = [(isinstance(out, tuple), [skeleton(p) for p in parts])]
        return tuple(x for p in parts for x in trees.leaves(p))

    outs = iter(_Remat.apply(body, *(x for a in args for x in trees.leaves(a))))
    is_tuple, parts = out_tree[0]
    got = tuple(trees.from_leaves(p, [next(outs) for _ in trees.leaves(p)]) for p in parts)
    return got if is_tuple else got[0]
