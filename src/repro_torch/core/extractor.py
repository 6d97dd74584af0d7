"""Distribution extractor Ψ (paper §3.1).

Ψ(D) = Normalize(∂ℓ(ψ; D)/∂ψ): the L2-normalised gradient of a frozen
anchor model ψ over a client's local dataset. The anchor is never
optimised; the paper sets ψ = ω₀, the FL initialisation.

For LLM-scale anchors two options of the JAX package shrink Ψ:
``leaf_filter`` keeps only the leaves whose ``/``-joined path it accepts
(``llm_leaf_filter``: the vocab matrices), and ``project_dim`` sketches
the kept gradient to that many dimensions with a signed-bucket
Johnson-Lindenstrauss projection. The sketch's buckets and signs come from
``jl_draws``, on the host, so one seed gives one sketch on every device;
the JAX package draws them from ``jax.random``, which torch cannot
reproduce, so the two sketches agree only when the same draws are fed to
both (as the tests do).
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from repro_torch.utils import trees


def leaf_paths(tree, prefix: str = "") -> List[str]:
    """``/``-joined key paths of the leaves in sorted-key order, as the
    JAX package joins ``tree_flatten_with_path`` keys."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in leaf_paths(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def llm_leaf_filter(path: str) -> bool:
    """Ψ restricted to the distribution-bearing vocab matrices."""
    return ("embed" in path) or ("lm_head" in path)


def jl_draws(n: int, dim: int, seed: int):
    """The sketch's draws for an n-long vector: buckets (n,) int32 in
    [0, dim) and signs (n,) int8 in {−1, +1}, on the host, from a CPU
    torch generator seeded with ``seed``."""
    g = torch.Generator().manual_seed(seed)
    buckets = torch.randint(0, dim, (n,), generator=g, dtype=torch.int32)
    signs = torch.randint(0, 2, (n,), generator=g, dtype=torch.int8) * 2 - 1
    return buckets, signs


class JLSketch:
    """Signed-bucket projection of a vector given as consecutive parts
    (the kept leaves' gradients): out[j] = Σ_{i: bucket[i] = j} sign[i]·v[i].

    Built once from ``jl_draws`` over the whole length, moved to ``device``
    in one copy. Each part keeps its
    entries' order sorted by bucket (int32, stable, so a bucket's entries
    stay in index order), their signs in that order (int8) and the
    bucket lengths; a projection is then a gather, a sign flip and
    ``torch.segment_reduce``, which sums each bucket in order on one
    thread: deterministic on the card, unlike a scatter-add. The parts'
    sums are added in part order."""

    def __init__(self, sizes, dim: int, seed: int, device):
        buckets, signs = (x.to(device) for x in jl_draws(sum(sizes), dim, seed))
        edges = torch.arange(dim + 1, dtype=torch.int32, device=buckets.device)
        self.parts, off = [], 0
        for n in sizes:
            sorted_b, order = torch.sort(buckets[off:off + n], stable=True)
            lengths = torch.diff(torch.searchsorted(sorted_b, edges))
            self.parts.append((order.to(torch.int32),
                               signs[off:off + n].to(torch.int8)[order], lengths))
            off += n

    def __call__(self, parts) -> torch.Tensor:
        out = None
        for x, (order, sgn, lengths) in zip(parts, self.parts):
            v = torch.index_select(x.reshape(-1).to(torch.float32), 0, order)
            v.mul_(sgn)
            s = torch.segment_reduce(v, "sum", lengths=lengths)
            out = s if out is None else out + s
        return out


def make_extractor(loss_fn: Callable, anchor_params,
                   project_dim: Optional[int] = None,
                   leaf_filter: Optional[Callable[[str], bool]] = None) -> Callable:
    """Returns Ψ: batch -> normalised fp32 representation vector, on the
    anchor's device, in sorted-leaf order.

    loss_fn(params, batch) -> scalar tensor. Only the leaves ``leaf_filter``
    keeps (all without one) take a gradient; with ``project_dim`` their
    gradients are sketched by ``JLSketch`` (seed 0, the reference's), built
    at the first call.

    A batch whose floating leaves have another dtype than the anchor's
    (bf16 batches of ``EngineConfig.dtype="bfloat16"`` under the fp32
    anchor) is cast to the anchor's dtype first: JAX promotes the mixed
    product to fp32 at its first operation, which torch's matmul does not
    do, and the cast is exact."""
    anchor = trees.tree_map(lambda x: x.detach(), anchor_params)
    keep = [leaf_filter is None or leaf_filter(p) for p in leaf_paths(anchor)]
    anchor_dt = next((x.dtype for x in trees.leaves(anchor) if x.is_floating_point()),
                     torch.float32)
    sketch: List[JLSketch] = []

    def psi(batch) -> torch.Tensor:
        batch = trees.tree_map(
            lambda x: x.to(anchor_dt) if x.is_floating_point() else x, batch)
        # the kept leaves become views of the anchor that take a gradient
        kept = [x.detach().requires_grad_(True)
                for x, k in zip(trees.leaves(anchor), keep) if k]
        it = iter(kept)
        params = trees.from_leaves(anchor, [next(it) if k else x
                                            for x, k in zip(trees.leaves(anchor), keep)])
        with torch.enable_grad():
            loss = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, kept, allow_unused=True)
        # a leaf the loss never reads has gradient 0, as under jax.grad
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(kept, grads)]
        if project_dim:
            if not sketch:
                sketch.append(JLSketch([g.numel() for g in grads], project_dim, 0,
                                       grads[0].device))
            vec = sketch[0](grads)
        else:
            vec = torch.cat([g.reshape(-1).to(torch.float32) for g in grads])
        norm = torch.linalg.vector_norm(vec)
        return torch.where(norm > 0, vec / norm, vec)

    return psi

