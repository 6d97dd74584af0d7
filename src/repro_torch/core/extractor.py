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

``make_extractor(..., batched=True)`` is the reference's vmapped Ψ over a
stacked batch of clients, which the serving router's ``infer_batch``
runs: a chunk of clients' losses under one ``torch.func.vmap`` and their
kept gradients from one autograd call, then sketched and normalised row
by row outside the vmap. The round keeps the one-client autograd Ψ.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
from torch.func import vmap

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
    sums are added in part order. ``rows`` projects a stack of vectors,
    each row summed in the same order as ``__call__`` sums it alone."""

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

    def rows(self, parts) -> torch.Tensor:
        """Parts with a leading axis of J vectors -> (J, dim): row j is
        ``self([p[j] for p in parts])`` bit for bit (each bucket summed
        in index order along the row)."""
        out = None
        for x, (order, sgn, lengths) in zip(parts, self.parts):
            v = torch.index_select(x.reshape(x.shape[0], -1).to(torch.float32), 1, order)
            v.mul_(sgn)
            s = torch.segment_reduce(v, "sum", lengths=lengths.expand(v.shape[0], -1)
                                     .contiguous(), axis=1)
            out = s if out is None else out + s
        return out


def psi_dim(anchor_params, project_dim: Optional[int] = None,
            leaf_filter: Optional[Callable[[str], bool]] = None) -> int:
    """The width of a Ψ row: ``project_dim`` with a sketch, else the
    element count of the leaves ``leaf_filter`` keeps (all without one)."""
    if project_dim:
        return int(project_dim)
    return sum(x.numel() for p, x in zip(leaf_paths(anchor_params),
                                         trees.leaves(anchor_params))
               if leaf_filter is None or leaf_filter(p))


def make_extractors(loss_fn: Callable, anchor_params,
                    project_dim: Optional[int] = None,
                    leaf_filter: Optional[Callable[[str], bool]] = None,
                    chunk: int = 0) -> Tuple[Callable, Callable]:
    """``(Ψ, batched Ψ)`` over one anchor, one leaf filter and one sketch
    (built once, at the first call of either): ``make_extractor``'s two
    forms, as the engine holds them."""
    anchor = trees.tree_map(lambda x: x.detach(), anchor_params)
    frozen = trees.leaves(anchor)
    keep = [leaf_filter is None or leaf_filter(p) for p in leaf_paths(anchor)]
    anchor_dt = next((x.dtype for x in frozen if x.is_floating_point()), torch.float32)
    sketch: List[JLSketch] = []

    def cast(batch):
        return trees.tree_map(
            lambda x: x.to(anchor_dt) if x.is_floating_point() else x, batch)

    def with_kept(kept):
        """The anchor's tree with its kept leaves replaced by ``kept``."""
        it = iter(kept)
        return trees.from_leaves(anchor, [next(it) if k else x for x, k in zip(frozen, keep)])

    def project(grads, many: bool) -> torch.Tensor:
        """The kept gradients (a leading client axis when ``many``) as
        fp32 vectors, sketched with ``project_dim``."""
        if project_dim:
            if not sketch:
                sizes = [x.numel() for x, k in zip(frozen, keep) if k]
                sketch.append(JLSketch(sizes, project_dim, 0, grads[0].device))
            return sketch[0].rows(grads) if many else sketch[0](grads)
        if many:
            return torch.cat([g.reshape(g.shape[0], -1).to(torch.float32) for g in grads],
                             dim=1)
        return torch.cat([g.reshape(-1).to(torch.float32) for g in grads])

    def psi(batch) -> torch.Tensor:
        batch = cast(batch)
        # the kept leaves become views of the anchor that take a gradient
        kept = [x.detach().requires_grad_(True) for x, k in zip(frozen, keep) if k]
        with torch.enable_grad():
            loss = loss_fn(with_kept(kept), batch)
            grads = torch.autograd.grad(loss, kept, allow_unused=True)
        # a leaf the loss never reads has gradient 0, as under jax.grad
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(kept, grads)]
        vec = project(grads, many=False)
        norm = torch.linalg.vector_norm(vec)
        return torch.where(norm > 0, vec / torch.where(norm > 0, norm, 1.0), vec)

    # the cohort update's form: each client's loss under vmap reads its own
    # row of the kept leaves, stride-0 expansions of the anchor, and one
    # autograd call of the summed losses gives every client's gradient
    dims = trees.from_leaves(anchor, [0 if k else None for k in keep])
    per_client = vmap(loss_fn, in_dims=(dims, 0))
    kept0 = [x for x, k in zip(frozen, keep) if k]

    def psi_many(batches) -> torch.Tensor:
        batches = cast(batches)
        n = trees.leaves(batches)[0].shape[0]
        step = chunk if chunk and chunk > 0 else n
        rows = []
        for lo in range(0, n, step):
            part = trees.tree_map(lambda x: x[lo:lo + step], batches)
            c = trees.leaves(part)[0].shape[0]
            kept = [x.expand(c, *x.shape).requires_grad_(True) for x in kept0]
            with torch.enable_grad():
                loss = per_client(with_kept(kept), part).sum()
                grads = torch.autograd.grad(loss, kept, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(kept, grads)]
            vec = project(grads, many=True)                     # (c, dim)
            norm = torch.linalg.vector_norm(vec, dim=1, keepdim=True)
            rows.append(torch.where(norm > 0, vec / torch.where(norm > 0, norm, 1.0), vec))
        return rows[0] if len(rows) == 1 else torch.cat(rows)

    return psi, psi_many


def make_extractor(loss_fn: Callable, anchor_params,
                   project_dim: Optional[int] = None,
                   batched: bool = False,
                   leaf_filter: Optional[Callable[[str], bool]] = None,
                   chunk: int = 0) -> Callable:
    """Returns Ψ: batch -> normalised fp32 representation vector, on the
    anchor's device, in sorted-leaf order.

    loss_fn(params, batch) -> scalar tensor. Only the leaves ``leaf_filter``
    keeps (all without one) take a gradient; with ``project_dim`` their
    gradients are sketched by ``JLSketch`` (seed 0, the reference's), built
    at the first call.

    With ``batched`` the returned function maps a stacked batch (a leading
    client axis) to (J, dim) rows, at most ``chunk`` clients a call (0:
    all in one): the clients' losses under one ``torch.func.vmap``, the
    kept leaves expanded along the client axis, and one autograd call of
    their sum, as the cohort update takes its gradients; then every row
    of the call sketched and normalised in one pass. Row j equals the
    unbatched Ψ of client j to rounding. (``vmap`` over ``torch.func.grad``
    held 4.6× the one-client Ψ's memory at one client on qwen2-1.5b on an
    H100 and did not fit two: ``scripts/torch_psi_forms.py``.) Without
    ``batched`` Ψ is one autograd call, the round's Ψ.

    A batch whose floating leaves have another dtype than the anchor's
    (bf16 batches of ``EngineConfig.dtype="bfloat16"`` under the fp32
    anchor) is cast to the anchor's dtype first: JAX promotes the mixed
    product to fp32 at its first operation, which torch's matmul does not
    do, and the cast is exact."""
    return make_extractors(loss_fn, anchor_params, project_dim, leaf_filter,
                           chunk)[bool(batched)]


def representation(loss_fn, anchor_params, batch, project_dim=None) -> torch.Tensor:
    """One-shot Ψ(D) of one batch."""
    return make_extractor(loss_fn, anchor_params, project_dim)(batch)
