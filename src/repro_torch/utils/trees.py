"""Helpers over parameter trees: nested dicts of tensors.

Leaves are visited in sorted-key order, the order JAX flattens a dict in,
so a vector of the leaves concatenated in this order (Ψ, the fused
step's flat buffers) lines up element for element with the JAX package's.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import torch


def leaves(tree) -> List[torch.Tensor]:
    """Leaves of a nested dict in sorted-key order (a bare tensor is its
    own single leaf)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    return [tree]


def from_leaves(tree, flat_leaves):
    """A tree of ``tree``'s structure holding ``flat_leaves``, given in
    sorted-key order (the inverse of ``leaves``)."""
    it = iter(flat_leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return next(it)

    return walk(tree)


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leaf-wise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *[r[k] for r in rest]) for k in tree}
    return fn(tree, *rest)


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(tree, s):
    return tree_map(lambda x: x * s, tree)


def tree_axpy(a, x, y):
    """a*x + y elementwise over two trees."""
    return tree_map(lambda xi, yi: a * xi + yi, x, y)


def tree_dot(a, b) -> torch.Tensor:
    """Inner product of two trees (fp32 accumulate): each leaf's sum of
    products, added in sorted-key order from 0.0, as the reference's
    ``jax.tree.reduce`` adds them. A 0-d tensor on the leaves' device."""
    pairs = list(zip(leaves(a), leaves(b)))
    out = torch.zeros((), dtype=torch.float32, device=pairs[0][0].device if pairs else None)
    for x, y in pairs:
        out = out + torch.sum(x.to(torch.float32) * y.to(torch.float32))
    return out


def tree_norm(tree) -> torch.Tensor:
    return torch.sqrt(tree_dot(tree, tree))


def tree_size(tree) -> int:
    """Total number of scalar parameters, read from the shapes."""
    return sum(leaf.numel() for leaf in leaves(tree))


def tree_bytes(tree) -> int:
    return sum(leaf.numel() * leaf.element_size() for leaf in leaves(tree))


def tree_has_nan(tree) -> torch.Tensor:
    """A 0-d bool tensor on the leaves' device (no host read)."""
    return torch.stack([torch.isnan(leaf).any() for leaf in leaves(tree)]).any()


def tree_weighted_mean(trees: Sequence, weights):
    """Weighted mean of a list of trees; ``weights`` are scalars."""
    w = torch.as_tensor(weights, dtype=torch.float32)
    w = w / torch.sum(w)
    out = tree_map(lambda x: x * w[0].to(x.device), trees[0])
    for i in range(1, len(trees)):
        out = tree_map(lambda x, y, wi=w[i]: wi.to(x.device) * x + y,
                       trees[i], out)
    return out


def tree_flatten_vector(tree, dtype=torch.float32) -> torch.Tensor:
    """Flatten a tree into one 1-D vector of ``dtype``, leaves in
    sorted-key order (Ψ's representation space, CFL's update vectors)."""
    return torch.cat([leaf.reshape(-1).to(dtype) for leaf in leaves(tree)])


def tree_unflatten_vector(vec: torch.Tensor, tree):
    """Inverse of ``tree_flatten_vector`` given a template tree: each leaf
    takes its shape and dtype from the template's."""
    out, off = [], 0
    for leaf in leaves(tree):
        n = leaf.numel()
        out.append(vec[off:off + n].reshape(leaf.shape).to(leaf.dtype))
        off += n
    return from_leaves(tree, out)


def tree_cast(tree, dtype):
    """Every leaf cast to ``dtype``."""
    return tree_map(lambda x: x.to(dtype), tree)
