"""Client-axis placement of the federated engine over a torch ``DeviceMesh``.

The JAX package places each cohort's stacked inputs on the client axis
of a ``jax.sharding.Mesh`` and lets GSPMD split the per-client math and
turn every cross-client reduction into per-shard partial sums and an
all-reduce. The port runs one process per rank on a 1-D ``DeviceMesh``
(``launch.mesh.make_client_mesh``) and writes that program out:

* a stacked cohort's leading (client) axis is split into contiguous
  per-rank slices when it divides the mesh's client-axis rank count, and
  kept whole on every rank otherwise (the reference's "relax to
  replicated" rule, ``_divisible``): ``place_cohort``, ``row_split``;
* a reduction over those rows is a local partial sum and one
  ``all_reduce`` (``RowSplit.reduce_``; ``segment_sum``, which
  ``psum_segments`` and the engine's ``bilevel.aggregate_segments`` both
  run);
* where every rank needs every row (Ditto's personal rows, IFCA's
  losses, CFL's split statistics, the async buffer's rows), the rows come
  back through an ``all_reduce`` of a zero-filled full stack, summed as
  bytes so the result is the rows bit for bit (``RowSplit.gather``);
* everything else is replicated: every rank computes it from the same
  inputs. The card's ``index_add_`` sums floats with atomics, in an
  order that differs from run to run and so from rank to rank; under a
  mesh every float segment sum therefore runs in one fixed order
  (``ordered_index_add_``), so the ranks' replicated sums, and the
  partitions built from them, are the same bits on every rank.

Every collective is an ``all_reduce``, which ``gloo`` supports on CUDA
tensors (as it does ``broadcast``, but not ``all_gather`` or
``reduce_scatter``), so two ranks on one card can run the engine under
``gloo`` where NCCL refuses two ranks on one GPU.

The helpers that read only axis names and sizes (``client_axes``,
``mesh_client_count``, ``align_cohort_chunk``, ``cohort_spec``,
``_divisible``) take any object with ``mesh_dim_names`` (a
``DeviceMesh``) or ``axis_names`` and a ``shape`` (a tuple in axis order,
or a mapping by axis name).
"""
from __future__ import annotations

import dataclasses
import os
from collections.abc import Mapping
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.utils import trees

try:                                    # public since torch 2.4
    from torch.distributed.tensor import Replicate, Shard
except ImportError:                     # pragma: no cover - older torch
    from torch.distributed._tensor import Replicate, Shard

CLIENT_AXES = ("pod", "data", "clients")


# ------------------------------------------------------------------- axes
def _names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = getattr(mesh, "axis_names", ())
    return tuple(names or ())


def _size(mesh, axis: str) -> int:
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return int(shape[axis])
    return int(tuple(shape)[_names(mesh).index(axis)])


def client_axes(mesh) -> tuple:
    """Mesh axes that carry the client / cohort dimension, in the
    canonical order ``("pod", "data", "clients")``."""
    names = _names(mesh)
    return tuple(a for a in CLIENT_AXES if a in names)


def mesh_client_count(mesh) -> int:
    """Ranks along the client / cohort axes (their sizes' product)."""
    n = 1
    for a in client_axes(mesh):
        n *= _size(mesh, a)
    return n


def align_cohort_chunk(chunk: int, mesh) -> int:
    """Round ``cohort_chunk`` up to a multiple of the mesh's client-axis
    rank count, so that a chunked cohort splits evenly over the ranks."""
    if mesh is None or chunk <= 0:
        return chunk
    n = mesh_client_count(mesh)
    return chunk if n <= 1 else -(-chunk // n) * n


def cohort_spec(mesh, ndim: int):
    """The placement of a stacked cohort tensor: ``Shard(0)`` (its leading
    axis over the client axes) or ``Replicate()`` for a 0-d tensor or a
    mesh without a client axis."""
    if ndim == 0 or not client_axes(mesh):
        return Replicate()
    return Shard(0)


def _divides(n: int, mesh) -> bool:
    """True when ``n`` rows split evenly over the client-axis ranks."""
    return int(n) % mesh_client_count(mesh) == 0


def _divisible(x, spec, mesh) -> bool:
    """True when ``x`` can take ``spec`` on ``mesh``: replicated, or its
    leading axis divides the client-axis rank count (``row_split``'s
    rule)."""
    return not isinstance(spec, Shard) or _divides(x.shape[0], mesh)


def mesh_fingerprint(mesh):
    """Hashable identity of a mesh for the captured-program cache: axis
    names, axis sizes and the ranks in mesh order (None without a mesh).
    A program captured under one mesh is never replayed under another."""
    if mesh is None:
        return None
    names = _names(mesh)
    return (names, tuple(_size(mesh, a) for a in names),
            tuple(int(r) for r in mesh.mesh.flatten().tolist()))


# ---------------------------------------------------------------- process
def _client_dim(mesh) -> str:
    axes = client_axes(mesh)
    if len(axes) != 1:
        raise ValueError(f"the engine runs on a mesh with one client axis, got {_names(mesh)}")
    return axes[0]


def mesh_rank(mesh) -> int:
    """This process's coordinate along the mesh's client axis."""
    dim = _names(mesh).index(_client_dim(mesh))
    return int(mesh.get_coordinate()[dim])


def mesh_group(mesh):
    """The process group of the mesh's client axis."""
    return mesh.get_group(_client_dim(mesh))


def mesh_backend(mesh) -> str:
    """The backend of the client axis' group (``"nccl"``, ``"gloo"``)."""
    return str(dist.get_backend(mesh_group(mesh)))


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on: ``cuda:(local_rank %
    device_count)`` on a CUDA mesh, the CPU on a CPU mesh."""
    if mesh.device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        return torch.device("cuda", local % torch.cuda.device_count())
    return torch.device(mesh.device_type)


def all_reduce_(t: torch.Tensor, mesh) -> torch.Tensor:
    """Sum ``t`` over the client axis, in place (identity without a mesh)."""
    if mesh is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh_group(mesh))
    return t


def barrier(mesh, device=None) -> None:
    """Wait until every rank of the client axis reaches this point: a
    one-element ``all_reduce`` read back on the host."""
    if mesh is None:
        return
    t = torch.zeros((1,), device=device or mesh_device(mesh))
    float(all_reduce_(t, mesh).sum())


# ---------------------------------------------------------------- order
def ordered_index_add_(out: torch.Tensor, index: torch.Tensor,
                       src: torch.Tensor) -> torch.Tensor:
    """``out.index_add_(0, index, src)`` in one fixed order, so the same
    inputs give the same bits on every run and every rank. On the card
    ``index_add_`` adds with atomics, in an order that changes from run to
    run; ``index_put_`` with ``accumulate=True`` sorts ``index`` stably and
    sums each index's rows in turn (deterministic algorithms would reroute
    ``index_add_`` to it too, but they are a global mode whose first use
    in a process is slow). On the CPU ``index_add_`` already sums each
    index's rows in index order, while ``index_put_`` may add with atomics
    on several threads, so the CPU keeps ``index_add_``."""
    if out.is_cuda:
        return out.index_put_((index,), src, accumulate=True)
    return out.index_add_(0, index, src)


# --------------------------------------------------------------- row split
@dataclasses.dataclass(frozen=True)
class RowSplit:
    """This rank's share of a leading axis of ``n`` rows: rows ``[lo,
    hi)``. ``mesh`` is the mesh (None without one). ``sharded`` is False
    when the rows are not split (no mesh, or ``n`` does not divide the
    client-axis rank count): every rank then holds all ``n`` rows and no
    collective runs."""
    n: int
    lo: int
    hi: int
    mesh: Any = None
    sharded: bool = False

    def take(self, x):
        """This rank's rows of a full-length tensor, array or tree of
        tensors (a contiguous ``narrow``; the whole input when unsplit)."""
        if not self.sharded or (self.lo == 0 and self.hi == self.n):
            return x
        if isinstance(x, torch.Tensor):
            return x.narrow(0, self.lo, self.hi - self.lo)
        if isinstance(x, dict):
            return trees.tree_map(self.take, x)
        return x[self.lo:self.hi]

    def reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """A per-rank partial sum summed over the ranks, in place."""
        return all_reduce_(t, self.mesh) if self.sharded else t

    def gather(self, tree):
        """Every rank's rows of a tree of ``(hi - lo, ...)`` tensors as the
        full ``(n, ...)`` stack on every rank, bit for bit: each rank
        writes its rows into a zero-filled stack and the stacks are summed
        as bytes, to which one rank gives each byte."""
        if not self.sharded:
            return tree

        def leaf(x):
            full = x.new_zeros((self.n,) + tuple(x.shape[1:]))
            full[self.lo:self.hi].copy_(x)
            all_reduce_(full.view(torch.uint8), self.mesh)
            return full

        return trees.tree_map(leaf, tree)


def row_split(n: int, mesh) -> RowSplit:
    """The rank's contiguous slice of ``n`` rows when ``n`` divides the
    mesh's client-axis rank count, else all of them, unsplit."""
    n = int(n)
    if mesh is None or not client_axes(mesh) or not _divides(n, mesh):
        return RowSplit(n, 0, n, mesh)
    k = n // mesh_client_count(mesh)
    r = mesh_rank(mesh)
    return RowSplit(n, r * k, (r + 1) * k, mesh, True)


def segment_sum(stacked, weights, segment_ids, num_segments: int, split=None):
    """Weighted segment sum over a cohort's leading axis: ``out[s] =
    Σ_{i: seg[i] = s} weights[i]·stacked[i]`` per leaf, in the promoted
    dtype of the product (``weights`` None: unweighted). Under a mesh,
    ``split`` (``row_split``) names the rows ``stacked`` holds, this
    rank's, while ``weights`` and ``segment_ids`` stay full length: each
    leaf's sum over those rows is a partial sum, and one ``all_reduce``
    sums the partials over the ranks when the rows are split. Under a
    mesh the sums run in a fixed order (``ordered_index_add_``). The one
    implementation behind ``psum_segments`` and
    ``bilevel.aggregate_segments``."""
    x0 = trees.leaves(stacked)[0]
    seg = torch.as_tensor(segment_ids, device=x0.device).long()
    w = None if weights is None else torch.as_tensor(weights, device=x0.device)
    if split is not None:
        seg = split.take(seg)
        w = None if w is None else split.take(w)

    def leaf(x):
        contrib = x if w is None else x * w.reshape((-1,) + (1,) * (x.dim() - 1))
        out = torch.zeros((num_segments,) + tuple(x.shape[1:]), dtype=contrib.dtype,
                          device=x.device)
        if split is None:
            return out.index_add_(0, seg, contrib)
        return split.reduce_(ordered_index_add_(out, seg, contrib))

    return trees.tree_map(leaf, stacked)


# -------------------------------------------------------------- placement
def _place_leaf(x, mesh):
    if not isinstance(x, torch.Tensor) or x.dim() == 0:
        return x
    return row_split(x.shape[0], mesh).take(x)


def place_cohort(tree, mesh):
    """This rank's rows of a stacked cohort tree: each leaf's leading
    axis narrowed to the rank's contiguous slice when it divides the
    client-axis rank count, the whole leaf otherwise."""
    if mesh is None:
        return tree
    return trees.tree_map(lambda x: _place_leaf(x, mesh), tree)


def place_replicated(tree, mesh):
    """A tree every rank holds whole, on the rank's device."""
    if mesh is None:
        return tree
    dev = mesh_device(mesh)
    return trees.tree_map(lambda x: x.to(dev), tree)


# an async buffer's flushed row stack (``run_round_async``) and a value
# made inside a round step take the rule of ``place_cohort``: eager torch
# has no trace, so the reference's three rules are one
place_buffer_rows = place_cohort
constrain_cohort = place_cohort


def psum_segments(stacked, weights, segment_ids, num_segments: int, mesh):
    """Weighted segment sum over a cohort's leading axis as a collective:
    ``stacked``, ``weights`` and ``segment_ids`` are full length on every
    rank; each rank sums its slice of the rows into ``num_segments``
    partial sums and one ``all_reduce`` a leaf combines them
    (``segment_sum``, the engine's own). Falls back to the dense sum where
    the reference does: no client axis, one rank, or rows that do not
    divide."""
    if mesh is None:
        return segment_sum(stacked, weights, segment_ids, num_segments)
    split = row_split(int(trees.leaves(stacked)[0].shape[0]), mesh)
    return segment_sum(split.take(stacked), weights, segment_ids, num_segments, split)
