"""Mesh placement over a torch ``DeviceMesh``: the client axis of the
federated engine, and the model axis of the LLM parameter rule table.

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
  losses, CFL's split statistics), the rows come back through an
  ``all_reduce`` of a zero-filled full stack, summed as bytes so the
  result is the rows bit for bit (``RowSplit.gather``);
* a stack that lives only on the ranks that own its rows (the client
  arena's rows, ``ClientArena.place``; the async buffer's row banks,
  ``place_buffer_rows``) is read through ``RowOwners``:
  each row on one rank, by a stride, and a gather of any rows is the
  same byte sum (``RowOwners.gather``);
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

The model axis (``ShardCtx``, ``shard``, ``PARAM_RULES``,
``param_shardings``, ``unshard_fsdp``) is the reference's GSPMD rule
table as DTensor placements. A spec is a tuple with one entry per tensor
dimension (a mesh-axis name, a tuple of names, or ``None``), exactly the
reference's ``PartitionSpec`` (a one-name tuple is that name, as
``PartitionSpec`` normalises it); its placements give each mesh
dimension ``Shard(d)`` where the spec names that axis at dimension ``d``
and ``Replicate()`` elsewhere. A dimension its axes do not divide is
replicated, as the reference relaxes it, though DTensor could shard it
unevenly, so every placement is the reference's spec. The models call
``shard`` and ``unshard_fsdp`` at the reference's sites; without an
entered ``ShardCtx`` over a mesh both return their input, so every path
that enters none runs as it did. Where DTensor has no usable rule for a
site the reference leaves to GSPMD, a helper hands each rank its local
operands and wraps the local result back (``local_heads`` for
attention, ``local_channels`` for the selective scan's kernel,
``local_experts`` for the MoE combine, ``embed_rows`` for the vocab
lookup); ``CollectiveLog`` counts the collectives a block issues.

The helpers that read only axis names and sizes (``client_axes``,
``mesh_client_count``, ``align_cohort_chunk``, ``cohort_spec``,
``_divisible``, ``ShardCtx.resolve``, ``spec_for_path``, ``relax``,
``NamedSharding.placements``) take any object with ``mesh_dim_names``
(a ``DeviceMesh``) or ``axis_names`` and a ``shape`` (a tuple in axis
order, or a mapping by axis name).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import re
import threading
from collections.abc import Mapping
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.utils import trees

try:                                    # public since torch 2.4
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
except ImportError:                     # pragma: no cover - older torch
    from torch.distributed._tensor import (DTensor, Partial, Replicate, Shard,
                                           distribute_tensor)

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


# the functional collectives DTensor issues (``torch.distributed._functional_collectives``)
FUNCTIONAL_COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
                          "all_to_all_single")


def model_axis_blocker(mesh) -> Optional[str]:
    """Why DTensor cannot run on ``mesh`` in this process, or None.

    DTensor redistributes through ``_c10d_functional``'s collectives, which
    have no CUDA kernel of their own: they run the group's asynchronous
    collective and wait on it in ``wait_tensor``, and under a non-NCCL
    group on CUDA tensors that wait crashes both ranks (SIGSEGV, gloo,
    torch 2.11). So a CUDA mesh whose group is not ``nccl`` is refused,
    unless the caller has registered CUDA kernels for those collectives
    (``torch.library.Library("_c10d_functional", "IMPL")``) that run the
    group's own blocking ones. A CPU mesh, or anything that is not a
    ``DeviceMesh`` on CUDA, passes, and so does a ``fake`` group (torch's
    fake backend, ``launch.dryrun``'s: its collectives move nothing, so
    nothing can crash)."""
    if getattr(mesh, "device_type", None) != "cuda":
        return None
    backend = str(dist.get_backend(mesh.get_group(0)))
    if backend in ("nccl", "fake"):
        return None
    routed = lambda op: torch._C._dispatch_has_kernel_for_dispatch_key(
        f"_c10d_functional::{op}", "CUDA")
    missing = [op for op in FUNCTIONAL_COLLECTIVES if not routed(op)]
    if not missing:
        return None
    return (f"a {backend!r} group on CUDA tensors cannot carry DTensor's functional "
            f"collectives ({', '.join(missing)} have no CUDA kernel here; their wait "
            "crashes the ranks): use an 'nccl' group, or register CUDA kernels for "
            "them with torch.library.Library('_c10d_functional', 'IMPL') that run the "
            "group's own dist.* collectives")


def check_model_axis(mesh) -> None:
    """Raise ``RuntimeError`` with ``model_axis_blocker``'s reason, if any."""
    reason = model_axis_blocker(mesh)
    if reason is not None:
        raise RuntimeError(reason)


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
            return _sum_bytes_(full, self.mesh)

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


def _sum_bytes_(full: torch.Tensor, mesh) -> torch.Tensor:
    """``all_reduce`` of ``full``'s bytes, in place: where one rank holds
    each byte and every other rank zeros, the sum is that rank's bits."""
    all_reduce_(full.view(torch.uint8), mesh)
    return full


@dataclasses.dataclass(frozen=True)
class RowOwners:
    """Rows of a stack held by their owners: row ``i`` lives on rank ``i %
    size`` only, as its local row ``i // size`` (a stride). ``sharded`` is
    False with one rank or no mesh: the rank then holds every row and no
    collective runs.

    A stride and not contiguous blocks, because a stack whose row count
    doubles (``ClientArena.grow``) keeps every row on its owner at the same
    local row: growth is a local zero-extension on every rank, where
    contiguous blocks would move most rows at each doubling, and
    consecutive new rows (joins) land on the ranks in turn."""
    rank: int = 0
    size: int = 1
    mesh: Any = None

    @property
    def sharded(self) -> bool:
        return self.size > 1

    def held(self, n: int) -> int:
        """The rows of an ``n``-row stack this rank holds."""
        return n // self.size if self.sharded else n

    def owner(self, row: int) -> int:
        return int(row) % self.size

    def mine(self, row: int) -> bool:
        return self.owner(row) == self.rank

    def local(self, row: int) -> int:
        """The local row at which this rank holds ``row`` (its owner's)."""
        return int(row) // self.size

    def take(self, x):
        """This rank's rows of a full-length tensor or tree of tensors."""
        if not self.sharded:
            return x
        return trees.tree_map(lambda t: t[self.rank::self.size], x)

    def gather(self, held, rows: torch.Tensor):
        """Rows ``rows`` (a device int64 vector of global rows) of the stack
        whose rows this rank holds in ``held`` (a tree of ``(n / size,
        ...)`` tensors), as a full ``(len(rows), ...)`` stack on every rank,
        bit for bit: each rank writes the rows it owns into a zero-filled
        stack and one byte sum a leaf combines them (``RowSplit.gather``'s
        pattern). Fixed shapes and no host read, so a CUDA graph captures
        it; every rank must call it with the same ``rows``."""
        if not self.sharded:
            return trees.tree_map(lambda x: torch.index_select(x, 0, rows), held)
        mine = torch.remainder(rows, self.size) == self.rank
        at = torch.div(rows, self.size, rounding_mode="floor")

        def leaf(x):
            got = torch.index_select(x, 0, at)
            got.masked_fill_(~mine.reshape((-1,) + (1,) * (got.dim() - 1)), 0)
            return _sum_bytes_(got, self.mesh)

        return trees.tree_map(leaf, held)

    def scatter(self, held, slots, updates, split: Optional[RowSplit] = None):
        """A copy of ``held`` (this rank's rows of the stack) with cohort
        row ``i`` of ``updates`` written at global row ``slots[i]``, bit
        for bit up to the stack's dtype. ``slots`` are host ints, or, with
        the stack whole, a device tensor, used as it is (no host read).

        ``updates`` holds the cohort rows of ``split`` (this rank's
        contiguous share, ``row_split``; None or unsplit: every row). With
        the stack whole on every rank a split cohort is gathered whole
        first. With the stack on its owners each row is written on its
        owner only: from its own share where the owner trained the row,
        otherwise received through one byte-sum ``all_reduce`` for each
        owner and leaf that carries just the rows that owner does not hold
        (``RowSplit.gather``'s pattern), so no rank holds the whole cohort.
        Every rank makes the same calls in the same order."""
        dev = trees.leaves(held)[0].device
        at = lambda pos: torch.as_tensor(np.asarray(pos, np.int64), device=dev)
        split_rows = split is not None and split.sharded
        if not self.sharded:
            full = split.gather(updates) if split_rows else updates
            idx = (slots.to(device=dev, dtype=torch.int64) if isinstance(slots, torch.Tensor)
                   else at(slots))
            return trees.tree_map(
                lambda r, u: r.clone().index_copy_(0, idx, u.to(r.dtype)), held, full)
        slots = np.asarray(slots, np.int64)
        m, size = len(slots), self.size
        k = m // size if split_rows else m
        lo = split.lo if split_rows else 0
        out = trees.tree_map(lambda r: r.clone(), held)
        for q in range(size):
            mine = np.nonzero(slots % size == q)[0]
            if split_rows:                  # owner q trained rows [q·k, (q+1)·k)
                local = mine[(mine >= q * k) & (mine < (q + 1) * k)]
                moved = mine[(mine < q * k) | (mine >= (q + 1) * k)]
            else:
                local, moved = mine, mine[:0]
            if q == self.rank and local.size:
                dst, src = at(slots[local] // size), at(local - lo)
                trees.tree_map(lambda r, u: r.index_copy_(
                    0, dst, torch.index_select(u, 0, src).to(r.dtype)), out, updates)
            if not moved.size:
                continue
            sent = moved[(moved >= lo) & (moved < lo + k)]
            pos, src = at(np.searchsorted(moved, sent)), at(sent - lo)

            def send(r, u):
                got = u.new_zeros((moved.size,) + tuple(u.shape[1:]))
                if sent.size:
                    got.index_copy_(0, pos, torch.index_select(u, 0, src))
                _sum_bytes_(got, self.mesh)
                if q == self.rank:
                    r.index_copy_(0, at(slots[moved] // size), got.to(r.dtype))

            trees.tree_map(send, out, updates)
        return out

    def send(self, x: Optional[torch.Tensor], src: int, like: torch.Tensor) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank, bit for bit (the other
        ranks pass None; ``like`` gives the shape, dtype and device)."""
        if not self.sharded:
            return x
        full = x.clone() if self.rank == src else torch.zeros_like(like)
        return _sum_bytes_(full.contiguous(), self.mesh)


def row_owners(n: int, mesh) -> RowOwners:
    """The owners of an ``n``-row stack: a stride over the client-axis
    ranks when ``n`` divides them and there are two or more, else every
    row on every rank (the reference's relaxation)."""
    if mesh is None or not client_axes(mesh) or not _divides(int(n), mesh):
        return RowOwners()
    size = mesh_client_count(mesh)
    if size <= 1:
        return RowOwners()
    return RowOwners(mesh_rank(mesh), size, mesh)


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


def place_buffer_rows(tree, mesh):
    """This rank's rows of an async buffer's row bank (``AsyncBuffer.place``)
    on its owners: row ``s`` on rank ``s % N`` only, as its local row ``s //
    N`` (``row_owners`` of the leading axis, the client arena's layout), on
    the rank's device. A power-of-two capacity at least the rank count
    divides a power-of-two count; where the rows do not divide, or there
    is one rank, the bank stays whole (the reference's relaxation)."""
    if mesh is None:
        return tree
    dev = mesh_device(mesh)

    def leaf(x):
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            return x
        return row_owners(x.shape[0], mesh).take(x).to(dev)

    return trees.tree_map(leaf, tree)


# a value made inside a round step takes the rule of ``place_cohort``: eager
# torch has no trace, so the reference's two rules are one
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


# ============================================================ model axis
_ctx = threading.local()


def _spec_entry(axes):
    """One dimension's entry as ``PartitionSpec`` keeps it: ``None``, a
    name, or a tuple of two or more names (a one-name tuple is the name)."""
    if isinstance(axes, tuple):
        return axes[0] if len(axes) == 1 else (axes or None)
    return axes


@contextlib.contextmanager
def _implicit_replication():
    """Plain tensors mixed with DTensors count as replicated within the
    block (DTensor's own ``implicit_replication``, with the previous
    setting restored on the way out, so that blocks may nest)."""
    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


class ShardCtx:
    """Maps logical axis names (``batch``, ``fsdp``, ``tp``, ``expert``) to
    the axes of one mesh; entered with ``with``, it is what ``shard`` and
    ``unshard_fsdp`` read. Entered over a ``DeviceMesh`` it also lets the
    models' plain tensors (positions, masks) mix with DTensors as
    replicated values. The entered contexts are a stack of this thread's;
    a layer recomputed in the backward (``layers.remat``) enters its
    forward's context again on the autograd thread."""

    def __init__(self, mesh, logical_map: Optional[dict] = None):
        self.mesh = mesh
        if logical_map is None and mesh is not None:
            axes = _names(mesh)
            logical_map = {
                "batch": tuple(a for a in ("pod", "data") if a in axes) or None,
                "fsdp": "data" if "data" in axes else None,
                "tp": "model" if "model" in axes else None,
                "expert": "model" if "model" in axes else None,
            }
        self.logical_map = logical_map or {}

    def resolve(self, logical: Sequence) -> tuple:
        """Logical per-dimension names -> the spec (unmapped names and
        ``None`` dimensions replicate)."""
        return tuple(None if ax is None else _spec_entry(self.logical_map.get(ax))
                     for ax in logical)

    def __enter__(self):
        mode = (_implicit_replication() if isinstance(self.mesh, DeviceMesh)
                else contextlib.nullcontext())
        mode.__enter__()
        _ctx.stack = getattr(_ctx, "stack", []) + [(self, mode)]
        return self

    def __exit__(self, *exc):
        (_, mode), _ctx.stack = _ctx.stack[-1], _ctx.stack[:-1]
        mode.__exit__(*exc)
        return False


def current_ctx() -> Optional[ShardCtx]:
    """The innermost entered ``ShardCtx`` of this thread, or None (then
    ``shard`` and ``unshard_fsdp`` return their input)."""
    stack = getattr(_ctx, "stack", [])
    return stack[-1][0] if stack else None


def _axes(entry) -> tuple:
    return () if entry is None else (entry if isinstance(entry, tuple) else (entry,))


def relax(shape, spec, mesh) -> tuple:
    """``spec`` with every dimension its axes do not divide replicated
    (the reference's divisibility rule)."""
    out = []
    for dim, entry in zip(shape, spec):
        n = 1
        for a in _axes(entry):
            n *= _size(mesh, a)
        out.append(entry if entry is not None and int(dim) % n == 0 else None)
    return tuple(out)


def placements(spec, mesh) -> tuple:
    """A spec as one DTensor placement per mesh dimension: ``Shard(d)``
    where the spec names that axis at dimension ``d``, ``Replicate()``
    elsewhere. A dimension split over several axes names them in the
    mesh's order (DTensor splits a dimension over its mesh dimensions in
    that order); another order raises, as does an axis named twice."""
    names = _names(mesh)
    where = {}
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
            raise ValueError(f"spec {spec}: dimension {d} names {axes} out of the "
                             f"mesh's order {names}")
        for a in axes:
            if a in where:
                raise ValueError(f"spec {spec} names mesh axis {a!r} twice")
            where[a] = d
    return tuple(Shard(where[a]) if a in where else Replicate() for a in names)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor's relaxed ``spec`` on ``mesh`` and its DTensor
    ``placements``: the counterpart of ``jax.sharding.NamedSharding``."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


# ---------------------------------------------------------------------------
# Parameter sharding rules: (path regex, logical spec per dim), the
# reference's table verbatim. Paths are "/"-joined sorted keys
# ("layers/attn/wq"); stacked-layer leaves have a leading L axis, so a
# rule binds to the TRAILING dims and the leading ones replicate.
# ---------------------------------------------------------------------------
PARAM_RULES = [
    # embeddings (vocab, d) / head (d, vocab): vocab on tp, d replicated
    (r".*(embed)$", ("tp", None)),
    (r".*(lm_head|output_proj)$", (None, "tp")),
    # attention projections (d_model, heads*hd): rows fsdp, cols tp
    (r".*(wq|wk|wv|wkv_a|wkv_b|wq_a|wq_b|w_cross_k|w_cross_v)$", ("fsdp", "tp")),
    (r".*(wo)$", ("tp", "fsdp")),
    # MoE experts: (E, d, ff) -> experts on tp (expert parallel), rows fsdp
    # (must precede the generic mlp rules: same leaf names, extra E dim)
    (r".*experts/(w_gate|w_up)$", ("expert", "fsdp", None)),
    (r".*experts/(w_down)$", ("expert", None, "fsdp")),
    (r".*router/w$", ("fsdp", None)),
    # mlp
    (r".*(w_gate|w_up)$", ("fsdp", "tp")),
    (r".*(w_down)$", ("tp", "fsdp")),
    # mamba
    (r".*(in_proj)$", ("fsdp", "tp")),
    (r".*(x_proj)$", ("tp", None)),
    (r".*(dt_proj)$", (None, "tp")),
    (r".*(out_proj)$", ("tp", "fsdp")),
    (r".*(a_log2|conv_w)$", ("tp", None)),
    (r".*(a_log|d_skip|conv_b|dt_bias)$", ("tp",)),
    # biases / norms / small vectors: replicate
    (r".*(scale|bias|b_q|b_k|b_v)$", ()),
]


def spec_for_path(path: str, ndim: int, ctx: ShardCtx) -> tuple:
    """A parameter path's spec: the first matching rule wins and binds to
    the TRAILING dims (a stacked leaf's leading axes replicate); no match
    replicates everything."""
    for pat, logical in PARAM_RULES:
        if re.match(pat, path):
            spec = ctx.resolve(logical)
            pads = ndim - len(logical)
            if pads < 0:        # rule longer than rank (e.g. stacked scalar)
                return tuple(spec[-ndim:]) if ndim else ()
            return (None,) * pads + tuple(spec)
    return (None,) * ndim


def _map_paths(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a nested dict, paths ``/``-joined as
    ``extractor.leaf_paths`` joins them."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    return fn(prefix[:-1], tree)


def param_shardings(params, mesh, ctx: Optional[ShardCtx] = None):
    """A ``NamedSharding`` per leaf of a parameter tree (tensors, or
    anything with a ``shape``): its rule's spec, relaxed. Raises on a mesh
    DTensor cannot run on (``model_axis_blocker``)."""
    check_model_axis(mesh)
    ctx = ctx or ShardCtx(mesh)
    return _map_paths(lambda path, x: NamedSharding(
        mesh, relax(x.shape, spec_for_path(path, len(x.shape), ctx), mesh)), params)


def replicated(mesh) -> NamedSharding:
    """Fully replicated over ``mesh``."""
    return NamedSharding(mesh, ())


def _distribute(x: torch.Tensor, mesh, placements):
    """``x`` (the same full tensor on every rank) as a DTensor of
    ``placements`` on ``mesh``: each rank keeps its own shard, with no
    collective."""
    try:
        return distribute_tensor(x, mesh, placements, src_data_rank=None)
    except TypeError:                   # pragma: no cover - torch < 2.5
        return distribute_tensor(x, mesh, placements)


def place_params(tree, shardings):
    """Every leaf of ``tree`` as a DTensor of its ``NamedSharding`` (the
    counterpart of ``jax.device_put(params, shardings)``). Every rank
    passes the same full tree, as every rank makes it from one seed."""
    return trees.tree_map(lambda x, s: _distribute(x, s.mesh, s.placements), tree, shardings)


def _redistribute(x, mesh, spec):
    want = placements(spec, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def shard(x, *logical):
    """An activation put in its logical layout when a ``ShardCtx`` over a
    mesh is entered: a DTensor is redistributed to the resolved spec,
    relaxed where its axes do not divide. Without one, or for a plain
    tensor, ``x`` itself."""
    ctx = current_ctx()
    if ctx is None or ctx.mesh is None or not isinstance(x, DTensor):
        return x
    return _redistribute(x, ctx.mesh, relax(x.shape, ctx.resolve(logical), ctx.mesh))


def split_heads(x, n: int, hd: int):
    """(B, S, n·hd) -> (B, S, n, hd). Under an entered ``ShardCtx`` a
    DTensor is first put where the reference's head layout
    (``shard(·, "batch", None, "tp", None)``) puts it: its columns on the
    ``tp`` axis only when that axis divides ``n``, else replicated, as
    DTensor cannot split a dimension sharded across a head boundary."""
    B, S = x.shape[0], x.shape[1]
    ctx = current_ctx()
    if ctx is not None and ctx.mesh is not None and isinstance(x, DTensor):
        spec = relax((B, S, n, hd), ctx.resolve(("batch", None, "tp", None)), ctx.mesh)
        x = _redistribute(x, ctx.mesh, spec[:3])
    return x.reshape(B, S, n, hd)


def merge_heads(x):
    """(B, S, n, hd) -> (B, S, n·hd), the inverse of ``split_heads``.
    Under an entered ``ShardCtx`` the result is put in the same layout
    (columns on ``tp`` only when it divides ``n``), and so is the
    gradient that comes back through it (``DTensor.from_local``'s
    backward redistributes it), which the reshape's backward must split
    into heads. The result is rewrapped with a contiguous global stride:
    DTensor's view rule gives size-1 dimensions other strides, and
    ``matmul`` then takes a batched product in place of the one
    ``mm`` a plain tensor folds into, which rounds differently."""
    B, S, n, hd = x.shape
    out = x.reshape(B, S, n * hd)
    ctx = current_ctx()
    if ctx is not None and ctx.mesh is not None and isinstance(out, DTensor):
        spec = relax((B, S, n, hd), ctx.resolve(("batch", None, "tp", None)), ctx.mesh)
        out = _redistribute(out, ctx.mesh, spec[:3])
        out = DTensor.from_local(out.to_local(), ctx.mesh, out.placements, run_check=False,
                                 shape=out.shape, stride=(S * n * hd, n * hd, 1))
    return out


def local_heads(q, *kv, rows=()):
    """Attention's operands as this rank's local tensors, all in ``q``'s
    layout, and the function that wraps a local result (one row and head
    of it per row and head of ``q``) back into a DTensor of that layout.
    Attention is independent per batch row and head, so each rank attends
    its own rows and heads on local tensors: what GSPMD partitions the
    reference's einsums into. (DTensor's einsum decomposes into a batched
    product that flattens the batch and head dimensions together, which
    some torch versions refuse when the head dimension is sharded.) ``q``
    is (B, S, H, d), sharded on at most its batch and head dimensions;
    each of ``kv`` is (B, S', H, d') and is redistributed to that layout.
    ``rows`` are plain tensors with one leading entry per batch row (a
    decode's per-row masks), narrowed to this rank's rows. Without an
    entered ``ShardCtx`` or for plain tensors, the operands and the
    identity."""
    ctx = current_ctx()
    if ctx is None or ctx.mesh is None or not isinstance(q, DTensor):
        return (q, *kv, *rows), lambda out: out
    mesh, pl = q.device_mesh, tuple(q.placements)
    if any(isinstance(p, Shard) and p.dim not in (0, 2) for p in pl):
        raise ValueError(f"attention's query must be sharded on batch and heads only, got {pl}")
    place = lambda x, want: (x if tuple(x.placements) == tuple(want)
                             else x.redistribute(mesh, want)).to_local()
    by_row = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in pl)
    local = [q.to_local()] + [place(x, pl) for x in kv] + [
        place(r, by_row) if isinstance(r, DTensor)
        else _distribute(r, mesh, by_row).to_local() for r in rows]
    return local, lambda out: DTensor.from_local(out, mesh, pl, run_check=False)


def to_local(x):
    """A DTensor's local shard; anything else as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def wrap_like(local, like):
    """``local`` as a DTensor with ``like``'s mesh, placements, shape and
    stride (a local result of a rank's own shards of ``like``'s layout);
    ``local`` itself when ``like`` is no DTensor."""
    if not isinstance(like, DTensor):
        return local
    return DTensor.from_local(local, like.device_mesh, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())


def local_channels(dA, dBx, C):
    """The selective scan's operands as this rank's local tensors, and the
    function that wraps its local output back into a DTensor. The scan is
    independent per channel and batch row, so each rank scans its own
    rows and channels exactly: ``dA`` and ``dBx`` (B, S, D, N) are put
    with their rows on the client axes and the channels D on ``tp``
    (``shard(·, "batch", None, "tp", None)``; a partial sum is reduced on
    the way), ``C`` (B, S, N) with its rows split alone. Each rank's
    gradient of ``C`` sums its own channels only, so it comes back as a
    partial sum over the mesh dimensions that split D. The output (B, S,
    D) takes ``dBx``'s new placements. Without an entered ``ShardCtx`` or
    for plain tensors, the operands and the identity."""
    ctx = current_ctx()
    if ctx is None or ctx.mesh is None or not isinstance(dBx, DTensor):
        return (dA, dBx, C), lambda out: out
    mesh = ctx.mesh
    spec = relax(dBx.shape, ctx.resolve(("batch", None, "tp", None)), mesh)
    dA, dBx = _redistribute(dA, mesh, spec), _redistribute(dBx, mesh, spec)
    C = _redistribute(C, mesh, spec[:2] + (None,))
    pl = tuple(dBx.placements)
    grad_c = tuple(Partial() if isinstance(p, Shard) and p.dim == 2 else q
                   for p, q in zip(pl, C.placements))
    local = (dA.to_local(), dBx.to_local(), C.to_local(grad_placements=grad_c))
    return local, lambda out: DTensor.from_local(out, mesh, pl, run_check=False)


def local_experts(combine, expert_out):
    """The MoE combine's operands as this rank's local tensors, and the
    function that wraps its local output back into a DTensor. The combine
    ``out[g, s] = Σ_{e, c} combine[g, s, e, c]·expert_out[e, g, c]`` sums
    over the experts, which ``expert_out`` (E, G, c, d) splits over the
    ``expert`` axis: each rank contracts its own experts with their slice
    of ``combine`` (G, g, E, c), which is put whole over those mesh
    dimensions and keeps its row split elsewhere, and the result (G, g,
    d) is a partial sum over the mesh dimensions that split the experts
    (what GSPMD makes of the reference's einsum; DTensor's own einsum
    flattens the sharded expert dimension into its neighbour, which some
    torch versions refuse). Without an entered ``ShardCtx`` or for plain
    tensors, the operands and the identity."""
    ctx = current_ctx()
    if ctx is None or ctx.mesh is None or not isinstance(expert_out, DTensor):
        return (combine, expert_out), lambda out: out
    mesh = ctx.mesh
    spec = relax(expert_out.shape, ctx.resolve(("expert", None, None, None)), mesh)
    expert_out = _redistribute(expert_out, mesh, spec)
    split = [isinstance(p, Shard) for p in expert_out.placements]
    cpl = combine.placements if isinstance(combine, DTensor) else (Replicate(),) * mesh.ndim
    want = tuple(Replicate() if e or not (isinstance(p, Shard) and p.dim == 1) else p
                 for e, p in zip(split, cpl))
    # a rank reads only its experts' slice of combine, so the gradient it
    # returns for combine is a partial sum over the mesh dimensions that
    # split the experts; the one it returns for expert_out sums its own
    # rows only, a partial sum over the mesh dimensions that split the rows
    out_pl = tuple(Partial() if e else p for e, p in zip(split, want))
    local = (combine if isinstance(combine, DTensor) else
             _distribute(combine, mesh, (Replicate(),) * mesh.ndim)).redistribute(
        mesh, want).to_local(grad_placements=out_pl)
    lo, n = 0, expert_out.shape[0]
    for i, e in enumerate(split):
        if e:
            n //= mesh.size(i)
            lo += mesh.get_local_rank(i) * n
    rows = tuple(Partial() if isinstance(p, Shard) and not e else q
                 for e, p, q in zip(split, want, expert_out.placements))
    return ((local[:, :, lo:lo + n], expert_out.to_local(grad_placements=rows)),
            lambda out: DTensor.from_local(out, mesh, out_pl, run_check=False))


def embed_rows(tokens, table):
    """``table[tokens]``. Under an entered ``ShardCtx`` a table whose
    vocab rows are split over one mesh dimension is looked up shard by
    shard, as GSPMD partitions the reference's gather: each rank indexes
    the rows it holds (the others zero), and one sum over that dimension
    completes them; on a mesh of one rank that is the index without a
    mesh, gradient included. (DTensor's own rule gives a masked partial
    sum whose gradient some torch versions cannot take.) The result is
    split as ``tokens`` are and replicated otherwise."""
    ctx = current_ctx()
    if ctx is None or ctx.mesh is None or not isinstance(table, DTensor):
        return table[tokens]
    mesh, tpl = table.device_mesh, tuple(table.placements)
    vocab = [i for i, p in enumerate(tpl) if isinstance(p, Shard)]
    if len(vocab) != 1 or tpl[vocab[0]].dim != 0:
        return torch.nn.functional.embedding(tokens, table)
    (dim,) = vocab
    rows = table.shape[0] // mesh.size(dim)
    lo = mesh.get_local_rank(dim) * rows
    if isinstance(tokens, DTensor):
        kpl, tokens = tuple(tokens.placements), tokens.to_local()
    else:
        kpl = (Replicate(),) * mesh.ndim
    held = (tokens >= lo) & (tokens < lo + rows)
    # a rank's gradient of its rows sums its own tokens' only: partial over
    # the dimensions that split the tokens
    grad = [Partial() if i != dim and isinstance(k, Shard) else t
            for i, (k, t) in enumerate(zip(kpl, tpl))]
    local = table.to_local(grad_placements=grad)[torch.where(held, tokens - lo, 0)]
    local = local * held[..., None].to(local.dtype)
    placed = [Partial() if i == dim else p for i, p in enumerate(kpl)]
    out = DTensor.from_local(local, mesh, placed, run_check=False)
    return out.redistribute(mesh, [Replicate() if i == dim else p for i, p in enumerate(kpl)])


def unshard_fsdp(tree):
    """A layer's weights in their compute layout: each DTensor leaf
    redistributed to its rule's spec with ``fsdp`` replicated and ``tp``
    kept (ZeRO-3's per-layer gather; its gradient comes back reduced and
    scattered to the stored layout). Without an entered ``ShardCtx`` over
    a mesh, ``tree`` itself."""
    ctx = current_ctx()
    if ctx is None or ctx.mesh is None:
        return tree
    mesh = ctx.mesh
    ctx2 = ShardCtx(mesh, {**ctx.logical_map, "fsdp": None})

    def one(path, x):
        if not isinstance(x, DTensor):
            return x
        return _redistribute(x, mesh, relax(x.shape, spec_for_path(path, x.dim(), ctx2), mesh))

    return _map_paths(one, tree)


class CollectiveLog(TorchDispatchMode):
    """Within the block, ``calls`` receives (op, elements, bytes) of every
    collective dispatched on this thread: ``c10d`` ops (``dist.all_reduce``
    and its kin), ``_c10d_functional`` ops and ``_dtensor.shard_dim_alltoall``
    (DTensor's redistributions), counted by their first tensor, the one
    they send."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__
        if ((func.namespace in ("c10d", "_c10d_functional") and "wait" not in name)
                or (func.namespace == "_dtensor" and "alltoall" in name)):
            first = args[0][0] if isinstance(args[0], (list, tuple)) else args[0]
            self.calls.append((f"{func.namespace}.{name.split('.')[0]}",
                               int(first.numel()), int(first.numel() * first.element_size())))
        return func(*args, **(kwargs or {}))


def place_decode_state(tree, mesh):
    """The serving engine's cluster-group rows on this rank: the leading
    (cluster-group) axis of every leaf narrowed to the rank's
    ``row_split``, whole where the group count does not divide the ranks
    (``serve.ServeEngine(mesh=...)``; ``place_cohort``'s rule)."""
    return place_cohort(tree, mesh)
