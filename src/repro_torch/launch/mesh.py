"""The port's meshes: ``torch.distributed`` device meshes over the ranks.

The JAX package builds its meshes over the local devices of one process.
The port runs one process per rank (``torchrun --nproc_per_node N``, or
processes the caller starts) and builds a ``DeviceMesh`` over the ranks of
the default process group:

    mesh = make_client_mesh()               # every rank, axis ("clients",)
    state = engine.init("stocfl", loss, params, clients, cfg, mesh=mesh)

When no default group exists, the first call makes one: from the
environment under ``torchrun`` (``RANK`` / ``WORLD_SIZE`` /
``MASTER_ADDR``), otherwise a world of one over an in-process store. It
takes ``nccl`` on a CUDA mesh and ``gloo`` on a CPU mesh; a group the
caller initialised keeps its backend (``gloo`` for two ranks on one card,
where NCCL refuses a GPU shared by two ranks). Rank r computes on
``cuda:(local_rank % device_count)``, or on the CPU when ``device="cpu"``
is asked for; a CUDA mesh without a GPU raises.

``make_host_mesh`` builds the 2-D ``("data", "model")`` mesh the LLM
parameter rule table places over (``sharding.param_shardings``,
``launch.steps``).

``make_production_mesh`` is the reference's TPU v5e pod layout mapped to
H100 nodes of 8 GPUs, with the model axis inside a node's NVLink domain:
single ``("data", "model")`` = (32, 8), 256 GPUs; multi ``("pod", "data",
"model")`` = (2, 32, 8), 512. No such cluster exists here: the mesh is
built over a fake process group (``fake_mesh``: torch's ``fake`` backend,
whose collectives return at once and move nothing), for the dry run
(``launch.dryrun``), which traces a step on fake tensors over it.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.sharding.specs import check_model_axis


def _device_type(device) -> str:
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' for a "
                           "mesh of CPU ranks")
    return kind


def _ensure_group(kind: str) -> None:
    """Initialise the default process group if nobody has."""
    if dist.is_initialized():
        return
    under_torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if kind == "cuda":
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
        torch.cuda.set_device(local % torch.cuda.device_count())
    backend = "nccl" if kind == "cuda" else "gloo"
    if under_torchrun:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def _mesh(axis: str, n: int, device) -> DeviceMesh:
    kind = _device_type(device)
    _ensure_group(kind)
    world = dist.get_world_size()
    n = world if n <= 0 else min(int(n), world)
    return DeviceMesh(kind, list(range(n)), mesh_dim_names=(axis,))


def make_client_mesh(n: int = 0, device=None) -> DeviceMesh:
    """1-D ``("clients",)`` mesh for the engine (``engine.init(...,
    mesh=...)``): cohort rows split over its ranks, cross-client
    reductions all-reduced across them. ``n=0`` takes every rank of the
    default group, otherwise its first ``n``. ``device``: ``None`` or
    ``"cuda"`` for a CUDA mesh, ``"cpu"`` for CPU ranks."""
    return _mesh("clients", n, device)


def make_cohort_mesh(n: int = 0, device=None) -> DeviceMesh:
    """1-D ``("data",)`` mesh for the cohort step: the same placement as
    ``make_client_mesh`` under the reference's other client-axis name."""
    return _mesh("data", n, device)


def make_host_mesh(model_parallel: int = 1, device=None) -> DeviceMesh:
    """2-D ``("data", "model")`` mesh over the default group's ranks:
    ``mp = min(model_parallel, world)`` ranks on the model axis and
    ``world // mp`` on the data axis, ranks in row-major order. ``device``
    as ``make_client_mesh``. Raises where DTensor's collectives cannot
    run (``sharding.model_axis_blocker``: a non-NCCL group on the card,
    its collectives not routed by the caller)."""
    kind = _device_type(device)
    _ensure_group(kind)
    world = dist.get_world_size()
    mp = max(1, min(int(model_parallel), world))
    dp = world // mp
    ranks = torch.arange(dp * mp).reshape(dp, mp)
    mesh = DeviceMesh(kind, ranks, mesh_dim_names=("data", "model"))
    check_model_axis(mesh)
    return mesh


# the reference's production meshes (launch/mesh.py) on H100 nodes of 8 GPUs
PRODUCTION = {False: ((32, 8), ("data", "model")),
              True: ((2, 32, 8), ("pod", "data", "model"))}
FAKE_WORLD = 512        # the largest production mesh: one fake world serves both


def fake_world(n: int = FAKE_WORLD) -> None:
    """Make the default process group a fake one of ``n`` ranks, this
    process rank 0 (``torch.testing._internal.distributed.fake_pg``: its
    collectives complete at once and move nothing). A fake group of at
    least ``n`` ranks already in place is kept; any other group raises."""
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() < n:
            raise RuntimeError(f"a fake mesh of {n} ranks needs a fake default group of at "
                               f"least {n} ranks, found {dist.get_backend()!r} of "
                               f"{dist.get_world_size()}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def fake_mesh(shape, axes, device=None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over the first
    ranks of a fake world (``fake_world``), seen from rank 0. Build it
    before entering a ``FakeTensorMode``: its groups are made from real
    tensors. ``device`` as ``make_client_mesh``."""
    kind = _device_type(device)
    n = 1
    for d in shape:
        n *= int(d)
    fake_world(max(n, FAKE_WORLD))
    return DeviceMesh(kind, torch.arange(n).reshape(tuple(shape)), mesh_dim_names=tuple(axes))


def make_production_mesh(multi_pod: bool = False, device=None) -> DeviceMesh:
    """The production mesh on H100 nodes: (32, 8) ``("data", "model")``, or
    with ``multi_pod`` (2, 32, 8) ``("pod", "data", "model")``, over a fake
    process group (``fake_mesh``). ``device``: ``None`` or ``"cuda"`` for a
    CUDA mesh (its fake tensors are CUDA tensors), ``"cpu"`` for CPU."""
    shape, axes = PRODUCTION[bool(multi_pod)]
    return fake_mesh(shape, axes, device)
