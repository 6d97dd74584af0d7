"""Client-axis meshes of the port: 1-D ``torch.distributed`` device meshes.

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
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


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
