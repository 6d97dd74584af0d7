"""The port's command-line entry points (``python -m
repro_torch.launch.train`` and ``python -m repro_torch.launch.serve``),
its meshes (``launch.mesh``: ``make_client_mesh``, ``make_host_mesh``)
and the mesh-aware LLM step builders (``launch.steps``)."""
from __future__ import annotations

import torch

from repro_torch import engine


def device_of(name: str) -> torch.device:
    """``--device``: ``cuda`` raises when no GPU is present (never a quiet
    fall back to the CPU)."""
    return engine.resolve_device(None if name == "cuda" else name)


from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_client_mesh, make_cohort_mesh, make_host_mesh  # noqa: E402,F401
