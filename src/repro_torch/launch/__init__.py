"""The port's command-line entry points (``python -m
repro_torch.launch.train`` and ``python -m repro_torch.launch.serve``)."""
from __future__ import annotations

import torch

from repro_torch import engine


def device_of(name: str) -> torch.device:
    """``--device``: ``cuda`` raises when no GPU is present (never a quiet
    fall back to the CPU)."""
    return engine.resolve_device(None if name == "cuda" else name)
