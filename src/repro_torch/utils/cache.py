"""Persistent cache of what the port builds at run time.

The JAX package points XLA's compilation cache at a directory. The port
compiles nothing through a JIT: its one build product that outlives a
process is the CUDA kernel library (``kernels/_build.py``), named by a
hash of its sources and flags. One call points the build directory at a
directory on disk, so a fresh process finds the library there and
loads it in milliseconds instead of running ``nvcc`` again; ranks that
build at once each write through a temporary file and ``os.replace``.

Used by ``launch.train`` (``--compile-cache``).
"""
from __future__ import annotations

import os
from pathlib import Path

from repro_torch.kernels import _build

_ENV_DIR = "REPRO_TORCH_COMPILATION_CACHE_DIR"


def default_cache_dir() -> str:
    return os.environ.get(_ENV_DIR) or os.path.join(
        os.path.expanduser("~"), ".cache", "repro-torch-cache")


def enable_compilation_cache(path: str | None = None) -> str:
    """Point the kernel library's build directory at ``path`` (default:
    ``$REPRO_TORCH_COMPILATION_CACHE_DIR`` or ``~/.cache/repro-torch-cache``),
    creating it. A later ``_build.build()`` loads the library from there
    or writes it there. Returns the directory used. Safe to call more
    than once; a library this process has already loaded stays loaded."""
    path = path or default_cache_dir()
    os.makedirs(path, exist_ok=True)
    _build.BUILD_DIR = Path(path)
    return path
