"""Union-find root resolution by pointer halving (kernel K4).

The CUDA kernel is ``csrc/resolve_roots.cu`` (it replaces the JAX package's
``kernels/ops.py`` ``_halving_kernel``): ``max(N.bit_length(), 1)`` steps
of ``p <- p[p]``, in one block's shared memory up to N = 32,768 and one
launch per step above that. On a CUDA tensor the wrapper launches it or
raises; on a CPU tensor it runs the plain version ``ref.resolve_roots_ref``.
Every entry of ``parent`` must lie in [0, N).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0          # wrapper calls that launched the kernel (one or more steps)

RESIDENT_MAX = 32768  # largest N the one-block shared-memory path takes


def steps_for(n: int) -> int:
    """Pointer-halving steps for an N-entry array (the reference's count)."""
    return max(int(n).bit_length(), 1)


def resolve_roots(parent: torch.Tensor) -> torch.Tensor:
    """(N,) int32 parent pointers -> (N,) int32 fully resolved roots, in a
    new tensor (``parent`` is not written)."""
    global launches
    if parent.dim() != 1:
        raise ValueError(f"resolve_roots takes a 1-D array, got {tuple(parent.shape)}")
    if parent.device.type == "cpu":
        return ref.resolve_roots_ref(parent)
    if parent.device.type != "cuda":
        raise ValueError(f"no kernel for device {parent.device}")
    if parent.dtype != torch.int32:
        raise TypeError(f"the resolve_roots kernel takes int32, got {parent.dtype}")
    if not parent.is_contiguous():
        raise ValueError("resolve_roots needs a contiguous array")
    n = parent.numel()
    out = torch.empty_like(parent)
    if n == 0:
        return out
    scratch = torch.empty_like(parent) if n > RESIDENT_MAX else None
    lib = _build.load()
    stream = torch.cuda.current_stream(parent.device).cuda_stream
    with torch.cuda.device(parent.device):
        err = lib.resolve_roots_i32(parent.data_ptr(), out.data_ptr(),
                                    None if scratch is None else scratch.data_ptr(),
                                    n, steps_for(n), stream)
    _build.check(err, "resolve_roots_i32")
    launches += 1
    return out
