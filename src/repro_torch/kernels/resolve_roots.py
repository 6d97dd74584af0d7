"""The union-find layer of the device merge pass: K4 ``resolve_roots`` and
``component_labels``, both in ``csrc/resolve_roots.cu``.

``resolve_roots`` (it replaces the JAX package's ``kernels/ops.py``
``_halving_kernel``) runs at most ``max(N.bit_length(), 1)`` steps of
``p <- p[p]`` and stops at the first step that changes nothing, which gives
the same array: in one block's shared memory up to N = 32,768, one launch
per step (every step) above that. Every entry of ``parent`` must lie in
[0, N).

``component_labels`` runs the merge pass's min-label propagation with
pointer jumping to its fixed point in one launch, pass for pass the plain
loop ``ref.component_labels_ref`` (the reference runs it as a jnp
``lax.while_loop``); it makes no host sync. Up to 128 blocks pack the
adjacency into a bit matrix and the last to finish runs the passes.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0          # resolve_roots calls that launched the kernel (one or more steps)
label_launches = 0    # component_labels calls that launched its kernel

RESIDENT_MAX = 32768  # largest N the one-block shared-memory path takes
BITS_SHARED_MAX = 1024     # largest k whose bit matrix the passes read from shared memory
LABELS_SHARED_MAX = 16384  # largest k whose two label arrays sit in shared memory
LABELS_MAX = 65536         # largest k the labelling kernel takes (K3 writes k < 65536)


def steps_for(n: int) -> int:
    """Pointer-halving steps for an N-entry array (the reference's count)."""
    return max(int(n).bit_length(), 1)


def _on_card(x: torch.Tensor, name: str, dtype: torch.dtype) -> bool:
    """False for a CPU tensor (the caller runs the plain version); True for
    a contiguous CUDA tensor of ``dtype``; raises on anything else."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"the {name} kernel takes {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous array")
    return True


def resolve_roots(parent: torch.Tensor) -> torch.Tensor:
    """(N,) int32 parent pointers -> (N,) int32 fully resolved roots, in a
    new tensor (``parent`` is not written)."""
    global launches
    if parent.dim() != 1:
        raise ValueError(f"resolve_roots takes a 1-D array, got {tuple(parent.shape)}")
    if not _on_card(parent, "resolve_roots", torch.int32):
        return ref.resolve_roots_ref(parent)
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


def component_labels(adj: torch.Tensor) -> torch.Tensor:
    """(k, k) fp32 0/1 adjacency -> (k,) int32 connected-component labels,
    each node's the smallest id in its component."""
    global label_launches
    if adj.dim() != 2 or adj.shape[0] != adj.shape[1]:
        raise ValueError(f"component_labels takes a square matrix, got {tuple(adj.shape)}")
    if not _on_card(adj, "component_labels", torch.float32):
        return ref.component_labels_ref(adj)
    k = adj.shape[0]
    if k > LABELS_MAX:
        raise ValueError(f"component_labels supports k <= {LABELS_MAX}, got {k}")
    out = torch.empty((k,), dtype=torch.int32, device=adj.device)
    if k == 0:
        return out
    shared_labels = k <= LABELS_SHARED_MAX
    # the bit matrix, then the two label arrays where shared memory is short
    scratch = torch.empty((k * -(-k // 32) + (0 if shared_labels else 2 * k),),
                          dtype=torch.int32, device=adj.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(adj.device).cuda_stream
    counter = _build.arrival_counters(adj.device, stream, 1)
    with torch.cuda.device(adj.device):
        err = lib.component_labels_f32(adj.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                                       counter.data_ptr(), k, int(k <= BITS_SHARED_MAX),
                                       int(shared_labels), stream)
    _build.check(err, "component_labels_f32")
    label_launches += 1
    return out
