"""Selective scan (kernel K5), forward and backward, as one autograd op.

The CUDA kernels are in ``csrc/ssm_scan.cu``; they replace the JAX
package's ``kernels/ssm_scan.py`` ``_scan_kernel``, which has no gradient.
Here both directions are kernels: ``scan_fwd`` computes y and the state
entering every ``CHUNK`` steps, ``scan_bwd`` recomputes each chunk's states
from those and runs the reverse recurrence. ``SSMScan`` binds them as a
``torch.autograd.Function`` whose ``vmap`` rule folds a vmapped axis into
B, so the engine's ``torch.func.vmap`` over a cohort reaches one launch.
Its backward calls ``scan_bwd`` through ``_ScanBwd``, a function with a
``vmap`` rule of its own: under a layer checkpoint (``models.layers.remat``)
the backward runs inside ``torch.func.vjp``, and inside a cohort's vmap
too, where its operands arrive wrapped by those transforms, without the
storage a kernel's pointer needs; ``_ScanBwd`` hands the kernel the
unwrapped tensors, the batch folded into B.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor
it runs the plain version in ``ref`` (``ssm_scan_states_ref``,
``ssm_scan_bwd_ref``), with the same contract. Under
``analysis.sanitize.nan_guard`` a launch's outputs are checked (a ctypes
launch passes no dispatcher). Each direction is one dispatcher op
(``repro_torch::ssm_scan_fwd`` / ``ssm_scan_bwd``) with a shape-only path,
so a trace over fake tensors (``launch.dryrun``) sees each as one op with
its own operands and results.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.utils import events

fwd_launches = 0      # forward kernel launches so far (reset by callers that count)
bwd_launches = 0      # backward kernel launches so far

CHUNK = 16            # steps per saved state; fixed by the CUDA source
N_STATE = 16          # state width N the CUDA kernels take
THREADS = 256         # threads per block; 256 // N_STATE channels a block


def _check(dA, dBx, C):
    if dA.dim() != 4 or dBx.shape != dA.shape:
        raise ValueError("ssm_scan takes dA and dBx of one (B, S, D, N) shape, got "
                         f"{tuple(dA.shape)} and {tuple(dBx.shape)}")
    B, S, _D, N = dA.shape
    if tuple(C.shape) != (B, S, N):
        raise ValueError(f"C must be (B, S, N) = {(B, S, N)}, got {tuple(C.shape)}")
    if len({dA.device, dBx.device, C.device}) != 1:
        raise ValueError("operands lie on different devices")


def _on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for any other."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return True


def _f32(x: torch.Tensor, name: str) -> torch.Tensor:
    if x.dtype != torch.float32:
        raise TypeError(f"the ssm_scan kernels take float32, got {name} in {x.dtype}")
    return x.contiguous()


def _shape_ok(B: int, N: int) -> None:
    if N != N_STATE:
        raise ValueError(f"the ssm_scan kernels take N = {N_STATE}, got {N}")
    if B > 65535:
        raise ValueError(f"the ssm_scan kernels take B <= 65535, got {B}")


def scan_fwd(dA, dBx, C):
    """(dA, dBx (B, S, D, N), C (B, S, N)) -> (y (B, S, D), hs (B, ⌈S/CHUNK⌉,
    D, N)), fp32: the scan's output and the state entering each chunk.
    One dispatcher op, ``repro_torch::ssm_scan_fwd``, with a shape-only
    path for fake tensors (``launch.dryrun``)."""
    _check(dA, dBx, C)
    return tuple(_scan_fwd_op(dA, dBx, C))


@torch.library.custom_op("repro_torch::ssm_scan_fwd", mutates_args=())
def _scan_fwd_op(dA: torch.Tensor, dBx: torch.Tensor,
                 C: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    global fwd_launches
    if not _on_card(dA):
        return ref.ssm_scan_states_ref(dA, dBx, C, CHUNK)
    dA, dBx, C = _f32(dA, "dA"), _f32(dBx, "dBx"), _f32(C, "C")
    B, S, D, N = dA.shape
    _shape_ok(B, N)
    y = torch.empty((B, S, D), dtype=torch.float32, device=dA.device)
    hs = torch.empty((B, -(-S // CHUNK), D, N), dtype=torch.float32, device=dA.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(dA.device).cuda_stream
    with torch.cuda.device(dA.device):
        err = lib.ssm_scan_fwd_f32(dA.data_ptr(), dBx.data_ptr(), C.data_ptr(),
                                   y.data_ptr(), hs.data_ptr(), B, S, D, N, CHUNK,
                                   stream)
    _build.check(err, "ssm_scan_fwd_f32")
    fwd_launches += 1
    events.check_nan("ssm_scan_fwd", y, hs)
    return y, hs


@_scan_fwd_op.register_fake
def _scan_fwd_shape(dA, dBx, C):
    """The forward's outputs on fake tensors: y and the chunk states, fp32."""
    B, S, D, N = dA.shape
    return (dA.new_empty((B, S, D), dtype=torch.float32),
            dA.new_empty((B, -(-S // CHUNK), D, N), dtype=torch.float32))


def scan_bwd(dA, dBx, C, hs, g_y):
    """Gradients ``(g_dA, g_dBx, g_C)`` of the scan at (dA, dBx, C), given
    the forward's saved states ``hs`` and the output's gradient ``g_y``.
    One dispatcher op, ``repro_torch::ssm_scan_bwd``, with a shape-only
    path for fake tensors."""
    _check(dA, dBx, C)
    return tuple(_scan_bwd_op(dA, dBx, C, hs, g_y))


@torch.library.custom_op("repro_torch::ssm_scan_bwd", mutates_args=())
def _scan_bwd_op(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor, hs: torch.Tensor,
                 g_y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    global bwd_launches
    if not _on_card(dA):
        return ref.ssm_scan_bwd_ref(dA, dBx, C, hs, g_y, CHUNK)
    dA, dBx, C = _f32(dA, "dA"), _f32(dBx, "dBx"), _f32(C, "C")
    hs, g_y = _f32(hs, "hs"), _f32(g_y, "g_y")
    B, S, D, N = dA.shape
    _shape_ok(B, N)
    if tuple(hs.shape) != (B, -(-S // CHUNK), D, N) or tuple(g_y.shape) != (B, S, D):
        raise ValueError(f"hs {tuple(hs.shape)} or g_y {tuple(g_y.shape)} does not "
                         f"match dA {tuple(dA.shape)}")
    g_dA, g_dBx = torch.empty_like(dA), torch.empty_like(dA)
    g_C = torch.empty((B, S, N), dtype=torch.float32, device=dA.device)
    part = torch.empty((B, S, -(-D // (THREADS // N)), N), dtype=torch.float32,
                       device=dA.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(dA.device).cuda_stream
    with torch.cuda.device(dA.device):
        err = lib.ssm_scan_bwd_f32(dA.data_ptr(), dBx.data_ptr(), C.data_ptr(),
                                   hs.data_ptr(), g_y.data_ptr(), g_dA.data_ptr(),
                                   g_dBx.data_ptr(), part.data_ptr(), g_C.data_ptr(),
                                   B, S, D, N, CHUNK, stream)
    _build.check(err, "ssm_scan_bwd_f32")
    bwd_launches += 1
    events.check_nan("ssm_scan_bwd", g_dA, g_dBx, g_C)
    return g_dA, g_dBx, g_C


@_scan_bwd_op.register_fake
def _scan_bwd_shape(dA, dBx, C, hs, g_y):
    """The backward's gradients on fake tensors, fp32, in their operands'
    shapes."""
    f32 = lambda x: x.new_empty(x.shape, dtype=torch.float32)
    return f32(dA), f32(dBx), f32(C)


class SSMScan(torch.autograd.Function):
    """y = scan(dA, dBx, C) with the kernels both ways. ``apply`` returns
    ``(y, hs)``; ``hs`` is the forward's saved states and carries no
    gradient."""

    @staticmethod
    def forward(dA, dBx, C):
        return scan_fwd(dA, dBx, C)

    @staticmethod
    def setup_context(ctx, inputs, output):
        dA, dBx, C = inputs
        _y, hs = output
        ctx.mark_non_differentiable(hs)
        ctx.save_for_backward(dA, dBx, C, hs)

    @staticmethod
    def backward(ctx, g_y, _g_hs):
        dA, dBx, C, hs = ctx.saved_tensors
        return _ScanBwd.apply(dA, dBx, C, hs, g_y)

    @staticmethod
    def vmap(info, in_dims, dA, dBx, C):
        """Fold the vmapped axis into B: one launch for the whole batch."""
        v = info.batch_size
        y, hs = SSMScan.apply(*(_fold(x, d, v) for x, d in zip((dA, dBx, C), in_dims)))
        return ((y.reshape(v, -1, *y.shape[1:]), hs.reshape(v, -1, *hs.shape[1:])),
                (0, 0))


def _fold(x, dim, v):
    """``x`` with its vmapped axis ``dim`` (None: broadcast to ``v``)
    moved to the front and merged into the next one."""
    x = x.movedim(dim, 0) if dim is not None else x.expand(v, *x.shape)
    return x.reshape(v * x.shape[1], *x.shape[2:])


class _ScanBwd(torch.autograd.Function):
    """``scan_bwd`` as a function the ``torch.func`` transforms call with
    unwrapped operands: under ``vjp`` its forward receives them unwrapped,
    and under ``vmap`` its rule folds the vmapped axis into B, one launch
    for the batch. It has no derivative of its own."""

    @staticmethod
    def forward(dA, dBx, C, hs, g_y):
        return scan_bwd(dA, dBx, C, hs, g_y)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *_grads):
        raise RuntimeError("ssm_scan has no second derivative")

    @staticmethod
    def vmap(info, in_dims, *operands):
        v = info.batch_size
        grads = _ScanBwd.apply(*(_fold(x, d, v) for x, d in zip(operands, in_dims)))
        return tuple(g.reshape(v, -1, *g.shape[1:]) for g in grads), (0, 0, 0)


def ssm_scan(dA, dBx, C) -> torch.Tensor:
    """dA, dBx: (B, S, D, N); C: (B, S, N) -> y: (B, S, D) fp32, with a
    gradient for all three (kernels on CUDA, plain versions on the CPU)."""
    return SSMScan.apply(dA, dBx, C)[0]
