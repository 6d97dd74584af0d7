"""Fused bi-level client update (kernel K1), in place on θ and ω, and its
local-SGD form, in place on θ alone.

The CUDA kernels are ``csrc/prox_update.cu`` (they replace the JAX
package's ``kernels/prox_update.py`` ``_prox_kernel``). On a CUDA tensor a
wrapper launches its kernel or raises; on a CPU tensor it runs the plain
version in place (``ref.prox_update_ref_``, ``ref.prox_theta_ref_``), so
both devices give the same contract. Under ``analysis.sanitize.nan_guard``
a launch's outputs are checked (a ctypes launch passes no dispatcher).
The bi-level step is a dispatcher op with a shape-only path for fake
tensors (``prox_update_flat``); the local-SGD form, which no traced step
runs, is a plain function.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.utils import events

launches = 0        # kernel launches so far (reset by callers that count)
theta_launches = 0  # ... of the local-SGD form (prox_theta_flat)

_ENTRY = {torch.float32: "prox_update_f32", torch.bfloat16: "prox_update_bf16"}
_THETA_ENTRY = {torch.float32: "prox_theta_f32", torch.bfloat16: "prox_theta_bf16"}


def _check(theta, omega, g_theta, g_omega):
    ops = (theta, omega, g_theta, g_omega)
    if any(t.dim() != 1 for t in ops):
        raise ValueError("prox_update_flat takes four 1-D tensors")
    if len({t.numel() for t in ops}) != 1:
        raise ValueError(f"length mismatch: {[t.numel() for t in ops]}")
    if len({t.dtype for t in ops}) != 1 or theta.dtype not in _ENTRY:
        raise TypeError("prox_update_flat takes four float32 or four "
                        f"bfloat16 tensors, got {[t.dtype for t in ops]}")
    if len({t.device for t in ops}) != 1:
        raise ValueError("operands lie on different devices")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("operands must be contiguous")


def prox_update_flat(theta, omega, g_theta, g_omega, eta: float, lam: float):
    """θ ← θ − η(g_θ + λ(θ − ω)), ω ← ω − η g_ω on flat vectors, written
    into ``theta`` and ``omega``; returns ``(theta, omega)``.

    One dispatcher op, ``repro_torch::prox_update_`` (its two written
    operands declared mutated), so that a trace over fake tensors
    (``launch.dryrun``) sees the kernel as one op with its own operands,
    through the op's shape-only path; on real tensors the op runs the
    launch below (or the plain version on the CPU)."""
    _check(theta, omega, g_theta, g_omega)
    _prox_update_op(theta, omega, g_theta, g_omega, float(eta), float(lam))
    return theta, omega


@torch.library.custom_op("repro_torch::prox_update_", mutates_args=("theta", "omega"))
def _prox_update_op(theta: torch.Tensor, omega: torch.Tensor, g_theta: torch.Tensor,
                    g_omega: torch.Tensor, eta: float, lam: float) -> None:
    global launches
    if theta.device.type == "cpu":
        ref.prox_update_ref_(theta, omega, g_theta, g_omega, eta, lam)
        return
    if theta.device.type != "cuda":
        raise ValueError(f"no kernel for device {theta.device}")
    if theta.numel() == 0:
        return
    lib = _build.load()
    stream = torch.cuda.current_stream(theta.device).cuda_stream
    name = _ENTRY[theta.dtype]
    with torch.cuda.device(theta.device):
        err = getattr(lib, name)(theta.data_ptr(), omega.data_ptr(),
                                 g_theta.data_ptr(), g_omega.data_ptr(),
                                 theta.numel(), float(eta), float(lam), stream)
    _build.check(err, name)
    launches += 1
    events.check_nan("prox_update", theta, omega)


@_prox_update_op.register_fake
def _prox_update_shape(theta, omega, g_theta, g_omega, eta, lam) -> None:
    """The op on fake tensors: it writes its operands in place and makes
    nothing."""


def _span(t: torch.Tensor):
    return t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()


def _check_theta(theta, anchor, grad):
    ops = (theta, anchor, grad)
    if any(t.dim() != 1 for t in ops):
        raise ValueError("prox_theta_flat takes three 1-D tensors")
    n, p = theta.numel(), anchor.numel()
    if grad.numel() != n or p == 0 and n or p and n % p:
        raise ValueError(f"lengths {[t.numel() for t in ops]}: the gradient must "
                         "have θ's length and the anchor θ's or a period dividing it")
    if len({t.dtype for t in ops}) != 1 or theta.dtype not in _THETA_ENTRY:
        raise TypeError("prox_theta_flat takes three float32 or three "
                        f"bfloat16 tensors, got {[t.dtype for t in ops]}")
    if len({t.device for t in ops}) != 1:
        raise ValueError("operands lie on different devices")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("operands must be contiguous")
    (t0, t1), (a0, a1) = _span(theta), _span(anchor)
    if a0 < t1 and t0 < a1 and (a0, a1) != (t0, t1):
        raise ValueError("the anchor overlaps θ without being θ")


def prox_theta_flat(theta, anchor, grad, eta: float, lam: float):
    """θ ← θ − η(g + λ(θ − a)) on a flat θ, written into ``theta``; returns
    ``theta``. The anchor is read and never written: a vector of θ's
    length (θ itself when λ = 0, as the reference's local SGD passes it), or
    of a period P dividing θ's length, broadcast over the rows of a (C, P)
    cohort buffer seen flat."""
    global theta_launches
    _check_theta(theta, anchor, grad)
    if theta.device.type == "cpu":
        return ref.prox_theta_ref_(theta, anchor, grad, eta, lam)
    if theta.device.type != "cuda":
        raise ValueError(f"no kernel for device {theta.device}")
    if theta.numel() == 0:
        return theta
    lib = _build.load()
    stream = torch.cuda.current_stream(theta.device).cuda_stream
    name = _THETA_ENTRY[theta.dtype]
    with torch.cuda.device(theta.device):
        err = getattr(lib, name)(theta.data_ptr(), anchor.data_ptr(), grad.data_ptr(),
                                 theta.numel(), anchor.numel(), float(eta),
                                 float(lam), stream)
    _build.check(err, name)
    theta_launches += 1
    events.check_nan("prox_theta", theta)
    return theta
