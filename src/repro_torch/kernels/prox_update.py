"""Fused bi-level client update (kernel K1), in place on θ and ω.

The CUDA kernel is ``csrc/prox_update.cu`` (it replaces the JAX package's
``kernels/prox_update.py`` ``_prox_kernel``). On a CUDA tensor the wrapper
launches it or raises; on a CPU tensor it runs the plain version in place
(``ref.prox_update_ref_``), so both devices give the same contract.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0        # kernel launches so far (reset by callers that count)

_ENTRY = {torch.float32: "prox_update_f32", torch.bfloat16: "prox_update_bf16"}


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
    into ``theta`` and ``omega``; returns ``(theta, omega)``."""
    global launches
    _check(theta, omega, g_theta, g_omega)
    if theta.device.type == "cpu":
        return ref.prox_update_ref_(theta, omega, g_theta, g_omega, eta, lam)
    if theta.device.type != "cuda":
        raise ValueError(f"no kernel for device {theta.device}")
    if theta.numel() == 0:
        return theta, omega
    lib = _build.load()
    stream = torch.cuda.current_stream(theta.device).cuda_stream
    name = _ENTRY[theta.dtype]
    with torch.cuda.device(theta.device):
        err = getattr(lib, name)(theta.data_ptr(), omega.data_ptr(),
                                 g_theta.data_ptr(), g_omega.data_ptr(),
                                 theta.numel(), float(eta), float(lam), stream)
    _build.check(err, name)
    launches += 1
    return theta, omega
