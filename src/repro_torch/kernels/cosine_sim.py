"""Pairwise cosine similarity (kernel K2).

The CUDA kernel is ``csrc/cosine_sim.cu`` (it replaces the JAX package's
``kernels/cosine_sim.py`` ``_cosine_kernel``): a split-K fp32 X·Xᵀ with an
inverse-norm epilogue. On a CUDA tensor the wrapper launches it or raises;
on a CPU tensor it runs the plain version ``ref.cosine_sim_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0        # kernel launches so far (reset by callers that count)

TILE = 64           # output tile edge of the CUDA kernel
BK = 32             # contraction columns per staged step
MIN_CHUNK = 256     # least contraction length one split is given


def split_plan(n: int, d: int, sms: int):
    """(kchunk, splits) for an (n, d) input on a card with ``sms`` SMs:
    enough K splits to put about two blocks on every SM, each split at
    least ``MIN_CHUNK`` long and a multiple of ``BK``."""
    tiles = -(-n // TILE)
    want = max(1, -(-2 * sms // (tiles * tiles)))
    kchunk = max(MIN_CHUNK, -(-d // want))
    kchunk = -(-kchunk // BK) * BK
    return kchunk, -(-d // kchunk)


def cosine_sim(x: torch.Tensor) -> torch.Tensor:
    """x: (N, D) -> (N, N) fp32 cosine similarity; zero rows give exactly 0."""
    global launches
    if x.dim() != 2:
        raise ValueError(f"cosine_sim takes an (N, D) matrix, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return ref.cosine_sim_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the cosine_sim kernel takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("cosine_sim needs a contiguous (N, D) matrix")
    n, d = x.shape
    if n >= 65536:
        raise ValueError(f"cosine_sim supports N < 65536, got {n}")
    if n == 0 or d == 0:
        return torch.zeros((n, n), dtype=torch.float32, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    kchunk, splits = split_plan(n, d, sms)
    np_ = -(-n // TILE) * TILE
    partial = torch.empty((splits, np_, np_), dtype=torch.float32, device=x.device)
    inv = torch.empty((np_,), dtype=torch.float32, device=x.device)
    out = torch.empty((n, n), dtype=torch.float32, device=x.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.cosine_sim_f32(x.data_ptr(), n, d, kchunk, splits,
                                 partial.data_ptr(), inv.data_ptr(),
                                 out.data_ptr(), stream)
    _build.check(err, "cosine_sim_f32")
    launches += 1
    return out
