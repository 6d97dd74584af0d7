"""Pairwise cosine similarity (kernel K2) and merge candidates (kernel K3).

The CUDA kernels are in ``csrc/cosine_sim.cu``. K2 replaces the JAX
package's ``kernels/cosine_sim.py`` ``_cosine_kernel``: a split-K fp32 X·Xᵀ
with an inverse-norm epilogue. K3 replaces ``_candidates_kernel``
(``merge_candidates``): the same product over the upper tiles, ending in a
threshold epilogue that writes only the 0/1 adjacency. On a CUDA tensor a
wrapper launches its kernel or raises; on a CPU tensor it runs the plain
version in ``ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0              # K2 launches so far (reset by callers that count)
candidate_launches = 0    # K3 launches so far

TILE = 64           # output tile edge of the CUDA kernel
BK = 32             # contraction columns per staged step
MIN_CHUNK = 256     # least contraction length one split is given


def split_plan(n: int, d: int, sms: int, upper: bool = False):
    """(kchunk, splits) for an (n, d) input on a card with ``sms`` SMs:
    enough K splits to put about two blocks on every SM (K2), or, with
    ``upper`` (K3, which computes only the tiles on and above the
    diagonal), about eight blocks of those tiles on every SM, so that the
    long contraction at a few hundred rows is spread over more blocks
    than SMs. Each split is at least ``MIN_CHUNK`` long and a multiple of
    ``BK``."""
    tiles = -(-n // TILE)
    work, per_sm = (tiles * (tiles + 1) // 2, 8) if upper else (tiles * tiles, 2)
    want = max(1, -(-per_sm * sms // work))
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


def merge_candidates(x: torch.Tensor, live: torch.Tensor, tau: float) -> torch.Tensor:
    """(K, D) cluster means + (K,) live mask -> (K, K) fp32 0/1 adjacency:
    ``adj[i, j] = 1`` iff i ≠ j, both rows are live and cos(x_i, x_j) ≥ τ
    (τ compared in fp32). Zero rows have cosine 0; the diagonal is 0."""
    global candidate_launches
    if x.dim() != 2 or live.shape != (x.shape[0],):
        raise ValueError("merge_candidates takes an (N, D) matrix and an (N,) "
                         f"mask, got {tuple(x.shape)} and {tuple(live.shape)}")
    if x.device.type == "cpu":
        return ref.merge_candidates_ref(x, live, tau)
    if x.device.type != "cuda" or live.device != x.device:
        raise ValueError(f"no kernel for devices {x.device}, {live.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the merge_candidates kernel takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("merge_candidates needs a contiguous (N, D) matrix")
    n, d = x.shape
    if n >= 65536:
        raise ValueError(f"merge_candidates supports N < 65536, got {n}")
    if n == 0:
        return torch.zeros((0, 0), dtype=torch.float32, device=x.device)
    if d == 0:
        raise ValueError("merge_candidates needs D > 0")
    # a bool tensor is one byte of 0 or 1 per entry: the kernel reads it as is
    lv = (live if live.dtype == torch.bool else live != 0).contiguous()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    kchunk, splits = split_plan(n, d, sms, upper=True)
    np_ = -(-n // TILE) * TILE
    partial = torch.empty((splits, np_, np_), dtype=torch.float32, device=x.device)
    inv = torch.empty((np_,), dtype=torch.float32, device=x.device)
    out = torch.empty((n, n), dtype=torch.float32, device=x.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.merge_candidates_f32(x.data_ptr(), lv.data_ptr(), n, d, kchunk,
                                       splits, float(tau), partial.data_ptr(),
                                       inv.data_ptr(), out.data_ptr(), stream)
    _build.check(err, "merge_candidates_f32")
    candidate_launches += 1
    return out
