"""Pairwise cosine similarity (kernel K2) and merge candidates (kernel K3).

The CUDA kernels are in ``csrc/cosine_sim.cu``: one X·Xᵀ over the tiles on
and above the diagonal, in 3xTF32 on the tensor cores fed by a TMA ring,
split over the contraction and reduced in the same launch in a fixed order
(bitwise repeatable). K2 replaces the JAX package's
``kernels/cosine_sim.py`` ``_cosine_kernel`` and ends in the inverse-norm
scale; K3 replaces ``_candidates_kernel`` (``merge_candidates``) and ends in
the threshold, writing only the 0/1 adjacency. On a CUDA tensor a wrapper
launches its kernel (one launch a call) or raises; on a CPU tensor it runs
the plain version in ``ref``. Under ``analysis.sanitize.nan_guard`` K2's
output is checked (a ctypes launch passes no dispatcher; K3's is 0/1).

The kernel reads x through a TMA tensor map, which needs a row stride that
is a multiple of 16 bytes. The callers build their matrices with
``row_padded`` (rows ``D`` rounded up to ``ROW_ALIGN`` floats apart) and
hand the (N, D) view over. A contiguous (N, D) whose stride cannot be
mapped (D·4 not a multiple of 16) is copied into such a buffer first; that
copy is counted in ``padded_copies``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.utils import events

launches = 0              # K2 launches so far (reset by callers that count)
candidate_launches = 0    # K3 launches so far
padded_copies = 0         # inputs copied into a row-padded buffer by a wrapper

KSTEP = 32          # contraction columns per k-step of the kernel
MIN_STEPS = 8       # least k-steps one split is given
ROW_ALIGN = 32      # row stride, in floats, of the matrices the callers build
SPREAD = 1.02       # a plan may cost this much more than the best wave fill


class Plan(NamedTuple):
    tile: int       # output tile edge: 64 (one consumer warpgroup) or 128 (two)
    splits: int     # contraction splits of every upper tile
    group: int      # splits summed together before the groups are summed


def plan(n: int, d: int, sms: int) -> Plan:
    """The launch plan for an (n, d) input on a card with ``sms`` SMs.

    Tiles of 64 rows up to n = 64, else 128. Each of the U tiles on and
    above the diagonal is split over the contraction into ``splits`` runs
    of whole k-steps (at least ``MIN_STEPS`` each, none empty), one block
    each; the U·splits blocks run in ⌈U·splits / sms⌉ waves. The plan takes
    the fewest splits whose waves per unit of contraction, ⌈U·s/sms⌉ / s,
    are within ``SPREAD`` of the best, so the card is filled without
    more partial tiles than that needs. ``group`` = ⌈√splits⌉ sets the
    two-level in-launch reduction."""
    tile = 64 if n <= 64 else 128
    tiles = -(-n // tile)
    upper = tiles * (tiles + 1) // 2
    ksteps = -(-d // KSTEP)
    most = max(1, min(ksteps // MIN_STEPS, 4 * sms))
    # split counts that whole k-steps give: ceil(ksteps / per) for some per
    counts = sorted({-(-ksteps // -(-ksteps // s)) for s in range(1, most + 1)})
    cost = {s: -(-upper * s // sms) / s for s in counts}
    best = min(cost.values())
    splits = next(s for s in counts if cost[s] <= SPREAD * best)
    return Plan(tile, splits, math.isqrt(splits - 1) + 1)


def row_padded(n: int, d: int, device, dtype=torch.float32) -> torch.Tensor:
    """An uninitialised (n, d) matrix whose rows lie ``d`` rounded up to
    ``ROW_ALIGN`` elements apart: a view the kernels map as it is. The pad
    columns beyond d are zero; no operation on the view reads them."""
    stride = -(-max(d, 1) // ROW_ALIGN) * ROW_ALIGN
    buf = torch.empty((n, stride), dtype=dtype, device=device)
    buf[:, d:].zero_()
    return buf[:, :d]


def _mappable(x: torch.Tensor):
    """(x or a row-padded copy of it, its row stride in elements): the
    operand as the kernel takes it. Rows must be contiguous; a stride TMA
    cannot take is copied into ``row_padded`` and counted."""
    global padded_copies
    n, d = x.shape
    if d > 1 and x.stride(1) != 1:
        raise ValueError("the cosine kernels need an (N, D) matrix with contiguous rows")
    stride = x.stride(0) if n > 1 else -(-d // 4) * 4
    if (stride * 4) % 16 or x.data_ptr() % 16 or stride < d:
        y = row_padded(n, d, x.device)
        y.copy_(x)
        padded_copies += 1
        return y, y.stride(0)
    return x, stride


def _workspace(x: torch.Tensor, p: Plan, stream: int):
    """(partials, counters) for one launch: the partial records of every
    (upper tile, split), and the counters, which the kernel leaves 0 and
    which are kept per device and stream."""
    tiles = -(-x.shape[0] // p.tile)
    upper = tiles * (tiles + 1) // 2
    work = torch.empty((upper * p.splits * (p.tile * p.tile + 2 * p.tile),),
                       dtype=torch.float32, device=x.device)
    need = upper * (-(-p.splits // p.group) + 1)
    return work, _build.arrival_counters(x.device, stream, need)


def _check_operand(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the {name} kernel takes float32, got {x.dtype}")
    if x.shape[0] >= 65536:
        raise ValueError(f"{name} supports N < 65536, got {x.shape[0]}")


def cosine_sim(x: torch.Tensor) -> torch.Tensor:
    """x: (N, D) -> (N, N) fp32 cosine similarity; zero rows give exactly 0."""
    global launches
    if x.dim() != 2:
        raise ValueError(f"cosine_sim takes an (N, D) matrix, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return ref.cosine_sim_ref(x)
    _check_operand(x, "cosine_sim")
    n, d = x.shape
    if n == 0 or d == 0:
        return torch.zeros((n, n), dtype=torch.float32, device=x.device)
    x, stride = _mappable(x)
    p = plan(n, d, torch.cuda.get_device_properties(x.device).multi_processor_count)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    work, cnt = _workspace(x, p, stream)
    out = torch.empty((n, n), dtype=torch.float32, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.cosine_sim_f32(x.data_ptr(), n, d, stride, p.tile, p.splits, p.group,
                                 work.data_ptr(), cnt.data_ptr(), out.data_ptr(), stream)
    _build.check(err, "cosine_sim_f32")
    launches += 1
    events.check_nan("cosine_sim", out)
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
    if live.device != x.device:
        raise ValueError(f"no kernel for devices {x.device}, {live.device}")
    _check_operand(x, "merge_candidates")
    n, d = x.shape
    if n == 0:
        return torch.zeros((0, 0), dtype=torch.float32, device=x.device)
    if d == 0:
        raise ValueError("merge_candidates needs D > 0")
    x, stride = _mappable(x)
    # a bool tensor is one byte of 0 or 1 per entry: the kernel reads it as is
    lv = (live if live.dtype == torch.bool else live != 0).contiguous()
    p = plan(n, d, torch.cuda.get_device_properties(x.device).multi_processor_count)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    work, cnt = _workspace(x, p, stream)
    out = torch.empty((n, n), dtype=torch.float32, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.merge_candidates_f32(x.data_ptr(), lv.data_ptr(), n, d, stride, p.tile,
                                       p.splits, p.group, float(tau), work.data_ptr(),
                                       cnt.data_ptr(), out.data_ptr(), stream)
    _build.check(err, "merge_candidates_f32")
    candidate_launches += 1
    return out
