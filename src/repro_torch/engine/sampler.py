"""On-device cohort sampling (threefry-2x32, without replacement).

The port of the JAX package's ``engine/sampler.py``. The sampling state is
a threefry key, a (2,) int64 tensor of the two 32-bit key words, stored in
``ServerState.rng_key`` under ``rng_backend="device"``. One draw is

    key', sub = split(key)
    u         = uniform(sub, (n,))      masked to +inf off-pool
    cohort    = stable argsort(u)[:m]   (distinct by construction)

which is an exact without-replacement draw of ``m`` clients from the pool.
``split`` and ``uniform`` are written here in tensor arithmetic and give
the bits of ``jax.random.split`` and ``jax.random.uniform`` (threefry-2x32,
``jax_threefry_partitionable``), so one seed draws the reference's cohorts
and advanced keys, on the CPU and on the card alike.

Torch has no full uint32 arithmetic, so the words live in int64 tensors
masked to 32 bits after every add and shift. ``draw`` is a pure function
of (key, pool mask, static m): no host read, no ``torch.Generator``, so
the eager round and a captured round body (``engine.run_rounds``) draw the
same cohorts from the same key.

``m = ⌈sample_rate · live⌉`` is sized by the live population (registered
minus departed) and clipped to the pool (live minus unavailable); the pool
is padded to a power of two with slots that are never drawn, exactly as
the reference pads it, since the padding changes the uniform's shape.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

__all__ = ["cohort_pool", "cohort_size", "draw", "draw_cohort",
           "pool_capacity", "split", "uniform"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def pool_capacity(n_clients: int) -> int:
    """Power-of-two pool quantum for ``n_clients`` registered ids (the
    uniform's shape, and every captured round body it feeds, follows it)."""
    n = int(n_clients)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def cohort_pool(n_clients: int, left: Iterable[int],
                unavailable: Iterable[int] = (),
                capacity: int = None) -> np.ndarray:
    """Boolean draw-pool mask over client ids: registered, not departed,
    not unavailable this round. ``capacity`` (>= ``n_clients``) pads the
    mask with False slots for unregistered ids."""
    cap = int(n_clients if capacity is None else capacity)
    assert cap >= int(n_clients), "pool capacity below population"
    pool = np.zeros(cap, bool)
    pool[:int(n_clients)] = True
    for c in left:
        if 0 <= int(c) < n_clients:
            pool[int(c)] = False
    for c in unavailable:
        if 0 <= int(c) < n_clients:
            pool[int(c)] = False
    return pool


def cohort_size(sample_rate: float, n_live: int, pool_size: int) -> int:
    """Cohort size ``m = ⌈sample_rate · live⌉`` clipped to the pool (0 when
    the pool is empty: the caller's skipped-round case)."""
    if pool_size <= 0 or n_live <= 0:
        return 0
    m = int(np.ceil(float(sample_rate) * int(n_live)))
    return min(max(m, 0), int(pool_size))


# ------------------------------------------------------------- threefry
def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def _threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                  x1: torch.Tensor):
    """Threefry-2x32 (20 rounds) of counter words (x0, x1) under key words
    (k0, k1); every operand an int64 tensor of values in [0, 2³²)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _counters(n: int, device):
    """(hi, lo) words of the flat indices 0..n-1, the partitionable
    counter layout."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & _MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (num, 2) new keys from a (2,) key."""
    hi, lo = _counters(num, key.device)
    x0, x1 = _threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([x0, x1], dim=1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """n 32-bit words (int64 tensor) of ``jax.random.bits(key, (n,))``."""
    hi, lo = _counters(n, key.device)
    x0, x1 = _threefry2x32(key[0], key[1], hi, lo)
    return x0 ^ x1


def uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))``: float32 in [0, 1), the top 23
    random bits as a mantissa of [1, 2), minus 1."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def draw(key: torch.Tensor, pool_mask: torch.Tensor, m: int):  # torchlint: hot-path
    """One without-replacement draw: ``(key, (n,) bool mask, static m) ->
    (key', (m,) int64 cohort)``. Off-pool ids get +inf sort keys; ties
    break by id (a stable sort, as ``jnp.argsort``), so callers that clip
    ``m`` to the pool (``cohort_size``) never draw an off-pool id."""
    keys = split(key)
    u = uniform(keys[1], int(pool_mask.shape[0]))
    u = torch.where(pool_mask, u, torch.full_like(u, float("inf")))
    return keys[0], torch.sort(u, stable=True).indices[:m]


def draw_cohort(key: torch.Tensor, pool_mask, m: int):
    """``draw`` with a host mask (the eager ``run_round`` entry): returns
    ``(advanced key, (m,) int64 cohort ids)`` on the key's device."""
    pool = torch.as_tensor(np.asarray(pool_mask, bool), device=key.device)
    return draw(key, pool, int(m))
