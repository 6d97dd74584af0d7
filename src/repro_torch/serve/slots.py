"""Fixed-slot decode state: the serving engine's preallocated data plane.

One ``DecodeSlots`` holds EVERYTHING the decode loop touches — a
(clusters × slots_per_cluster) grid of KV/SSM cache lanes allocated once
at engine construction (``alloc_slots``, shaped by
``models.registry.serve_cache_specs``), plus per-slot bookkeeping (last
token, context length, active mask, emit budget) and a device output
buffer tokens land in as they are generated. Every transition writes
these buffers in place (``copy_``), the port's form of the reference's
donation, so their addresses never change and a captured CUDA graph
stays valid across requests:

- ``make_prefill``   — grouped prefill: one forward over a cluster's
  admission batch, returning first tokens + the prefill cache (an MoE
  model routes each request of the batch in groups of its own).
- ``make_insert``    — admit: copy request ``j`` of a prefill group into
  lane ``(k, s)`` (attention caches overwrite their ``[0, prompt_len)``
  prefix, SSM/conv states their full extent) and arm the slot's counters.
- ``make_decode_step`` — the single decode transition: every slot of
  every cluster group advances one token in one call. The cluster axis is
  a ``torch.func.vmap`` over the stacked cluster params; the slot axis is
  the batch axis of one decode that takes one position per lane.
  Generated tokens are written into the on-device ``out`` buffer — NO
  per-token host sync; ``harvest`` copies a finished slot's row to the
  host exactly once per request.
- ``DecodeGraph`` — on the card, the decode step captured once as a CUDA
  graph over those buffers and replayed n times with no host read.

Inactive lanes still execute (fixed shapes are the point) but their
bookkeeping is masked and their cache writes land at their frozen final
position, which a reused slot's insert+decode never reads: attention
reads are masked to ``[0, pos]`` and every decode writes position ``pos``
before attending to it, so a recycled lane's stale suffix is dead by
construction. The port of the JAX package's ``serve/slots.py``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.analysis import sanitize
from repro_torch.engine.api import capture_graph
from repro_torch.kernels import _build
from repro_torch.models import moe
from repro_torch.models.registry import build, embed_prefix_, serve_cache_specs
from repro_torch.utils import events, trees

__all__ = ["DecodeSlots", "DecodeGraph", "alloc_slots", "clear_slots", "make_decode_step",
           "make_insert", "make_prefill", "harvest", "request_grouped"]


class DecodeSlots(NamedTuple):
    """The serving engine's device-resident decode state.

    ``caches`` leaves are ``(K, ...) = (clusters,) + make_cache(slots,
    max_len).shape`` — cluster k's slot s is the cache's own batch lane
    ``[k, :, s]``. The bookkeeping grids are ``(K, slots)`` int32 (bool
    for ``active``): ``token`` (last emitted token, the next decode
    input), ``pos`` (tokens already cached — the absolute position the
    next decode writes), ``active`` (slot is mid-generation),
    ``remaining`` (tokens still to emit), ``emitted`` (tokens emitted so
    far, = the next ``out`` column). ``out`` is the ``(K, slots,
    max_gen)`` device output buffer."""
    caches: Any
    token: torch.Tensor
    pos: torch.Tensor
    active: torch.Tensor
    remaining: torch.Tensor
    emitted: torch.Tensor
    out: torch.Tensor


def _buffers(sl: DecodeSlots):
    return trees.leaves(sl.caches) + list(sl[1:])


def alloc_slots(model, clusters: int, slots: int, max_len: int, max_gen: int,
                device="cpu") -> DecodeSlots:
    """Allocate the fixed-slot decode state ONCE on ``device``: zeroed
    cache lanes for ``clusters × slots`` concurrent requests of context
    budget ``max_len`` and emit budget ``max_gen`` (shapes from
    ``registry.serve_cache_specs``). Everything after this is
    insert-on-admit / free-on-finish — no per-request allocation."""
    specs = serve_cache_specs(model, clusters, slots, max_len)
    caches = trees.tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
                            specs)

    def z(dtype=torch.int32):
        return torch.zeros((clusters, slots), dtype=dtype, device=device)

    return DecodeSlots(caches=caches, token=z(), pos=z(), active=z(torch.bool),
                       remaining=z(), emitted=z(),
                       out=torch.zeros((clusters, slots, max_gen), dtype=torch.int32,
                                       device=device))


def clear_slots(sl: DecodeSlots) -> None:
    """Zero every buffer of ``sl`` in place (the state ``alloc_slots``
    returns, at the same addresses)."""
    for x in _buffers(sl):
        x.zero_()


def request_grouped(model, prompt_len: int):
    """The model a prefill group of prompts of ``prompt_len`` tokens runs:
    ``model`` itself, or for an MoE model the same model with its routing
    groups cut to the largest divisor of ``prompt_len`` not above
    ``moe_group_size``, the groups one request prefilled alone has. Then
    no routing group spans two requests, so co-admitted requests never
    take each other's expert capacity, and a request's tokens do not
    depend on which requests share its prefill (the reference's bucketed
    group prefill lets them, and its pad copies, share groups)."""
    cfg = model.cfg
    if not cfg.n_experts:
        return model
    g = moe.group_tokens(prompt_len, cfg.moe_group_size)
    return model if g == cfg.moe_group_size else build(cfg.with_(moe_group_size=g))


def make_prefill(model):
    """Grouped prefill: ``(params, batch) -> (first tokens (B,) int32,
    prefill cache)``, each request of the group routed through MoE
    layers on its own (``request_grouped``). The greedy first token is
    taken on the device, so the admission path never syncs."""
    def serve_prefill(params, batch):
        grouped = request_grouped(model, batch["tokens"].shape[1])
        with torch.no_grad():
            logits, cache = grouped.prefill(params, batch)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return serve_prefill


def make_insert(model):
    """The admit transition: copy request ``j`` of a prefill group into
    lane ``(k, s)`` and arm the slot, writing ``sl`` in place. The slot's
    caches take the prefill prefix at the lane origin (attention leaves
    overwrite ``[0, prompt_len)`` of the seq axis; SSM state/conv leaves
    overwrite their full extent), ``out[k, s, 0]`` takes the prefill's
    greedy token, and the counters start at ``pos = prompt_len``,
    ``emitted = 1``, ``remaining = gen - 1``. ``j``/``k``/``s`` are host
    ints; nothing is read back from the device."""
    del model   # the cache layout is read off the buffers

    def serve_insert(sl: DecodeSlots, gcache, gtok, j: int, k: int, s: int,
                     prompt_len: int, gen: int) -> DecodeSlots:
        for full, got in zip(trees.leaves(sl.caches), trees.leaves(gcache)):
            embed_prefix_(full[k, :, s], got[:, j])
        sl.token[k, s] = gtok[j]
        sl.pos[k, s] = prompt_len
        sl.active[k, s] = gen > 1
        sl.remaining[k, s] = gen - 1
        sl.emitted[k, s] = 1
        sl.out[k, s, 0] = gtok[j]
        return sl

    return serve_insert


def make_decode_step(model):
    """The one-token transition ``step(stacked_params, sl)``, writing
    ``sl`` in place — the serving engine's whole decode data plane.

    Cluster heterogeneity is a ``torch.func.vmap`` over the stacked
    cluster params (every personalized model advances its own slot
    block); per-slot position heterogeneity is the model's decode with one
    position per batch row, which turns the cache update into a one-hot
    write and the causal mask into a per-lane ``valid_len``. Active lanes
    append their greedy token to ``out`` and advance their counters;
    inactive lanes are computed and their results discarded (fixed shapes
    are what a captured graph needs). Every new value is computed before
    the first buffer is written."""
    lanes = torch.func.vmap(model.decode, in_dims=(0, 0, 0, 0))

    def serve_step(stacked_params, sl: DecodeSlots) -> None:
        with torch.no_grad():
            logits, caches = lanes(stacked_params, sl.token, sl.caches, sl.pos)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            act = sl.active
            adv = act.to(torch.int32)
            col = torch.where(act, sl.emitted, 0).to(torch.int64)[..., None]
            keep = torch.gather(sl.out, 2, col)[..., 0]
            new = (torch.where(act, nxt, sl.token), sl.pos + adv,
                   act & (sl.remaining > 1), sl.remaining - adv, sl.emitted + adv,
                   sl.out.scatter(2, col, torch.where(act, nxt, keep)[..., None]))
            for dst, src in zip(_buffers(sl), trees.leaves(caches) + list(new)):
                dst.copy_(src)

    return serve_step


class DecodeGraph:
    """The decode step on one engine's static buffers, captured as a CUDA
    graph: ``run(n)`` advances every lane n tokens with n replays and no
    host read.

    The first ``run`` makes its first step eagerly on a side stream (the
    warm-up: ``vmap``, cuBLAS and the allocator are set up there), then
    captures one step on that stream and replays it for the rest. Both
    the warm-up and the capture run under ``sanitize.no_transfer()``, so a
    host read in the step raises, and a capture that fails raises: there
    is no eager fallback. The kernels' launch counters stay true: a
    capture's counts are taken back off and added once per replay
    (``per_step``; ``engine.api.capture_graph``, as ``RoundProgram``).
    Making one is reported to ``sanitize.compile_budget`` as a program,
    ``name`` (the engine passes ``DecodeGraph (K, slots, max_len)``);
    under ``sanitize.nan_guard()`` the lanes' floating buffers are checked
    after each replay."""

    def __init__(self, step, stacked, sl: DecodeSlots, name: Optional[str] = None):
        self.step, self.stacked, self.sl = step, stacked, sl
        self.name = name or f"DecodeGraph {tuple(sl.token.shape)}"
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.stream: Optional[torch.cuda.Stream] = None
        self.per_step: dict = {}
        self.capture_s: Optional[float] = None     # host seconds of the capture
        events.report("program", self.name)

    def run(self, n: int) -> None:
        if n < 1:
            return
        done = 0
        if self.graph is None:
            main = torch.cuda.current_stream()
            self.stream = torch.cuda.Stream()
            self.stream.wait_stream(main)
            with torch.cuda.stream(self.stream):
                with sanitize.no_transfer():
                    self.step(self.stacked, self.sl)
                self.graph, _, self.per_step, self.capture_s = capture_graph(
                    self.stream, lambda: self.step(self.stacked, self.sl))
            main.wait_stream(self.stream)
            done = 1
        for _ in range(done, n):
            self.graph.replay()
            events.check_nan(self.name, _buffers(self.sl))
            _build.add_launches(self.per_step)


def harvest(sl: DecodeSlots, k: int, s: int) -> np.ndarray:
    """Copy lane ``(k, s)``'s output row to the host — the request's ONE
    device→host transfer (the caller slices to its known emit count).
    Everything before this point stayed on the device. Always a copy: on
    the CPU ``.cpu()`` would return the buffer itself, which the lane's
    next request overwrites."""
    return sl.out[k, s].to("cpu", copy=True).numpy()
