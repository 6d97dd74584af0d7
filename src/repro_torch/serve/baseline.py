"""Sequential serving baseline — one request at a time, and the near-tie
rule that greedy token streams are compared under.

``SequentialLoop`` is the port of the JAX package's ``serve/baseline.py``
(the debugged legacy loop the continuous-batching engine is held against):

- **no per-request cache allocation** — ONE decode cache (batch 1) is
  allocated at construction and recycled through every request: the
  prefill prefix is written at its origin and each decode step's cache is
  copied back into it (a stale suffix from the previous request is dead:
  attention reads are masked to the live prefix and decode writes each
  position before attending to it; SSM/conv state is fully overwritten);
- **no per-token host sync** — tokens accumulate in an on-device output
  buffer; each request does exactly ONE device→host copy, at the end;
- routing goes through the same cached ``Router`` as the batched engine.

It also keeps each token's top-2 logit gap (one more device buffer,
copied with the tokens), which ``near_tie_compare`` needs of a reference
stream.

**The near-tie rule.** Two greedy streams of one request must be equal;
they may part only at a step where the REFERENCE stream's top-2 logit gap
is below ε, since there two sound fp32 computations summed in another
order may pick either token. At such a step the comparison of that
request stops, and the step is reported. ε is ``NEAR_TIE_EPS``: 1e-5 for
fp32 on the CPU, 1e-3 for fp32 on the card.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.models.registry import embed_prefix_
from repro_torch.serve.engine import RequestResult
from repro_torch.serve.router import Router
from repro_torch.serve.scheduler import Request
from repro_torch.utils import trees

__all__ = ["NEAR_TIE_EPS", "SequentialLoop", "near_tie_compare", "top2_gap"]

NEAR_TIE_EPS = {"cpu": 1e-5, "cuda": 1e-3}   # fp32 greedy streams, by device type


def top2_gap(logits: torch.Tensor) -> torch.Tensor:
    """(..., V) logits -> (...,) fp32 gap between the largest two."""
    top = torch.topk(logits.to(torch.float32), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def near_tie_compare(ref_tokens, got_tokens, ref_gaps, eps: float) -> Optional[int]:
    """The near-tie rule for one request: None when the streams are
    equal; the step where they part when the reference's top-2 gap there
    is below ``eps`` (the comparison stops at it). Raises AssertionError
    when they part anywhere else or differ in length."""
    ref = [int(t) for t in ref_tokens]
    got = [int(t) for t in got_tokens]
    if len(ref) != len(got):
        raise AssertionError(f"streams differ in length: {len(ref)} against {len(got)}")
    for i, (a, b) in enumerate(zip(ref, got)):
        if a != b:
            gap = float(ref_gaps[i])
            if gap < eps:
                return i
            raise AssertionError(f"streams part at step {i} ({a} against {b}) where the "
                                 f"reference's top-2 gap is {gap:.3e} >= {eps:g}")
    return None


class SequentialLoop:
    """One-request-at-a-time greedy serving over a ``ServerState``, with
    the cache template and the output buffer hoisted out of the request
    loop. ``serve(req)`` routes, prefills, decodes ``req.gen`` tokens, and
    returns a ``RequestResult`` (tokens and their gaps) after one
    device→host copy of each."""

    def __init__(self, model, state, max_len: int, max_gen: int):
        self.model = model
        self.state = state
        self.max_len = max_len
        self.max_gen = max_gen
        self.router = Router(state)
        dev = state.ctx.device
        self._template = model.make_cache(1, max_len, device=dev)
        self._out = torch.zeros((max_gen,), dtype=torch.int32, device=dev)
        self._gaps = torch.zeros((max_gen,), dtype=torch.float32, device=dev)
        self.n_requests = 0
        self.n_tokens = 0

    def _emit(self, i: int, logits) -> torch.Tensor:
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        self._out[i] = tok[0]
        self._gaps[i] = top2_gap(logits)[0]
        return tok

    def serve(self, req: Request) -> RequestResult:
        """Serve one request to completion (greedy, ``req.gen`` tokens
        including the prefill's first token)."""
        P = len(req.prompt)
        if req.gen < 1 or req.gen > self.max_gen:
            raise ValueError(f"gen={req.gen} outside [1, {self.max_gen}]")
        if P + req.gen - 1 > self.max_len:
            raise ValueError(f"prompt {P} + gen {req.gen} - 1 exceeds "
                             f"max_len={self.max_len}")
        rt = self.router.route(req.client_id, req.history)
        if rt.root is None:
            raise ValueError("no cluster to serve from")
        params = self.state.cluster_model(rt.root)
        cache = self._template
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int32)[None],
                                 device=self._out.device)
        with torch.no_grad():
            logits, got = self.model.prefill(params, {"tokens": prompt})
            for full, g in zip(trees.leaves(cache), trees.leaves(got)):
                embed_prefix_(full, g)
            tok = self._emit(0, logits)
            for i in range(1, req.gen):
                logits, new = self.model.decode(params, tok, cache, P + i - 1)
                for full, g in zip(trees.leaves(cache), trees.leaves(new)):
                    full.copy_(g)
                tok = self._emit(i, logits)
        row = self._out[:req.gen].to("cpu", copy=True).numpy()
        gaps = self._gaps[:req.gen].to("cpu", copy=True).numpy()
        self.n_requests += 1
        self.n_tokens += req.gen
        return RequestResult(rid=req.rid, cluster=rt.root,
                             similarity=rt.similarity, accepted=rt.accepted,
                             tokens=row, gaps=gaps)
