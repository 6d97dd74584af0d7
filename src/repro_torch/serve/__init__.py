"""repro_torch.serve — continuous-batching cluster-routed serving engine,
the port of the JAX package's ``repro.serve``.

StoCFL's §4.4 inference surface: route each client to its cluster's
personalized model ONCE (Ψ-cosine, per-client cache — ``router``), admit
requests into a fixed ``clusters × slots`` grid of preallocated KV/SSM
cache lanes (``slots``), and advance every active lane of every cluster
model with ONE decode step per token, captured as a CUDA graph on the
card (continuous batching: slots free on finish and refill from the
queues mid-flight — ``scheduler`` + ``engine``). ``baseline`` holds the
sequential loop the engine is held against and the near-tie rule the two
are compared under; ``docs/SERVING.md`` has the scheduler contract.

    from repro_torch import serve
    eng = serve.ServeEngine(model, state, serve.ServeConfig(slots=8))
    eng.submit_many([serve.Request(rid=i, client_id=c, prompt=p, gen=16,
                                   history=h) for ...])
    results = eng.run()      # {rid: RequestResult}
"""
from repro_torch.serve.engine import RequestResult, ServeConfig, ServeEngine
from repro_torch.serve.baseline import (NEAR_TIE_EPS, SequentialLoop,
                                        near_tie_compare, top2_gap)
from repro_torch.serve.router import Route, Router
from repro_torch.serve.scheduler import Request, SlotScheduler
from repro_torch.serve.slots import (DecodeGraph, DecodeSlots, alloc_slots, harvest,
                                     make_decode_step, make_insert, make_prefill)

__all__ = [
    "ServeEngine", "ServeConfig", "RequestResult",
    "Request", "SlotScheduler",
    "Router", "Route",
    "DecodeSlots", "DecodeGraph", "alloc_slots", "make_decode_step", "make_insert",
    "make_prefill", "harvest",
    "SequentialLoop", "NEAR_TIE_EPS", "near_tie_compare", "top2_gap",
]
