"""Cluster-model serving CLI — a thin layer over ``repro_torch.serve``,
the port of the JAX package's ``python -m repro.launch.serve``.

StoCFL serving = hold a ``ServerState``, route each client to its
cluster's personalized model (§4.4 inference: nearest cluster mean by Ψ
cosine, cached per client), then serve tokens. The engine lives in
``repro_torch.serve``: continuous batching over a fixed-slot decode state
(``ServeEngine``, the default) or the one-at-a-time loop
(``--sequential``, ``serve.SequentialLoop``). This module only builds
the state, fabricates a request stream, and times it — with the first
compile and capture SEPARATED from the timed region (a warmup wave at
identical shapes pays them; ``reset()`` keeps the captured graph and the
routing cache, then the timed wave runs capture-free).

It runs on the card unless ``--device cpu`` is given; with no GPU and no
``--device cpu`` it raises instead of running on the CPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --full \\
      --requests 8 --prompt-len 32 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --requests 4 --gen 8
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import engine, serve
from repro_torch.configs import get_config
from repro_torch.core.extractor import llm_leaf_filter
from repro_torch.data import synthetic_lm_batch
from repro_torch.engine.bank import ClusterBank
from repro_torch.launch import device_of
from repro_torch.models.registry import build
from repro_torch.sharding.specs import row_split


def build_parser() -> argparse.ArgumentParser:
    """The serve CLI: the reference's flags (``--smoke`` and ``--full``
    a mutually-exclusive pair, smoke the default) plus ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--smoke", dest="smoke", action="store_true",
                      help="smoke-sized config (default)")
    size.add_argument("--full", dest="smoke", action="store_false",
                      help="full-sized config")
    ap.set_defaults(smoke=True)
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--sequential", action="store_true",
                    help="serve one request at a time instead of continuous batching")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--clusters", type=int, default=2)
    ap.add_argument("--slots", type=int, default=4,
                    help="decode lanes per cluster group")
    ap.add_argument("--tau", type=float, default=0.3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap


def _generator(device, seed: int, k: int = -1) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, k): k = -1 for the
    anchor ω₀, k for cluster k's model (the reference folds k into its
    key)."""
    words = [seed] if k < 0 else [seed, k]
    return torch.Generator(device=device).manual_seed(
        int(np.random.SeedSequence(words).generate_state(1)[0]))


# Clients whose routing Ψ one call of the batched extractor takes
# (``EngineConfig.cohort_chunk``). Beside the serving state's three fp32
# qwen2-1.5b models (23.8 GB), a call holds about 8.4 GB a client (8 x 256
# tokens, fp32, remat, the vocab leaves sketched to 8192: 33.8 GB for 4 on
# an H100, chip_smoke.py phase 13a), so 4 clients put the phase's peak at
# 57.6 GB of the card's 80 and 8 would not fit.
ROUTE_CHUNK = 4


def build_server_state(cfg, model, clusters: int, tau: float, seed: int, device=None,
                       cohort_chunk: int = 0, mesh=None):
    """A serving ``ServerState`` on ``device``: K cluster models
    (stand-ins for a trained checkpoint — a real deployment would
    ``checkpoint.load_server_state`` here), each cluster's reference Ψ
    registered via the ``join`` transition so routing has real cluster
    means to cosine against. ``cohort_chunk`` bounds the clients of one
    batched Ψ call when a wave is routed (0: the whole wave at once).
    Under a client-axis ``mesh`` (``ServeEngine(mesh=...)``'s) the bank
    is placed: the rank makes only the models of its ``row_split`` of the
    sorted roots (``ClusterBank.placed``), while it still joins every
    cluster's client, so its router has all K cluster means."""
    dev = engine.resolve_device(device)
    params0 = model.init(_generator(dev, seed), dev)
    st = engine.init("stocfl", model.loss_fn, params0, [],
                     engine.EngineConfig(tau=tau, seed=seed, project_dim=8192,
                                         cohort_chunk=cohort_chunk),
                     device=dev, leaf_filter=llm_leaf_filter)
    roots = []
    for k in range(clusters):
        st, cid = engine.join(st, synthetic_lm_batch(cfg, 256, 8, seed=100 + k, domain=k))
        roots.append(st.client_root(cid))
    mine = set(row_split(len(set(roots)), mesh).take(sorted(set(roots))))
    cluster_models = {r: model.init(_generator(dev, seed, k), dev)
                      for k, r in enumerate(roots) if r in mine}
    return st.replace(models=ClusterBank.placed(cluster_models, roots, mesh))


def make_requests(cfg, n: int, prompt_len: int, gen: int, clusters: int,
                  seed_base: int = 0):
    """A synthetic request stream: request r comes from domain
    ``r % clusters`` with a domain-matched Ψ-routing history (the
    prompt alone is too thin to route on)."""
    reqs = []
    for r in range(n):
        dom = r % clusters
        prompt = np.asarray(synthetic_lm_batch(cfg, prompt_len, 1, seed=seed_base + r,
                                               domain=dom)["tokens"][0], np.int32)
        hist = synthetic_lm_batch(cfg, 256, 8, seed=1000 + seed_base + r, domain=dom)
        reqs.append(serve.Request(rid=seed_base + r, client_id=f"client-{seed_base + r}",
                                  prompt=prompt, gen=gen, history=hist))
    return reqs


def _clock(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.time()


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = device_of(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build(cfg)
    st = build_server_state(cfg, model, args.clusters, args.tau, args.seed, device=dev,
                            cohort_chunk=ROUTE_CHUNK)
    max_len = args.prompt_len + args.gen

    if args.sequential:
        loop = serve.SequentialLoop(model, st, max_len=max_len, max_gen=args.gen)
        warm = make_requests(cfg, 1, args.prompt_len, args.gen, args.clusters,
                             seed_base=10_000)
        t0 = _clock(dev)
        loop.serve(warm[0])                       # pays every first call
        first_compile_s = _clock(dev) - t0
        reqs = make_requests(cfg, args.requests, args.prompt_len, args.gen, args.clusters)
        t0 = _clock(dev)
        results = [loop.serve(r) for r in reqs]
        wall = _clock(dev) - t0
        mode, stats = "sequential", {"router_hits": loop.router.hits,
                                     "router_misses": loop.router.misses}
    else:
        eng = serve.ServeEngine(model, st, serve.ServeConfig(
            slots=args.slots, max_len=max_len, max_gen=args.gen))
        warm = make_requests(cfg, min(args.requests, args.slots), args.prompt_len,
                             args.gen, args.clusters, seed_base=10_000)
        t0 = _clock(dev)
        eng.submit_many(warm)
        eng.run()                                 # pays the capture
        first_compile_s = _clock(dev) - t0
        eng.reset()                               # keeps the captured graph
        reqs = make_requests(cfg, args.requests, args.prompt_len, args.gen, args.clusters)
        t0 = _clock(dev)
        eng.submit_many(reqs)
        results = list(eng.run().values())
        wall = _clock(dev) - t0
        mode, stats = "continuous", eng.stats()

    for res in sorted(results, key=lambda r: r.rid):
        print(f"req {res.rid}: cluster={res.cluster} "
              f"(cos={res.similarity:.3f}) "
              f"tokens={[int(t) for t in res.tokens[:8]]}...")
    n_tokens = sum(len(r.tokens) for r in results)
    print(json.dumps({"mode": mode, "requests": len(results),
                      "tokens": n_tokens,
                      "first_compile_s": round(first_compile_s, 2),
                      "wall_s": round(wall, 4),
                      "tok_per_s": round(n_tokens / max(wall, 1e-9), 2),
                      **stats}))


if __name__ == "__main__":
    main()
