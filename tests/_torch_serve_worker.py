"""One rank of a ``gloo`` world on the CPU for ``tests/test_torch_serve_mesh.py``.

    python tests/_torch_serve_worker.py RANK WORLD ROOT K

Joins the world through a ``FileStore`` under ``ROOT``, builds the same
serving state on every rank from ``ROOT/reference_{K}.pkl``, the JAX
package's state as the test wrote it (qwen2 smoke in fp32: ω₀, the Ψ
sketch's draws, and a model per cluster root; K clients of K token
domains joined, so K clusters), its bank placed on the mesh as
``launch.serve.build_server_state(..., mesh=...)`` places it (from the
rank's own groups' models alone, ``ClusterBank.placed``), and serves it
with ``ServeEngine(mesh=make_client_mesh(device="cpu"))``: a wave of
requests, an eviction mid-run, then ``reset`` and the first wave again
under new request ids. It also saves the whole state and serves the first
wave again from ``checkpoint.load_server_state(..., mesh=...)``. Rank 0
also serves the waves with the engine without a mesh and with
``SequentialLoop`` (the gaps of the near-tie rule). Every rank writes its
results, stats, routes, the number of cluster groups it holds and what
its bank holds to ``ROOT/serve_{WORLD}_{K}_r{RANK}.pkl``. Imports only torch and
the port; the test imports it for the inputs and the wave driver.
"""
import datetime
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert, engine, serve
from repro_torch.checkpoint import load_server_state, save_server_state
from repro_torch.configs import get_config
from repro_torch.core import extractor
from repro_torch.data import synthetic_lm_batch
from repro_torch.engine.bank import ClusterBank, RemoteRowError
from repro_torch.launch.mesh import make_client_mesh
from repro_torch.models.registry import build
from repro_torch.sharding import specs
from repro_torch.utils import trees

P, G, HIST_S, HIST_B, N_REQ = 8, 5, 64, 2, 8
GENS = (5, 1, 3, 5, 4, 2, 5, 3)
SLOTS = 2
ENGINE_CFG = dict(tau=0.3, seed=0, project_dim=4096)


def config():
    return get_config("qwen2-1.5b", smoke=True).with_(dtype="float32")


def joined(cfg, k):
    """The history batch of the client that founds cluster ``k``."""
    return synthetic_lm_batch(cfg, HIST_S, HIST_B, seed=100 + k, domain=k)


def fresh_state(model, ref):
    """``engine.init`` of the serving state, before any join, with the
    sketch's draws of ``ref`` (``extractor.jl_draws`` answers from them)."""
    def jl_draws(n, dim, seed):
        buckets, signs = ref["draws"][(n, dim, seed)]
        return torch.as_tensor(buckets), torch.as_tensor(signs)

    extractor.jl_draws = jl_draws
    return engine.init("stocfl", model.loss_fn, convert.to_torch(ref["init"]), [],
                       engine.EngineConfig(**ENGINE_CFG), device="cpu")


def state_of(model, k_groups, ref):
    """The port's state from the reference's pieces ``ref``: ω₀, the
    sketch's draws, K joined clients (one per domain), and the reference's
    model per root."""
    st = fresh_state(model, ref)
    cids = []
    for k in range(k_groups):
        st, cid = engine.join(st, joined(model.cfg, k))
        cids.append(cid)
    roots = sorted({st.client_root(c) for c in cids})
    assert roots == sorted(ref["models"]), (roots, sorted(ref["models"]))
    models = {r: convert.to_torch(m) for r, m in ref["models"].items()}
    return st.replace(models=ClusterBank.from_dict(models))


def requests(cfg, k_groups, base=0):
    out = []
    for i in range(N_REQ):
        prompt = np.asarray(synthetic_lm_batch(cfg, P, 1, seed=i, domain=i % k_groups)
                            ["tokens"][0], np.int32)
        hist = synthetic_lm_batch(cfg, HIST_S, HIST_B, seed=1000 + i, domain=i % k_groups)
        out.append(serve.Request(rid=base + i, client_id=f"c{i}", prompt=prompt,
                                 gen=GENS[i], history=hist))
    return out


def flat(results):
    return {rid: (int(r.cluster), float(r.similarity), bool(r.accepted),
                  np.asarray(r.tokens), bool(r.evicted)) for rid, r in results.items()}


def waves(eng, reqs_of):
    """Wave 1, an eviction mid-run, then reset and wave 1 again: the same
    calls on either package's engine. ``reqs_of(base)`` is the wave with
    request ids from ``base``."""
    routes = eng.submit_many(reqs_of(0))
    first = flat(eng.run())
    stats = eng.stats()
    eng.reset()
    eng.submit_many(reqs_of(100)[:3])
    eng._admit_all()
    eng._decode_burst(2)
    eng.sched.tick(2)
    evicted = flat({100: eng.evict(100)})
    rest = flat(eng.run())
    eng.reset()
    eng.submit_many(reqs_of(200))
    second = flat(eng.run())
    return {"first": first, "stats": stats, "routes": [(rt.root, rt.similarity, rt.accepted)
                                                       for rt in routes],
            "evicted": evicted, "rest": rest, "second": second, "stats2": eng.stats()}


def placed_state(state, mesh):
    """``state`` with its bank placed on ``mesh`` from this rank's groups'
    models alone, as ``launch.serve.build_server_state`` builds it."""
    roots = sorted(state.models.roots)
    mine = specs.row_split(len(roots), mesh).take(roots)
    return state.replace(models=ClusterBank.placed({r: state.models[r] for r in mine},
                                                   roots, mesh))


def bank_of(state) -> dict:
    """What a (placed) bank holds: its rows, the roots it holds, and the
    error ``cluster_model`` raises for each root another rank holds."""
    bank, remote = state.models, {}
    for r in bank.roots:
        if not bank.holds(r):
            try:
                state.cluster_model(r)
                remote[r] = None
            except RemoteRowError as err:
                remote[r] = str(err)
    return {"rows": int(trees.leaves(bank.stacked)[0].shape[0]),
            "holds": [r for r in bank.roots if bank.holds(r)], "remote": remote}


def engine_of(model, state, mesh):
    return serve.ServeEngine(model, state, serve.ServeConfig(slots=SLOTS, max_len=P + G,
                                                             max_gen=G), mesh=mesh)


def serve_waves(model, state, k_groups, mesh):
    """``waves`` on the port's engine, with the groups it holds."""
    eng = engine_of(model, state, mesh)
    out = waves(eng, lambda base: requests(model.cfg, k_groups, base))
    out["held"] = [int(trees.leaves(eng._stacked)[0].shape[0]),
                   int(trees.leaves(eng.sl.caches)[0].shape[0]), int(eng.sl.out.shape[0])]
    return out


def main() -> int:
    rank, world, root, k_groups = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4])
    torch.set_num_threads(1)
    tag = f"{world}_{k_groups}"
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(root, f"store_{tag}"),
                                                         world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    with open(os.path.join(root, f"reference_{k_groups}.pkl"), "rb") as f:
        ref = pickle.load(f)
    model = build(config())
    state = state_of(model, k_groups, ref)
    mesh = make_client_mesh(device="cpu")
    placed = placed_state(state, mesh)
    out = {"mesh": serve_waves(model, placed, k_groups, mesh),
           "groups": len(state.models.keys()), "bank": bank_of(placed)}
    # the whole state saved, loaded back onto a fresh state with only this
    # rank's rows, and its first wave served
    ck = os.path.join(root, f"ck_{tag}_r{rank}")
    save_server_state(ck, state)
    loaded = load_server_state(ck, fresh_state(model, ref), mesh=mesh)
    eng = engine_of(model, loaded, mesh)
    routes = eng.submit_many(requests(model.cfg, k_groups))
    out["loaded"] = {"first": flat(eng.run()), "bank": bank_of(loaded),
                     "routes": [(rt.root, rt.similarity, rt.accepted) for rt in routes]}
    if rank == 0:
        out["nomesh"] = serve_waves(model, state, k_groups, None)
        loop = serve.SequentialLoop(model, state, max_len=P + G, max_gen=G)
        out["gaps"] = {r.rid: np.asarray(loop.serve(r).gaps)
                       for r in requests(model.cfg, k_groups)}
    with open(os.path.join(root, f"serve_{tag}_r{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
