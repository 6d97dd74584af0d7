"""End-to-end training driver on the functional engine API, the port of
the JAX package's ``python -m repro.launch.train``.

Any registered strategy (stocfl, fedavg, fedprox, ditto, ifca, cfl) runs
through the same ``engine.init -> engine.run_round`` loop; StoCFL adds
clustering metrics, checkpointing of the full ``ServerState`` (the
reference's file format, ``repro_torch.checkpoint``), and §4.4
inference. ``--churn`` swaps the static loop for the §5
dynamic-federation simulator (``repro_torch.sim``): Poisson joins,
leaves and stragglers or a replayed JSON trace, e.g.

      PYTHONPATH=src python -m repro_torch.launch.train --setting rotated \\
          --rounds 50 --arena --churn join=1.0,leave=0.5,straggle=0.1

Two modes:
  classification (paper-faithful, default): cross-device federation on a
    synthetic Non-IID setting with the paper's MLP task model.

      PYTHONPATH=src python -m repro_torch.launch.train --setting rotated \\
          --rounds 100 --algo stocfl

  LLM: federated pretraining of an assigned architecture (reduced via
    --smoke) on domain-clustered synthetic token streams.

      PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --smoke \\
          --rounds 10 --clients 8 --domains 2

It runs on the card unless ``--device cpu`` is given; with no GPU and no
``--device cpu`` it raises instead of running on the CPU. ``--mesh``
splits each cohort over a ``("clients",)`` mesh of the default process
group's ranks (``launch.mesh.make_client_mesh``), one process per rank;
the multi-GPU entry point is

      torchrun --standalone --nproc_per_node N -m repro_torch.launch.train --mesh ...

and without ``torchrun`` it is a world of one. Only rank 0 prints.
``--compile-cache`` is the reference's flag for a part not ported yet
(ROADMAP.md queue 1 item 1); it raises ``NotImplementedError``.
Parameters are drawn with ``torch.Generator``, so for one seed they are
not the reference's ``jax.random`` draws.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import engine
from repro_torch.checkpoint import save_server_state, wait_pending
from repro_torch.configs import get_config
from repro_torch.core import adjusted_rand_index
from repro_torch.core.extractor import llm_leaf_filter
from repro_torch.data import make_federation, synthetic_lm_batch
from repro_torch.launch import device_of
from repro_torch.launch.mesh import make_client_mesh
from repro_torch.models import simple
from repro_torch.models.registry import build
from repro_torch.sharding import specs as shard_specs
from repro_torch.utils.logging import process_rank


def _say(*args, **kw) -> None:
    """``print`` on rank 0 only (every process is rank 0 without a group)."""
    if process_rank() == 0:
        print(*args, **kw)


def _mesh_and_device(args):
    """``(mesh or None, device)``: under ``--mesh`` the rank's device."""
    if not args.mesh:
        return None, device_of(args.device)
    mesh = make_client_mesh(device=args.device)
    return mesh, shard_specs.mesh_device(mesh)


def _generator(dev, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def _engine_cfg(args) -> engine.EngineConfig:
    cluster_backend = args.cluster_backend
    rng_backend = "numpy"
    if getattr(args, "scan_rounds", False):
        # the captured loop needs device sampling; StoCFL additionally
        # needs the device partition (run_rounds preconditions)
        rng_backend = "device"
        if args.algo == "stocfl" and cluster_backend != "device":
            _say("--scan-rounds: forcing --cluster-backend device")
            cluster_backend = "device"
    async_cfg = None
    if getattr(args, "async_mode", False):
        async_cfg = engine.AsyncConfig(staleness_decay=args.staleness_decay,
                                       staleness_cap=args.staleness_cap)
    return engine.EngineConfig(
        tau=args.tau, lam=args.lam, lr=args.lr, local_steps=args.local_steps,
        sample_rate=1.0 if args.algo == "cfl" else args.sample_rate,
        seed=args.seed, mu=args.lam, cohort_chunk=args.cohort_chunk,
        cluster_backend=cluster_backend, rng_backend=rng_backend,
        fused_step=args.fused_step, dtype=args.dtype, async_cfg=async_cfg)


def _churn_timeline(args, n_clusters: int):
    """The --churn Timeline (trace path or Poisson spec) plus the
    setting's client factory for Join events."""
    from repro_torch.data.synthetic import SETTING_FACTORIES
    from repro_torch.sim import Timeline
    tl = Timeline.from_spec(args.churn, rounds=args.rounds, seed=args.seed,
                            n_clusters=n_clusters)
    factory = None
    if args.setting in SETTING_FACTORIES:
        factory = SETTING_FACTORIES[args.setting](n_clusters=n_clusters, seed=args.seed)
    elif any(k == "join" for k in tl.counts()):
        raise SystemExit(f"--churn with joins needs a client factory; "
                         f"setting {args.setting!r} has none "
                         f"(see repro_torch.data.synthetic.SETTING_FACTORIES)")
    return tl, factory


def run_classification(args) -> dict:
    mesh, dev = _mesh_and_device(args)
    clients, true_cluster, test_sets = make_federation(
        args.setting, n_clients=args.clients, seed=args.seed)

    task = simple.SYNTH_MLP if args.task == "synth_mlp" else simple.MNIST_MLP
    params = simple.init(_generator(dev, args.seed), task, device=dev)
    loss = lambda p, b: simple.loss_fn(p, b, task)
    evalf = lambda p, b: simple.accuracy(p, b, task)

    t0 = time.time()
    arena = args.arena or args.scan_rounds   # the captured loop gathers from the arena
    st = engine.init(args.algo, loss, params, clients, _engine_cfg(args),
                     eval_fn=evalf, device=dev, arena=arena, mesh=mesh)
    out = {"algo": args.algo, "rounds": args.rounds}
    log_every = max(args.rounds // 10, 1)
    if args.churn:
        from repro_torch.sim import simulate
        tl, factory = _churn_timeline(args, n_clusters=len(test_sets))
        st, log = simulate(st, tl, rounds=args.rounds, client_factory=factory,
                           seed=args.seed, cohort_quantum=args.cohort_quantum,
                           eval_every=log_every, test_sets=test_sets,
                           true_cluster=true_cluster, scan_spans=args.scan_rounds,
                           async_mode=args.async_mode)
        out["churn"] = {"timeline": tl.counts(), "joined": len(log.joined),
                        "departed": len(log.departed),
                        "final_gap": log.records[-1].get("gap")}
        # joined clients need latent-cluster labels for evaluate()
        true_cluster = list(true_cluster) + [
            log.joined[cid] if log.joined[cid] is not None else -1
            for cid in sorted(log.joined)]
        if args.save_log:
            with open(args.save_log, "w") as f:
                json.dump(log.to_json(), f, indent=1)
    elif args.async_mode:
        for t in range(args.rounds):
            st, rec = engine.run_round_async(st)
            if t % log_every == 0:
                _say(f"round {t}: {rec}")
    elif args.scan_rounds:
        st = engine.run_rounds(st, args.rounds)   # one captured round body, replayed
        for t, rec in enumerate(st.history):
            if t % log_every == 0:
                _say(f"round {t}: {rec}")
    else:
        st = engine.run(st, args.rounds, log_every=log_every if process_rank() == 0 else 0)
    res = engine.evaluate(st, test_sets, true_cluster)
    out.update({"cluster_avg_acc": res["cluster_avg"],
                "wall_s": round(time.time() - t0, 1)})
    if st.clusters is not None:
        assign = st.clusters.assignment()
        ids = sorted(assign)
        out["ari"] = adjusted_rand_index([assign[c] for c in ids],
                                         [true_cluster[c] for c in ids])
        out["n_clusters"] = st.clusters.n_clusters()
        out["global_avg_acc"] = res["global_avg"]
    if args.save:
        # the JSON summary below overlaps the checkpoint write;
        # wait_pending() waits for it before returning
        save_server_state(args.save, st, block=False)
    _say(json.dumps(out, indent=1))
    wait_pending()
    return out


def run_llm(args) -> dict:
    mesh, dev = _mesh_and_device(args)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build(cfg)
    clients, true_cluster = [], []
    for i in range(args.clients):
        dom = i % args.domains
        clients.append(synthetic_lm_batch(cfg, args.seq_len, args.batch, seed=i, domain=dom))
        true_cluster.append(dom)

    params = model.init(_generator(dev, args.seed), dev)
    ecfg = engine.EngineConfig(tau=args.tau, lam=args.lam, lr=args.lr,
                               local_steps=args.local_steps,
                               sample_rate=args.sample_rate, seed=args.seed,
                               project_dim=8192, cohort_chunk=args.cohort_chunk,
                               cluster_backend=args.cluster_backend,
                               fused_step=args.fused_step, dtype=args.dtype)
    st = engine.init("stocfl", model.loss_fn, params, clients, ecfg, device=dev,
                     leaf_filter=llm_leaf_filter, arena=args.arena, mesh=mesh)
    t0 = time.time()
    for t in range(args.rounds):
        st, rec = engine.run_round(st)
        with torch.no_grad():
            loss0 = float(model.loss_fn(st.omega, st.ctx.clients[0]))
        _say(f"round {t}: clusters={rec['n_clusters']} omega_loss={loss0:.4f}")
    assign = st.clusters.assignment()
    ids = sorted(assign)
    ari = adjusted_rand_index([assign[c] for c in ids], [true_cluster[c] for c in ids])
    out = {"arch": cfg.name, "ari": ari, "n_clusters": st.clusters.n_clusters(),
           "rounds": args.rounds, "wall_s": round(time.time() - t0, 1)}
    if args.save:
        save_server_state(args.save, st, block=False)
    _say(json.dumps(out, indent=1))
    wait_pending()
    return out


def build_parser() -> argparse.ArgumentParser:
    """The reference's flags and defaults, plus ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--setting", default="rotated",
                    choices=["pathological", "rotated", "shifted", "hybrid", "femnist"])
    ap.add_argument("--task", default="synth_mlp")
    ap.add_argument("--algo", default="stocfl", choices=sorted(engine.list_strategies()))
    ap.add_argument("--arch", default=None, help="LLM mode: assigned arch id")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mesh", action="store_true",
                    help="split each cohort over a (\"clients\",) mesh of the process "
                         "group's ranks (torchrun --nproc_per_node N; a world of one "
                         "without torchrun)")
    ap.add_argument("--arena", action="store_true",
                    help="pack client shards into a device-resident arena "
                         "(cohort = one gather instead of a per-round restack)")
    ap.add_argument("--cluster-backend", default="numpy", choices=["numpy", "device"],
                    help="StoCFL partition backend: host ClusterState or the "
                         "device union-find (core.device_clustering)")
    ap.add_argument("--scan-rounds", action="store_true",
                    help="run the round loop through engine.run_rounds (one "
                         "round body captured as a CUDA graph on the card and "
                         "replayed; a loop on the CPU): on-device cohort "
                         "sampling; implies --arena and rng_backend=device (and "
                         "cluster-backend device for stocfl). Under --churn, "
                         "event-free spans are replayed (sim scan_spans)")
    ap.add_argument("--cohort-chunk", type=int, default=0,
                    help="max clients per cohort step; larger cohorts run in "
                         "chunks with flat memory (0 = unchunked)")
    ap.add_argument("--fused-step", action="store_true",
                    help="route the bilevel inner step through the fused prox "
                         "kernel (kernels.prox_update: one flat in-place update "
                         "instead of a per-leaf chain); its plain version off "
                         "the card, bitwise-identical in fp32")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                    help="compute dtype for client params/grads/batches; "
                         "Psi-embeddings, cluster means and the Eq. 2 "
                         "objective always stay float32")
    ap.add_argument("--compile-cache", nargs="?", const="auto", default=None,
                    metavar="DIR",
                    help="persist compiled programs to DIR (not ported yet: "
                         "raises, ROADMAP.md queue 1 item 1)")
    ap.add_argument("--async", dest="async_mode", action="store_true",
                    help="async buffered aggregation (engine.run_round_async): "
                         "delayed client deltas land in a device-resident buffer "
                         "and flush as staleness-weighted merges; bitwise equal "
                         "to the sync loop at zero delay. Supported by "
                         "stocfl/fedavg/fedprox; under --churn, Straggle victims "
                         "report back late instead of dropping")
    ap.add_argument("--staleness-decay", type=float, default=1.0,
                    help="async merge-weight decay (weight = count * "
                         "decay^staleness; 1.0 = pure count weighting)")
    ap.add_argument("--staleness-cap", type=int, default=4,
                    help="max rounds a buffered delta may age before it is "
                         "dropped instead of merged")
    ap.add_argument("--churn", default=None,
                    help="dynamic-federation mode (§5): a JSON trace path, or "
                         "Poisson churn 'join=2.0,leave=1.5,straggle=0.1' "
                         "(see repro_torch.sim.Timeline.from_spec)")
    ap.add_argument("--cohort-quantum", type=int, default=0,
                    help="under --churn, truncate each cohort to a multiple of "
                         "this (0 = off)")
    ap.add_argument("--save-log", default=None,
                    help="under --churn, write the per-round simulator log "
                         "(SimLog.to_json) to this path")
    ap.add_argument("--clients", type=int, default=80)
    ap.add_argument("--domains", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--tau", type=float, default=0.5)
    ap.add_argument("--lam", type=float, default=0.05)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--local-steps", type=int, default=5)
    ap.add_argument("--sample-rate", type=float, default=0.2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.async_mode and args.scan_rounds:
        raise SystemExit("--async is host-orchestrated (the delta buffer "
                         "bookkeeping lives on the host) and cannot be "
                         "combined with --scan-rounds")
    if args.compile_cache is not None:
        raise NotImplementedError("--compile-cache: a persistent compilation cache is "
                                  "not ported yet: ROADMAP.md queue 1 item 1")
    owns_group = args.mesh and not torch.distributed.is_initialized()
    try:
        return run_llm(args) if args.arch else run_classification(args)
    finally:
        if owns_group and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
