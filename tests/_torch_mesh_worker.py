"""One rank of a ``gloo`` world on the CPU for ``tests/test_torch_mesh.py``.

    python tests/_torch_mesh_worker.py RANK WORLD ROOT

Joins the world through a ``FileStore`` under ``ROOT``, builds
``make_client_mesh(device="cpu")`` and drives the port's engine through
every case the test holds (each strategy's eager rounds and
``run_rounds`` spans, churn, a checkpoint resumed across world sizes, a
cohort that does not divide, a ragged arena, async rounds,
``psum_segments``), writing a snapshot of the state after every round or
span, and the number of ``all_reduce`` calls of the main cases, to
``ROOT/w{WORLD}_r{RANK}.pkl``. The world of one also runs every
case without a mesh, the reference the test holds the meshes to. The
inputs (federations, ω₀, IFCA's hypotheses) come as numpy arrays from
``ROOT/inputs.pkl``, made by the test with the JAX package; this process
imports only torch and the port.
"""
import datetime
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import engine
from repro_torch.checkpoint import load_server_state, save_server_state
from repro_torch.launch.mesh import make_client_mesh
from repro_torch.models import simple
from repro_torch.sharding import specs

ALL = ("stocfl", "fedavg", "fedprox", "ditto", "ifca", "cfl")
TASK = simple.TaskConfig("synth_mlp", "mlp", (64,), 10, hidden=32)
CHURN = ("stocfl", "fedavg", "ditto")
CKPT = ("stocfl", "ditto", "cfl")
NONDIV = ("fedavg", "stocfl")
ASYNC = ("stocfl", "fedavg")


def loss(p, b):
    return simple.loss_fn(p, b, TASK)


def cfg(name, scan=True):
    kw = dict(lr=0.1, local_steps=2, sample_rate=0.5, seed=0, rng_backend="device")
    if name == "stocfl":
        kw.update(tau=0.3, cluster_backend="device" if scan else "numpy")
    if name == "ifca":
        kw.update(n_models=3)
    if name == "cfl":
        kw.update(sample_rate=1.0, eps_rel=0.9, eps2=1e-4)
    return engine.EngineConfig(**kw)


def snapshot(st) -> dict:
    """The state as numpy and plain Python values."""
    flat = lambda tree: {k: v.detach().cpu().numpy() for k, v in tree.items()}
    out = {"round": st.round, "left": sorted(st.left), "members": st.members,
           "history": [{k: v for k, v in r.items() if k != "merges"} for r in st.history],
           "omega": flat(st.omega),
           "models": {int(r): flat(st.models[r]) for r in st.models.roots},
           "personal": {int(c): flat(m) for c, m in st.personal.items()},
           "rng_key": None if st.rng_key is None else st.rng_key.cpu().numpy()}
    if st.clusters is not None:
        out["assignment"] = st.clusters.assignment()
        out["seen"] = sorted(st.clusters.seen)
        if hasattr(st.clusters, "arrays"):
            a = st.clusters.arrays()
            out["reps"] = {int(c): np.asarray(a["rep"])[c] for c in st.clusters.seen}
        else:
            out["reps"] = {int(c): st.clusters.reps[c].cpu().numpy()
                           for c in st.clusters.seen}
    return out


class Runner:
    def __init__(self, inputs):
        self.inputs = inputs

    def init(self, name, mesh, clients="clients", scan=True):
        params = {k: torch.as_tensor(v) for k, v in self.inputs["params"].items()}
        st = engine.init(name, loss, params, list(self.inputs[clients]), cfg(name, scan),
                         device="cpu", arena=True, mesh=mesh)
        if name == "ifca":
            st = st.replace(models=engine.ClusterBank.from_dict(
                {m: {k: torch.as_tensor(v) for k, v in tree.items()}
                 for m, tree in self.inputs["ifca"].items()}))
        return st

    def eager(self, name, mesh):
        st, snaps = self.init(name, mesh, scan=False), []
        for _ in range(3):
            st, _ = engine.run_round(st)
            snaps.append(snapshot(st))
        return snaps

    def scan(self, name, mesh):
        st = engine.run_rounds(self.init(name, mesh), 2)
        snaps = [snapshot(st)]
        st = engine.run_rounds(st, 3)
        return snaps + [snapshot(st)]

    def churn(self, name, mesh):
        st = engine.run_rounds(self.init(name, mesh, clients="churn"), 2)
        snaps = [snapshot(st)]
        extra = {k: torch.as_tensor(v) for k, v in self.inputs["extra"].items()}
        st, _ = engine.join(st, extra)
        st = engine.run_rounds(st, 2)
        snaps.append(snapshot(st))
        st = engine.leave(st, 3)
        st = engine.run_rounds(st, 2)
        return snaps + [snapshot(st)]

    def nondiv(self, name, mesh):
        return [snapshot(engine.run_rounds(self.init(name, mesh, clients="ten"), 4))]

    def ragged(self, mesh):
        return [snapshot(engine.run_rounds(self.init("fedavg", mesh, clients="ragged"), 4))]

    def async_rounds(self, name, mesh):
        st, snaps = self.init(name, mesh, scan=False), []
        for delays in ([0, 1, 0, 2, 0, 1, 0, 1], 0, [1, 0, 0, 0, 0, 0, 0, 0], 0):
            st, _ = engine.run_round_async(st, delays=delays)
            snaps.append(snapshot(st))
        return snaps


def main() -> int:
    rank, world, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(root, f"store{world}"),
                                                         world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    mesh = make_client_mesh(device="cpu")
    with open(os.path.join(root, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    run = Runner(inputs)
    out = {}

    # every all_reduce the engine makes, counted per case
    calls, real = [0], specs.all_reduce_

    def counting(t, m):
        calls[0] += 1
        return real(t, m)

    specs.all_reduce_ = counting

    def record(key, fn, *args):
        before = calls[0]
        out[key] = fn(*args)
        out[key + "/collectives"] = calls[0] - before

    meshes = [("mesh", mesh)] + ([("nomesh", None)] if world == 1 else [])
    for tag, m in meshes:
        for name in ALL:
            record(f"eager/{name}/{tag}", run.eager, name, m)
            record(f"scan/{name}/{tag}", run.scan, name, m)
        for name in CHURN:
            out[f"churn/{name}/{tag}"] = run.churn(name, m)
        for name in NONDIV:
            record(f"nondiv/{name}/{tag}", run.nondiv, name, m)
        for name in ASYNC:
            out[f"async/{name}/{tag}"] = run.async_rounds(name, m)
        out[f"ragged/{tag}"] = run.ragged(m)

    # a checkpoint saved after 2 rounds at the previous world size (this
    # one for a world of one), resumed here for 3 more
    prev = {1: 1, 2: 1, 4: 2}[world]
    for name in CKPT:
        st = engine.run_rounds(run.init(name, mesh), 2)
        save_server_state(os.path.join(root, f"ck_{name}_w{world}"), st)
        src = os.path.join(root, f"ck_{name}_w{prev}")
        resumed = load_server_state(src, run.init(name, mesh))
        out[f"ckpt/{name}/mesh"] = [snapshot(engine.run_rounds(resumed, 3))]
        if world == 1:
            resumed = load_server_state(src, run.init(name, None))
            out[f"ckpt/{name}/nomesh"] = [snapshot(engine.run_rounds(resumed, 3))]

    p = inputs["psum"]
    x = {k: torch.as_tensor(v) for k, v in p["stacked"].items()}
    got = specs.psum_segments(x, torch.as_tensor(p["weights"]),
                              torch.as_tensor(p["seg"]), 4, mesh)
    out["psum"] = {k: v.numpy() for k, v in got.items()}
    rows = world + 1 if world > 1 else 3
    odd = torch.arange(rows * 2, dtype=torch.float32).reshape(rows, 2)
    out["psum_fallback"] = specs.psum_segments(odd, torch.ones(rows), torch.zeros(
        rows, dtype=torch.int64), 2, mesh).numpy()
    out["split"] = [(r.lo, r.hi, r.sharded) for r in (specs.row_split(12, mesh),
                                                      specs.row_split(5, mesh))]
    rows = torch.arange(4 * world + 1, dtype=torch.float32)[:, None].expand(-1, 3)
    out["place"] = [specs.place_cohort(rows[:4 * world].contiguous(), mesh).numpy(),
                    specs.place_cohort(rows.contiguous(), mesh).numpy()]

    with open(os.path.join(root, f"w{world}_r{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
