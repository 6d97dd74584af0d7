"""One rank of a ``gloo`` world on the CPU for ``tests/test_torch_mesh.py``.

    python tests/_torch_mesh_worker.py RANK WORLD ROOT [main|owned]

Joins the world through a ``FileStore`` under ``ROOT``, builds
``make_client_mesh(device="cpu")`` and drives the port's engine through
the cases the test holds. ``main`` (the default): each strategy's eager
rounds and ``run_rounds`` spans, churn, a checkpoint resumed across
world sizes, a cohort that does not divide, a ragged arena, async
rounds, a churn cycle that grows and compacts the arena,
``psum_segments``. ``owned``: async rounds whose buffer grows, loses a
departed client's entry, flushes and is checkpointed and resumed, its
rows on their owners. It writes a snapshot of the state after every
round or span, the number of ``all_reduce`` calls of the main cases
(those that move the arena's rows between their owners counted apart),
StoCFL's Ψ calls beside the new clients of the rank's slice of each
cohort, and which arena rows the rank holds, to
``ROOT/{MODE}_w{WORLD}_r{RANK}.pkl``. The world of one also runs every
case without a mesh, the reference the test holds the meshes to. The
inputs (federations, ω₀, IFCA's hypotheses) come as numpy arrays from
``ROOT/inputs.pkl``, made by the test with the JAX package; this process
imports only torch and the port.
"""
import contextlib
import dataclasses
import datetime
import os
import pickle
import sys
import zipfile

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
CYCLE = ("stocfl", "fedavg")
CYCLE_LEAVES = (0, 2, 4, 6, 8, 10, 12, 14, 1, 3)   # the 10th compacts 18 rows
CKPT = ("stocfl", "ditto", "cfl")
NONDIV = ("fedavg", "stocfl")
ASYNC = ("stocfl", "fedavg")
# buffered rounds over a buffer of 8 rows: round 0 fills it, round 1's
# dispatch doubles it before the first flush merges (every 2nd round), and
# the first cohort member leaves with its row in flight
OWNED_CFG = dict(buffer_capacity=8, flush_every=2, staleness_cap=4)
OWNED_DELAYS = ([0, 1, 0, 2, 0, 1, 0, 1], [1, 0, 0, 0, 2, 0, 0, 0], [0, 2, 0, 0, 1, 0, 0, 0])


def loss(p, b):
    return simple.loss_fn(p, b, TASK)


def cfg(name, scan=True, **extra):
    kw = dict(lr=0.1, local_steps=2, sample_rate=0.5, seed=0, rng_backend="device", **extra)
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


def layout(arena) -> dict:
    """The arena rows this rank holds: ``{cid: (global row, {leaf: data})}``
    for the live clients whose rows it owns, with its row counts."""
    own = arena.owners
    live = {int(c) for c in arena._live()}
    rows = {}
    for cid in sorted(live):
        row = int(arena.rows[cid])
        if own.mine(row):
            j = own.local(row)
            rows[cid] = (row, {k: v[j].cpu().numpy() for k, v in arena.packed.items()})
    return {"held": arena.held, "capacity": arena.capacity, "n_rows": arena.n_rows,
            "live": sorted(live), "rows": rows, "mask_rows": int(arena.mask.shape[0])}


@contextlib.contextmanager
def recording_writes():
    """Within the block, every ``AsyncBuffer.write`` / ``write_psi`` call's
    slots and rows, the cohort's rows gathered whole from every rank's
    slice (a collective), as numpy, appended to the yielded list."""
    from repro_torch.engine.async_agg import AsyncBuffer
    real_write, real_psi, writes = AsyncBuffer.write, AsyncBuffer.write_psi, []
    flat = lambda tree: {k: v.numpy() for k, v in
                         (tree.items() if isinstance(tree, dict) else [("", tree)])}

    def write(self, slots, payload, aux=None, split=None):
        whole = lambda t: t if split is None or not split.sharded else split.gather(t)
        writes.append((np.asarray(slots), {"payload": flat(whole(payload))}
                       | ({} if aux is None else {"aux": flat(whole(aux))})))
        return real_write(self, slots, payload, aux, split)

    def write_psi(self, slots, rows):
        writes.append((np.asarray(slots), {"psi": flat(rows.to(torch.float32))}))
        return real_psi(self, slots, rows)

    AsyncBuffer.write, AsyncBuffer.write_psi = write, write_psi
    try:
        yield writes
    finally:
        AsyncBuffer.write, AsyncBuffer.write_psi = real_write, real_psi


def buffer_rows(buf) -> dict:
    """What a rank holds of the async buffer (its rows and their bytes, the
    capacity, the entries) and the whole buffer, gathered from every rank's
    rows (a collective: every rank calls it)."""
    flat = lambda tree: {k: v.numpy() for k, v in
                         (tree.items() if isinstance(tree, dict) else [("", tree)])}
    comps = lambda b: {c: flat(getattr(b, c)) for c in ("payload", "aux", "psi")
                       if getattr(b, c) is not None}
    return {"held": buf.held, "capacity": buf.capacity, "nbytes": buf.nbytes,
            "entries": [tuple(e) for e in buf.entries], "mine": comps(buf),
            "whole": comps(buf.gathered())}


def counting_psi(st):
    """``st``'s context with its Ψ counting its calls in ``calls[0]``."""
    calls, real = [0], st.ctx.extractor

    def psi(batch):
        calls[0] += 1
        return real(batch)

    st.ctx.extractor = psi
    return calls


class Runner:
    def __init__(self, inputs):
        self.inputs = inputs
        self.psi = {}       # StoCFL's Ψ calls (and what they should be) by case

    def init(self, name, mesh, clients="clients", scan=True, **extra):
        params = {k: torch.as_tensor(v) for k, v in self.inputs["params"].items()}
        st = engine.init(name, loss, params, list(self.inputs[clients]),
                         cfg(name, scan, **extra),
                         device="cpu", arena=True, mesh=mesh)
        if name == "ifca":
            st = st.replace(models=engine.ClusterBank.from_dict(
                {m: {k: torch.as_tensor(v) for k, v in tree.items()}
                 for m, tree in self.inputs["ifca"].items()}))
        return st

    def eager(self, name, mesh):
        st, snaps, want = self.init(name, mesh, scan=False), [], []
        calls = counting_psi(st) if name == "stocfl" else None
        for _ in range(3):
            if name == "stocfl":
                _, ids = engine.sample_clients(st)
                split = specs.row_split(len(ids), mesh)
                want.append(sum(int(c) not in st.clusters.seen
                                for c in ids[split.lo:split.hi]))
            st, _ = engine.run_round(st)
            snaps.append(snapshot(st))
        if name == "stocfl":
            self.psi[f"eager/{mesh is not None}"] = (calls[0], sum(want))
        return snaps

    def scan(self, name, mesh):
        st = self.init(name, mesh)
        calls = counting_psi(st) if name == "stocfl" else None
        st = engine.run_rounds(st, 2)
        snaps = [snapshot(st)]
        st = engine.run_rounds(st, 3)
        if name == "stocfl":
            m = 8                                     # 16 clients at rate 0.5
            split = specs.row_split(m, mesh)
            self.psi[f"scan/{mesh is not None}"] = (calls[0], 5 * (split.hi - split.lo))
        return snaps + [snapshot(st)]

    def cycle(self, name, mesh):
        """Churn past the arena's capacity and past ``compact_frac``: 2
        rounds, 3 joins (15 -> 18 rows: the capacity doubles), 2 rounds,
        10 leaves (the 10th compacts the arena to the 8 live rows), 2
        rounds; the arena's layout after the joins and after the leaves."""
        st = engine.run_rounds(self.init(name, mesh, clients="churn"), 2)
        snaps, layouts = [snapshot(st)], []
        for extra in self.inputs["extras"]:
            st, _ = engine.join(st, {k: torch.as_tensor(v) for k, v in extra.items()})
        layouts.append(layout(st.ctx.arena))
        st = engine.run_rounds(st, 2)
        snaps.append(snapshot(st))
        for cid in CYCLE_LEAVES:
            st = engine.leave(st, cid)
        layouts.append(layout(st.ctx.arena))
        st = engine.run_rounds(st, 2)
        return snaps + [snapshot(st)], layouts

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

    def owned(self, name, mesh, path):
        """``OWNED_DELAYS``' rounds over ``OWNED_CFG``'s buffer, the first
        member of round 0's cohort leaving after it and the state saved to
        ``path`` there; then the same rounds resumed from ``path``. Returns
        the uninterrupted run's (snapshot, buffer) pairs and the resumed
        run's snapshots."""
        acfg = engine.AsyncConfig(**OWNED_CFG)
        st, out = self.init(name, mesh, scan=False, async_cfg=acfg), []
        for t, delays in enumerate(OWNED_DELAYS):
            with recording_writes() as writes:
                st, _ = engine.run_round_async(st, delays=delays)
            if t == 0:
                st = engine.leave(st, st.buffer.entries[0].cid)
                save_server_state(path, st)
                # the same state, its buffer gathered whole, saved by a
                # writer without a mesh: the file the mesh's must equal
                whole = st.replace(ctx=dataclasses.replace(st.ctx, mesh=None),
                                   buffer=st.buffer.gathered())
                if mesh is not None and dist.get_rank() == 0:
                    save_server_state(path + "_whole", whole)
            out.append((snapshot(st), dict(buffer_rows(st.buffer), writes=writes)))
        st = load_server_state(path, self.init(name, mesh, scan=False, async_cfg=acfg))
        resumed = []
        for delays in OWNED_DELAYS[1:]:
            st, _ = engine.run_round_async(st, delays=delays)
            resumed.append(snapshot(st))
        return out, resumed


def owned_cases(run, world, root, mesh) -> dict:
    """The buffer with its rows on their owners (``Runner.owned``) for
    each async strategy, and the ``async_buffer.npz`` each run saved."""
    out = {}
    meshes = [("mesh", mesh)] + ([("nomesh", None)] if world == 1 else [])
    for tag, m in meshes:
        for name in ASYNC:
            path = os.path.join(root, f"ck_owned_{name}_w{world}_{tag}")
            out[f"owned/{name}/{tag}"] = run.owned(name, m, path)
            for suffix in ("", "_whole") if m is not None else ("",):
                dist.barrier()
                with zipfile.ZipFile(os.path.join(path + suffix, "async_buffer.npz")) as f:
                    out[f"owned/{name}/{tag}/file{suffix}"] = {k: f.read(k)
                                                               for k in f.namelist()}
    return out


def main_cases(run, world, root, mesh, inputs) -> dict:
    """Every case but the owned buffer's, as ``main`` writes them."""
    out = {}

    # every all_reduce the engine makes, counted per case; those that move
    # the arena's rows from their owners (RowOwners) counted apart
    calls, moves, inside, real = [0], [0], [0], specs.all_reduce_

    def counting(t, m):
        (moves if inside[0] else calls)[0] += 1
        return real(t, m)

    def moving(fn):
        def wrapped(*args, **kw):
            inside[0] += 1
            try:
                return fn(*args, **kw)
            finally:
                inside[0] -= 1
        return wrapped

    specs.all_reduce_ = counting
    specs.RowOwners.gather = moving(specs.RowOwners.gather)
    specs.RowOwners.send = moving(specs.RowOwners.send)

    def record(key, fn, *args):
        before, moved = calls[0], moves[0]
        out[key] = fn(*args)
        out[key + "/collectives"] = calls[0] - before
        out[key + "/row_moves"] = moves[0] - moved

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
        for name in CYCLE:
            out[f"cycle/{name}/{tag}"], out[f"cycle/{name}/{tag}/layout"] = run.cycle(name, m)
        out[f"layout/{tag}"] = layout(run.init("fedavg", m).ctx.arena)
    out["psi"] = run.psi

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
    return out


def main() -> int:
    rank, world, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    mode = sys.argv[4] if len(sys.argv) > 4 else "main"
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(root, f"store_{mode}{world}"), world), rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60))
    mesh = make_client_mesh(device="cpu")
    with open(os.path.join(root, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    run = Runner(inputs)
    if mode == "owned":
        out = owned_cases(run, world, root, mesh)
    else:
        out = main_cases(run, world, root, mesh, inputs)
    with open(os.path.join(root, f"{mode}_w{world}_r{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
