"""Tree and server-state checkpoints in the JAX package's file format
(npz + a JSON manifest), so either package reads what the other wrote.

Keys are ``/``-joined paths ("layers/attn/wq"), stable across dict order
and easy to read with ``np.load``. Tensors are copied to the host before
they are written; bf16 leaves are stored as lossless f32 (numpy has no
bfloat16) and cast back to the template's dtype when loaded.

Every save takes ``block=False``: it copies every tensor to the host
before it returns (a consistent cut, whatever the caller writes next) and
hands the file writes to one background writer thread, so rounds overlap
the disk. ``wait_pending()`` is the barrier and re-raises the first
writer error. Writes are ordered (one writer), so a manifest never lands
before its arrays.
"""
from __future__ import annotations

import json
import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_WRITER: Optional[ThreadPoolExecutor] = None
_WRITER_LOCK = threading.Lock()
_PENDING: List[Future] = []


def _writer() -> ThreadPoolExecutor:
    global _WRITER
    with _WRITER_LOCK:
        if _WRITER is None:
            _WRITER = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-writer")
        return _WRITER


def _submit(fn) -> Future:
    fut = _writer().submit(fn)
    _PENDING.append(fut)
    return fut


def wait_pending() -> None:
    """Block until every background checkpoint write has landed; re-raises
    the first writer failure. Call before reading a checkpoint back, and
    at the end of a run."""
    pending, _PENDING[:] = _PENDING[:], []
    for fut in pending:
        fut.result()


def _np_safe(x: torch.Tensor) -> np.ndarray:
    """A host copy of a tensor in an npz-portable dtype: it leaves the
    device (a CPU tensor is cloned, so later in-place writes cannot reach
    the copy) and bf16 becomes lossless f32."""
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.to(torch.float32)
    elif x.device.type == "cpu":
        x = x.clone()
    return x.cpu().numpy()


def _flatten(tree, prefix="") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _host(tree) -> Dict[str, np.ndarray]:
    """``tree`` path-flattened to host arrays (``_np_safe``)."""
    return {k: _np_safe(v) for k, v in _flatten(tree).items()}


def _plain(x):
    """A history value as plain JSON types: ints, floats, bools, strings,
    lists and dicts (tuples such as the eager StoCFL record's ``merges``
    become lists)."""
    if isinstance(x, dict):
        return {str(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (bool, np.bool_)):
        return bool(x)
    if isinstance(x, (int, np.integer)):
        return int(x)
    if isinstance(x, (float, np.floating)):
        return float(x)
    return x


def save_pytree(path: str, tree, block: bool = True) -> Optional[Future]:
    """Write ``tree`` to ``path`` (npz). ``block=False`` copies it to the
    host now and writes in the background; returns the Future
    (``wait_pending()`` is the barrier)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _host(tree)
    if block:
        np.savez(path, **flat)
        return None
    return _submit(lambda: np.savez(path, **flat))


def _leaf(arr: np.ndarray, tmpl: torch.Tensor) -> torch.Tensor:
    """A loaded array as a tensor in the template leaf's dtype, on its
    device."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device=tmpl.device, dtype=tmpl.dtype)


def load_pytree(path: str, template=None):
    """Without a template, the flat ``{path: array}`` dict; with a tree of
    tensors, the arrays reassembled into its structure, each leaf in the
    template leaf's dtype and on its device, so a bf16 round trip is
    exact."""
    data = dict(np.load(path if path.endswith(".npz") else path + ".npz"))
    return data if template is None else _rebuild(data, template)


def _rebuild(data: Dict[str, np.ndarray], tmpl, prefix: str = ""):
    """The arrays of ``data`` under ``prefix`` in ``tmpl``'s structure
    (``_leaf`` per leaf; only the template leaves' dtypes and devices are
    read, not their shapes)."""
    if isinstance(tmpl, dict):
        return {k: _rebuild(data, v, f"{prefix}{k}/") for k, v in tmpl.items()}
    if isinstance(tmpl, (list, tuple)):
        return type(tmpl)(_rebuild(data, v, f"{prefix}{i}/") for i, v in enumerate(tmpl))
    return _leaf(data[prefix[:-1]], tmpl)


# ---------------------------------------------------------------------------
# Engine ServerState checkpoints: the tensors go to arrays.npz, the host
# bookkeeping (partition, rng position, history, buffer entries) to
# manifest.json. Loading reattaches onto a freshly engine.init'ed state,
# which supplies the context and the parameter templates, and resumes
# exactly, the sampling rng included.
# ---------------------------------------------------------------------------
def save_server_state(dirpath: str, state, block: bool = True) -> Optional[Future]:
    """Checkpoint an ``engine.ServerState`` (any strategy) to a directory:
    ``arrays.npz`` (ω, the bank rows, Ditto's personal rows),
    ``manifest.json``, ``clusters_device.npz`` (the ``DeviceClusters``'
    parent / live / rep) or ``reps.npz`` (the host ``ClusterState``'s Ψ
    rows), and ``async_buffer.npz`` with deltas in flight. ``rng_key`` is
    written as its raw key words. ``block=False`` copies everything to
    the host now and writes the files from the background writer
    (returns the Future; ``wait_pending()`` is the barrier). Under a
    client-axis mesh (``state.ctx.mesh``) the state is the same on every
    rank: rank 0 writes, and then every rank waits at a barrier, so the
    save blocks whatever ``block`` says and every rank can load the files
    as soon as it returns. No mesh is written: a state saved at one world
    size resumes at another, or with no mesh."""
    from repro_torch.core.device_clustering import DeviceClusters

    os.makedirs(dirpath, exist_ok=True)
    flat_arrays = _host({"omega": state.omega,
                         "models": {str(k): v for k, v in state.models.items()},
                         "personal": {str(k): v for k, v in state.personal.items()}})
    device_clusters = isinstance(state.clusters, DeviceClusters)
    manifest = {
        "strategy": state.strategy,
        "round": int(state.round),
        "rng_state": state.rng_state,
        "rng_key": (None if state.rng_key is None
                    else [int(x) for x in state.rng_key.reshape(-1).tolist()]),
        "sizes": [int(s) for s in state.sizes],
        "left": sorted(int(c) for c in state.left),
        "members": ([list(map(int, m)) for m in state.members]
                    if state.members is not None else None),
        "history": _plain(list(state.history)),
        "model_keys": sorted(int(k) for k in state.models),
        "personal_keys": sorted(int(k) for k in state.personal),
        "clusters": None if state.clusters is None else {
            "tau": state.clusters.tau,
            "backend": "device" if device_clusters else "numpy",
            "parent": (None if device_clusters else
                       {str(k): int(v) for k, v in state.clusters.uf.parent.items()}),
            "seen": sorted(int(c) for c in state.clusters.seen),
        },
    }
    if device_clusters:
        cluster_file, cluster_arrays = "clusters_device.npz", {
            k: np.array(v) for k, v in state.clusters.arrays().items()}
    elif state.clusters is not None:
        cluster_file, cluster_arrays = "reps.npz", {
            str(k): _np_safe(v) for k, v in state.clusters.reps.items()}
    else:
        cluster_file, cluster_arrays = None, None

    # the async buffer: device rows to async_buffer.npz, the entries
    # (slots, rounds, seq order, f32 weights) to the manifest
    buf = state.buffer
    buffer_arrays = None
    if buf is None:
        manifest["async_buffer"] = None
    else:
        comps = [k for k, v in (("payload", buf.payload), ("aux", buf.aux),
                                ("psi", buf.psi)) if v is not None]
        manifest["async_buffer"] = {
            "capacity": int(buf.capacity),
            "next_seq": int(buf.next_seq),
            "entries": [[int(e.slot), int(e.cid), int(e.dispatch), int(e.arrival),
                         int(e.seq), float(e.weight)] for e in buf.entries],
            "components": comps,
        }
        if comps:
            buffer_arrays = _host({c: getattr(buf, c) for c in comps})

    def write():
        np.savez(os.path.join(dirpath, "arrays.npz"), **flat_arrays)
        with open(os.path.join(dirpath, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if cluster_file is not None:
            np.savez(os.path.join(dirpath, cluster_file), **cluster_arrays)
        if buffer_arrays is not None:
            np.savez(os.path.join(dirpath, "async_buffer.npz"), **buffer_arrays)

    mesh = state.ctx.mesh
    if mesh is not None:
        from repro_torch.sharding import specs
        if specs.mesh_rank(mesh) == 0:
            write()
        specs.barrier(mesh, state.ctx.device)
        return None
    if block:
        write()
        return None
    return _submit(write)


def load_server_state(dirpath: str, state):
    """Restore a checkpoint onto a freshly initialised ``ServerState``,
    which supplies the context (functions, clients, device) and the
    parameter templates; the returned state carries the checkpoint's
    tensors (on the engine's device, in its dtypes), partition (on the
    engine's device too), history, rng position and async buffer. A
    checkpoint without an async buffer loads with ``buffer=None``. Under a
    mesh every rank loads the same files onto its own context."""
    from repro_torch.core.clustering import ClusterState
    from repro_torch.core.device_clustering import DeviceClusters
    from repro_torch.engine.async_agg import AsyncBuffer, _Entry
    from repro_torch.engine.bank import ClusterBank

    dev = state.ctx.device
    with open(os.path.join(dirpath, "manifest.json")) as f:
        man = json.load(f)
    tmpl = state.ctx.init_params
    arrays = load_pytree(os.path.join(dirpath, "arrays.npz"), {
        "omega": tmpl,
        "models": {str(k): tmpl for k in man["model_keys"]},
        "personal": {str(k): tmpl for k in man["personal_keys"]}})
    clusters = None
    cman = man["clusters"]
    if cman is not None:
        if cman.get("backend", "numpy") == "device":
            arr = np.load(os.path.join(dirpath, "clusters_device.npz"))
            clusters = DeviceClusters.from_arrays(cman["tau"], arr["parent"], arr["live"],
                                                  arr["rep"], device=dev)
        else:
            clusters = ClusterState(cman["tau"], device=dev)
            clusters.uf.parent = {int(k): int(v) for k, v in cman["parent"].items()}
            clusters.seen = set(cman["seen"])
            reps_path = os.path.join(dirpath, "reps.npz")
            if os.path.exists(reps_path):
                reps = np.load(reps_path)
                clusters.reps = {int(k): clusters._as_rep(reps[k]) for k in reps.files}

    rng_key = state.rng_key
    if man.get("rng_key") is not None:
        rng_key = torch.tensor(man["rng_key"], dtype=torch.int64, device=dev)

    buffer = None
    abm = man.get("async_buffer")
    if abm is not None:
        parts = {}
        if abm["components"]:
            data = dict(np.load(os.path.join(dirpath, "async_buffer.npz")))
            for c in abm["components"]:
                # θ / ω rows take the parameters' dtype (bf16 comes back
                # from its f32 copy); Ψ rows are fp32 as written
                parts[c] = (torch.from_numpy(data["psi"]).to(dev) if c == "psi"
                            else _rebuild(data, tmpl, c + "/"))
        buffer = AsyncBuffer(
            capacity=int(abm["capacity"]), payload=parts.get("payload"),
            aux=parts.get("aux"), psi=parts.get("psi"),
            entries=tuple(_Entry(int(s), int(c), int(d), int(a), int(q), float(w))
                          for s, c, d, a, q, w in abm["entries"]),
            next_seq=int(abm["next_seq"]))
    return state.replace(
        buffer=buffer, strategy=man["strategy"], round=man["round"],
        rng_state=man["rng_state"], rng_key=rng_key,
        sizes=tuple(man["sizes"]), left=frozenset(man["left"]),
        omega=arrays["omega"],
        models=ClusterBank.from_dict({int(k): v for k, v in arrays["models"].items()}),
        personal={int(k): v for k, v in arrays["personal"].items()},
        clusters=clusters,
        members=(tuple(tuple(m) for m in man["members"])
                 if man["members"] is not None else None),
        history=tuple(man["history"]))


def save_stocfl(dirpath: str, trainer) -> None:
    """The legacy ``core.stocfl.StoCFL`` shim's server state: ω, the
    cluster models, the partition and the Ψ rows (the JAX package's
    layout: ``omega.npz``, ``cluster_<root>.npz``, ``state.json``,
    ``reps.npz``)."""
    os.makedirs(dirpath, exist_ok=True)
    save_pytree(os.path.join(dirpath, "omega.npz"), trainer.omega)
    for root, model in trainer.models.items():
        save_pytree(os.path.join(dirpath, f"cluster_{root}.npz"), model)
    state = {
        "tau": trainer.state.tau,
        "parent": {str(k): int(v) for k, v in trainer.state.uf.parent.items()},
        "seen": sorted(int(c) for c in trainer.state.seen),
        "history": _plain(trainer.history),
    }
    with open(os.path.join(dirpath, "state.json"), "w") as f:
        json.dump(state, f)
    np.savez(os.path.join(dirpath, "reps.npz"),
             **{str(k): _np_safe(v) for k, v in trainer.state.reps.items()})


def load_stocfl(dirpath: str, trainer) -> None:
    """Restore ``save_stocfl``'s state into the shim in place (its clients
    and loss stay the caller's)."""
    trainer.omega = load_pytree(os.path.join(dirpath, "omega.npz"), trainer.init_params)
    with open(os.path.join(dirpath, "state.json")) as f:
        state = json.load(f)
    clusters = trainer.state
    clusters.tau = state["tau"]
    clusters.uf.parent = {int(k): int(v) for k, v in state["parent"].items()}
    clusters.seen = set(state["seen"])
    trainer.history = state["history"]
    reps = np.load(os.path.join(dirpath, "reps.npz"))
    clusters.reps = {int(k): clusters._as_rep(reps[k]) for k in reps.files}
    for fn in sorted(os.listdir(dirpath)):
        if fn.startswith("cluster_") and fn.endswith(".npz"):
            root = int(fn[len("cluster_"):-len(".npz")])
            trainer.models[root] = load_pytree(os.path.join(dirpath, fn), trainer.init_params)
