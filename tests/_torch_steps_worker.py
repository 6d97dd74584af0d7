"""One rank of a ``gloo`` world on the CPU for the port's model-axis tests
(``tests/test_torch_steps_mesh.py``, ``tests/test_torch_family_mesh.py``,
``tests/test_torch_card_worlds.py``).

    python tests/_torch_steps_worker.py RANK WORLD ROOT MODEL_PARALLEL TP_ONLY \
        [NAME:ARCH:USE_PALLAS ...]

Joins the world through a ``FileStore`` under ``ROOT``, builds
``make_host_mesh(MODEL_PARALLEL, device="cpu")`` and, for each case in
turn (one process runs them all, so a world pays torch's imports and
DTensor's first calls once), runs the four steps ``launch.steps.lower_step``
binds there (train, prefill, decode, repr, with ``serve_params_tp_only``
when TP_ONLY is 1) on ARCH's smoke config in fp32, ``use_pallas`` set when
USE_PALLAS is 1, on the inputs the test wrote to ``ROOT/NAME/inputs.pkl``
as numpy arrays (the parameters θ and ω, a batch, a decode token, cache,
position and cache length). Without a case it runs qwen2-1.5b on
``ROOT/inputs.pkl``. Every rank checks that each output leaf has the
placements the rule table gives it (``param_shardings`` for parameter
trees, ``cache_shardings`` for caches, replicated for logits and
losses), and records the type of every operand the selective-scan
kernel's two wrappers (``ssm_scan.scan_fwd`` / ``scan_bwd``) receive;
rank 0 writes each case's outputs as full numpy arrays, with the checks,
to ``ROOT/NAME/out_{WORLD}_{MODEL_PARALLEL}_{TP_ONLY}.pkl``. Imports only
torch and the port.
"""
import datetime
import os
import pickle
import sys

import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import ssm_scan
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.config import InputShape
from repro_torch.models.registry import build
from repro_torch.sharding import ShardCtx, param_shardings, replicated
from repro_torch.sharding.specs import DTensor
from repro_torch.utils import trees


def full(tree):
    """A tree of DTensors as full numpy arrays."""
    return trees.tree_map(lambda x: x.full_tensor().detach().numpy(), tree)


def placed_as(tree, shardings) -> bool:
    """Every leaf of ``tree`` is a DTensor with its sharding's placements."""
    if not isinstance(shardings, dict):
        shardings = trees.tree_map(lambda _: shardings, tree)
    got = trees.leaves(trees.tree_map(
        lambda x, s: isinstance(x, DTensor) and tuple(x.placements) == s.placements,
        tree, shardings))
    return all(got)


def recording_scan_operands(seen):
    """Wrap ``ssm_scan.scan_fwd`` / ``scan_bwd`` so that each call appends
    (its name, the type name of every operand) to ``seen``."""
    for name in ("scan_fwd", "scan_bwd"):
        real = getattr(ssm_scan, name)

        def record(*ops, _real=real, _name=name):
            seen.append((_name, [type(x).__name__ for x in ops]))
            return _real(*ops)

        setattr(ssm_scan, name, record)


def run_case(root, arch, pallas, mesh, tp_only, rank, world, tag, scans):
    """The four steps of one case on ``mesh``, the scan kernel's operand
    types recorded into ``scans``; rank 0 writes them."""
    with open(os.path.join(root, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    model = build(get_config(arch, smoke=True).with_(dtype="float32", use_pallas=pallas))
    theta, omega = convert.to_torch(inp["theta"]), convert.to_torch(inp["omega"])
    batch = convert.to_torch(inp["batch"])
    B, S = inp["batch"]["tokens"].shape
    cache, S_max = convert.to_torch(inp["cache"]), inp["s_max"]
    scans.clear()
    ctx = ShardCtx(mesh)
    pctx = ShardCtx(mesh, {**ctx.logical_map, "fsdp": None}) if tp_only else ctx
    pshard = param_shardings(theta, mesh, pctx)
    rep = replicated(mesh)
    bind = lambda kind, s: steps.lower_step(model, InputShape(kind, s, B, kind), mesh, kind,
                                            serve_params_tp_only=tp_only)
    out, ok = {}, {}

    t2, o2, metrics = bind("train", S).fn(theta, omega, batch)
    ok["train"] = placed_as(t2, pshard) and placed_as(o2, pshard) and placed_as(metrics, rep)
    out["train"] = {"theta": full(t2), "omega": full(o2), **full(metrics)}

    logits, pcache = bind("prefill", S).fn(theta, batch)
    cshard = steps.cache_shardings(model.make_cache(B, S, device="meta"), mesh, ctx)
    ok["prefill"] = placed_as(logits, rep) and placed_as(pcache, cshard)
    out["prefill"] = {"logits": full(logits), "cache": full(pcache)}

    dec = bind("decode", S_max)
    logits, dcache = dec.fn(theta, torch.as_tensor(inp["token"]), cache,
                            torch.tensor(inp["pos"], dtype=torch.int32))
    cshard = steps.cache_shardings(model.make_cache(B, S_max, device="meta"), mesh, ctx)
    ok["decode"] = placed_as(logits, rep) and placed_as(dcache, cshard)
    out["decode"] = {"logits": full(logits), "cache": full(dcache)}

    psi = bind("repr", S).fn(theta, batch)
    ok["repr"] = placed_as(psi, pshard)
    out["repr"] = full(psi)

    oks = [None] * world
    dist.all_gather_object(oks, ok)
    scanned = [None] * world
    dist.all_gather_object(scanned, scans)
    if rank == 0:
        specs = trees.tree_map(lambda s: s.spec, pshard)
        with open(os.path.join(root, f"out_{tag}.pkl"), "wb") as f:
            pickle.dump({"out": out, "ok": oks, "specs": specs, "scans": scanned,
                         "mesh": tuple(mesh.mesh.shape)}, f)


def main() -> int:
    rank, world, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    mp, tp_only = int(sys.argv[4]), sys.argv[5] == "1"
    cases = [c.split(":") for c in sys.argv[6:]] or [("", "qwen2-1.5b", "0")]
    torch.set_num_threads(1)
    tag = f"{world}_{mp}_{int(tp_only)}"
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(root, f"store_{tag}"),
                                                         world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    mesh = make_host_mesh(mp, device="cpu")
    scans = []
    recording_scan_operands(scans)
    for name, arch, pallas in cases:
        run_case(os.path.join(root, name), arch, pallas == "1", mesh, tp_only, rank, world, tag,
                 scans)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
