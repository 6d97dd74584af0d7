"""One rank of a ``gloo`` world on the CPU for ``tests/test_torch_flash_decode.py``
and ``tests/test_torch_card_worlds.py``.

    python tests/_torch_flash_worker.py RANK WORLD ROOT MODEL_PARALLEL

Joins the world through a ``FileStore`` under ``ROOT``, builds
``make_host_mesh(MODEL_PARALLEL, device="cpu")`` and, for each case the
test wrote to ``ROOT/inputs.pkl`` (qwen2-1.5b smoke in fp32 with a
window, the parameters, a decode token, cache and position, a scalar or
one per row), runs the decode step ``launch.steps.lower_step`` binds
there twice: with ``flash_decode`` set and without. Each call records
every collective it issues (the op's name and its element count,
``sharding.CollectiveLog``); every rank checks that the caches come back in their
``cache_shardings`` placement. Rank 0 writes the outputs as full numpy
arrays, with the records, to ``ROOT/out_{WORLD}_{MODEL_PARALLEL}.pkl``.
Imports only torch and the port.
"""
import datetime
import os
import pickle
import sys

import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.config import InputShape
from repro_torch.models.registry import build
from repro_torch.sharding import CollectiveLog, ShardCtx
from repro_torch.utils import trees


def decode(model, mesh, params, token, cache, pos):
    """The bound decode step: (logits, cache, its collectives)."""
    B, S_max = token.shape[0], trees.leaves(cache)[0].shape[2]
    bound = steps.lower_step(model, InputShape("decode", S_max, B, "decode"), mesh, "decode")
    with torch.no_grad(), CollectiveLog() as log:
        logits, out = bound.fn(params, token, cache, pos)
    return logits, out, [(op, n) for op, n, _ in log.calls]


def main() -> int:
    rank, world, root, mp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4])
    torch.set_num_threads(1)
    tag = f"{world}_{mp}"
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(root, f"store_{tag}"),
                                                         world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    with open(os.path.join(root, "inputs.pkl"), "rb") as f:
        cases = pickle.load(f)
    mesh = make_host_mesh(mp, device="cpu")
    ctx = ShardCtx(mesh)
    results = {}
    for name, case in cases.items():
        cfg = get_config("qwen2-1.5b", smoke=True).with_(dtype="float32",
                                                         sliding_window=case["window"])
        params = convert.to_torch(case["params"])
        token = torch.as_tensor(case["token"])
        pos = torch.as_tensor(case["pos"])
        res = {}
        for flash in (True, False):
            model = build(cfg.with_(flash_decode=flash))
            logits, cache, calls = decode(model, mesh, params, token,
                                          convert.to_torch(case["cache"]), pos)
            want = steps.cache_shardings(convert.to_torch(case["cache"]), mesh, ctx)
            placed = all(tuple(x.placements) == s.placements for x, s in
                         zip(trees.leaves(cache), trees.leaves(want)))
            res["flash" if flash else "plain"] = {
                "logits": logits.full_tensor().numpy(),
                "cache": trees.tree_map(lambda x: x.full_tensor().numpy(), cache),
                "calls": calls, "placed": placed}
        results[name] = res
    gathered = [None] * world
    dist.all_gather_object(gathered, {n: {k: (r[k]["calls"], r[k]["placed"]) for k in r}
                                      for n, r in results.items()})
    if rank == 0:
        with open(os.path.join(root, f"out_{tag}.pkl"), "wb") as f:
            pickle.dump({"results": results, "ranks": gathered,
                         "mesh": tuple(mesh.mesh.shape)}, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
