"""Two forms of the port's batched Ψ on one GPU: memory and time a client.

The port's ``make_extractor(..., batched=True)`` runs a chunk of clients'
losses under one ``torch.func.vmap`` and takes every client's gradient of
the kept leaves from one autograd call of their sum (the cohort update's
form). This script measures it beside the other form,
``vmap(torch.func.grad(loss), in_dims=(None, 0))``, and beside the
one-client autograd Ψ, on the serve CLI's state (``launch.serve.
build_server_state``: three fp32 models, Ψ on the vocab leaves sketched
to 8192) and its request histories (8 x 256 tokens a client), at full
width. For each form and chunk it prints the ms a client (host clock
around a synchronised call, the second of two) and the peak memory over
what the state holds; an out-of-memory call prints OOM. Rows are held
against the one-client Ψ (largest |difference| over the largest |value|).

  PYTHONPATH=src python scripts/torch_psi_forms.py [--arch qwen2-1.5b]
      [--layers N] [--clients 8] [--chunks 1,2,4]

It needs a GPU and imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import time

import torch
from torch.func import grad, vmap

from repro_torch.configs import get_config
from repro_torch.core import extractor
from repro_torch.engine.state import on_device
from repro_torch.engine.strategies import stack_batches
from repro_torch.launch import serve as launch_serve
from repro_torch.models.registry import build
from repro_torch.utils import trees


def grad_form(loss_fn, anchor, sketch, chunk):
    """Ψ rows by ``vmap`` over ``torch.func.grad`` of the loss in the kept
    leaves (the anchor shared, the batch mapped), sketched outside."""
    frozen = trees.leaves(anchor)
    keep = [extractor.llm_leaf_filter(p) for p in extractor.leaf_paths(anchor)]

    def loss_of_kept(kept, batch):
        it = iter(kept)
        return loss_fn(trees.from_leaves(anchor, [next(it) if k else x
                                                  for x, k in zip(frozen, keep)]), batch)

    grads = vmap(grad(loss_of_kept), in_dims=(None, 0))
    kept0 = [x for x, k in zip(frozen, keep) if k]

    def rows(batches):
        n = trees.leaves(batches)[0].shape[0]
        out = []
        for lo in range(0, n, chunk):
            vec = sketch.rows(grads(kept0, trees.tree_map(lambda x: x[lo:lo + chunk],
                                                          batches)))
            norm = torch.linalg.vector_norm(vec, dim=1, keepdim=True)
            out.append(torch.where(norm > 0, vec / norm, vec))
        return torch.cat(out)

    return rows


def timed(fn, arg, n):
    """(ms a client, peak bytes over what was held, result) of the second
    of two synchronised calls."""
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = fn(arg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n
    return ms, torch.cuda.max_memory_allocated() - held, out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth (0: the config's)")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--chunks", default="1,2,4")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = get_config(args.arch).with_(dtype="float32", **(
        {"n_layers": args.layers} if args.layers else {}))
    model = build(cfg)
    state = launch_serve.build_server_state(cfg, model, 2, 0.3, 0, device=dev)
    hists = [on_device(r.history, dev) for r in launch_serve.make_requests(
        cfg, args.clients, 32, 16, 2, seed_base=100)]
    ctx = state.ctx
    ms, peak, one = timed(lambda hs: torch.stack([ctx.extractor(h) for h in hs]), hists,
                          args.clients)
    print(f"{cfg.name}, {cfg.n_layers} layers, remat {cfg.remat}, fp32: the state holds "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB; one-client Psi {ms:.1f} ms a client, "
          f"peak {peak / 1e9:.2f} GB", flush=True)
    stacked = stack_batches(hists)
    anchor = trees.tree_map(lambda x: x.detach(), ctx.init_params)
    sizes = [x.numel() for x, p in zip(trees.leaves(anchor), extractor.leaf_paths(anchor))
             if extractor.llm_leaf_filter(p)]
    sketch = extractor.JLSketch(sizes, 8192, 0, dev)
    for chunk in (int(c) for c in args.chunks.split(",")):
        forms = {"vmap(loss)+autograd": extractor.make_extractor(
                     model.loss_fn, anchor, 8192, batched=True,
                     leaf_filter=extractor.llm_leaf_filter, chunk=chunk),
                 "vmap(grad)": grad_form(model.loss_fn, anchor, sketch, chunk)}
        for name, fn in forms.items():
            try:
                ms, peak, rows = timed(fn, stacked, args.clients)
                err = float((rows - one).abs().max()) / float(one.abs().max())
                print(f"  chunk {chunk} {name}: {ms:.1f} ms a client, peak {peak / 1e9:.2f} "
                      f"GB, rows within {err:.2e} of the one-client rows", flush=True)
            except torch.OutOfMemoryError:
                print(f"  chunk {chunk} {name}: OOM", flush=True)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
