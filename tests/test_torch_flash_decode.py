"""The port's flash decode (``models.attention._gqa_decode_flash``): the
reference's partial-softmax decode over a sequence-sharded KV cache.

In the test process, on a ``(data, model)`` mesh of one rank (as the
reference's ``tests/test_flash_decode.py`` runs on one device), the two
reference tests are mirrored: llama3 smoke with window None and 8 (pos 11
wraps the ring), flash under a 1 × 1 ``ShardCtx`` against the dense
decode; and qwen2's token-by-token flash decode against
``forward_train``. Each is also held against the JAX package's own flash
path under its one-device mesh, within 1e-5 of the largest |logit|.

Then ``tests/_torch_flash_worker.py`` runs in two ``gloo`` worlds of four
ranks, a 2×2 mesh (model axis 2, the batch split over data) and a 1×4
(model axis 4), each the decode step ``launch.steps.lower_step`` binds,
with and without ``flash_decode``, on qwen2 smoke with a scalar position
and one per row, without a window and with a window that wraps. Flash
logits are within 1e-5 of the port's plain decode without a mesh; the
caches come back in their ``cache_shardings`` placement, every entry the
step did not write bitwise equal and the written ones within 1e-5 (after
the first layer a written key carries the attention's rounding: flash
divides by the normaliser after the context's sum, the plain decode
before). The flash step's collectives are counted: three ``all_reduce``
a layer, of B·H, B·H and B·H·hd elements (B the rank's rows), and the
same list of collectives for a cache twice as long, so no cache bytes
move; the plain decode on the same mesh gathers every layer's cache. A
cache the model axis does not divide takes the plain decode, as the
reference's condition says. On every case with a scalar position, the
one the reference's ``gqa_decode`` takes, each world's flash logits and
caches are also held against the JAX package's decode of the same
parameters and cache without a mesh (its dense decode, the ground truth),
within the same 1e-5.
"""
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from _torch_mesh_cases import (B, DIVIDED, FLASH_CASES as CASES, close_logits,  # noqa: E402
                               flash_config, hold_cache, plain_decode, write_flash_cases,
                               written)
from _torch_world import HERE, start_worlds  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models.registry import grow_cache as jgrow_cache  # noqa: E402
from repro.sharding import ShardCtx as JShardCtx  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.registry import build, grow_cache  # noqa: E402
from repro_torch.sharding import ShardCtx  # noqa: E402
from repro_torch.utils import trees  # noqa: E402

WORKER = os.path.join(HERE, "_torch_flash_worker.py")
WORLDS = {"2x2": (4, 2), "1x4": (4, 4)}   # name: (ranks, model axis)
# the worlds' eight single-threaded ranks at once take ~20 s alone; the cap
# leaves room for a loaded machine and still fails a hung world
WORLDS_TIMEOUT = 300.0


def _jmesh11():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


@pytest.fixture(scope="module")
def mesh11():
    """A 1 × 1 ``make_host_mesh`` over a world of one made here (and
    taken down after the module) unless a default group exists."""
    made = not dist.is_initialized()
    mesh = make_host_mesh(1, device="cpu")
    yield mesh
    if made:
        dist.destroy_process_group()


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


# ------------------------------------------------------------- one rank
@pytest.mark.parametrize("window", [None, 8])
def test_flash_matches_dense_and_the_reference(mesh11, window):
    """The reference's ``test_flash_matches_dense``: llama3 smoke, an empty
    cache of 16 (8 with the window), pos 12 (window None) or 11 (window 8:
    the ring wraps)."""
    kw = {"dtype": "float32", "sliding_window": window}
    cfg = get_config("llama3-8b", smoke=True).with_(**kw)
    jcfg = jconfigs.get_config("llama3-8b", smoke=True).with_(**kw)
    jparams = jax.jit(jbuild(jcfg).init)(jax.random.PRNGKey(0))
    params = convert.to_torch(jparams)
    dense, flash = build(cfg), build(cfg.with_(flash_decode=True))
    cache = dense.make_cache(2, 16)
    tok = torch.ones((2,), dtype=torch.int32)
    pos = 12 if window is None else 11
    ld, cd = dense.decode(params, tok, cache, torch.tensor(pos, dtype=torch.int32))
    with ShardCtx(mesh11):
        lf, cf = flash.decode(params, tok, cache, torch.tensor(pos, dtype=torch.int32))
    jflash = jbuild(jcfg.with_(flash_decode=True))
    with JShardCtx(_jmesh11()):
        lj, cj = jax.jit(jflash.decode)(jparams, jnp.ones((2,), jnp.int32),
                                        jflash.make_cache(2, 16), jnp.int32(pos))
    close_logits(_full(lf), ld, "flash against dense")
    close_logits(_full(lf), lj, "flash against the reference's flash")
    S_max = cache["layers"]["k"].shape[2]                  # the window when it is shorter
    where = written(S_max, window, pos)[:2]
    hold_cache(trees.tree_map(_full, cf)["layers"], cd["layers"], where, "cache")
    hold_cache(trees.tree_map(_full, cf)["layers"], jax.tree.map(np.asarray, cj)["layers"],
               where, "cache against the reference")


def test_flash_sequential_decode_matches_teacher_forcing(mesh11):
    """The reference's ``test_flash_sequential_decode_consistency``: qwen2
    smoke, a prefill of 11 tokens under the 1 × 1 ``ShardCtx``, then the
    12th by flash decode, against ``forward_train``'s last logits and the
    reference's flash decode of the same."""
    kw = {"dtype": "float32", "flash_decode": True}
    cfg = get_config("qwen2-1.5b", smoke=True).with_(**kw)
    jcfg = jconfigs.get_config("qwen2-1.5b", smoke=True).with_(**kw)
    jmodel, model = jbuild(jcfg), build(cfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    params = convert.to_torch(jparams)
    n, S = 2, 12
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (n, S)).astype(np.int32)
    t = torch.as_tensor(tokens)
    want, _ = model.forward_train(params, {"tokens": t})
    with ShardCtx(mesh11):
        _, cache = model.prefill(params, {"tokens": t[:, :S - 1]})
        cache = grow_cache(model, cache, n, S)
        got, _ = model.decode(params, t[:, S - 1], cache, torch.tensor(S - 1, dtype=torch.int32))
    with JShardCtx(_jmesh11()):
        _, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens[:, :S - 1])})
        jcache = jgrow_cache(jmodel, jcache, n, S)
        jgot, _ = jax.jit(jmodel.decode)(jparams, jnp.asarray(tokens[:, S - 1]), jcache,
                                         jnp.int32(S - 1))
    close_logits(_full(got), want[:, -1], "flash against forward_train")
    close_logits(_full(got), jgot, "flash against the reference's flash")


# ------------------------------------------------------------- worlds
def _reference_decode(case):
    """The JAX package's decode without a mesh on ``case`` (a scalar
    position): its dense ``gqa_decode``."""
    jcfg = jconfigs.get_config("qwen2-1.5b", smoke=True).with_(dtype="float32",
                                                               sliding_window=case["window"])
    asj = lambda tree: jax.tree.map(jnp.asarray, tree)
    logits, cache = jax.jit(jbuild(jcfg).decode)(asj(case["params"]), jnp.asarray(case["token"]),
                                                 asj(case["cache"]), jnp.asarray(case["pos"]))
    return np.asarray(logits), jax.tree.map(np.asarray, cache)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("flash"))
    cases = write_flash_cases(root)
    running = start_worlds(WORKER, root, list(WORLDS.values()), timeout=WORLDS_TIMEOUT)
    try:
        plain = {name: plain_decode(case) for name, case in cases.items()}
        reference = {name: _reference_decode(cases[name]) for name in SCALAR}
    finally:
        running.wait()
    out = {}
    for name, (ranks, mp) in WORLDS.items():
        with open(os.path.join(root, f"out_{ranks}_{mp}.pkl"), "rb") as f:
            out[name] = pickle.load(f)
    return {"cases": cases, "plain": plain, "reference": reference, "out": out,
            "cfg": flash_config()}


GRID = [(w, c) for w in WORLDS for c in DIVIDED]
SCALAR = [c for c in DIVIDED if np.ndim(CASES[c][3]) == 0]
REF_GRID = [(w, c) for w in WORLDS for c in SCALAR]


@pytest.mark.parametrize("world,case", GRID, ids=[f"{w}-{c}" for w, c in GRID])
def test_flash_on_the_mesh_matches_the_plain_decode(worlds, world, case):
    window, cache_len, _, pos = CASES[case]
    got = worlds["out"][world]["results"][case]["flash"]
    logits, cache = worlds["plain"][case]
    close_logits(got["logits"], logits, f"{world} {case} logits")
    for stack in cache:
        hold_cache(got["cache"][stack], cache[stack], written(cache_len, window, pos),
                   f"{world} {case}")


@pytest.mark.parametrize("world,case", REF_GRID, ids=[f"{w}-{c}" for w, c in REF_GRID])
def test_flash_on_the_mesh_matches_the_reference(worlds, world, case):
    """The sequence-sharded flash decode of each world against the JAX
    package's dense decode of the same inputs without a mesh."""
    window, cache_len, _, pos = CASES[case]
    got = worlds["out"][world]["results"][case]["flash"]
    logits, cache = worlds["reference"][case]
    close_logits(got["logits"], logits, f"{world} {case} logits against the reference")
    for stack in cache:
        hold_cache(got["cache"][stack], cache[stack], written(cache_len, window, pos),
                   f"{world} {case} against the reference")


@pytest.mark.parametrize("world", list(WORLDS))
def test_caches_keep_their_placements_on_every_rank(worlds, world):
    for rank in worlds["out"][world]["ranks"]:
        for case, res in rank.items():
            assert all(placed for _, placed in res.values()), (world, case)


@pytest.mark.parametrize("world", list(WORLDS))
def test_flash_collectives_move_no_cache_bytes(worlds, world):
    """Three all-reduces a layer in the flash core, of B·H (max,
    normaliser) and B·H·hd (context) elements on the rank's rows; the
    step's whole list of collectives is the same for a cache twice as
    long, while the plain decode on the same mesh gathers each layer's
    cache, so its traffic grows by at least the extra cache."""
    cfg, (ranks, mp) = worlds["cfg"], WORLDS[world]
    rows = B // (ranks // mp)
    H, hd, L = cfg.n_heads, cfg.resolved_head_dim, cfg.n_layers
    for rank in worlds["out"][world]["ranks"]:
        flash, _ = rank["full-scalar"]["flash"]
        core = [n for op, n in flash if op == "c10d.allreduce_"]
        assert sorted(core) == sorted([rows * H, rows * H, rows * H * hd] * L), core
        assert rank["long-scalar"]["flash"][0] == flash
        moved = lambda calls: sum(n for _, n in calls)
        plain16, plain32 = (rank[c]["plain"][0] for c in ("full-scalar", "long-scalar"))
        extra = 2 * L * rows * 16 * cfg.n_kv_heads * hd // mp      # k and v, 16 more entries
        assert moved(plain32) - moved(plain16) >= extra, (moved(plain16), moved(plain32))
        assert moved(flash) < moved(plain16), (moved(flash), moved(plain16))


@pytest.mark.parametrize("world", list(WORLDS))
def test_an_undivided_cache_takes_the_plain_decode(worlds, world):
    """A cache of 13 entries: no model axis divides it, so the flash
    config runs the plain decode (no all-reduce of the flash core), the
    same bits as the config without flash on the same mesh."""
    res = worlds["out"][world]["results"]["undivided"]
    assert all(op != "c10d.allreduce_" for op, _ in res["flash"]["calls"])
    assert res["flash"]["calls"] == res["plain"]["calls"]
    assert np.array_equal(res["flash"]["logits"], res["plain"]["logits"])
    for stack in res["plain"]["cache"]:
        for name in res["plain"]["cache"][stack]:
            assert np.array_equal(res["flash"]["cache"][stack][name],
                                  res["plain"]["cache"][stack][name])


def test_worlds_run_the_meshes_asked_for(worlds):
    assert worlds["out"]["2x2"]["mesh"] == (2, 2) and worlds["out"]["1x4"]["mesh"] == (1, 4)
