"""The model-axis worlds under the card machine's own torch.

The card's machine runs another torch than the CPU tier, and DTensor in
one release refuses layouts the other accepts, so each model-axis site
is also held there. This test starts, on that machine's CPU, the gloo
worlds of ``test_torch_family_mesh.py`` (every family in its 2×2 and
1×2 worlds), qwen2 on 2×2 and 1×4 (``test_torch_steps_mesh.py``'s
meshes) and the flash decode's 2×2 and 1×4 worlds
(``test_torch_flash_decode.py``), all at once, on inputs made from a
seed with numpy and the port's own ``init``
(``tests/_torch_mesh_cases.py``). Each world's steps are held against
the port without a mesh, computed in this process while the worlds run,
within ``MESH_TOL`` (zamba2 ``MESH_TOLS``) of the largest magnitude of
each leaf; each output leaf keeps its rule-table placement on every
rank, and K5's wrappers get plain tensors. Flash logits within 1e-5 of
the plain decode, caches bitwise outside the written entries.

Marked ``cuda``: it skips without a card, and runs there without JAX:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_card_worlds.py
"""
import os
import pickle

import pytest

torch = pytest.importorskip("torch")

from _torch_mesh_cases import (DIVIDED, FAMILIES, FLASH_CASES, KINDS, close_logits,  # noqa: E402
                               hold_cache, mesh_tol, plain_decode, plain_steps,
                               write_flash_cases, write_inputs, written)
from _torch_world import HERE, close, start_worlds  # noqa: E402

pytestmark = pytest.mark.cuda

STEPS_WORKER = os.path.join(HERE, "_torch_steps_worker.py")
FLASH_WORKER = os.path.join(HERE, "_torch_flash_worker.py")
QWEN2 = ("qwen2-1.5b", False)
# (ranks, model axis): the step worlds and the cases each runs, by name
STEP_WORLDS = {"2x2": (4, 2, [f for f, (_, _, dps) in FAMILIES.items() if 2 in dps] + ["qwen2"]),
               "1x2": (2, 2, [f for f, (_, _, dps) in FAMILIES.items() if 1 in dps]),
               "1x4": (4, 4, ["qwen2"])}
FLASH_WORLDS = {"2x2": (4, 2), "1x4": (4, 4)}
# eighteen single-threaded ranks on the machine's cores at once
WORLDS_TIMEOUT = 600.0


def _arch(name):
    return QWEN2 if name == "qwen2" else FAMILIES[name][:2]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("runs on the card's machine, under its torch (-m cuda there)")
    root = tmp_path_factory.mktemp("card_worlds")
    steps_root, flash_root = str(root / "steps"), str(root / "flash")
    names = sorted({n for _, _, cases in STEP_WORLDS.values() for n in cases})
    inputs = {n: write_inputs(os.path.join(steps_root, n), *_arch(n)) for n in names}
    flash_cases = write_flash_cases(flash_root)
    specs = [(ranks, mp, 0, *[f"{n}:{_arch(n)[0]}:{int(_arch(n)[1])}" for n in cases])
             for ranks, mp, cases in STEP_WORLDS.values()]
    running = [start_worlds(STEPS_WORKER, steps_root, specs, timeout=WORLDS_TIMEOUT)]
    try:
        running.append(start_worlds(FLASH_WORKER, flash_root, list(FLASH_WORLDS.values()),
                                    timeout=WORLDS_TIMEOUT))
        plain = {n: plain_steps(inputs[n], *_arch(n)) for n in names}
        flash_plain = {c: plain_decode(flash_cases[c]) for c in DIVIDED}
        for worlds in running:
            worlds.wait()
    finally:
        for worlds in running:
            worlds.kill()
    out = {}
    for world, (ranks, mp, cases) in STEP_WORLDS.items():
        for n in cases:
            with open(os.path.join(steps_root, n, f"out_{ranks}_{mp}_0.pkl"), "rb") as f:
                out[(n, world)] = pickle.load(f)
    flash = {}
    for world, (ranks, mp) in FLASH_WORLDS.items():
        with open(os.path.join(flash_root, f"out_{ranks}_{mp}.pkl"), "rb") as f:
            flash[world] = pickle.load(f)
    return {"plain": plain, "worlds": out, "flash_plain": flash_plain, "flash": flash}


GRID = [(n, world, kind) for world, (_, _, cases) in STEP_WORLDS.items() for n in cases
        for kind in KINDS]
IDS = [f"{n}-{world}-{kind}" for n, world, kind in GRID]


@pytest.mark.parametrize("name,world,kind", GRID, ids=IDS)
def test_mesh_step_matches_no_mesh(runs, name, world, kind):
    close(runs["worlds"][(name, world)]["out"][kind], runs["plain"][name][kind], mesh_tol(name),
          f"{name} {world} {kind}")


@pytest.mark.parametrize("name,world,kind", GRID, ids=IDS)
def test_outputs_keep_their_placements(runs, name, world, kind):
    oks = runs["worlds"][(name, world)]["ok"]
    assert len(oks) == STEP_WORLDS[world][0] and all(ok[kind] for ok in oks), oks


def test_scan_kernel_gets_plain_tensors_under_the_model_axis(runs):
    scans = runs["worlds"][("falcon-mamba", "2x2")]["scans"]
    for calls in scans:
        names = [name for name, _ in calls]
        assert "scan_fwd" in names and "scan_bwd" in names, names
        assert all(t == ["Tensor"] * len(t) for _, t in calls), calls


FLASH_GRID = [(w, c) for w in FLASH_WORLDS for c in DIVIDED]


@pytest.mark.parametrize("world,case", FLASH_GRID, ids=[f"{w}-{c}" for w, c in FLASH_GRID])
def test_flash_on_the_mesh_matches_the_plain_decode(runs, world, case):
    window, cache_len, _, pos = FLASH_CASES[case]
    got = runs["flash"][world]["results"][case]["flash"]
    logits, cache = runs["flash_plain"][case]
    close_logits(got["logits"], logits, f"{world} {case} logits")
    for stack in cache:
        hold_cache(got["cache"][stack], cache[stack], written(cache_len, window, pos),
                   f"{world} {case}")


@pytest.mark.parametrize("world", list(FLASH_WORLDS))
def test_flash_caches_keep_their_placements_on_every_rank(runs, world):
    assert runs["flash"][world]["mesh"] == (FLASH_WORLDS[world][0] // FLASH_WORLDS[world][1],
                                            FLASH_WORLDS[world][1])
    for rank in runs["flash"][world]["ranks"]:
        for case, res in rank.items():
            assert all(placed for _, placed in res.values()), (world, case)
