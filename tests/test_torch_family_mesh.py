"""Every family's mesh-aware steps (``repro_torch.launch.steps``) on a
``(data, model)`` mesh of ``gloo`` ranks on the CPU.

Each family's smoke config in fp32 runs ``tests/_torch_steps_worker.py``
(train: StoCFL's bi-level step with the fused prox update; prefill;
decode; Ψ) in a 2×2 world of four ranks: falcon-mamba with ``use_pallas``
(K5's autograd op), phi3.5-moe, deepseek-v2 (MLA), zamba2, whisper-medium
and internvl2-26b. Worlds of two ranks on a 1×2 mesh add whisper and
falcon-mamba with ``use_pallas`` off, where the model axis alone splits
the heads and channels. qwen2 runs in ``test_torch_steps_mesh.py``.

Each step is held against the same port step without a mesh within
``MESH_TOL`` of the largest magnitude of each leaf (sharded contractions
sum in another order), and against the JAX package's step functions
(``repro.launch.steps``) run unsharded on the CPU within ``REF_TOL``, the
parameters carried across by ``convert``. Every output leaf
has its rule-table placement on every rank, and under the model axis the
selective-scan kernel's wrappers receive plain tensors, never DTensors
(a DTensor has no storage for a kernel's pointer). All worlds start at
once, while the test computes the references.
"""
import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_mesh_cases import FAMILIES, KINDS, mesh_tol, plain_steps, write_inputs  # noqa: E402
from _torch_world import HERE, close, start_worlds  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build as jbuild  # noqa: E402

WORKER = os.path.join(HERE, "_torch_steps_worker.py")
REF_TOL = 2e-5
# against the reference zamba2 measured 2.83e-05 on the 2×2 mesh (the port
# without a mesh 1.24e-05; see ``_torch_mesh_cases.MESH_TOLS``)
REF_TOLS = {"zamba2": 6e-5}
# both worlds at once, ~25 s alone; the cap leaves room for a loaded
# machine and still fails a hung world
WORLDS_TIMEOUT = 300.0


def _tols(fam):
    """(against no mesh, against the reference) for ``fam``."""
    return mesh_tol(fam), REF_TOLS.get(fam, REF_TOL)


def _reference(inputs, arch, pallas):
    """The JAX package's four steps, unsharded, on ``inputs``: one program
    (one compile) for the four."""
    jmodel = jbuild(jconfigs.get_config(arch, smoke=True, dtype="float32", use_pallas=pallas))

    def four(theta, omega, batch, token, cache, pos):
        logits, pcache = jsteps.prefill_step(jmodel)(theta, batch)
        t2, o2, m = jsteps.stocfl_train_step(jmodel)(theta, omega, batch)
        dlogits, dcache = jsteps.decode_step(jmodel)(theta, token, cache, pos)
        return {"train": {"theta": t2, "omega": o2, **m},
                "prefill": {"logits": logits, "cache": pcache},
                "decode": {"logits": dlogits, "cache": dcache},
                "repr": jsteps.repr_step(jmodel)(theta, batch)}

    args = [jax.tree.map(jnp.asarray, inputs[k]) for k in ("theta", "omega", "batch", "token",
                                                            "cache")]
    return jax.tree.map(np.asarray, jax.jit(four)(*args, jnp.int32(inputs["pos"])))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each family's world outputs by world, the reference's and the
    port's without a mesh. Two worlds (2×2 and 1×2) run every family of
    theirs in turn, started as soon as every input is written; each
    family's reference compiles on a thread of a pool (XLA compiles
    without the interpreter lock) while the port runs without a mesh."""
    root = str(tmp_path_factory.mktemp("families"))
    inputs = {fam: write_inputs(os.path.join(root, fam), arch, pallas)
              for fam, (arch, pallas, _) in FAMILIES.items()}
    cases = lambda dp: [f"{fam}:{arch}:{int(pallas)}"
                        for fam, (arch, pallas, dps) in FAMILIES.items() if dp in dps]
    worlds = start_worlds(WORKER, root, [(2 * dp, 2, 0, *cases(dp)) for dp in (2, 1)],
                          timeout=WORLDS_TIMEOUT)
    try:
        with ThreadPoolExecutor(4) as pool:
            # one reference an arch: falcon-mamba's two entries share the
            # JAX package's use_pallas route (its jnp scan on the CPU)
            refs = {}
            for fam, (arch, pallas, _) in FAMILIES.items():
                if arch not in refs:
                    refs[arch] = pool.submit(_reference, inputs[fam], arch, pallas)
            plain = {fam: plain_steps(inputs[fam], arch, pallas)
                     for fam, (arch, pallas, _) in FAMILIES.items()}
            ref = {fam: refs[arch].result() for fam, (arch, _, _) in FAMILIES.items()}
    finally:
        worlds.wait()
    out = {}
    for fam, (_, _, dps) in FAMILIES.items():
        for dp in dps:
            with open(os.path.join(root, fam, f"out_{2 * dp}_2_0.pkl"), "rb") as f:
                out[(fam, 2 * dp)] = pickle.load(f)
    return {"ref": ref, "plain": plain, "worlds": out}


WORLDS = [(fam, 2 * dp) for fam, (_, _, dps) in FAMILIES.items() for dp in dps]
GRID = [(fam, ranks, k) for fam, ranks in WORLDS for k in KINDS]
IDS = [f"{fam}-{ranks // 2}x2-{k}" for fam, ranks, k in GRID]


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_plain_steps_match_the_reference(runs, fam):
    for kind in KINDS:
        close(runs["plain"][fam][kind], runs["ref"][fam][kind], _tols(fam)[1], f"{fam} {kind}")


@pytest.mark.parametrize("fam,ranks,kind", GRID, ids=IDS)
def test_mesh_step_matches_no_mesh(runs, fam, ranks, kind):
    close(runs["worlds"][(fam, ranks)]["out"][kind], runs["plain"][fam][kind], _tols(fam)[0],
          f"{fam} {ranks} {kind}")


@pytest.mark.parametrize("fam,ranks,kind", GRID, ids=IDS)
def test_mesh_step_matches_the_reference(runs, fam, ranks, kind):
    close(runs["worlds"][(fam, ranks)]["out"][kind], runs["ref"][fam][kind], _tols(fam)[1],
          f"{fam} {ranks} {kind}")


@pytest.mark.parametrize("fam,ranks,kind", GRID, ids=IDS)
def test_outputs_keep_their_placements(runs, fam, ranks, kind):
    oks = runs["worlds"][(fam, ranks)]["ok"]
    assert len(oks) == ranks and all(ok[kind] for ok in oks), oks


def test_scan_kernel_gets_plain_tensors_under_the_model_axis(runs):
    """Under a ``ShardCtx`` with a model axis, K5's forward and backward
    wrappers receive tensors with storage on every rank (each rank's
    rows and channels), never DTensors: train and Ψ take the kernel
    (prefill and decode the plain scan, which returns the final state),
    and the world without ``use_pallas`` never reaches it."""
    scans = runs["worlds"][("falcon-mamba", 4)]["scans"]
    assert len(scans) == 4
    for calls in scans:
        names = [name for name, _ in calls]
        assert "scan_fwd" in names and "scan_bwd" in names, names
        assert all(t == ["Tensor"] * len(t) for _, t in calls), calls
    assert runs["worlds"][("falcon-mamba-plain", 2)]["scans"] == [[], []]


def test_worlds_split_the_channels_and_heads(runs):
    """falcon-mamba's d_inner columns and whisper's heads split over the
    model axis of both meshes (the fsdp rows over a data axis of 1 on the
    1×2 mesh, of 2 on the 2×2)."""
    for fam, ranks, mesh in (("falcon-mamba-plain", 2, (1, 2)), ("falcon-mamba", 4, (2, 2))):
        fm, wh = runs["worlds"][(fam, ranks)], runs["worlds"][("whisper", ranks)]
        assert fm["mesh"] == mesh and wh["mesh"] == mesh
        assert fm["specs"]["layers"]["mixer"]["in_proj"] == (None, "data", "model")
        assert wh["specs"]["dec_layers"]["cross"]["wq"] == (None, "data", "model")
