"""The port's mesh-aware LLM steps (``repro_torch.launch.steps``) on a
``(data, model)`` mesh of ``gloo`` ranks on the CPU.

Three worlds of four ranks run ``tests/_torch_steps_worker.py`` on the
qwen2 smoke config (6 heads, 2 KV heads, vocab 512) in fp32:

- ``make_host_mesh(model_parallel=2)``, a 2×2 mesh;
- a 1×4 mesh, where neither the 6 query heads nor the 2 KV heads divide
  the model axis, so their placements relax to replicated;
- the 2×2 mesh with ``serve_params_tp_only`` (parameters on the model
  axis only).

In each, the train (StoCFL's bi-level step with the fused prox update),
prefill, decode and Ψ steps are held against the same port steps without
a mesh, within 1e-5 of the largest magnitude (sharded contractions sum
in another order), and against the JAX package's step functions
(``repro.launch.steps``) run unsharded on the CPU with the reference's
parameters carried across by ``convert``, within 2e-5. Every output leaf
has the placements the rule table gives it, on every rank. The decode
runs on a cache grown from the port's prefill, the same cache for all.
The worlds run at once, while the test computes the two references, and
fail the test if they have not finished within ``WORLDS_TIMEOUT``.
"""
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_world import HERE, close as _close, start_worlds  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.registry import build, grow_cache  # noqa: E402

WORKER = os.path.join(HERE, "_torch_steps_worker.py")
WORLDS = {"2x2": (2, 0), "1x4": (4, 0), "2x2-tp-only": (2, 1)}
B, S, S_MAX = 4, 16, 24
MESH_TOL, REF_TOL = 1e-5, 2e-5
# the three worlds' twelve single-threaded ranks run at once, ~30 s alone;
# the cap leaves room for a loaded machine and still fails a hung world
WORLDS_TIMEOUT = 180.0
KINDS = ("train", "prefill", "decode", "repr")


def _model():
    return build(get_config("qwen2-1.5b", smoke=True).with_(dtype="float32"))


def _inputs(root):
    """The inputs every world and the two references run on, written to
    ``root/inputs.pkl``: the reference's parameters, ω a perturbation of
    them, a batch, and a decode cache grown from the port's prefill."""
    jcfg = jconfigs.get_config("qwen2-1.5b", smoke=True).with_(dtype="float32")
    theta = convert.to_numpy(convert.to_torch(jbuild(jcfg).init(jax.random.PRNGKey(0))))
    rng = np.random.default_rng(0)
    omega = jax.tree.map(lambda x: x + 0.01 * rng.standard_normal(x.shape).astype(np.float32),
                         theta)
    tokens = rng.integers(0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    model = _model()
    logits, cache = model.prefill(convert.to_torch(theta), {"tokens": torch.as_tensor(tokens)})
    inputs = {"theta": theta, "omega": omega, "tokens": tokens, "batch": {"tokens": tokens},
              "pos": S, "s_max": S_MAX,
              "token": torch.argmax(logits, -1).to(torch.int32).numpy(),
              "cache": convert.to_numpy(grow_cache(model, cache, B, S_MAX))}
    with open(os.path.join(root, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    return inputs


def _reference(inputs):
    """The JAX package's four steps, unsharded, on ``inputs``."""
    jmodel = jbuild(jconfigs.get_config("qwen2-1.5b", smoke=True).with_(dtype="float32"))
    theta = jax.tree.map(jnp.asarray, inputs["theta"])
    omega = jax.tree.map(jnp.asarray, inputs["omega"])
    batch = {"tokens": jnp.asarray(inputs["tokens"])}
    cache = jax.tree.map(jnp.asarray, inputs["cache"])
    logits, pcache = jax.jit(jsteps.prefill_step(jmodel))(theta, batch)
    t2, o2, m = jax.jit(jsteps.stocfl_train_step(jmodel))(theta, omega, batch)
    dlogits, dcache = jax.jit(jsteps.decode_step(jmodel))(
        theta, jnp.asarray(inputs["token"]), cache, jnp.int32(inputs["pos"]))
    ref = {"train": {"theta": t2, "omega": o2, **m},
           "prefill": {"logits": logits, "cache": pcache},
           "decode": {"logits": dlogits, "cache": dcache},
           "repr": jax.jit(jsteps.repr_step(jmodel))(theta, batch)}
    return jax.tree.map(np.asarray, ref)


def _plain(inputs):
    """The port's four steps without a mesh, on ``inputs``."""
    model = _model()
    theta, omega = convert.to_torch(inputs["theta"]), convert.to_torch(inputs["omega"])
    batch = {"tokens": torch.as_tensor(inputs["tokens"])}
    t2, o2, m = steps.stocfl_train_step(model)(theta, omega, batch)
    logits, pcache = steps.prefill_step(model)(theta, batch)
    dlogits, dcache = steps.decode_step(model)(
        theta, torch.as_tensor(inputs["token"]), convert.to_torch(inputs["cache"]),
        torch.tensor(inputs["pos"], dtype=torch.int32))
    return convert.to_numpy({"train": {"theta": t2, "omega": o2, **m},
                             "prefill": {"logits": logits, "cache": pcache},
                             "decode": {"logits": dlogits, "cache": dcache},
                             "repr": steps.repr_step(model)(theta, batch)})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The worlds' outputs, the reference's and the port's without a mesh;
    the worlds run while the other two are computed."""
    root = str(tmp_path_factory.mktemp("steps"))
    inputs = _inputs(root)
    worlds = start_worlds(WORKER, root, [(4, mp, tp_only) for mp, tp_only in WORLDS.values()],
                          timeout=WORLDS_TIMEOUT)
    try:
        ref, plain = _reference(inputs), _plain(inputs)
    finally:
        worlds.wait()
    out = {}
    for name, (mp, tp_only) in WORLDS.items():
        with open(os.path.join(root, f"out_4_{mp}_{tp_only}.pkl"), "rb") as f:
            out[name] = pickle.load(f)
    return {"ref": ref, "plain": plain, "worlds": out}


def test_plain_steps_match_the_reference(runs):
    for kind in KINDS:
        _close(runs["plain"][kind], runs["ref"][kind], REF_TOL, kind)


GRID = [(w, k) for w in WORLDS for k in KINDS]


@pytest.mark.parametrize("world,kind", GRID, ids=[f"{w}-{k}" for w, k in GRID])
def test_mesh_step_matches_no_mesh(runs, world, kind):
    _close(runs["worlds"][world]["out"][kind], runs["plain"][kind], MESH_TOL, f"{world} {kind}")


@pytest.mark.parametrize("world,kind", GRID, ids=[f"{w}-{k}" for w, k in GRID])
def test_mesh_step_matches_the_reference(runs, world, kind):
    _close(runs["worlds"][world]["out"][kind], runs["ref"][kind], REF_TOL, f"{world} {kind}")


@pytest.mark.parametrize("world,kind", GRID, ids=[f"{w}-{k}" for w, k in GRID])
def test_outputs_keep_their_placements(runs, world, kind):
    oks = runs["worlds"][world]["ok"]
    assert len(oks) == 4 and all(ok[kind] for ok in oks), oks


def test_worlds_run_the_meshes_asked_for(runs):
    """2×2 shards the fsdp rows over data; tp-only keeps them replicated;
    1×4 puts every rank on the model axis."""
    worlds = runs["worlds"]
    assert worlds["2x2"]["mesh"] == (2, 2) and worlds["1x4"]["mesh"] == (1, 4)
    wq = "layers/attn/wq"
    assert worlds["2x2"]["specs"]["layers"]["attn"]["wq"] == (None, "data", "model"), wq
    assert worlds["2x2-tp-only"]["specs"]["layers"]["attn"]["wq"] == (None, None, "model"), wq
    assert worlds["1x4"]["specs"]["embed"] == ("model", None)


def test_lm_train_step_matches_the_reference():
    """``lm_train_step`` (the plain data-parallel LM step, which
    ``lower_step`` does not bind, as the reference's does not) against the
    reference's, without a mesh."""
    jcfg = jconfigs.get_config("qwen2-1.5b", smoke=True).with_(dtype="float32")
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(1))
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    want, wm = jax.jit(jsteps.lm_train_step(jbuild(jcfg), lr=0.5))(
        jparams, {"tokens": jnp.asarray(tokens)})
    got, gm = steps.lm_train_step(_model(), lr=0.5)(
        convert.to_torch(jparams), {"tokens": torch.as_tensor(tokens)})
    _close(convert.to_numpy(got), jax.tree.map(np.asarray, want), REF_TOL, "lm_train")
    _close({"loss": gm["loss"].numpy()}, {"loss": np.asarray(wm["loss"])}, REF_TOL, "loss")
