"""The port's ``EngineConfig(dtype="bfloat16")`` policy, on the CPU (the
mirror of ``tests/test_precision.py``).

Params, grads and client batches compute in bf16; Ψ (anchored at the fp32
parameters), the cluster means and the Eq. 2 objective stay fp32. So a
bf16 run carries bf16 leaves end to end, keeps its clustering surfaces in
finite fp32, and tracks the fp32 trajectory per strategy (relative norm
< 0.05 over 4 rounds, the reference's own bound).

Against the JAX engine's bf16 eager rounds on the same numpy inputs:
cohorts and partitions exact; ω, the bank rows and Ditto's personal rows
each within a relative norm of 1e-2. bf16
keeps 8 significant bits (a relative step of 2⁻⁸ ≈ 3.9e-3), and the two
frameworks round the local steps' bf16 arithmetic at different places (XLA
may keep fp32 between fused bf16 operations, torch rounds every
operation), so single roundings differ by up to an ulp and a few of them
accumulate over 4 rounds of 2 steps; 1e-2 is about 2.5 ulp of relative
drift. The fused bf16 path (K1's bf16 entry on the card, its plain
version here) equals the tree path within the same bound.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import engine as jengine  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import engine as tengine  # noqa: E402
from repro_torch.core import device_clustering as devclust  # noqa: E402
from repro_torch.core.extractor import make_extractor  # noqa: E402
from repro_torch.models import simple as tsimple  # noqa: E402
from repro_torch.utils import trees  # noqa: E402

ALL = ["stocfl", "fedavg", "fedprox", "ditto", "ifca", "cfl"]
FP32_REL = 0.05
REF_REL = 1e-2
J_TASK = dataclasses.replace(jsimple.SYNTH_MLP, hidden=32)
T_TASK = tsimple.TaskConfig("synth_mlp", "mlp", (64,), 10, hidden=32)
ROUNDS = 4


def _tloss(p, b):
    return tsimple.loss_fn(p, b, T_TASK)


def _jloss(p, b):
    return jsimple.loss_fn(p, b, J_TASK)


def _fed():
    clients, _, _ = jsynthetic.rotated(n_clusters=2, n_clients=12, n_per=32, seed=3)
    return clients


def _kw(name, **kw):
    kw.setdefault("local_steps", 2)
    kw.setdefault("sample_rate", 0.5)
    kw.setdefault("seed", 0)
    kw.setdefault("rng_backend", "device")
    if name == "stocfl":
        kw.setdefault("cluster_backend", "device")
    if name == "cfl":
        kw["sample_rate"] = 1.0
        kw.setdefault("eps_rel", 0.9)
        kw.setdefault("eps2", 1e-4)
    return kw


def _params():
    return jsimple.init(jax.random.PRNGKey(0), J_TASK)


def _tinit(name, dtype, fused=False, **kw):
    return tengine.init(name, _tloss, convert.to_torch(_params()), _fed(),
                        tengine.EngineConfig(**_kw(name, dtype=dtype, fused_step=fused, **kw)),
                        device="cpu", arena=True)


def _run(state, rounds=ROUNDS):
    for _ in range(rounds):
        state, _ = tengine.run_round(state)
    return state


def _flat(tree) -> np.ndarray:
    return np.concatenate([x.detach().float().reshape(-1).numpy() for x in trees.leaves(tree)])


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-6))


def _model_trees(state):
    return ([state.omega] + [state.models[r] for r in state.models.roots]
            + list(state.personal.values()))


@pytest.mark.parametrize("name", ALL)
def test_bf16_tracks_fp32_trajectory(name):
    a = _run(_tinit(name, "float32"))
    b = _run(_tinit(name, "bfloat16"))
    for tree in _model_trees(b):
        for leaf in trees.leaves(tree):
            assert leaf.dtype == torch.bfloat16
            assert bool(torch.isfinite(leaf.float()).all())
    for leaf in trees.leaves(b.ctx.init_params) + trees.leaves(b.ctx.arena.packed):
        assert leaf.dtype in (torch.bfloat16, torch.int32, torch.int64)
    rel = _rel(_flat(a.omega), _flat(b.omega))
    assert rel < FP32_REL, f"{name}: bf16 drifted {rel:.4f} from fp32"


def test_bf16_clustering_surfaces_stay_fp32():
    st = _run(_tinit("stocfl", "bfloat16"))
    ref = _run(_tinit("stocfl", "float32"))
    assert st.clusters.state.rep.dtype == torch.float32
    roots, means = st.clusters.cluster_means()
    assert means.dtype == torch.float32 and roots
    assert devclust.objective_closed_impl(st.clusters.state).dtype == torch.float32
    for rec in st.history:
        assert isinstance(rec["objective"], float) and np.isfinite(rec["objective"])
    assert st.clusters.assignment() == ref.clusters.assignment()


def test_bf16_psi_is_the_fp32_anchors():
    """Ψ in bf16 mode is Ψ of the fp32 parameters on the bf16-cast batch:
    the extractor's anchor is not cast."""
    st = _tinit("stocfl", "bfloat16")
    anchor = convert.to_torch(_params())
    psi32 = make_extractor(_tloss, anchor)
    for c in (0, 5):
        batch = st.ctx.clients[c]
        assert batch["x"].dtype == torch.bfloat16
        got = st.ctx.extractor(batch)
        want = psi32({"x": batch["x"].float(), "y": batch["y"]})
        assert got.dtype == torch.float32 and torch.equal(got, want)


def _jrun(name, dtype, fused=False):
    js = jengine.init(name, _jloss, _params(), [jax.tree.map(jnp.asarray, c) for c in _fed()],
                      jengine.EngineConfig(**_kw(name, dtype=dtype, fused_step=fused)),
                      arena=True)
    recs = []
    for _ in range(ROUNDS):
        js, rec = jengine.run_round(js)
        recs.append(rec)
    return js, recs


@pytest.mark.parametrize("name", ALL)
def test_bf16_eager_rounds_match_reference(name):
    js, jrecs = _jrun(name, "bfloat16")
    ts = _tinit(name, "bfloat16")
    if name == "ifca":      # the reference's jax.random hypotheses, fed in
        js0 = jengine.init(name, _jloss, _params(), _fed(),
                           jengine.EngineConfig(**_kw(name, dtype="bfloat16")), arena=True)
        ts = ts.replace(models=tengine.ClusterBank.from_dict(
            {m: convert.to_torch(js0.models[m]) for m in js0.models.roots}))
    ts = _run(ts)
    for jr, tr in zip(jrecs, ts.history):
        for k in ("sampled", "n_clusters"):
            assert jr.get(k) == tr.get(k), k
    assert ts.rng_key is None or np.array_equal(
        np.asarray(jax.random.key_data(js.rng_key)), ts.rng_key.numpy())
    assert js.members == ts.members
    if name == "stocfl":
        assert js.clusters.assignment() == ts.clusters.assignment()
    for leaf in trees.leaves(ts.omega):
        assert leaf.dtype == torch.bfloat16
    # ω, then the bank rows and Ditto's personal rows (IFCA and CFL train
    # only their banks)
    assert sorted(js.models.roots) == sorted(ts.models.roots)
    pairs = ([(js.omega, ts.omega)] + [(js.models[r], ts.models[r]) for r in js.models.roots]
             + [(js.personal[c], ts.personal[c]) for c in sorted(js.personal)])
    for j_tree, t_tree in pairs:
        want = np.concatenate([np.asarray(x, np.float32).ravel()
                               for x in jax.tree.leaves(j_tree)])
        rel = _rel(want, _flat(t_tree))
        assert rel < REF_REL, f"{name}: port bf16 {rel:.2e} from the reference's"


@pytest.mark.parametrize("name", ["stocfl", "fedprox", "ditto"])
def test_bf16_fused_equals_tree(name):
    a = _run(_tinit(name, "bfloat16", fused=False))
    b = _run(_tinit(name, "bfloat16", fused=True))
    fa, fb = _flat(a.omega), _flat(b.omega)
    assert np.isfinite(fb).all() and _rel(fa, fb) < REF_REL


def test_bf16_run_rounds_matches_eager():
    start = _tinit("stocfl", "bfloat16", fused=True)
    eager = _run(start)
    scanned = tengine.run_rounds(start, ROUNDS)
    assert np.array_equal(_flat(eager.omega), _flat(scanned.omega))
    assert eager.clusters.assignment() == scanned.clusters.assignment()
    for r in eager.models.roots:
        assert np.array_equal(_flat(eager.models[r]), _flat(scanned.models[r]))
        assert all(x.dtype == torch.bfloat16 for x in trees.leaves(scanned.models[r]))


# --------------------------------------------- evaluation, inference, join
ACC_TOL = 2 / 512      # one or two of a 512-example test set flipping


def test_bf16_evaluate_infer_join_match_reference():
    """Under bf16 the models meet fp32 test and newcomer batches: the
    port's ``evaluate`` up-casts the model for the forward pass, as JAX
    promotes the mixed product, and returns the reference's accuracies;
    ``infer`` and ``join`` (Ψ on the fp32 newcomer, anchored at the fp32
    parameters) choose the reference's cluster."""
    _, true_cluster, tests = jsynthetic.rotated(n_clusters=2, n_clients=12, n_per=32, seed=3)
    js = jengine.init("stocfl", _jloss, _params(), [jax.tree.map(jnp.asarray, c) for c in _fed()],
                      jengine.EngineConfig(**_kw("stocfl", dtype="bfloat16")), arena=True,
                      eval_fn=lambda p, b: jsimple.accuracy(p, b, J_TASK))
    ts = tengine.init("stocfl", _tloss, convert.to_torch(_params()), _fed(),
                      tengine.EngineConfig(**_kw("stocfl", dtype="bfloat16")), device="cpu",
                      arena=True, eval_fn=lambda p, b: tsimple.accuracy(p, b, T_TASK))
    for _ in range(2):
        js, _ = jengine.run_round(js)
        ts, _ = tengine.run_round(ts)
    want = jengine.evaluate(js, tests, true_cluster)
    got = tengine.evaluate(ts, tests, true_cluster)
    assert sorted(got["cluster"]) == sorted(want["cluster"])
    for k in want["cluster"]:
        assert abs(got["cluster"][k] - float(want["cluster"][k])) <= ACC_TOL, k
        assert abs(got["global"][k] - float(want["global"][k])) <= ACC_TOL, k
    assert abs(got["cluster_avg"] - float(want["cluster_avg"])) <= ACC_TOL
    factory = jsynthetic.rotated_factory(n_clusters=2, n_per=32, seed=3)
    newcomers = [factory(k, np.random.default_rng(k)) for k in (0, 1, 1)]
    for batch in newcomers:
        ji = jengine.infer(js, jax.tree.map(jnp.asarray, batch))
        ti = tengine.infer(ts, batch)
        assert (ti["cluster"], ti["seed_from"]) == (ji["cluster"], ji["seed_from"])
        assert abs(ti["similarity"] - float(ji["similarity"])) <= 1e-5
    for batch in newcomers:
        js, jcid = jengine.join(js, jax.tree.map(jnp.asarray, batch))
        ts, tcid = tengine.join(ts, batch)
        assert tcid == jcid
        assert ts.clusters.assignment() == js.clusters.assignment()
        assert sorted(ts.models.roots) == sorted(js.models.roots)
        assert ts.ctx.clients[tcid]["x"].dtype == torch.bfloat16
    ts, _ = tengine.run_round(ts)
    js, _ = jengine.run_round(js)
    assert ts.clusters.assignment() == js.clusters.assignment()
