"""The batched Ψ extractor and the routing it serves, the port against the
JAX package, on the CPU.

``make_extractor(..., batched=True)`` maps a stacked batch of clients to
(J, dim) rows: the port runs a chunk of clients' losses under one
``torch.func.vmap``, takes their kept gradients from one autograd call
and sketches and normalises every row outside the vmap; the reference
vmaps its whole Ψ.
Held here, for the paper's MLP and the smoke configs of qwen2,
falcon-mamba (``use_pallas=True``: the ``SSMScan`` op, its plain versions
on the CPU), zamba2, phi3.5-moe, deepseek-v2, whisper and internvl2, in
fp32, with and without ``llm_leaf_filter`` and the JL sketch:

- the port's rows against the reference's within 1e-5 of the reference's
  largest |value|. Without the sketch both rows are first scaled to unit
  norm in float64, and each side's fp32 norm is held within 1e-3 of 1:
  Ψ is read only through cosines, and on the CPU the port's fp32
  ``torch.linalg.vector_norm`` over 10⁵–10⁶ entries is off by up to
  4e-4 of the norm on these models (its raw gradients meet the
  reference's within 2e-6 of each leaf's largest |value|; the batched
  rows keep the unbatched Ψ's norm, which the round uses);
- ``representation`` against the reference's;
- the batched rows against the port's unbatched Ψ within 1e-6, chunk 0
  against chunks 1 and 3, and the sketch's ``rows`` bit for bit against
  its one-vector call on the same gradients;
- ``engine.infer_batch`` (the serving router's path) against the
  reference's ``infer_batch``: routes equal, similarities within 1e-5;
  one vmapped call a chunk, no per-batch Ψ; a ``ValueError`` naming the
  leaf on ragged batches.

The sketch's draws are fed from ``jax.random`` (``_jax_draws``), so both
packages project with the same buckets and signs.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import engine as jengine  # noqa: E402
from repro.core import extractor as jextractor  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.data import tokens as jtokens  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import engine as tengine  # noqa: E402
from repro_torch.core import extractor as textractor  # noqa: E402
from repro_torch.models import registry as tregistry  # noqa: E402
from repro_torch.models import simple as tsimple  # noqa: E402

RTOL = 1e-5                 # of the reference's largest |value|
# zamba2: both packages' fp32 gradients sit up to 3e-5 of the largest |value|
# from a float64 gradient of the same model (Mamba2's scan amplifies
# rounding), so the two are held within 1e-4 of each other there
ZAMBA2_RTOL = 1e-4
SELF_TOL = 1e-6             # batched against unbatched, chunk against chunk
SKETCH = 4096
J, SEQ, PER_CLIENT = 3, 8, 2
J_TASK = dataclasses.replace(jsimple.SYNTH_MLP, hidden=32)
T_TASK = tsimple.TaskConfig("synth_mlp", "mlp", (64,), 10, hidden=32)
LLMS = {"qwen2": ("qwen2-1.5b", {}),
        "falcon-mamba": ("falcon-mamba-7b", {"use_pallas": True}),
        "zamba2": ("zamba2-1.2b", {}),
        "phi3.5-moe": ("phi3.5-moe-42b-a6.6b", {}),
        "deepseek-v2": ("deepseek-v2-236b", {}),
        "whisper": ("whisper-medium", {}),
        "internvl2": ("internvl2-26b", {})}
MODELS = ["mlp", *LLMS]


def _jax_draws(n, dim, seed):
    """The reference's ``_jl_sketch`` draws, as ``jl_draws`` returns them."""
    kb, ks = jax.random.split(jax.random.PRNGKey(seed))
    buckets = np.array(jax.random.randint(kb, (n,), 0, dim))
    signs = np.array(jax.random.rademacher(ks, (n,), dtype=jnp.float32))
    return (torch.as_tensor(buckets, dtype=torch.int32),
            torch.as_tensor(signs).to(torch.int8))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke models: one intra-op thread, so a parallel test run's
    oversubscribed CPU does not stall the thread pool's barriers."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.fixture(autouse=True)
def _draws(monkeypatch):
    monkeypatch.setattr(textractor, "jl_draws", _jax_draws)


class World:
    """One model in both packages: loss functions, the reference's
    parameters and the port's copy of them, and numpy client batches."""

    def __init__(self, name):
        self.name = name
        if name == "mlp":
            self.jloss = lambda p, b: jsimple.loss_fn(p, b, J_TASK)
            self.tloss = lambda p, b: tsimple.loss_fn(p, b, T_TASK)
            self.jparams = jsimple.init(jax.random.PRNGKey(0), J_TASK)
            clients, _, _ = jsynthetic.rotated(n_clusters=4, n_clients=12, n_per=16, seed=3)
            self.clients = [{k: np.asarray(v) for k, v in c.items()} for c in clients]
        else:
            arch, kw = LLMS[name]
            kw = {"dtype": "float32", **kw}
            jcfg = jconfigs.get_config(arch, smoke=True, **kw)
            jm = jregistry.build(jcfg)
            tm = tregistry.build(tconfigs.get_config(arch, smoke=True, **kw))
            self.jloss, self.tloss = jm.loss_fn, tm.loss_fn
            # the port's draw, carried to the reference (no init program to compile)
            self.jparams = jax.tree.map(jnp.asarray, convert.to_numpy(
                tm.init(torch.Generator().manual_seed(0))))
            self.clients = [{k: np.asarray(v) for k, v in
                             jtokens.synthetic_lm_batch(jcfg, SEQ, PER_CLIENT, seed=i,
                                                        domain=i % 2).items()}
                            for i in range(12)]
        self.tparams = convert.to_torch(self.jparams)

    def stacked(self, n=J):
        return {k: np.stack([c[k] for c in self.clients[:n]]) for k in self.clients[0]}

    def filters(self, filtered):
        return ((jextractor.llm_leaf_filter, textractor.llm_leaf_filter) if filtered
                else (None, None))


@functools.lru_cache(maxsize=None)
def _world(name) -> World:
    return World(name)


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(got, want, sketched, rtol=RTOL):
    """The port's rows against the reference's, within ``RTOL`` of the
    reference's largest |value|; unsketched rows compared as directions
    (the module's docstring)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    if not sketched:
        unit = []
        for x in (got, want):
            norms = np.linalg.norm(x, axis=-1, keepdims=True)
            assert np.all(np.abs(norms - 1) <= 1e-3), norms
            unit.append(x / norms)
        got, want = unit
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale, f"max |diff| {err:.3e} > {rtol:g} x {scale:.3e}"


def _kept(w):
    """The reference's ``llm_leaf_filter`` as a mask over its flat Ψ."""
    flat = jax.tree_util.tree_flatten_with_path(w.jparams)[0]
    return np.concatenate([
        np.full(v.size, jextractor.llm_leaf_filter("/".join(str(k.key) for k in kp)))
        for kp, v in flat])


@functools.lru_cache(maxsize=None)
def _reference_rows(name):
    """The reference's batched Ψ of the stacked batch, no filter, no sketch."""
    w = _world(name)
    return np.asarray(jextractor.make_extractor(w.jloss, w.jparams, batched=True)(
        _j(w.stacked())))


def _reference_variant(name, project_dim, filtered):
    """The reference's batched Ψ with ``llm_leaf_filter`` and a sketch of
    ``project_dim``, from its unfiltered rows: the kept entries, the
    reference's ``_jl_sketch`` of each row, unit norm in float64 (the
    full row's norm is a common factor that the last step drops).
    ``test_reference_variants_are_the_reference_extractor`` holds this
    against the reference's own extractor."""
    rows = _reference_rows(name)
    if filtered:
        rows = rows[:, _kept(_world(name))]
    if project_dim:
        rows = np.stack([np.asarray(jextractor._jl_sketch(jnp.asarray(r), project_dim))
                         for r in rows])
    rows = rows.astype(np.float64)
    return rows / np.linalg.norm(rows, axis=1, keepdims=True)


CASES = [("mlp", None, False), ("mlp", SKETCH, False)] + \
    [(m, p, f) for m in LLMS for p, f in ((None, False), (SKETCH, True))]


@pytest.mark.parametrize("name,project_dim,filtered", CASES)
def test_batched_psi_matches_reference(name, project_dim, filtered):
    w = _world(name)
    want = (_reference_rows(name) if not (project_dim or filtered)
            else _reference_variant(name, project_dim, filtered))
    got = textractor.make_extractor(w.tloss, w.tparams, project_dim, batched=True,
                                    leaf_filter=w.filters(filtered)[1],
                                    chunk=2)(_t(w.stacked()))
    assert got.dtype == torch.float32 and got.shape[0] == J
    _close(got, want, bool(project_dim), ZAMBA2_RTOL if name == "zamba2" else RTOL)


def test_reference_variants_are_the_reference_extractor():
    """On falcon-mamba (K5's family), the filtered and sketched rows that
    the cases above derive from the reference's unfiltered ones equal the
    reference's batched extractor called with the filter and the sketch,
    and the port's rows meet that call within 1e-5 too."""
    w, project_dim, filtered = _world("falcon-mamba"), SKETCH, True
    want = np.asarray(jextractor.make_extractor(
        w.jloss, w.jparams, project_dim, batched=True,
        leaf_filter=w.filters(filtered)[0])(_j(w.stacked())), np.float64)
    derived = _reference_variant("falcon-mamba", project_dim, filtered)
    assert np.abs(derived - want).max() <= SELF_TOL * np.abs(want).max()
    got = textractor.make_extractor(w.tloss, w.tparams, project_dim, batched=True,
                                    leaf_filter=w.filters(filtered)[1])(_t(w.stacked()))
    _close(got, want, bool(project_dim))


@pytest.mark.parametrize("project_dim", [None, SKETCH])
def test_representation_matches_reference(project_dim):
    w = _world("mlp")
    want = jextractor.representation(w.jloss, w.jparams, _j(w.clients[0]), project_dim)
    got = tcore.representation(w.tloss, w.tparams, _t(w.clients[0]), project_dim)
    assert got.dtype == torch.float32 and got.ndim == 1
    _close(got, want, bool(project_dim))


@pytest.mark.parametrize("name,project_dim,filtered",
                         [("mlp", None, False), ("qwen2", SKETCH, True),
                          ("falcon-mamba", SKETCH, True), ("zamba2", None, True),
                          ("phi3.5-moe", SKETCH, True)])
def test_batched_rows_match_unbatched_and_chunks_agree(name, project_dim, filtered):
    w = _world(name)
    _, tf = w.filters(filtered)
    one, many = textractor.make_extractors(w.tloss, w.tparams, project_dim, leaf_filter=tf)
    rows = torch.stack([one(_t(c)) for c in w.clients[:5]])
    whole = many(_t(w.stacked(5)))
    assert torch.allclose(whole, rows, rtol=0, atol=SELF_TOL)
    for chunk in (1, 3):
        got = textractor.make_extractor(w.tloss, w.tparams, project_dim, batched=True,
                                        leaf_filter=tf, chunk=chunk)(_t(w.stacked(5)))
        assert torch.allclose(got, whole, rtol=0, atol=SELF_TOL), chunk


def test_batched_psi_under_remat_matches_unbatched():
    """Every full config checkpoints its layers: ``layers.remat`` under
    ``vmap(grad)``, with K5's op inside (falcon-mamba, ``use_pallas``)."""
    for arch in ("qwen2-1.5b", "falcon-mamba-7b"):
        cfg = tconfigs.get_config(arch, smoke=True, dtype="float32", remat=True,
                                  use_pallas=True)
        model = tregistry.build(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        batches = [jtokens.synthetic_lm_batch(cfg, SEQ, PER_CLIENT, seed=i, domain=i % 2)
                   for i in range(3)]
        one, many = textractor.make_extractors(model.loss_fn, params, SKETCH,
                                               leaf_filter=textractor.llm_leaf_filter)
        rows = torch.stack([one(_t(b)) for b in batches])
        got = many(_t({k: np.stack([b[k] for b in batches]) for k in batches[0]}))
        assert torch.allclose(got, rows, rtol=0, atol=SELF_TOL), arch


def test_unread_leaf_gives_zero_rows_and_frozen_leaves_none():
    """A kept leaf the loss never reads has a zero gradient in every row
    (as ``jax.grad`` gives it), and a leaf the filter drops has no entries."""
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(4, 3, generator=gen), "unread": torch.randn(5, generator=gen),
              "frozen": torch.randn(2, generator=gen)}
    loss = lambda p, b: ((b["x"] @ p["w"]) * p["frozen"].sum()).pow(2).mean()
    batches = {"x": torch.randn(3, 6, 4, generator=gen)}
    keep = lambda path: path != "frozen"
    one, many = textractor.make_extractors(loss, params, leaf_filter=keep, chunk=2)
    rows = many(batches)
    assert rows.shape == (3, 5 + 12)                      # sorted leaves: unread, w
    assert torch.equal(rows[:, :5], torch.zeros(3, 5)) and bool(rows[:, 5:].any())
    want = torch.stack([one({"x": batches["x"][j]}) for j in range(3)])
    assert torch.allclose(rows, want, rtol=0, atol=SELF_TOL)


@pytest.mark.parametrize("sizes,dim", [((1000,), 64), ((300, 5, 700), 64), ((5, 5), 16)])
def test_sketch_rows_are_the_one_vector_sketch_bit_for_bit(sizes, dim):
    """Given the same gradients, each row of ``JLSketch.rows`` is the
    one-vector sketch exactly (empty buckets at 5 + 5 entries)."""
    rng = np.random.default_rng(sum(sizes))
    parts = [torch.as_tensor(rng.normal(size=(4, n)).astype(np.float32)) for n in sizes]
    sketch = textractor.JLSketch(list(sizes), dim, 0, "cpu")
    got = sketch.rows(parts)
    want = torch.stack([sketch([p[j] for p in parts]) for j in range(4)])
    assert got.shape == (4, dim) and torch.equal(got, want)


# ------------------------------------------------------------ infer_batch
def _engines(name, chunk=0):
    """Both engines with a client of each domain joined (τ 0.3), so each
    holds clusters to route against; the port's at ``cohort_chunk``."""
    w = _world(name)
    flt = w.filters(name != "mlp")
    project_dim = None if name == "mlp" else SKETCH
    js = jengine.init("stocfl", w.jloss, w.jparams, [],
                      jengine.EngineConfig(tau=0.3, seed=0, project_dim=project_dim),
                      leaf_filter=flt[0])
    ts = tengine.init("stocfl", w.tloss, w.tparams, [],
                      tengine.EngineConfig(tau=0.3, seed=0, project_dim=project_dim,
                                           cohort_chunk=chunk),
                      device="cpu", leaf_filter=flt[1])
    for c in w.clients[:2]:
        js, jcid = jengine.join(js, _j(c))
        ts, tcid = tengine.join(ts, c)
        assert ts.client_root(tcid) == js.client_root(jcid)
    return w, js, ts


@pytest.mark.parametrize("name,chunk", [("mlp", 0), ("falcon-mamba", 2)])
def test_infer_batch_matches_reference(name, chunk):
    w, js, ts = _engines(name, chunk)
    fresh = w.clients[2:9]
    want = jengine.infer_batch(js, [_j(c) for c in fresh])
    got = tengine.infer_batch(ts, fresh)
    assert len(got) == len(want) == len(fresh)
    for g, r in zip(got, want):
        assert (g["cluster"], g["seed_from"]) == (r["cluster"], r["seed_from"])
        assert g["similarity"] == pytest.approx(r["similarity"], abs=RTOL)


def test_infer_batch_runs_one_vmapped_call_a_chunk(monkeypatch):
    """Seven batches at ``cohort_chunk`` 3: the loss runs three times (once
    a chunk, under vmap), the one-client Ψ never; routes equal ``infer``'s."""
    w, calls = _world("mlp"), []

    def counted(p, b):
        calls.append(tuple(b["x"].shape))
        return w.tloss(p, b)

    ts = tengine.init("stocfl", counted, w.tparams, [],
                      tengine.EngineConfig(tau=0.3, seed=0, cohort_chunk=3), device="cpu")
    for c in w.clients[:4]:
        ts, _ = tengine.join(ts, c)
    fresh = w.clients[4:11]
    single = [tengine.infer(ts, c) for c in fresh]
    monkeypatch.setattr(ts.ctx, "extractor", None)        # a per-batch Ψ would raise
    calls.clear()
    got = tengine.infer_batch(ts, fresh)
    assert len(calls) == 3
    for g, s in zip(got, single):
        assert (g["cluster"], g["seed_from"]) == (s["cluster"], s["seed_from"])
        assert g["similarity"] == pytest.approx(s["similarity"], abs=SELF_TOL)


@pytest.mark.parametrize("bad,match", [
    (lambda b: {**b, "x": b["x"][:-1]}, "leaf 'x' of batch 2 has shape"),
    (lambda b: {"x": b["x"]}, "leaf 'y' differs"),
    (lambda b: {**b, "z": b["y"]}, "leaf 'z' differs"),
])
def test_infer_batch_names_the_ragged_leaf(bad, match):
    w = _world("mlp")
    ts = tengine.init("stocfl", w.tloss, w.tparams, [], tengine.EngineConfig(tau=0.3),
                      device="cpu")
    ts, _ = tengine.join(ts, w.clients[0])
    batches = list(w.clients[1:4])
    batches[2] = bad(batches[2])
    with pytest.raises(ValueError, match=match):
        tengine.infer_batch(ts, batches)
    js = jengine.init("stocfl", w.jloss, w.jparams, [], jengine.EngineConfig(tau=0.3))
    js, _ = jengine.join(js, _j(w.clients[0]))
    with pytest.raises(ValueError):                 # the reference refuses them too
        jengine.infer_batch(js, [_j(b) for b in batches])
