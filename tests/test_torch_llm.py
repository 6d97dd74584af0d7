"""StoCFL's federated LLM round, the port against the JAX package, on the
CPU: the token data, the filtered and sketched Ψ, and three rounds of
both engines as a whole, on falcon-mamba, zamba2 and phi3.5-moe.

The smoke configs (falcon-mamba: 2 layers, d_model 128, vocab 512;
zamba2: 4 Mamba2 layers and the shared block twice; phi3.5-moe: 2 MoE
layers of 4 experts top-2) run in fp32 with ``use_pallas=True``, so the
port's falcon-mamba rounds go through the ``SSMScan`` op (its plain
versions on the CPU) and the reference's through its differentiable
``ssm_scan_ref`` (Mamba2 and the MoE stack reach no kernel). The JL sketch's draws come from
``jax.random`` in the reference; the port's ``extractor.jl_draws`` is
replaced here by the same ``jax.random`` calls as ``_jl_sketch`` makes.
Integer bookkeeping (cohorts, partitions, merge lists, ``n_clusters``)
must be equal; Ψ within atol 1e-5, ω and the bank rows within atol 1e-5
(the slice-1 precedent: sums in another order, a few fp32 SGD steps).
zamba2's rounds amplify fp32 rounding: at lr 0.05 its training sits at
the edge of stability. The reference's own rounds from ω₀ moved by one
fp32 ulp (measured once on the CPU with these settings) end round 0 with
ω 2.45e-3 away, the bank rows 3.5e-5 and 4.9e-3 away and ω's loss
1.16e-3 away, and round 2 with ω and a bank row 4e-2 away; the port's
Mamba2 gradients agree with the reference's to about 1e-5 of each leaf's
scale. So zamba2's round 0 is held within twice the largest of that
spread (``ZAMBA2_ROUND0``: 1e-2 on ω and the rows, 2.5e-3 on ω's loss;
twice, because the port's rounding, about 1e-5 of a gradient's scale
each step, moves the rounds more than one ulp of ω₀ does), and its later
rounds on their integer bookkeeping, the objective and finite values.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import engine as jengine  # noqa: E402
from repro.core import clustering as jclustering  # noqa: E402
from repro.core import extractor as jextractor  # noqa: E402
from repro.data import tokens as jtokens  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import engine as tengine  # noqa: E402
from repro_torch.core import clustering as tclustering  # noqa: E402
from repro_torch.core import extractor as textractor  # noqa: E402
from repro_torch.data import tokens as ttokens  # noqa: E402
from repro_torch.models import registry as tregistry  # noqa: E402
from repro_torch.utils import trees  # noqa: E402

ATOL = 1e-5
SEQ, PER_CLIENT, CLIENTS, DOMAINS, ROUNDS = 32, 2, 4, 2, 3
ARCHS = ["falcon-mamba-7b", "zamba2-1.2b", "phi3.5-moe-42b-a6.6b"]
# zamba2's round 0: twice the reference's own one-ulp spread (ω / rows, loss)
ZAMBA2_ROUND0 = {"params": 1e-2, "loss": 2.5e-3}


def _jax_draws(n, dim, seed):
    """The reference's ``_jl_sketch`` draws, as ``jl_draws`` returns them."""
    kb, ks = jax.random.split(jax.random.PRNGKey(seed))
    buckets = np.array(jax.random.randint(kb, (n,), 0, dim))
    signs = np.array(jax.random.rademacher(ks, (n,), dtype=jnp.float32))
    return (torch.as_tensor(buckets, dtype=torch.int32),
            torch.as_tensor(signs).to(torch.int8))


def _cfgs(arch="falcon-mamba-7b", **kw):
    kw = {"dtype": "float32", "use_pallas": True, **kw}
    return (jconfigs.get_config(arch, smoke=True, **kw),
            tconfigs.get_config(arch, smoke=True, **kw))


def _clients(cfg):
    return [jtokens.synthetic_lm_batch(cfg, SEQ, PER_CLIENT, seed=i, domain=i % DOMAINS)
            for i in range(CLIENTS)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke models: many small ops (the Mamba scans' steps), whose
    intra-op pool's barriers stall on an oversubscribed CPU under a
    parallel test run; one thread for this module."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.fixture(scope="module")
def jparams():
    jcfg, _ = _cfgs()
    return jregistry.build(jcfg).init(jax.random.PRNGKey(0))


@pytest.mark.parametrize("vocab,seq,batch,seed,domain",
                         [(512, 32, 2, 0, 0), (512, 32, 2, 3, 1), (65024, 256, 2, 1, 1),
                          (100, 7, 5, 2, 3)])
def test_token_stream_byte_identical(vocab, seq, batch, seed, domain):
    a = ttokens.token_stream(vocab, seq, batch, seed, domain=domain)
    b = jtokens.token_stream(vocab, seq, batch, seed, domain=domain)
    assert a.dtype == b.dtype == np.int32 and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "whisper-medium", "internvl2-26b"])
def test_synthetic_lm_batch_byte_identical(arch):
    a = ttokens.synthetic_lm_batch(tconfigs.get_config(arch, smoke=True), 24, 3, seed=4,
                                   domain=1)
    b = jtokens.synthetic_lm_batch(jconfigs.get_config(arch, smoke=True), 24, 3, seed=4,
                                   domain=1)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


def test_leaf_paths_and_filter_match_reference(jparams):
    want = ["/".join(str(getattr(k, "key", k)) for k in kp)
            for kp, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]]
    got = textractor.leaf_paths(convert.to_torch(jparams))
    assert got == want
    assert [textractor.llm_leaf_filter(p) for p in got] == \
        [jextractor.llm_leaf_filter(p) for p in want]
    assert [p for p in got if textractor.llm_leaf_filter(p)] == ["embed", "lm_head"]


def test_jl_draws_are_fixed_by_their_seed():
    b1, s1 = textractor.jl_draws(1000, 64, 0)
    b2, s2 = textractor.jl_draws(1000, 64, 0)
    b3, _ = textractor.jl_draws(1000, 64, 1)
    assert torch.equal(b1, b2) and torch.equal(s1, s2) and not torch.equal(b1, b3)
    assert b1.dtype == torch.int32 and s1.dtype == torch.int8
    assert b1.device.type == "cpu" and s1.device.type == "cpu"
    assert int(b1.min()) >= 0 and int(b1.max()) < 64
    assert set(s1.tolist()) == {-1, 1}


@pytest.mark.parametrize("sizes", [(1000,), (300, 1, 700), (5, 5)])
def test_jl_sketch_matches_reference(monkeypatch, sizes):
    """The sketch of consecutive parts equals the reference's sketch of
    their concatenation (empty buckets included at 5 + 5 entries)."""
    monkeypatch.setattr(textractor, "jl_draws", _jax_draws)
    vec = np.random.default_rng(sum(sizes)).normal(size=sum(sizes)).astype(np.float32)
    want = jextractor._jl_sketch(jnp.asarray(vec), 64)
    parts = np.split(vec, np.cumsum(sizes)[:-1])
    got = textractor.JLSketch(list(sizes), 64, 0, "cpu")([torch.as_tensor(p) for p in parts])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("project_dim,filtered", [(None, False), (None, True),
                                                  (64, False), (64, True)])
def test_psi_matches_reference(monkeypatch, jparams, project_dim, filtered):
    monkeypatch.setattr(textractor, "jl_draws", _jax_draws)
    jcfg, tcfg = _cfgs()
    jm, tm = jregistry.build(jcfg), tregistry.build(tcfg)
    flt = (jextractor.llm_leaf_filter, textractor.llm_leaf_filter) if filtered else (None, None)
    jpsi = jextractor.make_extractor(jm.loss_fn, jparams, project_dim, leaf_filter=flt[0])
    tpsi = textractor.make_extractor(tm.loss_fn, convert.to_torch(jparams), project_dim,
                                     leaf_filter=flt[1])
    for batch in _clients(jcfg)[:2]:
        want = np.asarray(jpsi({"tokens": jnp.asarray(batch["tokens"])}))
        got = tpsi({"tokens": torch.as_tensor(batch["tokens"])})
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def _recording_merges(cls, log):
    real = cls.merge_round

    def merge_round(self):
        out = real(self)
        log.append([tuple(int(r) for r in m) for m in out])
        return out

    return merge_round


@pytest.fixture(scope="module", params=ARCHS)
def rounds(request, jparams):
    """Three rounds of both engines from the same start, with the merge
    list of every reference merge pass recorded."""
    jcfg, tcfg = _cfgs(request.param)
    jm, tm = jregistry.build(jcfg), tregistry.build(tcfg)
    if request.param != "falcon-mamba-7b":
        jparams = jax.jit(jm.init)(jax.random.PRNGKey(0))
    clients = _clients(jcfg)
    kw = dict(tau=0.12, lam=0.05, lr=0.05, local_steps=5, sample_rate=0.5, seed=0,
              project_dim=64, fused_step=True)
    jmerges = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(textractor, "jl_draws", _jax_draws)
        mp.setattr(jclustering.ClusterState, "merge_round",
                   _recording_merges(jclustering.ClusterState, jmerges))
        js = jengine.init("stocfl", jm.loss_fn, jparams,
                          [jax.tree.map(jnp.asarray, c) for c in clients],
                          jengine.EngineConfig(**kw), leaf_filter=jextractor.llm_leaf_filter)
        ts = tengine.init("stocfl", tm.loss_fn, convert.to_torch(jparams), clients,
                          tengine.EngineConfig(**kw), device="cpu",
                          leaf_filter=textractor.llm_leaf_filter)
        jloss_fn = jax.jit(jm.loss_fn)
        tok0 = {"tokens": jnp.asarray(clients[0]["tokens"])}
        out = []
        for _ in range(ROUNDS):
            _, jids = jengine.sample_clients(js)
            _, tids = tengine.sample_clients(ts)
            js, jrec = jengine.run_round(js)
            ts, trec = tengine.run_round(ts)
            jloss = float(jloss_fn(js.omega, tok0))
            with torch.no_grad():
                tloss = float(tm.loss_fn(ts.omega, {"tokens": torch.as_tensor(
                    clients[0]["tokens"])}))
            out.append((jids, tids, jrec, trec, js, ts, jloss, tloss))
    spread = ZAMBA2_ROUND0 if request.param == "zamba2-1.2b" else None
    return out, jmerges, spread


def _max_diff(jtree, ttree):
    a = jax.tree.leaves(jtree)
    b = [np.asarray(x) for x in jax.tree.leaves(convert.to_numpy(ttree))]
    assert len(a) == len(b)
    return max(float(np.abs(np.asarray(x) - y).max()) for x, y in zip(a, b))


def test_stocfl_llm_rounds_match_reference(rounds):
    out, jmerges, spread = rounds
    assert len(jmerges) == ROUNDS
    for t, (jids, tids, jrec, trec, js, ts, jloss, tloss) in enumerate(out):
        tol = {"loss": 0.0, "params": 0.0} if spread is None else spread
        if t and spread is not None:        # chaotic past round 0: no float bound
            tol = {"loss": float("inf"), "params": float("inf")}
            assert all(bool(torch.isfinite(x).all()) for x in
                       trees.leaves(ts.omega) + trees.leaves(ts.models.stacked))
        assert np.array_equal(np.asarray(jids), np.asarray(tids))
        assert len(tids) == 2
        assert jrec["n_clusters"] == trec["n_clusters"]
        assert js.clusters.assignment() == ts.clusters.assignment()
        assert [tuple(m) for m in trec["merges"]] == jmerges[t]
        assert abs(jrec["objective"] - trec["objective"]) <= ATOL
        assert abs(jloss - tloss) <= max(ATOL, tol["loss"])
        assert _max_diff(js.omega, ts.omega) <= max(ATOL, tol["params"])
        assert tuple(js.models.roots) == tuple(ts.models.roots)
        for r in js.models.roots:
            assert _max_diff(js.models[r], ts.models[r]) <= max(ATOL, tol["params"])
    assert isinstance(out[-1][5].clusters, tclustering.ClusterState)


def test_stocfl_llm_psi_bank_matches_reference(rounds):
    """The clustering state's Ψ rows (sketched to 64, vocab leaves only)."""
    out, _, _ = rounds
    js, ts = out[-1][4], out[-1][5]
    assert sorted(js.clusters.reps) == sorted(ts.clusters.reps)
    for c in js.clusters.reps:
        got = ts.clusters.reps[c]
        assert tuple(got.shape) == (64,)
        np.testing.assert_allclose(np.asarray(got.cpu()), np.asarray(js.clusters.reps[c]),
                                   rtol=0, atol=ATOL)


def test_engine_config_knobs_the_slice_adds():
    fields = {f.name for f in dataclasses.fields(tengine.EngineConfig)}
    assert "project_dim" in fields
    assert tengine.EngineConfig().project_dim is None
