"""The port's eager StoCFL round, held against the JAX engine as a whole.

Both engines start from the same federation (numpy, one seed) and the
same initial parameters (the reference's, converted). Integer bookkeeping
must match exactly every round: cohorts, partition, n_clusters. Floats
(ω, bank rows, the Eq. 2 objective) agree within atol 1e-5: the two
frameworks sum in different orders, and after a few fp32 SGD steps the
models differ by ~1e-7.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import engine as jengine  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import engine as tengine  # noqa: E402
from repro_torch.data import synthetic as tsynthetic  # noqa: E402
from repro_torch.models import simple as tsimple  # noqa: E402

ATOL = 1e-5
J_TASK = dataclasses.replace(jsimple.SYNTH_MLP, hidden=32)
T_TASK = tsimple.TaskConfig("synth_mlp", "mlp", (64,), 10, hidden=32)


def _jloss(p, b):
    return jsimple.loss_fn(p, b, J_TASK)


def _tloss(p, b):
    return tsimple.loss_fn(p, b, T_TASK)


def _jacc(p, b):
    return jsimple.accuracy(p, b, J_TASK)


def _tacc(p, b):
    return tsimple.accuracy(p, b, T_TASK)


@pytest.mark.parametrize("setting", sorted(tsynthetic.SETTINGS))
def test_make_federation_byte_identical(setting):
    kw = {} if setting == "rotated_partial" else {"n_clients": 16, "n_per": 8,
                                                   "seed": 5}
    ca, ta, sa = tsynthetic.make_federation(setting, **kw)
    cb, tb, sb = jsynthetic.make_federation(setting, **kw)
    assert ta == tb
    assert len(ca) == len(cb)
    for x, y in zip(ca, cb):
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].tobytes() == y[k].tobytes()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        for leaf in ("x", "y"):
            assert sa[k][leaf].tobytes() == sb[k][leaf].tobytes()


def _pair(fused, n_clients=24, local_steps=2):
    clients, tc, tests = jsynthetic.rotated(n_clusters=4, n_clients=n_clients,
                                            n_per=32, seed=3)
    params = jsimple.init(jax.random.PRNGKey(0), J_TASK)
    jcfg = jengine.EngineConfig(local_steps=local_steps, sample_rate=0.5,
                                seed=0, fused_step=fused)
    tcfg = tengine.EngineConfig(local_steps=local_steps, sample_rate=0.5,
                                seed=0, fused_step=fused)
    js = jengine.init("stocfl", _jloss, params, clients, jcfg,
                      eval_fn=jax.jit(_jacc))
    ts = tengine.init("stocfl", _tloss, convert.to_torch(params), clients,
                      tcfg, eval_fn=_tacc, device="cpu")
    return js, ts, tc, tests


def _close(a_np_tree, t_tree):
    a = convert.to_numpy(convert.to_torch(a_np_tree))
    b = convert.to_numpy(t_tree)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=ATOL, err_msg=k)


def _assert_states_agree(js, ts):
    assert js.clusters.assignment() == ts.clusters.assignment()
    assert js.clusters.n_clusters() == ts.clusters.n_clusters()
    _close(js.omega, ts.omega)
    assert tuple(js.models.roots) == tuple(ts.models.roots)
    for r in js.models.roots:
        _close(js.models[r], ts.models[r])


@pytest.fixture(scope="module")
def history(request):
    """Four rounds of both engines from the same start: per round the
    cohorts both sample, both records and both states (states are values,
    so every round's stays readable)."""
    js, ts, tc, tests = _pair(request.param)
    rounds = []
    for _ in range(4):
        _, jids = jengine.sample_clients(js)
        _, tids = tengine.sample_clients(ts)
        js, jrec = jengine.run_round(js)
        ts, trec = tengine.run_round(ts)
        rounds.append((jids, tids, jrec, trec, js, ts))
    return rounds, tc, tests


@pytest.mark.parametrize("history", [True, False], indirect=True,
                         ids=["fused", "tree"])
def test_stocfl_rounds_match_reference(history):
    rounds, _, _ = history
    for jids, tids, jrec, trec, js, ts in rounds:
        assert np.array_equal(np.asarray(jids), np.asarray(tids))
        assert jrec["n_clusters"] == trec["n_clusters"]
        assert jrec["sampled"] == trec["sampled"]
        assert abs(jrec["objective"] - trec["objective"]) <= ATOL
        _assert_states_agree(js, ts)
    assert ts.round == js.round == 4


@pytest.mark.parametrize("history", [True], indirect=True, ids=["fused"])
def test_serving_transitions_route_like_reference(history):
    rounds, tc, tests = history
    js, ts = rounds[-1][4], rounds[-1][5]
    jev = jengine.evaluate(js, tests, tc)
    tev = tengine.evaluate(ts, tests, tc)
    assert sorted(jev["cluster"]) == sorted(tev["cluster"])
    for k in jev["cluster"]:
        assert abs(jev["cluster"][k] - tev["cluster"][k]) <= 1e-6
        assert abs(jev["global"][k] - tev["global"][k]) <= 1e-6

    fresh, _, _ = jsynthetic.rotated(n_clusters=4, n_clients=8, n_per=32,
                                     seed=11)
    for batch in fresh[:4]:
        ji = jengine.infer(js, batch)
        ti = tengine.infer(ts, batch)
        assert (ji["cluster"], ji["seed_from"]) == (ti["cluster"], ti["seed_from"])
        assert abs(ji["similarity"] - ti["similarity"]) <= ATOL
        _close(ji["model"], ti["model"])

    for batch in fresh[4:6]:
        js, jcid = jengine.join(js, batch)
        ts, tcid = tengine.join(ts, batch)
        assert jcid == tcid
        _assert_states_agree(js, ts)
    for cid in (0, jcid):
        js = jengine.leave(js, cid)
        ts = tengine.leave(ts, cid)
        assert js.left == ts.left
        _assert_states_agree(js, ts)
    js, _ = jengine.run_round(js)
    ts, _ = tengine.run_round(ts)
    _assert_states_agree(js, ts)


def test_init_without_device_raises_when_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    clients, _, _ = tsynthetic.rotated(n_clients=4, n_per=4)
    params = tsimple.init(torch.Generator().manual_seed(0), T_TASK)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.init("stocfl", _tloss, params, clients)


def test_merge_cluster_models_matches_reference():
    """Count-weighted model merges, through the port's plain-dict path and
    its ``ClusterBank`` path, against the reference's; roots 2 and 9 have
    no model yet and merge in as ω₀."""
    from repro.engine import bank as jbank
    from repro.engine.strategies import merge_cluster_models as j_merge
    from repro_torch.engine.bank import ClusterBank
    from repro_torch.engine.strategies import merge_cluster_models as t_merge

    rng = np.random.default_rng(0)
    init = {"w": rng.normal(size=(3, 2)).astype(np.float32),
            "b": rng.normal(size=2).astype(np.float32)}
    models = {r: {k: (v + rng.normal(size=v.shape)).astype(np.float32)
                  for k, v in init.items()} for r in (0, 4, 7)}
    merges = [(0, 4), (0, 9), (2, 7)]
    counts = {0: 3, 4: 1, 9: 2, 2: 5, 7: 1}
    want = j_merge(models, merges, counts, init)
    want_bank = j_merge(jbank.ClusterBank.from_dict(models), merges, counts, init)
    t_init = convert.to_torch(init)
    got = t_merge({r: convert.to_torch(m) for r, m in models.items()},
                  merges, counts, t_init)
    roots = sorted(models)
    bank = ClusterBank.empty().put(roots, {k: torch.stack(
        [torch.from_numpy(models[r][k]) for r in roots]) for k in init})
    got_bank = t_merge(bank, merges, counts, t_init)
    assert sorted(got) == sorted(want) == [0, 2]
    assert tuple(got_bank.roots) == tuple(want_bank.roots)
    for r in want:
        _close(want[r], got[r])
        _close(want_bank[r], got_bank[r])


def test_round_phases_are_profiler_ranges():
    """A profiled round records every ``stocfl.*`` phase range once, and the
    round under the profiler still equals the JAX engine's."""
    from torch.profiler import ProfilerActivity, profile

    js, ts, _, _ = _pair(True)
    js, _ = jengine.run_round(js)
    ts, _ = tengine.run_round(ts)               # round 0 observes everyone new
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ts, _ = tengine.run_round(ts)
    js, _ = jengine.run_round(js)
    counts = {e.key: e.count for e in prof.key_averages()
              if e.key.startswith("stocfl.")}
    assert counts == {f"stocfl.{p}": 1 for p in (
        "psi_extract", "merge_pass", "bank_merge", "gather", "cohort_update",
        "aggregate", "objective")}
    _assert_states_agree(js, ts)
