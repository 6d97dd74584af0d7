"""The port's simulator (``repro_torch.sim``) and the data it draws
(``rotated_factory``, ``drift_batch``, ``rotated_pathological``,
``dirichlet``), on the CPU, against the JAX package.

For the same seeds the port draws what the reference draws: the Poisson
timelines' events (by ``to_dict``) and the numpy arrays, byte for byte.
Traces written by either package are read by the other. ``simulate`` over
14 clients, through joins, leaves, drift, stragglers and an availability
window, gives the reference's records (events, cohorts, population,
n_clusters, flush bookkeeping), ``joined`` and ``departed`` exactly, and
the §5 accuracies within 2/512 (one or two of the 512 test examples
flipping between the frameworks' float sums). ``scan_spans`` equals the
eager loop.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import engine as jengine  # noqa: E402
from repro import sim as jsim  # noqa: E402
from repro.data import dirichlet as jdirichlet  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import data as tdata  # noqa: E402
from repro_torch import engine as tengine  # noqa: E402
from repro_torch import sim as tsim  # noqa: E402
from repro_torch.models import simple as tsimple  # noqa: E402
from repro_torch.utils import trees  # noqa: E402

ACC_TOL = 2 / 512
J_TASK = dataclasses.replace(jsimple.SYNTH_MLP, hidden=32)
T_TASK = tsimple.TaskConfig("synth_mlp", "mlp", (64,), 10, hidden=32)
REC_KEYS = ("t", "events", "n_registered", "n_live", "cohort", "skipped", "had_events",
            "n_clusters", "merged", "dropped_stale", "dropped_left", "in_flight",
            "max_staleness")


def _tloss(p, b):
    return tsimple.loss_fn(p, b, T_TASK)


def _teval(p, b):
    return tsimple.accuracy(p, b, T_TASK)


def _jloss(p, b):
    return jsimple.loss_fn(p, b, J_TASK)


def _jeval(p, b):
    return jsimple.accuracy(p, b, J_TASK)


def _same_arrays(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _same_batches(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        _same_arrays(a[k], b[k])


# ================================================================ timeline
POISSON = [dict(rounds=20, join_rate=1.0, leave_rate=0.5, straggle=0.1, drift_every=5,
                n_clusters=4, seed=7),
           dict(rounds=30, join_rate=1 / 3, leave_rate=1 / 3, n_clusters=4, drift_every=10,
                seed=0, start=0),
           dict(rounds=30, join_rate=4 / 3, leave_rate=4 / 3, n_clusters=4, seed=3)]


@pytest.mark.parametrize("kw", POISSON, ids=["mixed", "churn5", "churn20"])
def test_poisson_events_match_reference(kw):
    got = [tsim.to_dict(e) for e in tsim.Timeline.from_poisson(**kw).events()]
    want = [jsim.to_dict(e) for e in jsim.Timeline.from_poisson(**kw).events()]
    assert got == want and got


def _timeline(pkg):
    return pkg.Timeline([pkg.Join(t=1, cluster=2), pkg.Leave(t=2, cid=5), pkg.Leave(t=2),
                         pkg.Straggle(t=3, rate=0.25), pkg.Drift(t=4, cids=(0, 3), strength=0.1),
                         pkg.Delay(t=5, rounds=2, cids=(1, 2)), pkg.Delay(t=6, rounds=1)],
                        windows=[pkg.Availability(cid=1, start=0, end=3)])


@pytest.mark.parametrize("writer,reader", [(tsim, jsim), (jsim, tsim)],
                         ids=["port_to_reference", "reference_to_port"])
def test_traces_cross_packages(tmp_path, writer, reader):
    p = str(tmp_path / "trace.json")
    _timeline(writer).to_trace(p)
    back = reader.Timeline.from_trace(p)
    assert [reader.to_dict(e) for e in back.events()] == \
        [writer.to_dict(e) for e in _timeline(writer).events()]
    assert [tuple(dataclasses.astuple(w)) for w in back.windows] == [(1, 0, 3)]
    assert back.unavailable(3) == frozenset({1}) and back.horizon == 6


def test_from_spec_kv_and_trace(tmp_path):
    spec = "join=1.0,leave=0.5,straggle=0.2,drift_every=3"
    got = tsim.Timeline.from_spec(spec, rounds=10, seed=4, n_clusters=4)
    want = jsim.Timeline.from_spec(spec, rounds=10, seed=4, n_clusters=4)
    assert [tsim.to_dict(e) for e in got.events()] == [jsim.to_dict(e) for e in want.events()]
    p = str(tmp_path / "t.json")
    got.to_trace(p)
    assert tsim.Timeline.from_spec(p, rounds=99).events() == got.events()
    with pytest.raises(ValueError, match="key=value"):
        tsim.Timeline.from_spec("join", rounds=3)


def test_join_with_batch_does_not_serialize(tmp_path):
    with pytest.raises(ValueError, match="batch"):
        tsim.Timeline([tsim.Join(t=0, batch={"x": np.zeros((2, 4))})]).to_trace(
            str(tmp_path / "t.json"))


# ================================================================ data
def test_rotated_factory_and_drift_match_reference():
    tf = tdata.rotated_factory(n_clusters=4, n_per=16, seed=2)
    jf = jsynthetic.rotated_factory(n_clusters=4, n_per=16, seed=2)
    ra, rb = np.random.default_rng(9), np.random.default_rng(9)
    for cluster in (0, 3, None, 6):
        _same_batches(tf(cluster, ra), jf(cluster, rb))
    batch = tf(1, np.random.default_rng(1))
    _same_batches(tdata.drift_batch(batch, np.random.default_rng(5), 0.1),
                  jsynthetic.drift_batch(batch, np.random.default_rng(5), 0.1))
    assert tdata.SETTING_FACTORIES.keys() == jsynthetic.SETTING_FACTORIES.keys()
    # the factory's clusters are rotated's latent clusters
    clients, tc, tests = jsynthetic.rotated(n_clusters=4, n_clients=8, n_per=16, seed=2)
    fresh = tdata.rotated_factory(n_clusters=4, n_per=512, seed=2)(3, np.random.default_rng(0))
    assert np.allclose(fresh["x"].std(0), tests[3]["x"].std(0), rtol=0.2)


def test_rotated_pathological_matches_reference():
    got_c, got_t = tdata.rotated_pathological(n_clients=16, n_per=8, seed=4)
    want_c, want_t = jsynthetic.rotated_pathological(n_clients=16, n_per=8, seed=4)
    assert got_t == want_t and len(got_c) == 16
    for a, b in zip(got_c, want_c):
        _same_batches(a, b)


def test_dirichlet_and_quantity_skew_match_reference():
    got = tdata.dirichlet_label_skew(n_clients=6, n_per=16, alpha=0.3, seed=1)
    want = jdirichlet.dirichlet_label_skew(n_clients=6, n_per=16, alpha=0.3, seed=1)
    for a, b in zip(got[0], want[0]):
        _same_batches(a, b)
    _same_arrays(got[1], want[1])
    _same_batches(got[2], want[2])
    got = tdata.quantity_skew(n_clients=6, seed=2)
    want = jdirichlet.quantity_skew(n_clients=6, seed=2)
    for a, b in zip(got[0], want[0]):
        _same_batches(a, b)
    _same_arrays(got[1], want[1])
    _same_batches(got[2], want[2])


# ================================================================ simulate
def _fed():
    return jsynthetic.rotated(n_clusters=2, n_clients=14, n_per=32, seed=3)


def _cfg(pkg, name, **kw):
    kw = dict(dict(local_steps=2, sample_rate=0.5, seed=0, tau=0.5), **kw)
    if name == "stocfl":
        kw.setdefault("cluster_backend", "device")
    return pkg.EngineConfig(**kw)


def _params():
    return jsimple.init(jax.random.PRNGKey(0), J_TASK)


def _tstart(name, clients, **kw):
    return tengine.init(name, _tloss, convert.to_torch(_params()), clients,
                        _cfg(tengine, name, **kw), eval_fn=_teval, device="cpu", arena=True)


def _jstart(name, clients, **kw):
    return jengine.init(name, _jloss, _params(), clients, _cfg(jengine, name, **kw),
                        eval_fn=_jeval, arena=True)


def _churn(pkg):
    return pkg.Timeline([pkg.Join(t=1, cluster=0), pkg.Join(t=1, cluster=1),
                         pkg.Leave(t=2), pkg.Drift(t=3, cids=(0, 4)), pkg.Join(t=4, cluster=1),
                         pkg.Straggle(t=4, rate=0.3), pkg.Leave(t=5, cid=2),
                         pkg.Delay(t=5, rounds=1), pkg.Delay(t=6, rounds=2, cids=(7, 8, 9))],
                        windows=[pkg.Availability(cid=1, start=0, end=3)])


def _run_sim(pkg, start, factory, tests, tc, **kw):
    return pkg.simulate(start, _churn(pkg), rounds=8, client_factory=factory, seed=2,
                        eval_every=3, test_sets=tests, true_cluster=tc, **kw)


SIM_CASES = [("stocfl", "device", False), ("stocfl", "numpy", False),
             ("stocfl", "device", True), ("fedavg", None, True)]


@pytest.mark.parametrize("name,backend,async_mode", SIM_CASES)
def test_simulate_matches_reference(name, backend, async_mode):
    clients, tc, tests = _fed()
    kw = {} if backend is None else {"cluster_backend": backend}
    ts, tlog = _run_sim(tsim, _tstart(name, clients, **kw),
                        tdata.rotated_factory(n_clusters=2, n_per=32, seed=3), tests, tc,
                        async_mode=async_mode)
    js, jlog = _run_sim(jsim, _jstart(name, clients, **kw),
                        jsynthetic.rotated_factory(n_clusters=2, n_per=32, seed=3), tests, tc,
                        async_mode=async_mode)
    assert tlog.joined == jlog.joined and tlog.departed == jlog.departed
    assert len(tlog.records) == len(jlog.records) == 8
    for tr, jr in zip(tlog.records, jlog.records):
        for k in REC_KEYS:
            assert tr.get(k) == jr.get(k), (k, tr, jr)
        for k in ("joined_acc", "incumbent_acc"):
            assert (tr.get(k) is None) == (jr.get(k) is None), k
            if jr.get(k) is not None:
                assert abs(tr[k] - jr[k]) <= ACC_TOL, (k, tr[k], jr[k])
    if async_mode:
        assert any(r.get("in_flight") for r in tlog.records), "nothing was ever in flight"
        assert [tuple(e) for e in ts.buffer.entries] == [tuple(e) for e in js.buffer.entries]
    assert tlog.curve("joined_acc")[0] == [3, 6, 7]
    assert tlog.curve("incumbent_acc")[0] == [0, 3, 6, 7]
    if name == "stocfl":
        assert ts.clusters.assignment() == js.clusters.assignment()
    assert ts.sizes == js.sizes and ts.left == js.left


def _flat(tree):
    return torch.cat([x.detach().reshape(-1).float() for x in trees.leaves(tree)])


def test_scan_spans_equals_eager():
    clients, tc, tests = _fed()
    kw = dict(rng_backend="device", fused_step=True)
    tl = tsim.Timeline([tsim.Join(t=3, cluster=1), tsim.Leave(t=6), tsim.Leave(t=6, cid=4)])
    runs = []
    for scan in (False, True):
        st = _tstart("stocfl", clients, **kw)
        runs.append(tsim.simulate(st, tl, rounds=12, seed=1, scan_spans=scan,
                                  client_factory=tdata.rotated_factory(2, 32, seed=3)))
    (a, alog), (b, blog) = runs
    assert sum(bool(r.get("scanned")) for r in blog.records) >= 6
    strip = lambda r: {k: v for k, v in r.items()
                       if k not in ("sec_train", "sec_round", "scanned")}
    assert [strip(r) for r in alog.records] == [strip(r) for r in blog.records]
    assert alog.joined == blog.joined and alog.departed == blog.departed
    assert a.clusters.assignment() == b.clusters.assignment()
    assert sorted(a.models.roots) == sorted(b.models.roots)
    assert torch.equal(a.rng_key, b.rng_key)
    diff = max([float((_flat(a.omega) - _flat(b.omega)).abs().max())]
               + [float((_flat(a.models[r]) - _flat(b.models[r])).abs().max())
                  for r in a.models.roots])
    assert diff <= 1e-6


def test_routed_model_picks_the_ifca_hypothesis_of_least_loss():
    clients, _, _ = _fed()
    st = _tstart("ifca", clients, n_models=3)
    st, _ = tengine.run_round(st)
    batch = st.ctx.clients[2]
    losses = [float(_tloss(st.models[m], batch)) for m in range(3)]
    got = tsim.routed_model(st, 2)
    assert torch.equal(_flat(got), _flat(st.models[int(np.argmin(losses))]))
