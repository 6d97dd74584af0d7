"""``engine.run_rounds`` of the port, on the CPU, where the round step runs
as a plain loop (the card captures the same step in a CUDA graph).

Against the port's own eager loop, for all six strategies, fused and tree:
integers exact (cohorts, records, partitions, members, keys) and floats
within 1e-6; on this CPU the two come out bitwise equal, since the step
makes the eager round's operations in the same order. Against the JAX
engine's eager ``run_round`` under ``rng_backend="device"`` (not its
``run_rounds``, whose own tests fail): cohorts and integer bookkeeping
exact, floats within 1e-5, the frameworks summing in different orders.
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
from repro_torch.engine import api as tapi  # noqa: E402
from repro_torch.models import simple as tsimple  # noqa: E402
from repro_torch.utils import trees  # noqa: E402

SELF_ATOL = 1e-6
REF_ATOL = 1e-5
ROUNDS = 5
J_TASK = dataclasses.replace(jsimple.SYNTH_MLP, hidden=32)
T_TASK = tsimple.TaskConfig("synth_mlp", "mlp", (64,), 10, hidden=32)
KNOBS = {"stocfl": {"cluster_backend": "device", "tau": 0.3},
         "fedavg": {}, "fedprox": {"mu": 0.05}, "ditto": {"mu": 0.05},
         "ifca": {"n_models": 3}, "cfl": {"eps_rel": 0.7, "eps2": 0.01}}
ALL = sorted(KNOBS)


def _tloss(p, b):
    return tsimple.loss_fn(p, b, T_TASK)


def _jloss(p, b):
    return jsimple.loss_fn(p, b, J_TASK)


def _fed(seed=5, n_clients=12):
    clients, _, _ = jsynthetic.pathological(n_clients=n_clients, n_per=16, seed=seed)
    return clients


def _cfg(name, module, **kw):
    kw = dict(dict(lr=0.1, local_steps=2, sample_rate=0.5, seed=0,
                   rng_backend="device", **KNOBS[name]), **kw)
    return module.EngineConfig(**kw)


def _tstate(name, clients=None, **kw):
    params = jsimple.init(jax.random.PRNGKey(0), J_TASK)
    clients = _fed() if clients is None else clients
    return tengine.init(name, _tloss, convert.to_torch(params), clients,
                        _cfg(name, tengine, **kw), device="cpu", arena=True)


def _flat(tree):
    return torch.cat([x.detach().reshape(-1).float() for x in trees.leaves(tree)])


def _maxdiff(a, b) -> float:
    return float((_flat(a) - _flat(b)).abs().max())


def _strip(history):
    """Records without the eager StoCFL round's ``merges`` key, which a
    fixed-shape step cannot record."""
    return [{k: v for k, v in r.items() if k != "merges"} for r in history]


def _assert_same(e, s, atol):
    assert _strip(e.history) == _strip(s.history)
    assert e.round == s.round
    if e.rng_key is not None:
        assert torch.equal(e.rng_key, s.rng_key)
    worst = _maxdiff(e.omega, s.omega)
    assert sorted(e.models.roots) == sorted(s.models.roots)
    for r in e.models.roots:
        worst = max(worst, _maxdiff(e.models[r], s.models[r]))
    assert sorted(e.personal) == sorted(s.personal)
    for c in e.personal:
        worst = max(worst, _maxdiff(e.personal[c], s.personal[c]))
    assert e.members == s.members
    if e.strategy == "stocfl":
        a, b = e.clusters.arrays(), s.clusters.arrays()
        assert np.array_equal(a["parent"], b["parent"])
        assert np.array_equal(a["live"], b["live"])
        worst = max(worst, float(np.abs(a["rep"] - b["rep"]).max()))
        assert e.clusters.assignment() == s.clusters.assignment()
    assert worst <= atol, worst
    return worst


CASES = [(n, f) for n in ALL for f in (True, False)]


@pytest.mark.parametrize("name,fused", CASES,
                         ids=[f"{n}-{'fused' if f else 'tree'}" for n, f in CASES])
def test_run_rounds_matches_eager_loop(name, fused):
    start = _tstate(name, fused_step=fused)
    eager = start
    for _ in range(ROUNDS):
        eager, _ = tengine.run_round(eager)
    scanned = tengine.run_rounds(start, ROUNDS)
    _assert_same(eager, scanned, SELF_ATOL)
    assert start.round == 0 and not start.history       # the input is untouched


def test_run_rounds_ragged_arena_stocfl():
    clients = _fed()
    for i in (1, 4, 7):
        clients[i] = {k: v[: 9 + i] for k, v in clients[i].items()}
    start = _tstate("stocfl", clients=clients, fused_step=True)
    assert start.ctx.arena.ragged
    eager = start
    for _ in range(ROUNDS):
        eager, _ = tengine.run_round(eager)
    _assert_same(eager, tengine.run_rounds(start, ROUNDS), SELF_ATOL)


def _jstate(name, **kw):
    params = jsimple.init(jax.random.PRNGKey(0), J_TASK)
    js = jengine.init(name, _jloss, params, _fed(), _cfg(name, jengine, **kw), arena=True)
    return js


@pytest.mark.parametrize("name", ALL)
def test_eager_device_rng_rounds_match_reference(name):
    """The port's eager device-rng rounds against the JAX engine's; then the
    port's ``run_rounds`` over the same span against the reference's last
    state."""
    js, ts = _jstate(name, fused_step=True), _tstate(name, fused_step=True)
    if name == "ifca":      # the reference's jax.random hypotheses, fed in
        ts = ts.replace(models=tengine.ClusterBank.from_dict(
            {m: convert.to_torch(js.models[m]) for m in js.models.roots}))
    start = ts
    for _ in range(ROUNDS):
        if not tengine.get_strategy(name).full_participation:
            jk, jids = jengine.sample_clients(js)
            tk, tids = tengine.sample_clients(ts)
            assert np.array_equal(np.asarray(jids), tids)
            assert np.array_equal(np.asarray(jax.random.key_data(jk)), tk.numpy())
        js, jrec = jengine.run_round(js)
        ts, trec = tengine.run_round(ts)
        for k, v in jrec.items():
            if isinstance(v, float):
                assert abs(v - trec[k]) <= REF_ATOL, k
            else:
                assert v == trec[k], k
    for state in (ts, tengine.run_rounds(start, ROUNDS)):
        _close_to_reference(js, state)


def _close_to_reference(js, ts):
    def close(j_tree, t_tree):
        want = convert.to_numpy(convert.to_torch(j_tree))
        got = convert.to_numpy(t_tree)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=REF_ATOL, err_msg=k)

    close(js.omega, ts.omega)
    assert sorted(js.models.roots) == sorted(ts.models.roots)
    for r in js.models.roots:
        close(js.models[r], ts.models[r])
    for c in js.personal:
        close(js.personal[c], ts.personal[c])
    assert js.members == ts.members
    if js.strategy == "stocfl":
        a, b = js.clusters.arrays(), ts.clusters.arrays()
        assert np.array_equal(np.asarray(a["parent"]), b["parent"])
        assert np.array_equal(np.asarray(a["live"]), b["live"])
        np.testing.assert_allclose(b["rep"], np.asarray(a["rep"]), rtol=0, atol=REF_ATOL)
    if js.rng_key is not None:
        assert np.array_equal(np.asarray(jax.random.key_data(js.rng_key)),
                              ts.rng_key.numpy())


@pytest.mark.parametrize("name", ALL)
def test_spans_compose(name):
    """3 rounds then 2 equal 5 (for StoCFL the second span resumes from the
    first's stashed carry)."""
    start = _tstate(name)
    five = tengine.run_rounds(start, 5)
    split = tengine.run_rounds(tengine.run_rounds(start, 3), 2)
    _assert_same(five, split, 0.0)


def test_resume_stash_follows_the_state():
    """The warm-resume stash serves only the state its span returned: a
    span from an older state rebuilds its carry and still equals eager."""
    start = _tstate("stocfl")
    mid = tengine.run_rounds(start, 2)
    stash = start.ctx.cache["stocfl_scan_resume"]
    assert stash["models"] is mid.models and stash["clusters"] is mid.clusters
    again = tengine.run_rounds(start, 2)
    _assert_same(mid, again, 0.0)


def test_all_unavailable_rounds_are_skipped():
    start = _tstate("fedavg")
    out = tengine.run_rounds(start, 3, unavailable=set(range(start.n_clients)))
    assert out.round == 3
    assert list(out.history) == [{"skipped": True, "sampled": 0}] * 3
    assert torch.equal(out.rng_key, start.rng_key)
    assert _maxdiff(out.omega, start.omega) == 0.0
    with pytest.raises(ValueError, match="non-empty cohort"):
        tengine.run_round(start, [])


def test_unavailable_clients_are_never_drawn():
    """A span with unavailable clients equals eager rounds over the draws
    ``sample_clients`` makes with the same set held out."""
    busy = {0, 3, 8}
    start = _tstate("fedavg")
    eager = start
    for _ in range(3):
        key, ids = tengine.sample_clients(eager, unavailable=busy)
        assert not set(ids.tolist()) & busy
        eager, _ = tengine.run_round(tengine.advance_rng(eager, key), ids)
    _assert_same(eager, tengine.run_rounds(start, 3, unavailable=busy), SELF_ATOL)


def test_full_participation_ignores_unavailable():
    start = _tstate("cfl")
    a = tengine.run_rounds(start, 2, unavailable={0, 1, 2})
    b = tengine.run_rounds(start, 2)
    _assert_same(a, b, 0.0)
    assert all(r["sampled"] == start.n_clients for r in a.history)


@pytest.mark.parametrize("case,match", [
    ("no_arena", "arena=True"),
    ("numpy_rng", "rng_backend='device'"),
    ("host_clusters", "cluster_backend='device'"),
    ("compacted", "compacted out of the arena"),
])
def test_scan_blockers_messages(case, match):
    if case == "no_arena":
        params = jsimple.init(jax.random.PRNGKey(0), J_TASK)
        state = tengine.init("fedavg", _tloss, convert.to_torch(params), _fed(),
                             _cfg("fedavg", tengine), device="cpu")
    elif case == "numpy_rng":
        state = _tstate("fedavg", rng_backend="numpy")
    elif case == "host_clusters":
        state = _tstate("stocfl", cluster_backend="numpy")
    else:
        state = _tstate("fedavg")
        for c in range(7):
            state = tengine.leave(state, c)
        assert (state.ctx.arena.rows[:7] < 0).all()      # compacted
        state = state.replace(left=frozenset({0, 1, 2, 3, 4, 5}))
    assert match in tengine.scan_blockers(state)
    with pytest.raises(ValueError, match=match.replace("(", r"\(").replace(")", r"\)")):
        tengine.run_rounds(state, 1)


def test_full_participation_needs_no_device_rng():
    state = _tstate("cfl", rng_backend="numpy")
    assert state.rng_key is None and tengine.scan_blockers(state) is None
    eager = state
    for _ in range(2):
        eager, _ = tengine.run_round(eager)
    _assert_same(eager, tengine.run_rounds(state, 2), SELF_ATOL)


def test_numpy_backend_is_the_default_and_unchanged():
    """By default the port draws with the numpy bit-generator, the
    reference's numpy draws, and carries no key."""
    params = jsimple.init(jax.random.PRNGKey(0), J_TASK)
    cfg = dict(lr=0.1, local_steps=2, sample_rate=0.5, seed=3)
    ts = tengine.init("fedavg", _tloss, convert.to_torch(params), _fed(),
                      tengine.EngineConfig(**cfg), device="cpu")
    js = jengine.init("fedavg", _jloss, params, _fed(), jengine.EngineConfig(**cfg))
    assert ts.ctx.cfg.rng_backend == "numpy" and ts.rng_key is None
    for _ in range(3):
        jst, jids = jengine.sample_clients(js)
        tst, tids = tengine.sample_clients(ts)
        assert np.array_equal(np.asarray(jids), tids) and jst == tst
        js, ts = jengine.advance_rng(js, jst), tengine.advance_rng(ts, tst)


def test_history_records_convert_like_eager():
    ys = {"n_clusters": torch.tensor([3, 2], dtype=torch.int32),
          "objective": torch.tensor([0.5, 0.25]), "sampled": torch.tensor([4, 4])}
    recs = tengine.scan_history(ys, 2)
    assert recs == ({"n_clusters": 3, "objective": 0.5, "sampled": 4},
                    {"n_clusters": 2, "objective": 0.25, "sampled": 4})
    assert all(type(r["n_clusters"]) is int and type(r["objective"]) is float for r in recs)


def test_program_is_cached_across_span_lengths():
    start = _tstate("fedavg")
    fn3, c3, k3, _ = tengine.scan_program(start, 3)
    fn5, c5, k5, _ = tengine.scan_program(start, 5)
    programs = [v for v in start.ctx.cache.values() if isinstance(v, tapi.RoundProgram)]
    assert len(programs) == 1
    _, ys = fn5(c5, k5)
    assert ys["sampled"].shape == (5,)


@pytest.mark.parametrize("ragged", [False, True])
def test_arena_take_by_device_ids_equals_gather(ragged):
    clients = _fed()
    if ragged:
        clients[2] = {k: v[:5] for k, v in clients[2].items()}
    arena = tengine.init("fedavg", _tloss, convert.to_torch(
        jsimple.init(jax.random.PRNGKey(0), J_TASK)), clients, _cfg("fedavg", tengine),
        device="cpu", arena=True).ctx.arena
    assert arena.ragged == ragged
    ids = [7, 2, 11, 0]
    want = arena.gather(ids)
    got = arena.take(torch.tensor(ids))
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert arena.device_rows.shape == (16,) and arena.device_rows is arena.device_rows
