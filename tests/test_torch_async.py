"""The port's async buffered aggregation (``engine.run_round_async``,
``engine.async_agg``) on the CPU, at the size of
``tests/test_async_agg.py`` (12 clients of 32 samples in 2 rotated
clusters, cohorts of 6), with a 32-wide hidden layer.

The sync limit: at zero delay with a flush every round, the async round
equals the port's ``run_round`` bitwise for stocfl (both clustering
backends, fused and tree), fedavg and fedprox. Against the JAX engine's
``run_round_async`` on the same numpy inputs, cohorts and delays (numpy
rng backend): entries, the flush records, cohorts and partitions exact;
ω and the bank rows within 1e-5 (the frameworks sum in different
orders). Around it: ``staleness_weights`` bitwise the reference's, flush
order, bounded staleness, buffer growth and capacity independence, a
departed client's delta dropped, a join while deltas are in flight, and
the strategies without async hooks raising.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import engine as jengine  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.engine import async_agg as jasync  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import engine as tengine  # noqa: E402
from repro_torch.engine import async_agg as tasync  # noqa: E402
from repro_torch.models import simple as tsimple  # noqa: E402
from repro_torch.utils import trees  # noqa: E402

REF_ATOL = 1e-5
J_TASK = dataclasses.replace(jsimple.SYNTH_MLP, hidden=32)
T_TASK = tsimple.TaskConfig("synth_mlp", "mlp", (64,), 10, hidden=32)
FLUSH_KEYS = ("sampled", "merged", "dropped_stale", "dropped_left", "in_flight",
              "max_staleness", "n_clusters")


def _tloss(p, b):
    return tsimple.loss_fn(p, b, T_TASK)


def _jloss(p, b):
    return jsimple.loss_fn(p, b, J_TASK)


def _fed(n_clients=12, seed=3):
    clients, _, _ = jsynthetic.rotated(n_clusters=2, n_clients=n_clients, n_per=32,
                                       seed=seed)
    return clients


def _params():
    return jsimple.init(jax.random.PRNGKey(0), J_TASK)


def _kw(name, **kw):
    kw.setdefault("local_steps", 2)
    kw.setdefault("sample_rate", 0.5)
    kw.setdefault("seed", 0)
    kw.setdefault("rng_backend", "device")
    if name == "stocfl":
        kw.setdefault("cluster_backend", "device")
    return kw


def _tinit(name, clients=None, **kw):
    clients = _fed() if clients is None else clients
    return tengine.init(name, _tloss, convert.to_torch(_params()), clients,
                        tengine.EngineConfig(**_kw(name, **kw)), device="cpu", arena=True)


def _jinit(name, clients, **kw):
    return jengine.init(name, _jloss, _params(), [jax.tree.map(jnp.asarray, c) for c in clients],
                        jengine.EngineConfig(**_kw(name, **kw)), arena=True)


def _flat(tree):
    return torch.cat([x.detach().reshape(-1).float() for x in trees.leaves(tree)])


def _same(a, b) -> bool:
    return torch.equal(_flat(a), _flat(b))


def assert_bitwise(sync, asy):
    """The async state equals the sync one bitwise: ω, bank rows,
    partition, Ψ rows, round, rng; every key the sync record holds (but
    the port's eager ``merges``) is in the async record with its value."""
    assert _same(sync.omega, asy.omega), "omega diverged"
    assert sorted(sync.models.roots) == sorted(asy.models.roots)
    for r in sync.models.roots:
        assert _same(sync.models[r], asy.models[r]), f"bank row {r} diverged"
    if sync.clusters is not None:
        assert sync.clusters.assignment() == asy.clusters.assignment()
        assert sorted(sync.clusters.seen) == sorted(asy.clusters.seen)
        for c in sync.clusters.seen:
            assert torch.equal(sync.clusters.reps[c], asy.clusters.reps[c]), c
    assert sync.round == asy.round and sync.left == asy.left
    assert sync.rng_state == asy.rng_state
    assert (sync.rng_key is None) == (asy.rng_key is None)
    if sync.rng_key is not None:
        assert torch.equal(sync.rng_key, asy.rng_key)
    assert len(sync.history) == len(asy.history)
    for hs, ha in zip(sync.history, asy.history):
        for k, v in hs.items():
            if k != "merges":
                assert k in ha and ha[k] == v, f"history[{k}] diverged"


def assert_same_states(a, b):
    """Async against async, bitwise, the buffer's entries included."""
    assert _same(a.omega, b.omega)
    assert sorted(a.models.roots) == sorted(b.models.roots)
    for r in a.models.roots:
        assert _same(a.models[r], b.models[r])
    if a.clusters is not None:
        assert a.clusters.assignment() == b.clusters.assignment()
    assert a.round == b.round and a.left == b.left
    assert a.history == b.history
    assert (a.buffer is None) == (b.buffer is None)
    if a.buffer is not None:
        assert a.buffer.entries == b.buffer.entries


# ================================================= the sync limit
SYNC_CASES = [("stocfl", "device", False), ("stocfl", "device", True),
              ("stocfl", "numpy", False), ("stocfl", "numpy", True),
              ("fedavg", None, False), ("fedavg", None, True), ("fedprox", None, True)]


@pytest.mark.parametrize("name,backend,fused", SYNC_CASES)
def test_zero_delay_equals_sync_bitwise(name, backend, fused):
    kw = dict(fused_step=fused)
    if backend is not None:
        kw["cluster_backend"] = backend
    sync = _tinit(name, **kw)
    asy = _tinit(name, async_cfg=tengine.AsyncConfig(), **kw)
    for _ in range(5):
        sync, _ = tengine.run_round(sync)
        asy, rec = tengine.run_round_async(asy)
        assert rec["in_flight"] == 0 and rec["merged"] == rec["sampled"]
    assert_bitwise(sync, asy)


@pytest.mark.parametrize("name", ["stocfl", "fedavg"])
def test_zero_delay_decay_does_not_matter(name):
    sync = _tinit(name)
    asy = _tinit(name, async_cfg=tengine.AsyncConfig(staleness_decay=0.5))
    for _ in range(3):
        sync, _ = tengine.run_round(sync)
        asy, _ = tengine.run_round_async(asy)
    assert_bitwise(sync, asy)


@pytest.mark.parametrize("name", ["ditto", "ifca", "cfl"])
def test_strategies_without_hooks_raise(name):
    st = _tinit(name, async_cfg=tengine.AsyncConfig())
    with pytest.raises(NotImplementedError, match="async"):
        tengine.run_round_async(st)


def test_empty_cohort_raises():
    st = _tinit("fedavg", async_cfg=tengine.AsyncConfig())
    with pytest.raises(ValueError, match="non-empty"):
        tengine.run_round_async(st, client_ids=np.asarray([], np.int64))


# ================================================= against the reference
REF_CASES = [("stocfl", "device"), ("fedavg", None)]


@pytest.mark.parametrize("name,backend", REF_CASES)
def test_matches_reference_run_round_async(name, backend):
    clients = _fed()
    kw = dict(rng_backend="numpy")
    if backend is not None:
        kw["cluster_backend"] = backend
    js = _jinit(name, clients, **dict(kw, async_cfg=jasync.AsyncConfig(
        staleness_decay=0.8, staleness_cap=2)))
    ts = _tinit(name, clients, **dict(kw, async_cfg=tengine.AsyncConfig(
        staleness_decay=0.8, staleness_cap=2)))
    rng = np.random.default_rng(7)
    for _ in range(4):
        delays = rng.integers(0, 4, 6)
        cohort = jengine.sample_clients(js)[1]
        assert np.array_equal(cohort, tengine.sample_clients(ts)[1])
        js, jrec = jengine.run_round_async(js, delays=delays)
        ts, trec = tengine.run_round_async(ts, delays=delays)
        for k in FLUSH_KEYS:
            assert jrec.get(k) == trec.get(k), (k, jrec, trec)
        if "objective" in jrec:
            assert abs(jrec["objective"] - trec["objective"]) <= 1e-4
        assert [tuple(e) for e in js.buffer.entries] == [tuple(e) for e in ts.buffer.entries]
        assert js.buffer.capacity == ts.buffer.capacity
    assert any(r["dropped_stale"] for r in ts.history), "the cap was never exercised"
    assert ts.rng_state == js.rng_state
    if name == "stocfl":
        assert ts.clusters.assignment() == js.clusters.assignment()
    assert sorted(ts.models.roots) == sorted(js.models.roots)
    pairs = [(js.omega, ts.omega)] + [(js.models[r], ts.models[r]) for r in js.models.roots]
    for jt, tt in pairs:
        want = torch.as_tensor(np.concatenate([np.asarray(x).ravel()
                                               for x in jax.tree.leaves(jt)]))
        assert float((want - _flat(tt)).abs().max()) <= REF_ATOL


def test_staleness_weights_bitwise_reference():
    rng = np.random.default_rng(0)
    w = rng.integers(1, 500, 64).astype(np.float32)
    s = rng.integers(0, 7, 64)
    for decay in (1.0, 0.9, 0.8, 0.5, 0.0, 0.3333):
        got = tasync.staleness_weights(w, s, decay)
        want = jasync.staleness_weights(w, s, decay)
        assert got.dtype == np.float32
        assert np.array_equal(got.view(np.uint32), np.asarray(want).view(np.uint32))
    assert np.array_equal(tasync.staleness_weights(w, np.zeros(64), 0.5), w)


# ================================================= buffer semantics
def test_flush_merges_in_dispatch_order():
    rows = lambda v: {"w": torch.full((1, 2, 3), float(v))}
    buf = tasync.AsyncBuffer.fresh(4)
    buf, sa = buf.reserve([10], dispatch=0, arrivals=[2], weights=[3.0])
    buf = buf.write(sa, rows(1.0))
    buf, sb = buf.reserve([11], dispatch=1, arrivals=[2], weights=[5.0])
    buf = buf.write(sb, rows(2.0))
    buf, batch, drops = buf.flush(t=2, staleness_cap=4)
    assert batch is not None and drops == {"stale": 0, "left": 0}
    assert batch.cids.tolist() == [10, 11]
    assert batch.staleness.tolist() == [2, 1]
    assert batch.weight.tolist() == [3.0, 5.0]
    assert torch.equal(batch.payload["w"][0], torch.full((2, 3), 1.0))
    assert torch.equal(batch.payload["w"][1], torch.full((2, 3), 2.0))
    assert buf.in_flight == 0


def test_write_leaves_the_old_buffer_untouched():
    buf, slots = tasync.AsyncBuffer.fresh(4).reserve([1, 2], 0, [1, 1], [1.0, 1.0])
    a = buf.write(slots, {"w": torch.ones(2, 3)})
    b = a.write(slots, {"w": torch.full((2, 3), 7.0)})
    assert torch.equal(a.payload["w"][:2], torch.ones(2, 3))
    assert torch.equal(b.payload["w"][:2], torch.full((2, 3), 7.0))


def test_bounded_staleness():
    cap = 2
    st = _tinit("stocfl", async_cfg=tengine.AsyncConfig(staleness_cap=cap,
                                                        staleness_decay=0.8))
    rng = np.random.default_rng(7)
    for _ in range(8):
        st, rec = tengine.run_round_async(st, delays=rng.integers(0, 6, 6))
        assert rec["max_staleness"] <= cap
        assert rec["in_flight"] <= rec["sampled"] * (cap + 1)
    assert any(r["dropped_stale"] > 0 for r in st.history)


@pytest.mark.parametrize("capacity", [0, 16, 128])
def test_capacity_does_not_change_the_run(capacity):
    clients = _fed()
    delays = [np.array([0, 1, 2, 0, 1, 2]), np.array([2, 2, 0, 0, 1, 1]),
              np.zeros(6, np.int64), np.array([1, 0, 1, 0, 1, 0])]
    ref = _tinit("stocfl", clients, async_cfg=tengine.AsyncConfig(staleness_decay=0.9))
    got = _tinit("stocfl", clients, async_cfg=tengine.AsyncConfig(
        staleness_decay=0.9, buffer_capacity=capacity))
    for d in delays:
        ref, _ = tengine.run_round_async(ref, delays=d)
        got, _ = tengine.run_round_async(got, delays=d)
    assert_same_states(ref, got)


def test_buffer_grows_on_overflow():
    clients = _fed()
    ref = _tinit("fedavg", clients, async_cfg=tengine.AsyncConfig())
    tiny = _tinit("fedavg", clients, async_cfg=tengine.AsyncConfig(buffer_capacity=2))
    for d in ([3, 3, 3, 3, 3, 3], [0, 0, 0, 0, 0, 0]):
        ref, _ = tengine.run_round_async(ref, delays=np.asarray(d))
        tiny, _ = tengine.run_round_async(tiny, delays=np.asarray(d))
    assert tiny.buffer.capacity >= 8
    assert_same_states(ref, tiny)


def test_departed_clients_delta_is_dropped():
    st = _tinit("stocfl", async_cfg=tengine.AsyncConfig())
    st, rec = tengine.run_round_async(st, delays=np.full(6, 2, np.int64))
    assert rec["in_flight"] == 6
    victim = int(st.buffer.entries[0].cid)
    st = tengine.leave(st, victim)
    dropped = 0
    for _ in range(3):
        st, rec = tengine.run_round_async(st)
        dropped += rec["dropped_left"]
    assert dropped == 1 and victim in st.left
    assert all(int(e.cid) != victim for e in st.buffer.entries)


def test_join_while_deltas_in_flight():
    clients = _fed()
    extra = _fed(n_clients=14, seed=9)[12:]
    st = _tinit("stocfl", clients, async_cfg=tengine.AsyncConfig(staleness_cap=3))
    st, _ = tengine.run_round_async(st, delays=np.full(6, 1, np.int64))
    assert st.buffer.in_flight > 0
    st, cid = tengine.join(st, extra[0])
    for _ in range(6):
        m = max(1, int(np.ceil(0.5 * (st.n_clients - len(st.left)))))
        st, _ = tengine.run_round_async(st, delays=np.full(m, 1, np.int64))
    assert cid in st.clusters.seen, "the joined client was never observed"
    assert sum(r["merged"] for r in st.history) > 0
