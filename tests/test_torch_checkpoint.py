"""The port's checkpoints (``repro_torch.checkpoint``) on the CPU: the JAX
package's file format, read both ways.

A checkpoint the port writes is loaded by the reference's
``load_server_state`` and one the reference writes by the port's, on both
clustering backends and with the device sampling key; the next round
after the resume then has the same cohort and partition in both packages
and rows within 1e-5. Within the port: a bf16 state round-trips bitwise,
a resume with deltas in flight finishes bitwise as the uninterrupted run
does, a synchronous checkpoint loads with ``buffer=None``, ``block=False``
saves the state as it was at the call, ``run_rounds`` after a resume
equals the uninterrupted span, and the legacy shim's ``save_stocfl`` /
``load_stocfl`` restore it.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro import engine as jengine  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import engine as tengine  # noqa: E402
from repro_torch.core.stocfl import StoCFL, StoCFLConfig  # noqa: E402
from repro_torch.models import simple as tsimple  # noqa: E402
from repro_torch.utils import trees  # noqa: E402

REF_ATOL = 1e-5
J_TASK = dataclasses.replace(jsimple.SYNTH_MLP, hidden=32)
T_TASK = tsimple.TaskConfig("synth_mlp", "mlp", (64,), 10, hidden=32)


def _tloss(p, b):
    return tsimple.loss_fn(p, b, T_TASK)


def _jloss(p, b):
    return jsimple.loss_fn(p, b, J_TASK)


def _fed():
    clients, _, _ = jsynthetic.rotated(n_clusters=2, n_clients=12, n_per=32, seed=3)
    return clients


def _params():
    return jsimple.init(jax.random.PRNGKey(0), J_TASK)


def _kw(name, **kw):
    kw = dict(dict(local_steps=2, sample_rate=0.5, seed=0, rng_backend="device"), **kw)
    if name == "stocfl":
        kw.setdefault("cluster_backend", "device")
    return kw


def _tinit(name, **kw):
    return tengine.init(name, _tloss, convert.to_torch(_params()), _fed(),
                        tengine.EngineConfig(**_kw(name, **kw)), device="cpu", arena=True)


def _jinit(name, **kw):
    return jengine.init(name, _jloss, _params(), [jax.tree.map(jnp.asarray, c) for c in _fed()],
                        jengine.EngineConfig(**_kw(name, **kw)), arena=True)


def _flat(tree):
    return torch.cat([x.detach().reshape(-1).float() for x in trees.leaves(tree)])


def _jflat(tree):
    return torch.as_tensor(np.concatenate([np.asarray(x, np.float32).ravel()
                                           for x in jax.tree.leaves(tree)]))


def _same(a, b) -> bool:
    return torch.equal(_flat(a), _flat(b))


def _close_to_reference(ts, js):
    """Cohort bookkeeping, partition and rows of a port state against a
    reference state after the same rounds."""
    if ts.clusters is not None:
        assert ts.clusters.assignment() == js.clusters.assignment()
    assert sorted(ts.models.roots) == sorted(js.models.roots)
    pairs = [(ts.omega, js.omega)] + [(ts.models[r], js.models[r]) for r in ts.models.roots]
    for t_tree, j_tree in pairs:
        assert float((_flat(t_tree) - _jflat(j_tree)).abs().max()) <= REF_ATOL


CROSS = [("stocfl", "device"), ("stocfl", "numpy"), ("fedavg", None)]


def _cross_kw(backend):
    return {} if backend is None else {"cluster_backend": backend}


@pytest.mark.parametrize("name,backend", CROSS)
def test_port_checkpoint_loads_in_the_reference(tmp_path, name, backend):
    kw = _cross_kw(backend)
    ts = _tinit(name, **kw)
    for _ in range(2):
        ts, _ = tengine.run_round(ts)
    tckpt.save_server_state(str(tmp_path / "ck"), ts)
    js = jckpt.load_server_state(str(tmp_path / "ck"), _jinit(name, **kw))
    assert js.round == ts.round and js.sizes == ts.sizes
    assert np.array_equal(np.asarray(js.rng_key, np.int64), ts.rng_key.numpy())
    _close_to_reference(ts, js)
    t_ids = tengine.sample_clients(ts)[1]
    assert np.array_equal(jengine.sample_clients(js)[1], t_ids)
    ts, _ = tengine.run_round(ts)
    js, _ = jengine.run_round(js)
    _close_to_reference(ts, js)


@pytest.mark.parametrize("name,backend", CROSS)
def test_reference_checkpoint_loads_in_the_port(tmp_path, name, backend):
    kw = _cross_kw(backend)
    js = _jinit(name, **kw)
    for _ in range(2):
        js, _ = jengine.run_round(js)
    jckpt.save_server_state(str(tmp_path / "ck"), js)
    ts = tckpt.load_server_state(str(tmp_path / "ck"), _tinit(name, **kw))
    assert ts.round == js.round and ts.history == tuple(js.history)
    assert ts.buffer is None
    _close_to_reference(ts, js)
    if ts.clusters is not None:
        assert ts.clusters.device == ts.ctx.device
    assert np.array_equal(jengine.sample_clients(js)[1], tengine.sample_clients(ts)[1])
    ts, trec = tengine.run_round(ts)
    js, jrec = jengine.run_round(js)
    assert trec["sampled"] == jrec["sampled"] and trec.get("n_clusters") == jrec.get("n_clusters")
    _close_to_reference(ts, js)


def test_reference_async_checkpoint_loads_in_the_port(tmp_path):
    acfg = dict(staleness_decay=0.8, staleness_cap=3)
    js = _jinit("stocfl", async_cfg=jengine.AsyncConfig(**acfg))
    for d in ([0, 1, 2, 0, 1, 2], [2, 0, 1, 1, 0, 2]):
        js, _ = jengine.run_round_async(js, delays=np.asarray(d))
    jckpt.save_server_state(str(tmp_path / "ck"), js)
    ts = tckpt.load_server_state(str(tmp_path / "ck"),
                                 _tinit("stocfl", async_cfg=tengine.AsyncConfig(**acfg)))
    assert [tuple(e) for e in ts.buffer.entries] == [tuple(e) for e in js.buffer.entries]
    assert ts.buffer.capacity == js.buffer.capacity and ts.buffer.next_seq == js.buffer.next_seq
    for c in ("payload", "aux", "psi"):
        want = getattr(js.buffer, c)
        got = getattr(ts.buffer, c)
        assert torch.equal(_flat(got), _jflat(want))
    d = np.asarray([1, 0, 0, 1, 0, 0])
    ts, trec = tengine.run_round_async(ts, delays=d)
    js, jrec = jengine.run_round_async(js, delays=d)
    for k in ("merged", "dropped_stale", "in_flight", "max_staleness", "n_clusters"):
        assert trec[k] == jrec[k], k
    _close_to_reference(ts, js)


def test_bf16_round_trip_bitwise(tmp_path):
    st = _tinit("stocfl", dtype="bfloat16", async_cfg=tengine.AsyncConfig())
    st, _ = tengine.run_round_async(st, delays=[0, 1, 2, 0, 1, 2])
    assert st.buffer.in_flight > 0
    tckpt.save_server_state(str(tmp_path / "ck"), st)
    back = tckpt.load_server_state(str(tmp_path / "ck"),
                                   _tinit("stocfl", dtype="bfloat16",
                                          async_cfg=tengine.AsyncConfig()))
    for a, b in ([(st.omega, back.omega)] + [(st.models[r], back.models[r])
                                              for r in st.models.roots]
                 + [(st.buffer.payload, back.buffer.payload), (st.buffer.aux, back.buffer.aux)]):
        for x, y in zip(trees.leaves(a), trees.leaves(b)):
            assert y.dtype == torch.bfloat16 and torch.equal(x, y)
    assert back.buffer.psi.dtype == torch.float32 and torch.equal(st.buffer.psi, back.buffer.psi)
    tree = {"a": {"w": torch.randn(3, 5).to(torch.bfloat16)}, "b": torch.arange(4)}
    tckpt.save_pytree(str(tmp_path / "t.npz"), tree)
    got = tckpt.load_pytree(str(tmp_path / "t.npz"), tree)
    assert got["a"]["w"].dtype == torch.bfloat16 and torch.equal(got["a"]["w"], tree["a"]["w"])
    assert torch.equal(got["b"], tree["b"])


@pytest.mark.parametrize("name", ["stocfl", "fedavg"])
def test_mid_buffer_resume_bitwise(tmp_path, name):
    acfg = tengine.AsyncConfig(staleness_decay=0.8, staleness_cap=3)
    st = _tinit(name, async_cfg=acfg)
    rng = np.random.default_rng(5)
    head = [rng.integers(0, 3, 6) for _ in range(3)]
    tail = [rng.integers(0, 3, 6) for _ in range(3)]
    for d in head:
        st, _ = tengine.run_round_async(st, delays=d)
    assert st.buffer.in_flight > 0
    tckpt.save_server_state(str(tmp_path / "ck"), st)
    resumed = tckpt.load_server_state(str(tmp_path / "ck"), _tinit(name, async_cfg=acfg))
    assert resumed.buffer.entries == st.buffer.entries
    for d in tail:
        st, _ = tengine.run_round_async(st, delays=d)
        resumed, _ = tengine.run_round_async(resumed, delays=d)
    assert _same(st.omega, resumed.omega)
    assert sorted(st.models.roots) == sorted(resumed.models.roots)
    assert all(_same(st.models[r], resumed.models[r]) for r in st.models.roots)
    assert st.buffer.entries == resumed.buffer.entries
    assert torch.equal(st.rng_key, resumed.rng_key)
    assert tckpt.ckpt._plain(list(st.history)) == list(resumed.history)
    if name == "stocfl":
        assert st.clusters.assignment() == resumed.clusters.assignment()


def test_sync_checkpoint_loads_without_buffer(tmp_path):
    st, _ = tengine.run_round(_tinit("fedavg"))
    tckpt.save_server_state(str(tmp_path / "ck"), st)
    back = tckpt.load_server_state(str(tmp_path / "ck"), _tinit("fedavg"))
    assert back.buffer is None and _same(st.omega, back.omega)


def test_block_false_saves_the_state_at_the_call(tmp_path):
    st = _tinit("stocfl", async_cfg=tengine.AsyncConfig())
    st, _ = tengine.run_round_async(st, delays=[1, 1, 0, 0, 2, 2])
    fut = tckpt.save_server_state(str(tmp_path / "ck"), st, block=False)
    omega0 = _flat(st.omega).clone()
    with torch.no_grad():           # later in-place writes reach no saved copy
        for x in trees.leaves(st.omega):
            x.add_(1.0)
    later, _ = tengine.run_round_async(st)
    tckpt.wait_pending()
    assert fut.done() and fut.exception() is None
    back = tckpt.load_server_state(str(tmp_path / "ck"),
                                   _tinit("stocfl", async_cfg=tengine.AsyncConfig()))
    assert torch.equal(_flat(back.omega), omega0)
    assert back.round == 1 and back.buffer.entries == st.buffer.entries


def test_run_rounds_after_resume_equals_uninterrupted(tmp_path):
    start = _tinit("stocfl", fused_step=True)
    mid = tengine.run_rounds(start, 2)
    tckpt.save_server_state(str(tmp_path / "ck"), mid)
    resumed = tckpt.load_server_state(str(tmp_path / "ck"), _tinit("stocfl", fused_step=True))
    a = tengine.run_rounds(mid, 3)
    b = tengine.run_rounds(resumed, 3)
    assert torch.equal(a.rng_key, b.rng_key)
    assert a.clusters.assignment() == b.clusters.assignment()
    assert _same(a.omega, b.omega) and a.models == b.models
    assert tckpt.ckpt._plain(list(a.history)) == list(b.history)


def test_bank_eq_and_setitem():
    rows = {3: {"w": torch.ones(2)}, 7: {"w": torch.zeros(2)}}
    bank = tengine.ClusterBank.from_dict(rows)
    assert bank == rows and bank == tengine.ClusterBank.from_dict(rows)
    assert bank != {3: {"w": torch.ones(2)}}
    bank[9] = {"w": torch.full((2,), 2.0)}
    bank[3] = {"w": torch.full((2,), 5.0)}
    assert sorted(bank.roots) == [3, 7, 9]
    assert torch.equal(bank[3]["w"], torch.full((2,), 5.0))
    assert torch.equal(bank[9]["w"], torch.full((2,), 2.0))


def test_save_and_load_stocfl_shim(tmp_path):
    cfg = StoCFLConfig(local_steps=2, sample_rate=0.5, seed=0)
    make = lambda: StoCFL(_tloss, convert.to_torch(_params()), _fed(), cfg, device="cpu")
    a = make().fit(2)
    tckpt.save_stocfl(str(tmp_path / "ck"), a)
    b = make()
    tckpt.load_stocfl(str(tmp_path / "ck"), b)
    assert _same(a.omega, b.omega) and a.models == b.models
    assert a.state.assignment() == b.state.assignment()
    assert sorted(a.state.seen) == sorted(b.state.seen)
    for c in a.state.seen:
        assert torch.equal(a.state.reps[c], b.state.reps[c])
    assert tckpt.ckpt._plain(a.history) == b.history
    # the reference reads the shim's files
    files = {"omega.npz", "state.json", "reps.npz"} | {f"cluster_{r}.npz" for r in a.models}
    assert files == set(p.name for p in (tmp_path / "ck").iterdir())
    om = jckpt.load_pytree(str(tmp_path / "ck" / "omega.npz"), _params())
    assert torch.equal(_jflat(om), _flat(a.omega))
