"""The port's ``ClientArena`` and ``bilevel.chunk_map`` against the JAX
package's, on the CPU.

Gathers of equal-size federations are bitwise equal to the reference's and
to a restack; ragged arenas give the same padded rows and masks; grow,
append, tombstone and compact keep every client id's rows. ``chunk_map`` at
chunk 3 over 8 clients equals the unchunked cohort step within rtol 2e-6,
atol 1e-6, the tolerance of the reference's own test (chunks change the
shapes the batched matmuls run at, so sums round differently).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.data.arena import ClientArena as JArena  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import engine as tengine  # noqa: E402
from repro_torch.core import bilevel  # noqa: E402
from repro_torch.data.arena import ClientArena  # noqa: E402
from repro_torch.models import simple as tsimple  # noqa: E402

T_TASK = tsimple.TaskConfig("synth_mlp", "mlp", (64,), 10, hidden=32)
J_TASK = dataclasses.replace(jsimple.SYNTH_MLP, hidden=32)


def _tloss(p, b):
    return tsimple.loss_fn(p, b, T_TASK)


def _fed(n_clients=8, n_per=24, seed=3):
    clients, _, _ = jsynthetic.rotated(n_clusters=2, n_clients=n_clients,
                                       n_per=n_per, seed=seed)
    return clients


def _ragged(seed=0, sizes=(5, 9, 3, 9, 7)):
    rng = np.random.default_rng(seed)
    return [{"x": rng.normal(size=(n, 64)).astype(np.float32),
             "y": rng.integers(0, 10, n).astype(np.int32)} for n in sizes]


def _torch_clients(clients):
    return [convert.to_torch(c) for c in clients]


def _assert_batch_equal(t_batch, j_batch):
    assert sorted(t_batch) == sorted(j_batch)
    for k in j_batch:
        got = t_batch[k].numpy()
        want = np.asarray(j_batch[k])
        assert got.dtype == want.dtype, k
        assert np.array_equal(got, want), k


def test_gather_equal_sizes_is_exact():
    clients = _fed(n_clients=6)
    ta = ClientArena.from_clients(_torch_clients(clients))
    ja = JArena.from_clients([jax.tree.map(jnp.asarray, c) for c in clients])
    assert not ta.ragged and ta.n_clients == 6 and ta.capacity == 6
    for ids in ([4, 1, 3], [0], [5, 5, 2]):
        got = ta.gather(ids)
        assert "mask" not in got
        _assert_batch_equal(got, ja.gather(ids))
        for k in got:                                  # == the restack
            want = torch.stack([torch.from_numpy(clients[i][k]) for i in ids])
            assert torch.equal(got[k], want)
    assert ta.nbytes == ja.nbytes


def test_ragged_pad_and_mask_match_reference():
    clients = _ragged()
    ta = ClientArena.from_clients(_torch_clients(clients))
    ja = JArena.from_clients(clients)
    assert ta.ragged and ja.ragged and ta.n_max == ja.n_max == 9
    got, want = ta.gather([2, 0, 4]), ja.gather([2, 0, 4])
    _assert_batch_equal(got, want)
    assert got["mask"].dtype == torch.float32
    for i, cid in enumerate([2, 0, 4]):
        n = len(clients[cid]["y"])
        assert got["mask"][i].sum() == n
        assert torch.equal(ta.client(cid)["x"], torch.from_numpy(clients[cid]["x"]))


def test_masked_loss_on_arena_rows_matches_unpadded():
    """The padded, masked rows of a ragged arena give the unpadded shard's
    loss, as in the reference."""
    clients = _ragged(seed=1)
    ta = ClientArena.from_clients(_torch_clients(clients))
    params = convert.to_torch(jsimple.init(jax.random.PRNGKey(0), J_TASK))
    row = {k: v[0] for k, v in ta.gather([1]).items()}
    got = float(_tloss(params, row))
    want = float(_tloss(params, convert.to_torch(clients[1])))
    assert abs(got - want) <= 1e-6


def test_grow_append_tombstone_compact_keep_every_cid():
    """Membership churn against the reference: after each step every live
    cid gathers the same rows in both packages, and the host index
    (sizes, rows, dead, n_rows, capacity) is the same."""
    clients = _ragged(seed=2, sizes=(6, 6, 4, 6))
    joins = _ragged(seed=3, sizes=(6, 2, 8))
    ta = ClientArena.from_clients(_torch_clients(clients))
    ja = JArena.from_clients(clients)
    grown = ta.grow(7)
    assert grown.capacity == 8 and grown.n_rows == 4 and ta.capacity == 4
    steps = [("append", joins[0]), ("tombstone", 1), ("append", joins[1]),
             ("append", joins[2]), ("tombstone", 0), ("tombstone", 3),
             ("tombstone", 4), ("compact", None), ("append", joins[0])]
    for op, arg in steps:
        if op == "append":
            ta, ja = ta.append(convert.to_torch(arg)), ja.append(arg)
        elif op == "tombstone":
            ta, ja = ta.tombstone(arg), ja.tombstone(arg)
        else:
            ta, ja = ta.compact(), ja.compact()
        assert (ta.capacity, ta.n_rows, ta.ragged, ta.dead) == \
            (ja.capacity, ja.n_rows, ja.ragged, ja.dead), op
        assert np.array_equal(ta.rows, ja.rows) and np.array_equal(ta.sizes, ja.sizes)
        assert ta.n_live == ja.n_live and ta.n_max == ja.n_max
        live = [c for c in range(ta.n_clients) if ta.rows[c] >= 0]
        _assert_batch_equal(ta.gather(live), ja.gather(live))
    with pytest.raises(KeyError):
        ta.gather([0])                       # compacted away


def test_update_rewrites_one_row():
    clients = _fed(n_clients=4)
    ta = ClientArena.from_clients(_torch_clients(clients))
    new = _fed(n_clients=4, seed=9)[2]
    before = ta.gather([0, 1, 3])
    ta = ta.update(2, convert.to_torch(new))
    ja = JArena.from_clients(clients).update(2, new)
    _assert_batch_equal(ta.gather([2]), ja.gather([2]))
    after = ta.gather([0, 1, 3])
    for k in before:
        assert torch.equal(before[k], after[k])


def test_chunk_map_matches_unchunked_fn():
    cohort = bilevel.make_cohort_update(_tloss, lr=0.1, lam=0.05, local_steps=2)
    chunked = bilevel.chunk_map(cohort, (0, None, 0), chunk=3)
    clients = _torch_clients(_fed(n_clients=8))
    params = convert.to_torch(jsimple.init(jax.random.PRNGKey(0), J_TASK))
    thetas = {k: torch.stack([v] * 8) for k, v in params.items()}
    batches = {k: torch.stack([c[k] for c in clients]) for k in clients[0]}
    t0, o0 = cohort(thetas, params, batches)          # 8 = one call
    t1, o1 = chunked(thetas, params, batches)         # 8 = 3+3+2 (padded)
    for a, b in ((t0, t1), (o0, o1)):
        for k in a:
            assert b[k].shape == a[k].shape
            torch.testing.assert_close(b[k], a[k], rtol=2e-6, atol=1e-6)


def test_chunk_map_noop_below_chunk():
    cohort = bilevel.make_cohort_update(_tloss, lr=0.1, lam=0.05, local_steps=1,
                                        fused=True)
    chunked = bilevel.chunk_map(cohort, (0, None, 0), chunk=16)
    assert bilevel.chunk_map(cohort, (0, None, 0), chunk=0) is cohort
    clients = _torch_clients(_fed(n_clients=4))
    params = convert.to_torch(jsimple.init(jax.random.PRNGKey(0), J_TASK))
    thetas = {k: torch.stack([v] * 4) for k, v in params.items()}
    batches = {k: torch.stack([c[k] for c in clients]) for k in clients[0]}
    t0, _ = cohort(thetas, params, batches)
    t1, _ = chunked(thetas, params, batches)
    for k in t0:
        assert torch.equal(t0[k], t1[k])


@pytest.mark.parametrize("backend", ["numpy", "device"])
def test_arena_rounds_equal_restack_rounds(backend):
    """Equal-size federations: the arena feeds bitwise the batches the
    restack does, so the port's whole trajectory is bitwise equal with and
    without the arena, on either clustering backend."""
    clients = _fed()
    params = convert.to_torch(jsimple.init(jax.random.PRNGKey(0), J_TASK))
    cfg = tengine.EngineConfig(local_steps=2, sample_rate=0.5, seed=0,
                               fused_step=True, cluster_backend=backend)
    a = tengine.init("stocfl", _tloss, params, clients, cfg, device="cpu")
    b = tengine.init("stocfl", _tloss, params, clients, cfg, device="cpu", arena=True)
    assert a.ctx.arena is None and b.ctx.arena is not None
    for _ in range(3):
        a, ra = tengine.run_round(a)
        b, rb = tengine.run_round(b)
        assert ra == rb
    for k in a.omega:
        assert torch.equal(a.omega[k], b.omega[k])
    assert tuple(a.models.roots) == tuple(b.models.roots)
    for r in a.models.roots:
        for k in a.omega:
            assert torch.equal(a.models[r][k], b.models[r][k])
