"""The memory-lean pieces the falcon-mamba slice gave the engine, on the
CPU: ``ClusterBank.put`` builds the new bank at its final capacity (no
scratch row) with the reference's rows, capacity and roots; the round
hands the fused cohort update one flat (C, P) θ buffer, which it owns and
writes in place, so the gathered θ rows are freed before the first local
step; the joint cohort gradient splits into θ's and ω's own gradients.
"""
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.engine import bank as jbank  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.core import bilevel  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.engine.bank import ClusterBank  # noqa: E402
from repro_torch.models import simple  # noqa: E402


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(n, 3, 2)).astype(np.float32),
            "b": {"c": rng.normal(size=(n, 4)).astype(np.float32)}}


def _same(tbank, jb):
    assert tuple(tbank.roots) == tuple(jb.roots)
    assert tbank.capacity == jb.capacity
    for r in jb.roots:
        np.testing.assert_array_equal(tbank[r]["w"].numpy(), np.asarray(jb[r]["w"]))
        np.testing.assert_array_equal(tbank[r]["b"]["c"].numpy(), np.asarray(jb[r]["b"]["c"]))
    for x in (tbank.stacked["w"], tbank.stacked["b"]["c"]):
        assert x.shape[0] == tbank.capacity
        assert not x[len(tbank):].any()                     # spare rows are zero


@pytest.mark.parametrize("steps", [
    [([3], 1), ([3, 8], 2), ([1, 5, 8], 4), ([2], 1)],      # grow 1 -> 2 -> 4 -> 8
    [([4, 6, 9], 4), ([6], 1), ([4, 6], 2), ([0, 1, 2, 3, 7], 8)],
])
def test_put_matches_reference_and_leaves_the_old_bank_unwritten(steps):
    """Each put carries a power-of-two update count (the surplus rows are
    discarded), as the engine's aggregate does."""
    tb, jb = ClusterBank.empty(), jbank.ClusterBank.empty()
    for k, (roots, n_rows) in enumerate(steps):
        ups = _rows(n_rows, k)
        before = None if tb.stacked is None else \
            {r: tb[r]["w"].clone() for r in tb.roots}
        old = tb
        tb = tb.put(roots, {"w": torch.from_numpy(ups["w"]),
                            "b": {"c": torch.from_numpy(ups["b"]["c"])}})
        jb = jb.put(roots, {"w": jnp.asarray(ups["w"]), "b": {"c": jnp.asarray(ups["b"]["c"])}})
        _same(tb, jb)
        if before is not None:
            for r, w in before.items():
                assert torch.equal(old[r]["w"], w)          # the old bank is intact


def test_fused_update_frees_the_gathered_rows():
    """A StoCFL round with ``fused_step=True``: the rows ``ClusterBank.take``
    gathers are dead by the first local step, and the update writes the
    flat θ buffer it was handed in place (its results are views of it)."""
    task = simple.TaskConfig("synth_mlp", "mlp", (64,), 10, hidden=16)
    loss = lambda p, b: simple.loss_fn(p, b, task)
    clients, _, _ = synthetic.make_federation("rotated", n_clients=8, n_per=8, seed=1)
    cfg = engine.EngineConfig(tau=0.5, lam=0.05, lr=0.1, local_steps=2, sample_rate=0.5,
                              seed=0, fused_step=True)
    state = engine.init("stocfl", loss, simple.init(torch.Generator().manual_seed(0), task),
                        clients, cfg, device="cpu")
    gathered, handed, dead = [], [], []
    real_take, real_update = ClusterBank.take, bilevel.make_cohort_update
    real_prox = bilevel.ops.prox_update_flat

    def take(self, roots, default):
        rows = real_take(self, roots, default)
        gathered.extend(weakref.ref(x) for x in rows.values())
        return rows

    def make_update(*a, **k):
        upd = real_update(*a, **k)

        def wrapped(thetas, omega, batches):
            handed.append((tuple(thetas.shape), thetas.data_ptr()))
            return upd(thetas, omega, batches)
        return wrapped

    def prox(*a, **k):
        dead.append(all(r() is None for r in gathered))
        return real_prox(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ClusterBank, "take", take)
        mp.setattr(bilevel, "make_cohort_update", make_update)
        mp.setattr(bilevel.ops, "prox_update_flat", prox)
        state, _ = engine.run_round(state)
    n_params = sum(x.numel() for x in state.omega.values())
    assert gathered and dead == [True, True]
    assert len(handed) == 1 and handed[0][0] == (4, n_params)


def test_fused_update_writes_a_flat_buffer_in_place():
    """Given a (C, P) buffer the fused update returns views of it, holding
    what it returns for the same rows given as a stacked tree, which it
    leaves untouched."""
    torch.manual_seed(0)
    loss = lambda p, b: torch.tanh(b["x"] @ p["w"]).pow(2).mean() + p["v"].norm()
    upd = bilevel.make_cohort_update(loss, 0.1, 0.05, 3, fused=True)
    thetas = {"w": torch.randn(3, 4, 2), "v": torch.randn(3, 5)}
    omega, batches = {"w": torch.randn(4, 2), "v": torch.randn(5)}, {"x": torch.randn(3, 6, 4)}
    before = {k: v.clone() for k, v in thetas.items()}
    want_t, want_o = upd(thetas, omega, batches)
    assert all(torch.equal(thetas[k], before[k]) for k in thetas)
    flat = bilevel.flatten_tree(thetas, batch_dims=1)
    got_t, got_o = upd(flat, omega, batches)
    assert all(got_t[k].data_ptr() >= flat.data_ptr() for k in got_t)
    assert torch.equal(bilevel.flatten_tree(got_t, batch_dims=1), flat)
    for a, b in ((got_t, want_t), (got_o, want_o)):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_side_by_side_gradients_equal_the_joint_gradient():
    """The cohort loss's one gradient over θ and ω equals θ's and ω's
    gradients taken side by side, each of its own sum, bit for bit."""
    torch.manual_seed(0)
    loss = lambda p, b: torch.tanh(b["x"] @ p["w"]).pow(2).mean() + p["v"].norm()
    th = {"w": torch.randn(3, 4, 2, requires_grad=True), "v": torch.randn(3, 5, requires_grad=True)}
    om = {"w": torch.randn(3, 4, 2, requires_grad=True), "v": torch.randn(3, 5, requires_grad=True)}
    batches = {"x": torch.randn(3, 6, 4)}
    leaves = [th["v"], th["w"], om["v"], om["w"]]
    per = torch.func.vmap(loss)
    with torch.enable_grad():
        joint = torch.autograd.grad(bilevel._cohort_loss(loss, th, om, batches), leaves)
        apart = (torch.autograd.grad(per(th, batches).sum(), leaves[:2])
                 + torch.autograd.grad(per(om, batches).sum(), leaves[2:]))
    assert all(torch.equal(a, b) for a, b in zip(joint, apart))
