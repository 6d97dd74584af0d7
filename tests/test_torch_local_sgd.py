"""The baselines' local update on the CPU: K1's local-SGD form
(``ops.prox_theta_flat``), ``bilevel.local_sgd`` / ``make_cohort_sgd``, the
server-side means, the tree-vector helpers and ``ClusterBank.from_dict``,
held against the JAX package.

K1's local-SGD plain version must be bitwise equal in fp32 to the θ output
of the reference's ``ops.prox_update_flat(θ, a, g, g, η, λ, backend="jnp")``,
the call its ``local_sgd`` makes (the same operations rounded in the same
order); bf16 within one ulp. ``local_sgd`` fused must equal unfused bitwise
in fp32, as the reference's ``tests/test_fused_step.py`` holds for itself,
and both agree with the reference's within atol 1e-5 after 3 steps (sums in
another order). The means agree within atol 1e-6.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bilevel as jbilevel  # noqa: E402
from repro.engine.bank import ClusterBank as JBank  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro.utils import trees as jtrees  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import bilevel as tbilevel  # noqa: E402
from repro_torch.engine.bank import ClusterBank  # noqa: E402
from repro_torch.kernels import ops, prox_update, ref  # noqa: E402
from repro_torch.models import simple as tsimple  # noqa: E402
from repro_torch.utils import trees as ttrees  # noqa: E402

ETA, MU = 0.1, 0.05
J_TASK = dataclasses.replace(jsimple.SYNTH_MLP, hidden=24)
T_TASK = tsimple.TaskConfig("synth_mlp", "mlp", (64,), 10, hidden=24)


def _vecs(n, seed, k=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=n).astype(np.float32) for _ in range(k)]


def _bf16_bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().astype(np.int32)
    return np.asarray(x).view(np.int16).astype(np.int32)


@pytest.mark.parametrize("n", [1, 7, 1000, 4099])
@pytest.mark.parametrize("lam", [0.0, MU], ids=["anchor-is-theta", "prox"])
def test_local_sgd_plain_bitwise_equals_reference_theta(n, lam):
    th, a, g = _vecs(n, seed=n)
    anchor = th if lam == 0.0 else a
    want, _ = jops.prox_update_flat(jnp.asarray(th), jnp.asarray(anchor),
                                    jnp.asarray(g), jnp.asarray(g), ETA, lam,
                                    backend="jnp")
    t = torch.from_numpy(th.copy())
    got = ops.prox_theta_flat(t, t if lam == 0.0 else torch.from_numpy(a), torch.from_numpy(g),
                              ETA, lam)
    assert got is t
    assert np.array_equal(t.numpy(), np.asarray(want))


@pytest.mark.parametrize("rows,period", [(1, 7), (5, 13), (40, 1001)])
def test_broadcast_anchor_equals_the_tiled_anchor(rows, period):
    """A (P,) anchor over the rows of a flat (C, P) θ gives what the
    reference's call gives with the anchor repeated C times; the anchor
    is not written."""
    th, g = _vecs(rows * period, seed=period, k=2)
    (a,) = _vecs(period, seed=period + 1, k=1)
    want, _ = jops.prox_update_flat(jnp.asarray(th), jnp.asarray(np.tile(a, rows)),
                                    jnp.asarray(g), jnp.asarray(g), ETA, MU,
                                    backend="jnp")
    for backend in ("auto", "torch"):
        t, anchor = torch.from_numpy(th.copy()), torch.from_numpy(a.copy())
        ops.prox_theta_flat(t, anchor, torch.from_numpy(g), ETA, MU, backend=backend)
        assert np.array_equal(t.numpy(), np.asarray(want))
        assert np.array_equal(anchor.numpy(), a)


@pytest.mark.parametrize("n", [1, 255, 4099])
def test_local_sgd_plain_bf16_within_one_ulp(n):
    th, a, g = _vecs(n, seed=200 + n)
    j = [jnp.asarray(x).astype(jnp.bfloat16) for x in (th, a, g)]
    want, _ = jops.prox_update_flat(j[0], j[1], j[2], j[2], ETA, MU, backend="jnp")
    t = [torch.from_numpy(x).to(torch.bfloat16) for x in (th, a, g)]
    got = prox_update.prox_theta_flat(t[0], t[1], t[2], ETA, MU)
    assert got.dtype == torch.bfloat16
    assert np.abs(_bf16_bits(got) - _bf16_bits(want)).max() <= 1


@pytest.mark.parametrize("bad", ["length", "period", "dtype", "2d", "overlap"])
def test_prox_theta_rejects_bad_operands(bad):
    th, a, g = (torch.from_numpy(x) for x in _vecs(12, seed=3))
    if bad == "length":
        g = g[:11]
    elif bad == "period":
        a = a[:5]
    elif bad == "dtype":
        a = a.double()
    elif bad == "2d":
        th = th.view(3, 4)
    else:
        a = th[2:8]
    with pytest.raises((ValueError, TypeError)):
        prox_update.prox_theta_flat(th, a, g, ETA, MU)


def _setup(seed):
    params = jsimple.init(jax.random.PRNGKey(seed), J_TASK)
    anchor = jsimple.init(jax.random.PRNGKey(seed + 1), J_TASK)
    rng = np.random.default_rng(seed)
    batch = {"x": rng.normal(size=(24, 64)).astype(np.float32),
             "y": rng.integers(0, 10, 24).astype(np.int32)}
    return params, anchor, batch


def _tloss(p, b):
    return tsimple.loss_fn(p, b, T_TASK)


def _jloss(p, b):
    return jsimple.loss_fn(p, b, J_TASK)


@pytest.mark.parametrize("prox", [False, True], ids=["sgd", "prox"])
def test_local_sgd_fused_bitwise_equals_unfused_and_matches_reference(prox):
    params, anchor, batch = _setup(7)
    kw = dict(lr=ETA, steps=3, lam=MU if prox else 0.0)
    want = jbilevel.local_sgd(_jloss, params, batch, prox_to=anchor if prox else None, **kw)
    t_params = convert.to_torch(params)
    keep = {k: v.clone() for k, v in t_params.items()}
    t_anchor = convert.to_torch(anchor) if prox else None
    outs = [tbilevel.local_sgd(_tloss, t_params, convert.to_torch(batch),
                               prox_to=t_anchor, fused=f, **kw) for f in (True, False)]
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k
        assert torch.equal(t_params[k], keep[k])      # caller's params untouched
        np.testing.assert_allclose(outs[0][k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "tree"])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "stacked"])
def test_cohort_sgd_is_the_vmapped_reference(fused, shared):
    """Four clients: from one shared start (FedAvg's in_axes=None) or from
    per-client starts (IFCA, CFL), prox to a shared anchor (Ditto's
    personal step); one plain K1 call a step on the CPU."""
    params, anchor, _ = _setup(3)
    rng = np.random.default_rng(5)
    batches = {"x": rng.normal(size=(4, 24, 64)).astype(np.float32),
               "y": rng.integers(0, 10, (4, 24)).astype(np.int32)}
    starts = params if shared else jax.tree.map(
        lambda x: np.stack([np.asarray(x) * (1 + 0.1 * i) for i in range(4)]), params)
    fn = lambda p, b: jbilevel.local_sgd(_jloss, p, b, ETA, 2, prox_to=anchor, lam=MU)
    want = jax.vmap(fn, in_axes=(None if shared else 0, 0))(starts, batches)
    sgd = tbilevel.make_cohort_sgd(_tloss, ETA, 2, MU, shared=shared, fused=fused)
    got = sgd(convert.to_torch(starts), convert.to_torch(batches), convert.to_torch(anchor))
    for k in got:
        assert got[k].shape == (4,) + tuple(np.shape(params[k]))
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_aggregate_and_aggregate_stacked_match_reference():
    rng = np.random.default_rng(0)
    stacked = {"w": rng.normal(size=(5, 3, 4)).astype(np.float32),
               "b": rng.normal(size=(5, 4)).astype(np.float32)}
    w = rng.integers(1, 50, 5).astype(np.float32)
    want = jbilevel.aggregate_stacked(stacked, w)
    got = tbilevel.aggregate_stacked(convert.to_torch(stacked), torch.from_numpy(w))
    listed = [{k: v[i] for k, v in stacked.items()} for i in range(5)]
    want_l = jbilevel.aggregate(listed, w)
    got_l = tbilevel.aggregate([convert.to_torch(t) for t in listed], w)
    for k in stacked:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got_l[k].numpy(), np.asarray(want_l[k]), rtol=0, atol=1e-6)


def test_tree_vector_round_trip_matches_reference():
    tree = {"b": np.arange(6, dtype=np.float32).reshape(2, 3),
            "a": {"z": np.arange(4, dtype=np.float32), "y": np.ones((1, 2), np.float32)}}
    want = jtrees.tree_flatten_vector(tree)
    got = ttrees.tree_flatten_vector(convert.to_torch(tree))
    assert np.array_equal(got.numpy(), np.asarray(want))
    back = ttrees.tree_unflatten_vector(got * 2, convert.to_torch(tree))
    jback = jtrees.tree_unflatten_vector(want * 2, tree)
    for k, v in convert.to_numpy(back).items():
        if isinstance(v, dict):
            for kk in v:
                assert np.array_equal(v[kk], np.asarray(jback[k][kk]))
        else:
            assert np.array_equal(v, np.asarray(jback[k]))


@pytest.mark.parametrize("keys", [(0,), (3, 0, 1), (5, 2, 9, 4, 7)])
def test_bank_from_dict_to_dict_match_reference(keys):
    rng = np.random.default_rng(len(keys))
    models = {k: {"w": rng.normal(size=(2, 3)).astype(np.float32)} for k in keys}
    jb = JBank.from_dict(models)
    tb = ClusterBank.from_dict({k: convert.to_torch(v) for k, v in models.items()})
    assert tb.roots == jb.roots and tb.capacity == jb.capacity
    assert np.array_equal(tb.stacked["w"].numpy(), np.asarray(jb.stacked["w"]))
    back = tb.to_dict()
    assert sorted(back) == sorted(keys)
    for k in keys:
        assert np.array_equal(back[k]["w"].numpy(), models[k]["w"])
    assert len(ClusterBank.from_dict({})) == 0
