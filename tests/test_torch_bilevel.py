"""The port's bi-level cohort update and aggregation against the JAX package.

Six clients, E=3, the reference's parameters converted: per-client θᵢ and
ωᵢ agree within atol 1e-5 for the fused (flat, one prox_update per step)
and the tree form. Aggregates agree within atol 1e-6.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import aggregators as jagg  # noqa: E402
from repro.core import bilevel as jbilevel  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import aggregators as tagg  # noqa: E402
from repro_torch.core import bilevel as tbilevel  # noqa: E402
from repro_torch.kernels import prox_update  # noqa: E402
from repro_torch.models import simple as tsimple  # noqa: E402

J_TASK = dataclasses.replace(jsimple.SYNTH_MLP, hidden=24)
T_TASK = tsimple.TaskConfig("synth_mlp", "mlp", (64,), 10, hidden=24)
LR, LAM, E, C = 0.1, 0.05, 3, 6


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    base = jsimple.init(jax.random.PRNGKey(seed), J_TASK)
    thetas = {k: np.stack([np.asarray(v) + 0.01 * rng.normal(size=v.shape)
                           .astype(np.float32) for _ in range(C)])
              for k, v in base.items()}
    omega = {k: np.asarray(v) for k, v in base.items()}
    batches = {"x": rng.normal(size=(C, 20, 64)).astype(np.float32),
               "y": rng.integers(0, 10, size=(C, 20)).astype(np.int32)}
    return thetas, omega, batches


def _close(t_tree, j_tree, atol):
    for k in j_tree:
        np.testing.assert_allclose(t_tree[k].detach().numpy(),
                                   np.asarray(j_tree[k]), rtol=0, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("fused", [True, False])
def test_cohort_update_matches_reference(fused):
    thetas, omega, batches = _setup()
    jfn = jbilevel.make_cohort_update(
        lambda p, b: jsimple.loss_fn(p, b, J_TASK), LR, LAM, E,
        backend="jnp", fused=fused)
    jth, jom = jfn(jax.tree.map(jnp.asarray, thetas),
                   jax.tree.map(jnp.asarray, omega),
                   jax.tree.map(jnp.asarray, batches))
    tfn = tbilevel.make_cohort_update(
        lambda p, b: tsimple.loss_fn(p, b, T_TASK), LR, LAM, E,
        backend="auto", fused=fused)
    t_in = convert.to_torch(thetas)
    keep = {k: v.clone() for k, v in t_in.items()}
    before = prox_update.launches
    tth, tom = tfn(t_in, convert.to_torch(omega), convert.to_torch(batches))
    assert prox_update.launches == before          # CPU: no kernel launch
    for k in keep:
        assert torch.equal(t_in[k], keep[k])        # caller's θ untouched
    _close(tth, jth, 1e-5)
    _close(tom, jom, 1e-5)
    assert tth["w1"].shape == (C, 64, 24)


def test_fused_and_tree_forms_agree_and_client_update_is_one_row():
    thetas, omega, batches = _setup(seed=1)
    loss = lambda p, b: tsimple.loss_fn(p, b, T_TASK)
    outs = [tbilevel.make_cohort_update(loss, LR, LAM, E, fused=f)(
        convert.to_torch(thetas), convert.to_torch(omega),
        convert.to_torch(batches)) for f in (True, False)]
    for a, b in zip(*outs):
        for k in a:
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=0, atol=1e-6)
    one = tbilevel.make_client_update(loss, LR, LAM, E, fused=True)
    th2, om2 = one({k: torch.from_numpy(v[2]) for k, v in thetas.items()},
                   convert.to_torch(omega),
                   {k: torch.from_numpy(v[2]) for k, v in batches.items()})
    for k in th2:
        np.testing.assert_allclose(th2[k].numpy(), outs[0][0][k][2].numpy(),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(om2[k].numpy(), outs[0][1][k][2].numpy(),
                                   rtol=0, atol=1e-6)


def test_flatten_unflatten_round_trip():
    tree = {"b": torch.arange(6.).reshape(2, 3),
            "a": {"z": torch.arange(4.).reshape(2, 2), "y": torch.arange(2.)[:, None]}}
    spec = tbilevel.flat_spec({"b": tree["b"][0], "a": {"z": tree["a"]["z"][0],
                                                         "y": tree["a"]["y"][0]}})
    flat = tbilevel.flatten_tree(tree, batch_dims=1)
    assert flat.shape == (2, 6)
    # sorted-key order: a/y, a/z, b
    assert flat[0].tolist() == [0., 0., 1., 0., 1., 2.]
    back = tbilevel.unflatten_tree(flat, spec)
    assert torch.equal(back["b"], tree["b"])
    assert torch.equal(back["a"]["z"], tree["a"]["z"])
    assert torch.equal(back["a"]["y"], tree["a"]["y"])


@pytest.mark.parametrize("num_segments", [3, 4, 8])
def test_aggregate_segments_matches_reference(num_segments):
    rng = np.random.default_rng(num_segments)
    stacked = {"w": rng.normal(size=(7, 3, 2)).astype(np.float32),
               "b": rng.normal(size=(7,)).astype(np.float32)}
    w = rng.integers(1, 50, size=7).astype(np.float32)
    seg = np.array([0, 2, 1, 0, 2, 2, 1])
    want = jbilevel.aggregate_segments(jax.tree.map(jnp.asarray, stacked), w,
                                       seg, num_segments)
    got = tbilevel.aggregate_segments(convert.to_torch(stacked),
                                      torch.from_numpy(w), seg, num_segments)
    _close(got, want, 1e-6)
    assert not got["w"][3:].any()                  # pad segments are zero rows


@pytest.mark.parametrize("name", sorted(tagg.AGGREGATORS))
@pytest.mark.parametrize("n", [5, 6])
def test_aggregators_match_reference(name, n):
    rng = np.random.default_rng(n)
    stacked = {"w": rng.normal(size=(n, 4, 3)).astype(np.float32),
               "b": rng.normal(size=(n, 3)).astype(np.float32)}
    w = rng.integers(1, 9, size=n).astype(np.float32)
    want = jagg.AGGREGATORS[name](jax.tree.map(jnp.asarray, stacked), w)
    got = tagg.AGGREGATORS[name](convert.to_torch(stacked), torch.from_numpy(w))
    _close(got, want, 1e-6)
