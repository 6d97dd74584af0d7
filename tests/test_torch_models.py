"""The port's task models and Ψ extractor against the JAX package.

The reference's own parameters cross over through ``repro_torch.convert``;
logits, loss and gradients agree within rtol 1e-5 / atol 1e-6 (fp32, sums
in another order), Ψ within atol 1e-6. TF32 is irrelevant on the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.extractor import make_extractor as j_extractor  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.extractor import make_extractor as t_extractor  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import simple as tsimple  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6

CASES = {
    "mlp": dict(kind="mlp", input_shape=(64,), n_classes=10, hidden=48),
    "cnn_gray": dict(kind="cnn", input_shape=(8, 8, 1), n_classes=6,
                     conv_channels=(4, 8), fc_hidden=16),
    "cnn_rgb": dict(kind="cnn", input_shape=(12, 12, 3), n_classes=10,
                    conv_channels=(3, 5), fc_hidden=12),
}


def _tasks(case):
    kw = CASES[case]
    return (jsimple.TaskConfig(case, **kw), tsimple.TaskConfig(case, **kw))


def _batch(jtask, n=9, seed=0, mask=False):
    rng = np.random.default_rng(seed)
    b = {"x": rng.normal(size=(n,) + jtask.input_shape).astype(np.float32),
         "y": rng.integers(0, jtask.n_classes, size=n).astype(np.int32)}
    if mask:
        b["mask"] = (rng.random(n) > 0.3).astype(np.float32)
    return b


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case,mask", [("mlp", False), ("mlp", True),
                                       ("cnn_gray", False), ("cnn_gray", True),
                                       ("cnn_rgb", True)])
def test_logits_loss_grads_match_reference(case, mask):
    jtask, ttask = _tasks(case)
    jp = jsimple.init(jax.random.PRNGKey(1), jtask)
    tp = convert.to_torch(jp)
    b = _batch(jtask, mask=mask)
    tb = convert.to_torch(b)

    _close(tsimple.apply(tp, tb["x"], ttask).numpy(),
           jsimple.apply(jp, jnp.asarray(b["x"]), jtask))
    jl, jg = jax.value_and_grad(lambda p: jsimple.loss_fn(p, b, jtask))(jp)
    tpg = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tl = tsimple.loss_fn(tpg, tb, ttask)
    tg = dict(zip(tpg, torch.autograd.grad(tl, list(tpg.values()))))
    _close(tl.detach().numpy(), jl)
    assert sorted(tg) == sorted(jg)
    for k in jg:
        _close(tg[k].numpy(), jg[k])
    _close(tsimple.accuracy(tp, tb, ttask).numpy(),
           jsimple.accuracy(jp, b, jtask))


@pytest.mark.parametrize("case", sorted(CASES))
def test_init_structure_matches_reference(case):
    jtask, ttask = _tasks(case)
    jp = jsimple.init(jax.random.PRNGKey(0), jtask)
    tp = tsimple.init(torch.Generator().manual_seed(0), ttask)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        assert tuple(jp[k].shape) == tuple(tp[k].shape)
        assert tp[k].dtype == torch.float32


def test_dense_init_scale():
    w = tlayers.dense_init(torch.Generator().manual_seed(0), 400, 300)
    assert w.shape == (400, 300)
    assert abs(float(w.std()) - 1 / 20) < 2e-3


@pytest.mark.parametrize("case", sorted(CASES))
def test_psi_matches_reference_extractor(case):
    jtask, ttask = _tasks(case)
    jp = jsimple.init(jax.random.PRNGKey(2), jtask)
    jpsi = j_extractor(lambda p, b: jsimple.loss_fn(p, b, jtask), jp)
    tpsi = t_extractor(lambda p, b: tsimple.loss_fn(p, b, ttask),
                       convert.to_torch(jp))
    for seed in range(3):
        b = _batch(jtask, n=16, seed=seed)
        got = tpsi(convert.to_torch(b))
        assert got.dtype == torch.float32 and got.dim() == 1
        np.testing.assert_allclose(got.numpy(), np.asarray(jpsi(b)), rtol=0, atol=1e-6)
        assert abs(float(torch.linalg.vector_norm(got)) - 1.0) < 1e-5


def test_psi_of_zero_gradient_is_zero():
    params = {"w": torch.ones(3, 2), "unused": torch.ones(4)}
    flat_loss = lambda p, b: (p["w"] * 0.0).sum() + b["x"].sum()
    got = t_extractor(flat_loss, params)({"x": torch.ones(2)})
    assert got.shape == (10,) and not got.any()      # 0, not NaN


def test_convert_round_trip_keeps_values_and_dtypes():
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "n": {"y": np.array([1, 2], np.int32)}}
    back = convert.to_numpy(convert.to_torch(tree))
    assert back["a"].dtype == np.float32 and back["n"]["y"].dtype == np.int32
    np.testing.assert_array_equal(back["a"], tree["a"])
    np.testing.assert_array_equal(back["n"]["y"], tree["n"]["y"])
    bf = convert.to_numpy({"h": torch.ones(3, dtype=torch.bfloat16)})
    assert bf["h"].dtype == np.float32


def test_cnn_flatten_order_is_hwc():
    """fc1 rows follow the reference's (H, W, C) flatten: permuting the
    conv2 output channels must move fc1's rows with the channel index
    innermost."""
    jtask, ttask = _tasks("cnn_rgb")
    jp = jsimple.init(jax.random.PRNGKey(4), jtask)
    tp = convert.to_torch(jp)
    b = _batch(jtask, n=3, seed=7)
    want = np.asarray(jsimple.apply(jp, jnp.asarray(b["x"]), jtask))
    got = tsimple.apply(tp, convert.to_torch(b)["x"], ttask).numpy()
    _close(got, want)
    c2 = jtask.conv_channels[1]
    perm = np.roll(np.arange(c2), 1)
    tp2 = dict(tp)
    tp2["conv2_w"] = tp["conv2_w"][..., perm]
    tp2["conv2_b"] = tp["conv2_b"][perm]
    fc1 = tp["fc1_w"].reshape(-1, c2, jtask.fc_hidden)
    tp2["fc1_w"] = fc1[:, perm].reshape(tp["fc1_w"].shape)
    _close(tsimple.apply(tp2, convert.to_torch(b)["x"], ttask).numpy(), want)
