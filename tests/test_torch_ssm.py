"""The port's falcon-mamba family (configs, Mamba1 block, LM, registry)
against the JAX package, on the CPU.

The smoke config (2 layers, d_model 128, vocab 512) runs in fp32
(``dtype="float32"``): the point here is the algorithm, not bf16 rounding,
which the two frameworks place differently. The reference's parameters
cross over through ``repro_torch.convert``; tokens are made with numpy.
Tolerances: rtol 1e-5 / atol 2e-5. The port's plain chunked scan takes
each chunk's running products step by step where JAX takes them by an
associative scan, so sums round differently (about 1e-6 relative); the
rest is the same fp32 arithmetic in another summation order.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import registry as tregistry  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.utils import trees  # noqa: E402

RTOL, ATOL = 1e-5, 2e-5


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _cfgs(**kw):
    kw = {"dtype": "float32", **kw}
    return (jconfigs.get_config("falcon-mamba-7b", smoke=True, **kw),
            tconfigs.get_config("falcon-mamba-7b", smoke=True, **kw))


@pytest.fixture(scope="module")
def jparams():
    jcfg, _ = _cfgs()
    return jregistry.build(jcfg).init(jax.random.PRNGKey(0))


def _tokens(cfg, b=2, s=24, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_the_reference(smoke):
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.CLI_ALIASES == jconfigs.CLI_ALIASES
    for arch in jconfigs.ARCH_IDS:
        assert (dataclasses.asdict(tconfigs.get_config(arch, smoke=smoke))
                == dataclasses.asdict(jconfigs.get_config(arch, smoke=smoke)))


def test_init_layout_matches_the_reference(jparams):
    """Same tree, shapes and dtypes as the reference's stacked init, and
    the full-width 2-layer model of the chip run has 743,305,216
    parameters (counted from the reference's shapes, nothing allocated)."""
    _, tcfg = _cfgs()
    tp = tregistry.build(tcfg).init(torch.Generator().manual_seed(0))
    jl = jax.tree_util.tree_flatten_with_path(jparams)[0]
    tl = trees.leaves(tp)
    assert len(jl) == len(tl)
    for (path, j), t in zip(jl, tl):
        assert tuple(j.shape) == tuple(t.shape), path
        assert str(j.dtype) == str(t.dtype).replace("torch.", ""), path
    full = jconfigs.get_config("falcon-mamba-7b", n_layers=2)
    shapes = jax.eval_shape(jregistry.build(full).init, jax.random.PRNGKey(0))
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) == 743_305_216


def test_chunked_scan_matches_reference():
    rng = np.random.default_rng(2)
    dA = rng.uniform(0.5, 1.0, (2, 40, 12, 16)).astype(np.float32)
    dBx = rng.normal(size=(2, 40, 12, 16)).astype(np.float32)
    h0 = rng.normal(size=(2, 12, 16)).astype(np.float32)
    for chunk in (16, 40, 128):
        jh, jlast = jssm._chunked_scan(jnp.asarray(dA), jnp.asarray(dBx),
                                       jnp.asarray(h0), chunk)
        th, tlast = tssm._chunked_scan(torch.as_tensor(dA), torch.as_tensor(dBx),
                                       torch.as_tensor(h0), chunk)
        _close(th, jh)
        _close(tlast, jlast)


def _layer0(params):
    return jax.tree.map(lambda x: x[0], params["layers"]["mixer"])


@pytest.mark.parametrize("use_pallas", [False, True])
def test_mamba1_train_matches_reference(jparams, use_pallas):
    jcfg, tcfg = _cfgs(use_pallas=use_pallas)
    x = np.random.default_rng(3).normal(size=(2, 24, jcfg.d_model)).astype(np.float32)
    p = _layer0(jparams)
    want = jssm.mamba1_train(p, jnp.asarray(x), jcfg)
    got = tssm.mamba1_train(convert.to_torch(p), torch.as_tensor(x), tcfg)
    _close(got, want)


def test_mamba1_prefill_and_decode_match_reference(jparams):
    """Prefill's output and cache against JAX, then decode token by token
    from an empty cache against prefill over the same prefix."""
    jcfg, tcfg = _cfgs()
    x = np.random.default_rng(4).normal(size=(2, 12, jcfg.d_model)).astype(np.float32)
    p = _layer0(jparams)
    tp = convert.to_torch(p)
    jout, jcache = jssm.mamba1_prefill(p, jnp.asarray(x), jcfg)
    tout, tcache = tssm.mamba1_prefill(tp, torch.as_tensor(x), tcfg)
    _close(tout, jout)
    _close(tcache["h"], jcache["h"])
    _close(tcache["conv"], jcache["conv"])
    cache = {"h": torch.zeros((2, tcfg.d_inner, tcfg.ssm_state)),
             "conv": torch.zeros((2, tcfg.ssm_conv - 1, tcfg.d_inner))}
    jc = jax.tree.map(jnp.asarray, convert.to_numpy(cache))
    for t in range(x.shape[1]):
        step, cache = tssm.mamba1_decode(tp, torch.as_tensor(x[:, t:t + 1]), cache, tcfg)
        jstep, jc = jssm.mamba1_decode(p, jnp.asarray(x[:, t:t + 1]), jc, jcfg)
        _close(step, tout[:, t:t + 1])
        _close(step, jstep)
    _close(cache["h"], tcache["h"])
    _close(cache["conv"], tcache["conv"])


@pytest.mark.parametrize("use_pallas", [False, True])
def test_lm_forward_loss_and_gradient_match_reference(jparams, use_pallas):
    jcfg, tcfg = _cfgs(use_pallas=use_pallas)
    jm, tm = jregistry.build(jcfg), tregistry.build(tcfg)
    toks = _tokens(jcfg)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(toks)}
    tp = convert.to_torch(jparams)
    jlogits, _ = jm.forward_train(jparams, jb)
    tlogits, aux = tm.forward_train(tp, tb)
    _close(tlogits, jlogits)
    assert float(aux) == 0.0
    jloss, jgrad = jax.value_and_grad(jm.loss_fn)(jparams, jb)
    leaves = [x.requires_grad_(True) for x in trees.leaves(tp)]
    tloss = tm.loss_fn(tp, tb)
    grads = torch.autograd.grad(tloss, leaves)
    _close(tloss.detach(), jloss)
    for got, want in zip(grads, jax.tree.leaves(jgrad)):
        _close(got, want)


def test_lm_prefill_and_decode_step_match_reference(jparams):
    jcfg, tcfg = _cfgs()
    jm, tm = jregistry.build(jcfg), tregistry.build(tcfg)
    toks = _tokens(jcfg, s=10, seed=5)
    tp = convert.to_torch(jparams)
    jlog, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(toks[:, :-1])})
    tlog, tcache = tm.prefill(tp, {"tokens": torch.as_tensor(toks[:, :-1])})
    _close(tlog, jlog)
    jlog2, _ = jm.decode(jparams, jnp.asarray(toks[:, -1]), jcache, 9)
    tlog2, tcache2 = tm.decode(tp, torch.as_tensor(toks[:, -1]), tcache, 9)
    _close(tlog2, jlog2)
    empty = tm.make_cache(2, 10)
    assert {k: tuple(v.shape) for k, v in empty.items()} == \
        {k: tuple(v.shape) for k, v in tcache2.items()}
    # prefill over all tokens ends where prefill + one decode step ends
    full, _ = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    _close(tlog2, full)
