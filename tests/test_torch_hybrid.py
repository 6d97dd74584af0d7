"""The port's Mamba2 block and zamba2 hybrid (``repro_torch.models.ssm``'s
``mamba2_*`` and ``repro_torch.models.hybrid``) against the JAX package,
on the CPU.

zamba2-1.2b's smoke config (4 Mamba2 layers, the shared attention block
after every 2, a 64-token window) and a remainder variant (5 layers: two
groups, then one layer without an application) in fp32. The reference's
parameters cross over through ``repro_torch.convert``; tokens and inputs
are made with numpy. Tolerances: rtol 1e-5 with atol 2e-5 on outputs,
logits and the loss (the falcon-mamba tests' precedent,
``tests/test_torch_ssm.py``); 3e-5 of the leaf's largest magnitude on the
model's caches and vocab gradients (``_close_leaf``). The port's chunked
scan takes each chunk's running products step by step where JAX takes
them by an associative scan, so sums round differently; through a stack
of Mamba2 layers (states up to about 80) and the shared block applied
twice, fp32 rounding reaches a few 1e-5 of a leaf's scale: the
reference's own fp32 embedding gradient of the 5-layer variant is 2.7e-5
from its float64 value, and the port's 2.4e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import hybrid as jhybrid  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import hybrid as thybrid  # noqa: E402
from repro_torch.models import registry as tregistry  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.utils import trees  # noqa: E402

RTOL, ATOL = 1e-5, 2e-5
LEAF_TOL = 3e-5
B, S, STEPS = 2, 12, 4
CASES = {"zamba2": {}, "zamba2_rem": {"n_layers": 5}}


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _close_leaf(got, want):
    """Within ``LEAF_TOL`` of the leaf's largest magnitude (at least 1)."""
    want = np.asarray(want)
    _close(got, want, rtol=0, atol=LEAF_TOL * max(1.0, float(np.abs(want).max())))


def _cfgs(**kw):
    kw = {"dtype": "float32", **kw}
    return (jconfigs.get_config("zamba2-1.2b", smoke=True, **kw),
            tconfigs.get_config("zamba2-1.2b", smoke=True, **kw))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _jitted(jmodel):
    return jmodel._replace(**{f: jax.jit(getattr(jmodel, f)) for f in
                              ("init", "forward_train", "prefill", "decode")})


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    jcfg, tcfg = _cfgs(**CASES[request.param])
    jmodel, tmodel = _jitted(jregistry.build(jcfg)), tregistry.build(tcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    # nonzero decay, dt bias and skip, so each parameter of the block
    # carries a value of its own
    rng = np.random.default_rng(7)
    ml = dict(jparams["mamba_layers"])
    for k in ("a_log", "dt_bias", "d_skip", "norm_scale"):
        ml[k] = ml[k] + jnp.asarray(rng.normal(0, 0.3, ml[k].shape).astype(np.float32))
    jparams = {**jparams, "mamba_layers": ml}
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return request.param, jcfg, tcfg, jmodel, tmodel, jparams, convert.to_torch(jparams), tokens


# ===================================================== the Mamba2 block
@pytest.fixture(scope="module")
def block():
    jcfg, tcfg = _cfgs(ssm_chunk=4)
    jp = jssm.mamba2_init(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(4)
    jp = {**jp, **{k: jp[k] + jnp.asarray(rng.normal(0, 0.3, jp[k].shape).astype(np.float32))
                   for k in ("a_log", "dt_bias", "d_skip", "norm_scale", "conv_b")}}
    x = rng.normal(size=(B, 10, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, convert.to_torch(jp), x


def test_mamba2_init_layout_matches_the_reference(block):
    _, tcfg, jp, _, _ = block
    got = tssm.mamba2_init(torch.Generator().manual_seed(0), tcfg)
    assert [(k, tuple(v.shape)) for k, v in sorted(got.items())] == \
        [(k, tuple(v.shape)) for k, v in sorted(jp.items())]
    nh = tcfg.d_inner // tcfg.ssm_head_dim
    assert got["in_proj"].shape == (tcfg.d_model, 2 * tcfg.d_inner + 2 * tcfg.ssm_state + nh)


def test_mamba2_train_and_prefill_match_reference(block):
    """Chunk 4 over 10 positions: two whole chunks and a remainder
    folded in as the reference folds it (n = 2 chunks of 5)."""
    jcfg, tcfg, jp, tp, x = block
    _close(tssm.mamba2_train(tp, torch.as_tensor(x), tcfg),
           jax.jit(lambda p, xx: jssm.mamba2_train(p, xx, jcfg))(jp, jnp.asarray(x)))
    out, cache = tssm.mamba2_prefill(tp, torch.as_tensor(x), tcfg)
    jout, jcache = jax.jit(lambda p, xx: jssm.mamba2_prefill(p, xx, jcfg))(jp, jnp.asarray(x))
    _close(out, jout)
    assert tuple(cache["h"].shape) == (B, tcfg.d_inner // tcfg.ssm_head_dim,
                                       tcfg.ssm_head_dim, tcfg.ssm_state)
    assert cache["h"].dtype == torch.float32
    for k in ("h", "conv"):
        _close(cache[k], jcache[k])


def test_mamba2_decode_continues_prefill_like_the_reference(block):
    """Prefill 7 positions, then 3 single-token decodes against the
    cached state and conv tail; each output and the final cache against
    the reference's, and against the prefill of all 10 positions."""
    jcfg, tcfg, jp, tp, x = block
    _, cache = tssm.mamba2_prefill(tp, torch.as_tensor(x[:, :7]), tcfg)
    _, jcache = jssm.mamba2_prefill(jp, jnp.asarray(x[:, :7]), jcfg)
    jdec = jax.jit(lambda p, xx, c: jssm.mamba2_decode(p, xx, c, jcfg))
    outs = []
    for t in range(7, 10):
        out, cache = tssm.mamba2_decode(tp, torch.as_tensor(x[:, t:t + 1]), cache, tcfg)
        jout, jcache = jdec(jp, jnp.asarray(x[:, t:t + 1]), jcache)
        _close(out, jout)
        outs.append(out)
    for k in ("h", "conv"):
        _close(cache[k], jcache[k])
    full, fcache = tssm.mamba2_prefill(tp, torch.as_tensor(x), tcfg)
    _close(torch.cat(outs, 1), full[:, 7:], rtol=1e-4, atol=1e-4)
    _close(cache["h"], fcache["h"], rtol=1e-4, atol=1e-4)


# ===================================================== the hybrid LM
def test_hybrid_init_layout_matches_the_reference(case):
    _, jcfg, tcfg, _, tmodel, jparams, _, _ = case
    got = tmodel.init(torch.Generator().manual_seed(0))
    assert tcfg.arch_type == "hybrid"
    want = [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(jparams)]
    assert [(tuple(x.shape), str(x.dtype).split(".")[-1]) for x in trees.leaves(got)] == want


def test_hybrid_forward_loss_and_vocab_gradient_match_reference(case):
    _, _, _, jmodel, tmodel, jparams, tparams, tokens = case
    batch = {"tokens": jnp.asarray(tokens)}
    want, _ = jmodel.forward_train(jparams, batch)
    got, aux = tmodel.forward_train(tparams, {"tokens": torch.as_tensor(tokens)})
    _close(got, want)
    assert float(aux) == 0.0
    jl, jg = jax.jit(jax.value_and_grad(jmodel.loss_fn))(jparams, batch)
    leaves = {k: tparams[k].clone().requires_grad_(True) for k in ("embed", "lm_head")}
    loss = tmodel.loss_fn({**tparams, **leaves}, {"tokens": torch.as_tensor(tokens)})
    _close(loss.detach(), jl)
    grads = torch.autograd.grad(loss, [leaves["embed"], leaves["lm_head"]])
    _close_leaf(grads[0], jg["embed"])
    _close_leaf(grads[1], jg["lm_head"])


def test_hybrid_prefill_and_decode_match_reference(case):
    """Prefill logits and caches (Mamba2 states on the layer axis, the
    shared block's KV per application), then STEPS decode steps, scalar
    positions; then one more step with a position per row equals the
    scalar step (Mamba2 reads no position)."""
    _, jcfg, tcfg, jmodel, tmodel, jparams, tparams, tokens = case
    jlog, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)})
    tlog, tcache = tmodel.prefill(tparams, {"tokens": torch.as_tensor(tokens)})
    _close(tlog, jlog)
    assert tcache["attn"]["k"].shape[0] == thybrid._n_groups(tcfg) == jhybrid._n_groups(jcfg)
    for a, b in zip(trees.leaves(tcache), jax.tree.leaves(jcache)):
        assert tuple(a.shape) == tuple(b.shape)
        _close_leaf(a, b)
    total = S + STEPS + 1
    jcache = jregistry.grow_cache(jmodel, jcache, B, total)
    tcache = tregistry.grow_cache(tmodel, tcache, B, total)
    tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    for t in range(STEPS):
        jlog, jcache = jmodel.decode(jparams, jnp.asarray(tok), jcache, jnp.int32(S + t))
        tlog, tcache = tmodel.decode(tparams, torch.as_tensor(tok), tcache, S + t)
        _close(tlog, jlog)
        tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    for a, b in zip(trees.leaves(tcache), jax.tree.leaves(jcache)):
        _close_leaf(a, b)
    one, _ = tmodel.decode(tparams, torch.as_tensor(tok), tcache, S + STEPS)
    rows, _ = tmodel.decode(tparams, torch.as_tensor(tok), tcache,
                            torch.full((B,), S + STEPS, dtype=torch.int32))
    _close(rows, one, rtol=0, atol=1e-6)


def test_hybrid_decode_past_the_window_wraps_the_ring():
    """zamba2 smoke's 64-token window: prefill 60 tokens, then 8 decode
    steps, the last 4 past the window, so the shared block's KV cache
    (64 entries) is written modulo its length; logits and caches against
    the reference's at every step."""
    jcfg, tcfg = _cfgs()
    jmodel, tmodel = _jitted(jregistry.build(jcfg)), tregistry.build(tcfg)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    tparams = convert.to_torch(jparams)
    n = 60
    tokens = np.random.default_rng(8).integers(0, jcfg.vocab_size, (1, n)).astype(np.int32)
    jlog, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)})
    tlog, tcache = tmodel.prefill(tparams, {"tokens": torch.as_tensor(tokens)})
    _close(tlog, jlog)
    jcache = jregistry.grow_cache(jmodel, jcache, 1, n + 8)
    tcache = tregistry.grow_cache(tmodel, tcache, 1, n + 8)
    assert tcache["attn"]["k"].shape[2] == jcfg.sliding_window == 64
    tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    for t in range(8):
        jlog, jcache = jmodel.decode(jparams, jnp.asarray(tok), jcache, jnp.int32(n + t))
        tlog, tcache = tmodel.decode(tparams, torch.as_tensor(tok), tcache, n + t)
        _close(tlog, jlog)
        tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    for a, b in zip(trees.leaves(tcache), jax.tree.leaves(jcache)):
        _close_leaf(a, b)


@pytest.mark.parametrize("n_layers", [1, 4, 5])
def test_hybrid_cache_shapes_match_the_reference(n_layers):
    """make_cache, serve_cache_specs and decode_specs against the
    reference's, including a depth with no application of the shared
    block (1 layer: A = 0), whose prefill falls back to make_cache's
    attention leaves."""
    jcfg, tcfg = _cfgs(n_layers=n_layers)
    jm, tm = jregistry.build(jcfg), tregistry.build(tcfg)
    for args in ((3, 40), (2, 100)):
        got = tm.make_cache(*args, device="meta")
        want = jax.eval_shape(lambda: jm.make_cache(*args))
        assert [(tuple(a.shape), str(a.dtype).split(".")[-1]) for a in trees.leaves(got)] == \
            [(tuple(w.shape), str(w.dtype)) for w in jax.tree.leaves(want)]
    specs = tregistry.serve_cache_specs(tm, 2, 3, 40)
    assert [s.shape for s in trees.leaves(specs)] == \
        [tuple(w.shape) for w in jax.tree.leaves(jregistry.serve_cache_specs(jm, 2, 3, 40))]
    if n_layers == 1:
        tparams = tm.init(torch.Generator().manual_seed(0))
        tokens = torch.zeros((2, 5), dtype=torch.int32)
        _, cache = tm.prefill(tparams, {"tokens": tokens})
        assert tuple(cache["attn"]["k"].shape) == (0, 2, 5, tcfg.n_kv_heads,
                                                    tcfg.resolved_head_dim)
        assert tuple(cache["mamba"]["h"].shape)[:2] == (1, 2)
