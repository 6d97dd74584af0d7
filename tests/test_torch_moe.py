"""The port's Mixture-of-Experts FFN (``repro_torch.models.moe``) against
the JAX package's ``models/moe.py``, on the CPU.

phi3.5-moe's smoke config (4 experts, top-2) and deepseek-v2's (4 routed
top-2 and a shared expert) in fp32, at their own capacity factor (4.0,
which drops nothing) and at 0.5, where the reference drops assignments
(asserted, so the drop bookkeeping is exercised), at several dispatch
group sizes. The reference's parameters cross over through
``repro_torch.convert``; inputs are made with numpy. Tolerance 1e-5
absolute on the output and the aux loss, and 1e-5 of each leaf's largest
|gradient| on the gradients of every parameter and of the input (an
expert weight's gradient sums every token's outer product, up to about
10 in size): the same fp32 arithmetic in another summation order (the
einsums' contraction paths differ).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.utils import trees  # noqa: E402

ATOL = 1e-5
B, S = 2, 12
ARCHS = {"phi35": "phi3.5-moe-42b-a6.6b", "deepseek": "deepseek-v2-236b"}
GROUPS = [0, 8, 5, 1]          # 0: cfg.moe_group_size (all 24 tokens); 5 -> 4


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@functools.lru_cache(maxsize=None)
def _setup(name, capacity_factor):
    kw = {"dtype": "float32"}
    if capacity_factor is not None:
        kw["capacity_factor"] = capacity_factor
    jcfg = jconfigs.get_config(ARCHS[name], smoke=True, **kw)
    tcfg = tconfigs.get_config(ARCHS[name], smoke=True, **kw)
    jp = jmoe.moe_init(jax.random.PRNGKey(0), jcfg)
    # a router at 0.2 scale instead of 0.02, so the gates spread and the
    # top-k choices crowd some experts
    jp = {**jp, "router": {"w": jp["router"]["w"] * 10.0}}
    x = np.random.default_rng(1).normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, convert.to_torch(jp), x


def _ref_drops(jcfg, jp, x, group_size):
    """Assignments the reference drops: its own router (softmax and
    ``jax.lax.top_k``), slot-major buffer positions past the capacity."""
    xg, _ = jmoe._group(jnp.asarray(x), group_size or jcfg.moe_group_size)
    G, g, _ = xg.shape
    gates = jax.nn.softmax((xg @ jp["router"]["w"]).astype(jnp.float32), axis=-1)
    _, idx = jax.lax.top_k(gates, jcfg.moe_top_k)
    cap = max(int(jcfg.moe_top_k * g / jcfg.n_experts * jcfg.capacity_factor), 1)
    cap = -(-cap // 4) * 4 if cap >= 4 else cap
    drops = 0
    for gi in range(G):
        seen = np.zeros(jcfg.n_experts, int)
        for e in np.asarray(idx[gi]).T.reshape(-1):     # slot-major
            drops += seen[e] >= cap
            seen[e] += 1
    return int(drops)


@pytest.mark.parametrize("group_size", GROUPS)
@pytest.mark.parametrize("capacity_factor", [None, 0.5])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_moe_ffn_matches_reference(name, capacity_factor, group_size):
    jcfg, tcfg, jp, tp, x = _setup(name, capacity_factor)
    fn = jax.jit(functools.partial(jmoe.moe_ffn, cfg=jcfg, group_size=group_size))
    want, waux = fn(jp, jnp.asarray(x))
    got, gaux = tmoe.moe_ffn(tp, torch.as_tensor(x), tcfg, group_size)
    _close(got, want)
    _close(gaux, waux)
    drops = _ref_drops(jcfg, jp, x, group_size)
    assert tmoe.dropped(tp, torch.as_tensor(x), tcfg, group_size) == drops
    if capacity_factor == 0.5 and group_size != 1:
        assert drops > 0, "the reference dropped nothing at capacity factor 0.5"
    if capacity_factor is None:
        assert drops == 0


@pytest.mark.parametrize("capacity_factor", [None, 0.5])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_moe_ffn_gradients_match_reference(name, capacity_factor):
    """Gradients of <out, R> + aux for every parameter and the input, at
    group size 8 (three groups)."""
    jcfg, tcfg, jp, tp, x = _setup(name, capacity_factor)
    r = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        out, aux = jmoe.moe_ffn(p, xx, jcfg, 8)
        return jnp.sum(out * r) + aux

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = [t.clone().requires_grad_(True) for t in trees.leaves(tp)]
    xt = torch.as_tensor(x).clone().requires_grad_(True)
    out, aux = tmoe.moe_ffn(trees.from_leaves(tp, leaves), xt, tcfg, 8)
    grads = torch.autograd.grad(torch.sum(out * torch.as_tensor(r)) + aux, leaves + [xt])
    for g, w in zip(grads, jax.tree.leaves(jg) + [jgx]):
        _close(g, w, atol=ATOL * max(1.0, float(jnp.abs(w).max())))


def test_equal_gates_choose_the_lower_experts_first():
    """With a zero router every gate is 1/E: ``jax.lax.top_k`` takes
    experts 0..k-1 in that order, and so must the port."""
    jcfg, tcfg, jp, tp, x = _setup("phi35", 0.5)
    jz = {**jp, "router": {"w": jnp.zeros_like(jp["router"]["w"])}}
    tz = {**tp, "router": {"w": torch.zeros_like(tp["router"]["w"])}}
    _, idx, pos, _ = tmoe.route(tz, torch.as_tensor(x).reshape(1, B * S, -1), tcfg)
    assert idx.tolist() == [[[0, 1]] * (B * S)]
    assert pos[0, :, 0].tolist() == list(range(B * S))
    want, waux = jmoe.moe_ffn(jz, jnp.asarray(x), jcfg)
    got, gaux = tmoe.moe_ffn(tz, torch.as_tensor(x), tcfg)
    _close(got, want)
    _close(gaux, waux)


def test_moe_ffn_under_vmap_equals_each_call():
    """The cohort update and the serving decode run the layer under
    ``torch.func.vmap`` (one-hots by comparison, a stable sort): the
    batched call equals the calls one by one."""
    _, tcfg, _, tp, x = _setup("deepseek", 0.5)
    stacked = trees.tree_map(lambda w: torch.stack([w, w * 1.5]), tp)
    xs = torch.as_tensor(np.stack([x, x[::-1].copy()]))
    out, aux = torch.func.vmap(lambda p, xx: tmoe.moe_ffn(p, xx, tcfg, 8))(stacked, xs)
    for i in range(2):
        o, a = tmoe.moe_ffn(trees.tree_map(lambda w: w[i], stacked), xs[i], tcfg, 8)
        _close(out[i], o, atol=1e-6)
        _close(aux[i], a, atol=1e-6)


@pytest.mark.parametrize("tokens,size,want", [(24, 4096, 24), (24, 5, 4), (7, 4, 1),
                                              (12, 1, 1), (4096, 4096, 4096)])
def test_group_and_capacity_follow_the_reference(tokens, size, want):
    assert tmoe.group_tokens(tokens, size) == want
    x = jnp.zeros((1, tokens, 2))
    assert jmoe._group(x, size)[0].shape[1] == want
    for name in ARCHS:
        cfg = tconfigs.get_config(ARCHS[name])
        cap = max(int(cfg.moe_top_k * want / cfg.n_experts * cfg.capacity_factor), 1)
        assert tmoe.capacity(cfg, want) == (-(-cap // 4) * 4 if cap >= 4 else cap)


def test_init_layout_matches_the_reference():
    for name in ARCHS:
        jcfg, tcfg, jp, _, _ = _setup(name, None)
        got = tmoe.moe_init(torch.Generator().manual_seed(0), tcfg)
        assert [tuple(t.shape) for t in trees.leaves(got)] == \
            [tuple(w.shape) for w in jax.tree.leaves(jp)]
