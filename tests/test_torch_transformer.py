"""The port's transformer families (RoPE, SwiGLU, GQA and MLA attention,
the dense and MoE layer stacks, the registry's cache helpers) against the
JAX package, on the CPU.

Dense: qwen2-1.5b's smoke config (with ``qkv_bias``), llama3-8b's
(without it) and qwen2's with a sliding window of 16. MoE: phi3.5-moe's
smoke config (GQA, 4 experts top-2, every layer MoE) and deepseek-v2's
(MLA, a dense layer 0 then an MoE layer with a shared expert), at
capacity factor 0.5, where routing drops assignments, and deepseek's at
its own factor and with an 8-entry sliding window (MLA's ring). All in fp32: the reference's
parameters cross over through ``repro_torch.convert``; tokens are made
with numpy. Tolerance 1e-5 absolute on logits, the aux loss, the loss,
its gradient on the vocab leaves and the caches: the same fp32 arithmetic
summed in another order (PyTorch's and XLA's CPU matmuls, exp, sin and
cos).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models.config import InputShape as JInputShape  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import registry as tregistry  # noqa: E402
from repro_torch.models.config import InputShape  # noqa: E402
from repro_torch.utils import trees  # noqa: E402

ATOL = 1e-5
S, B, STEPS = 12, 2, 4
CASES = {"qwen2": ("qwen2-1.5b", {}), "llama3": ("llama3-8b", {}),
         "qwen2_window": ("qwen2-1.5b", {"sliding_window": 16})}


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


MOE_CASES = {"phi35_cf05": ("phi3.5-moe-42b-a6.6b", {"capacity_factor": 0.5}),
             "deepseek": ("deepseek-v2-236b", {}),
             "deepseek_window": ("deepseek-v2-236b", {"sliding_window": 8})}


def _cfgs(name):
    arch, kw = {**CASES, **MOE_CASES}[name]
    kw = {"dtype": "float32", **kw}
    return (jconfigs.get_config(arch, smoke=True, **kw),
            tconfigs.get_config(arch, smoke=True, **kw))


def _biased(jparams, seed):
    """The reference's parameters with its zero-initialised QKV biases
    drawn at random, so the bias path carries a value."""
    rng = np.random.default_rng(seed)
    attn = dict(jparams["layers"]["attn"])
    for k in ("b_q", "b_k", "b_v"):
        if k in attn:
            attn[k] = jnp.asarray(rng.normal(0, 0.1, attn[k].shape).astype(np.float32))
    return {**jparams, "layers": {**jparams["layers"], "attn": attn}}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-sized models: one intra-op thread, so a parallel test run's
    oversubscribed CPU does not stall the thread pool's barriers."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _jitted(jmodel):
    """The reference model with its entry points compiled whole (one XLA
    program each, in place of the op-by-op dispatch that dominates these
    tests' time on the CPU)."""
    return jmodel._replace(**{f: jax.jit(getattr(jmodel, f)) for f in
                              ("init", "forward_train", "loss_fn", "prefill", "decode")})


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    jcfg, tcfg = _cfgs(request.param)
    jmodel, tmodel = _jitted(jregistry.build(jcfg)), tregistry.build(tcfg)
    jparams = _biased(jmodel.init(jax.random.PRNGKey(0)), 1)
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return request.param, jcfg, tcfg, jmodel, tmodel, jparams, convert.to_torch(jparams), tokens


def test_configs_build_dense_and_init_the_reference_layout(case):
    _, jcfg, tcfg, jmodel, tmodel, jparams, tparams, _ = case
    got = tmodel.init(torch.Generator().manual_seed(0))
    assert tregistry.build(tcfg).cfg == tcfg and tcfg.arch_type == "dense"
    want = [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(jparams)]
    assert [(tuple(x.shape), str(x.dtype).split(".")[-1]) for x in trees.leaves(got)] == want
    assert [tuple(x.shape) for x in trees.leaves(tparams)] == [w[0] for w in want]


def test_forward_train_and_loss_match_reference(case):
    _, _, _, jmodel, tmodel, jparams, tparams, tokens = case
    want, _ = jmodel.forward_train(jparams, {"tokens": jnp.asarray(tokens)})
    got, aux = tmodel.forward_train(tparams, {"tokens": torch.as_tensor(tokens)})
    _close(got, want)
    assert float(aux) == 0.0
    jl = jmodel.loss_fn(jparams, {"tokens": jnp.asarray(tokens)})
    tl = tmodel.loss_fn(tparams, {"tokens": torch.as_tensor(tokens)})
    _close(tl, jl)


def test_loss_gradient_on_vocab_leaves_matches_reference(case):
    _, _, _, jmodel, tmodel, jparams, tparams, tokens = case
    jg = jax.jit(jax.grad(jmodel.loss_fn))(jparams, {"tokens": jnp.asarray(tokens)})
    leaves = {k: tparams[k].clone().requires_grad_(True) for k in ("embed", "lm_head")}
    loss = tmodel.loss_fn({**tparams, **leaves}, {"tokens": torch.as_tensor(tokens)})
    grads = torch.autograd.grad(loss, [leaves["embed"], leaves["lm_head"]])
    _close(grads[0], jg["embed"])
    _close(grads[1], jg["lm_head"])


def test_prefill_and_decode_steps_match_reference(case):
    """Prefill logits and cache, then STEPS greedy decode steps against the
    reference's, each from the reference's own previous token."""
    _, jcfg, tcfg, jmodel, tmodel, jparams, tparams, tokens = case
    jlog, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)})
    tlog, tcache = tmodel.prefill(tparams, {"tokens": torch.as_tensor(tokens)})
    _close(tlog, jlog)
    for a, b in zip(trees.leaves(tcache), jax.tree.leaves(jcache)):
        _close(a, b)
    total = S + STEPS
    jcache = jregistry.grow_cache(jmodel, jcache, B, total)
    tcache = tregistry.grow_cache(tmodel, tcache, B, total)
    for a, b in zip(trees.leaves(tcache), jax.tree.leaves(jcache)):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b)
    tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    for t in range(STEPS):
        jlog, jcache = jmodel.decode(jparams, jnp.asarray(tok), jcache, jnp.int32(S + t))
        tlog, tcache = tmodel.decode(tparams, torch.as_tensor(tok), tcache, S + t)
        _close(tlog, jlog)
        tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    for a, b in zip(trees.leaves(tcache), jax.tree.leaves(jcache)):
        _close(a, b)


def test_gqa_decode_per_row_position_equals_scalar_calls(case):
    """One decode with a position per row equals each row decoded alone
    at its scalar position: the same cache entry written (every other
    entry unchanged), the written k/v and the output within 1e-5 relative
    (a batch of 4 and a batch of 1 round the projections' sums in another
    order; the random cache makes outputs in the hundreds). The window case's positions wrap past the 16-entry
    cache."""
    _, _, tcfg, _, _, _, tparams, _ = case
    p = trees.tree_map(lambda x: x[0], tparams["layers"])["attn"]
    S_max = 16 if tcfg.sliding_window else 24
    g = torch.Generator().manual_seed(3)
    shape = (4, S_max, tcfg.n_kv_heads, tcfg.resolved_head_dim)
    cache = {"k": torch.randn(shape, generator=g), "v": torch.randn(shape, generator=g)}
    x = torch.randn((4, 1, tcfg.d_model), generator=g)
    pos = torch.tensor([0, 5, 15, 21 if tcfg.sliding_window else 23], dtype=torch.int32)
    before = trees.tree_map(torch.clone, cache)
    out, new = tattn.gqa_decode(p, x, cache, pos, tcfg)
    assert all(torch.equal(cache[k], before[k]) for k in cache)
    for b in range(4):
        row = {k: v[b:b + 1] for k, v in cache.items()}
        o, c = tattn.gqa_decode(p, x[b:b + 1], row, int(pos[b]), tcfg)
        _close(out[b:b + 1], o, rtol=1e-5)
        for k in c:
            changed = (new[k][b] != before[k][b]).any(-1).any(-1)
            assert torch.equal(changed, (c[k][0] != before[k][b]).any(-1).any(-1))
            assert int(changed.sum()) == 1
            _close(new[k][b:b + 1], c[k], rtol=1e-5)


def test_rope_and_swiglu_match_reference():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 7)).astype(np.int32)
    for theta in (10000.0, 1000000.0):
        _close(tlayers.rope_freqs(16, theta), jlayers.rope_freqs(16, theta), atol=1e-7)
        _close(tlayers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta),
               jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    p = {k: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("w_gate", (16, 40)), ("w_up", (16, 40)), ("w_down", (40, 16)))}
    h = rng.normal(size=(3, 16)).astype(np.float32)
    _close(tlayers.swiglu(convert.to_torch(p), torch.as_tensor(h)),
           jlayers.swiglu({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(h)))


@pytest.mark.parametrize("sq", [40, 2100])
def test_chunked_causal_attention_matches_reference(monkeypatch, sq):
    """Above ``_CHUNK`` query rows both attend chunk by chunk (the
    reference needs whole chunks, so the chunk is 700 rows here and 2100
    is three of them); the window mask within and across chunks."""
    monkeypatch.setattr(jattn, "_CHUNK", 700)
    monkeypatch.setattr(tattn, "_CHUNK", 700)
    _, tcfg = _cfgs("qwen2_window")
    rng = np.random.default_rng(sq)
    q = rng.normal(size=(1, sq, 6, 8)).astype(np.float32)
    k = rng.normal(size=(1, sq, 2, 8)).astype(np.float32)
    v = rng.normal(size=(1, sq, 2, 8)).astype(np.float32)
    for cfg in (tcfg, tcfg.with_(sliding_window=None)):
        got = tattn.causal_attention(*map(torch.as_tensor, (q, k, v)), cfg)
        want = jattn.causal_attention(*map(jnp.asarray, (q, k, v)), cfg)
        _close(got, want)


def test_cache_specs_match_make_cache_and_reference():
    for name in ("qwen2", "qwen2_window"):
        jcfg, tcfg = _cfgs(name)
        jm, tm = jregistry.build(jcfg), tregistry.build(tcfg)
        specs = tregistry.serve_cache_specs(tm, 3, 4, 40)
        want = jregistry.serve_cache_specs(jm, 3, 4, 40)
        assert [s.shape for s in trees.leaves(specs)] == \
            [tuple(w.shape) for w in jax.tree.leaves(want)]
        d = tregistry.decode_specs(tm, InputShape("d", 40, 4, "decode"))
        jd = jregistry.decode_specs(jm, JInputShape("d", 40, 4, "decode"))
        assert d["token"].shape == tuple(jd["token"].shape) and d["pos"].shape == ()
        assert [s.shape for s in trees.leaves(d["cache"])] == \
            [tuple(w.shape) for w in jax.tree.leaves(jd["cache"])]



# ===================================================== the MoE stack and MLA
@pytest.fixture(scope="module", params=sorted(MOE_CASES))
def moe_case(request):
    """phi3.5 at capacity factor 0.5 (its forward and prefill drop
    assignments), deepseek (plain and with the window); deepseek at 0.5
    runs in the per-row decode test, phi3.5 at its own factor in
    ``tests/test_torch_serve.py``."""
    jcfg, tcfg = _cfgs(request.param)
    jmodel, tmodel = _jitted(jregistry.build(jcfg)), tregistry.build(tcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return request.param, jcfg, tcfg, jmodel, tmodel, jparams, convert.to_torch(jparams), tokens


def test_moe_configs_build_and_init_the_reference_layout(moe_case):
    name, jcfg, tcfg, _, tmodel, jparams, _, _ = moe_case
    got = tmodel.init(torch.Generator().manual_seed(0))
    assert tcfg.arch_type == jcfg.arch_type == "moe"
    assert sorted(got) == sorted(jparams)
    assert ("layers" in got) == name.startswith("deepseek")     # deepseek's dense layer 0
    want = [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(jparams)]
    assert [(tuple(x.shape), str(x.dtype).split(".")[-1]) for x in trees.leaves(got)] == want


def test_moe_forward_aux_loss_and_vocab_gradient_match_reference(moe_case):
    _, _, _, jmodel, tmodel, jparams, tparams, tokens = moe_case
    batch = {"tokens": jnp.asarray(tokens)}
    want, waux = jmodel.forward_train(jparams, batch)
    got, aux = tmodel.forward_train(tparams, {"tokens": torch.as_tensor(tokens)})
    _close(got, want)
    _close(aux, waux)
    assert float(aux) > 0.0
    jl, jg = jax.jit(jax.value_and_grad(jmodel.loss_fn))(jparams, batch)
    leaves = {k: tparams[k].clone().requires_grad_(True) for k in ("embed", "lm_head")}
    loss = tmodel.loss_fn({**tparams, **leaves}, {"tokens": torch.as_tensor(tokens)})
    _close(loss.detach(), jl)
    grads = torch.autograd.grad(loss, [leaves["embed"], leaves["lm_head"]])
    _close(grads[0], jg["embed"])
    _close(grads[1], jg["lm_head"])


def test_moe_prefill_and_scalar_decode_match_reference(moe_case):
    """Prefill logits and caches (MLA's latent and roped key; the last 8
    positions under the window), then STEPS decode steps at one scalar
    position, which route all B rows as one group, as the reference's
    ``decode_step`` does."""
    _, jcfg, _, jmodel, tmodel, jparams, tparams, tokens = moe_case
    jlog, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)})
    tlog, tcache = tmodel.prefill(tparams, {"tokens": torch.as_tensor(tokens)})
    _close(tlog, jlog)
    assert sorted(tcache) == sorted(jcache)
    for a, b in zip(trees.leaves(tcache), jax.tree.leaves(jcache)):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b)
    total = S + STEPS
    jcache = jregistry.grow_cache(jmodel, jcache, B, total)
    tcache = tregistry.grow_cache(tmodel, tcache, B, total)
    tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    for t in range(STEPS):
        jlog, jcache = jmodel.decode(jparams, jnp.asarray(tok), jcache, jnp.int32(S + t))
        tlog, tcache = tmodel.decode(tparams, torch.as_tensor(tok), tcache, S + t)
        _close(tlog, jlog)
        tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    for a, b in zip(trees.leaves(tcache), jax.tree.leaves(jcache)):
        _close(a, b)


@pytest.mark.parametrize("name,arch", [("phi35_cf05", "phi3.5-moe-42b-a6.6b"),
                                       ("deepseek_cf05", "deepseek-v2-236b")])
def test_per_row_decode_equals_vmapped_reference_batch1_decode(name, arch):
    """A decode with one position per row against the reference's serving
    form, ``jax.vmap`` of a batch-1 decode over the rows (each row its own
    MoE group), at capacity factor 0.5: grouping the rows together would
    drop assignments there (asserted) and give other logits. Three rows
    at positions 12, 7 and 10 over a 16-entry cache, three steps."""
    kw = {"dtype": "float32", "capacity_factor": 0.5}
    jcfg = jconfigs.get_config(arch, smoke=True, **kw)
    tcfg = tconfigs.get_config(arch, smoke=True, **kw)
    jmodel, tmodel = jregistry.build(jcfg), tregistry.build(tcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    tparams = convert.to_torch(jparams)
    rows = 3
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab_size, (rows, S)).astype(np.int32)
    _, jcache = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(tokens)})
    jcache = jregistry.grow_cache(jmodel, jcache, rows, 16)
    tcache = convert.to_torch(jax.tree.map(np.asarray, jcache))

    def one(tok, cache, pos):
        cache = jax.tree.map(lambda x: x[:, None], cache)
        logits, new = jmodel.decode(jparams, tok[None], cache, pos)
        return logits[0], jax.tree.map(lambda x: x[:, 0], new)

    jstep = jax.jit(jax.vmap(one, in_axes=(0, 1, 0), out_axes=(0, 1)))
    pos = np.array([12, 7, 10], np.int32)
    tok = tokens[:, -1].copy()
    h = torch.randn((1, rows, tcfg.d_model), generator=torch.Generator().manual_seed(0))
    lay = trees.tree_map(lambda x: x[0], tparams["moe_layers"])["mlp"]
    assert moe.dropped(lay, h, tcfg) > 0 and moe.dropped(lay, h, tcfg, 1) == 0
    for _ in range(3):
        jlog, jcache = jstep(jnp.asarray(tok), jcache, jnp.asarray(pos))
        tlog, tcache = tmodel.decode(tparams, torch.as_tensor(tok), tcache,
                                     torch.as_tensor(pos))
        _close(tlog, jlog)
        tok, pos = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32), pos + 1
    for a, b in zip(trees.leaves(tcache), jax.tree.leaves(jcache)):
        _close(a, b)


def test_mla_decode_per_row_position_equals_scalar_calls():
    """MLA's absorbed decode with a position per row equals each row
    decoded alone at its scalar position, with and without the window
    (positions past the 8-entry ring wrap)."""
    for name in ("deepseek", "deepseek_window"):
        _, tcfg = _cfgs(name)
        g = torch.Generator().manual_seed(3)
        p = tattn.mla_init(g, tcfg)
        S_max = 8 if tcfg.sliding_window else 24
        cache = {"c_kv": torch.randn((4, S_max, tcfg.kv_lora_rank), generator=g),
                 "k_rope": torch.randn((4, S_max, tcfg.qk_rope_dim), generator=g)}
        x = torch.randn((4, 1, tcfg.d_model), generator=g)
        pos = torch.tensor([0, 5, 7, 19 if tcfg.sliding_window else 23], dtype=torch.int32)
        out, new = tattn.mla_decode(p, x, cache, pos, tcfg)
        for b in range(4):
            row = {k: v[b:b + 1] for k, v in cache.items()}
            o, c = tattn.mla_decode(p, x[b:b + 1], row, int(pos[b]), tcfg)
            _close(out[b:b + 1], o, rtol=1e-5)
            for k in c:
                _close(new[k][b:b + 1], c[k], rtol=1e-5)
                assert int((new[k][b] != cache[k][b]).any(-1).sum()) == 1


def test_moe_cache_specs_match_make_cache_and_reference():
    for name in ("phi35_cf05", "deepseek", "deepseek_window"):
        jcfg, tcfg = _cfgs(name)
        jm, tm = jregistry.build(jcfg), tregistry.build(tcfg)
        specs = tregistry.serve_cache_specs(tm, 3, 4, 40)
        want = jregistry.serve_cache_specs(jm, 3, 4, 40)
        assert [s.shape for s in trees.leaves(specs)] == \
            [tuple(w.shape) for w in jax.tree.leaves(want)]
        d = tregistry.decode_specs(tm, InputShape("d", 40, 4, "decode"))
        jd = jregistry.decode_specs(jm, JInputShape("d", 40, 4, "decode"))
        assert [s.shape for s in trees.leaves(d["cache"])] == \
            [tuple(w.shape) for w in jax.tree.leaves(jd["cache"])]
