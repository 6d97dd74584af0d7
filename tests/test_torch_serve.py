"""The port's serving engine (``repro_torch.serve``) and its CLI, on the
CPU: the JAX package's battery (``tests/test_serve.py``) case for case for
its three families, qwen2-1.5b, falcon-mamba-7b and zamba2-1.2b, and the
port's engine against the JAX package's on the same requests, for those
three and for phi3.5-moe and deepseek-v2.

The contract — a request served through the fixed-slot continuous-batching
engine gets the tokens the sequential loop gives it (same route, same
greedy decode), through admission waves, slot reuse, staggered finishes,
``gen = 1`` and eviction; routing is computed once per client and cached;
the decode inner loop never reads the device from the host. Greedy
streams are compared under the near-tie rule (``serve.near_tie_compare``,
ε = ``NEAR_TIE_EPS["cpu"]`` = 1e-5): they may part only where the
reference stream's top-2 logit gap is below ε, and the comparison of that
request stops there. Smoke configs in fp32; falcon-mamba with
``use_pallas=True``, so its routing Ψ goes through the ``ssm_scan`` op
(kernel K5 on the card, its plain version here) as on the card. The
reference's parameters
and the JL sketch's draws cross over from the JAX package (``_setup``),
so both engines route on the same Ψ; similarities agree within 1e-5.
The MoE families also hold the contract where routing capacity drops
assignments (phi3.5-moe at capacity factor 0.5): the port prefills each
request of a group in MoE routing groups of its own
(``slots.request_grouped``), so its tokens equal the sequential loop's.
"""
import contextlib
import functools
import io
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import engine as jengine  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.data import synthetic_lm_batch  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import engine, serve  # noqa: E402
from repro_torch.core import extractor as textractor  # noqa: E402
from repro_torch.engine.bank import ClusterBank  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import registry as tregistry  # noqa: E402
from repro_torch.utils import trees  # noqa: E402

P, G, HIST_S, HIST_B = 8, 5, 128, 4
FAMILIES = ["qwen2_1_5b", "falcon_mamba_7b", "zamba2_1_2b"]
MOE = ["phi35_moe_42b", "deepseek_v2_236b"]
OPTIONS = {"qwen2_1_5b": {}, "falcon_mamba_7b": {"use_pallas": True}, "zamba2_1_2b": {},
           "phi35_moe_42b": {}, "deepseek_v2_236b": {},
           "phi35_moe_42b_cf05": {"capacity_factor": 0.5}}
EPS = serve.NEAR_TIE_EPS["cpu"]
SIM_ATOL = 1e-5


def _jax_draws(n, dim, seed):
    """The reference's ``_jl_sketch`` draws, as ``jl_draws`` returns them."""
    kb, ks = jax.random.split(jax.random.PRNGKey(seed))
    buckets = np.array(jax.random.randint(kb, (n,), 0, dim))
    signs = np.array(jax.random.rademacher(ks, (n,), dtype=jnp.float32))
    return (torch.as_tensor(buckets, dtype=torch.int32),
            torch.as_tensor(signs).to(torch.int8))


class _Family:
    """One family's world in both packages: the reference's ``_setup``
    (ω₀, two joined reference clients, a model per cluster) and the same
    state built by the port from the reference's parameters."""

    def __init__(self, arch, clusters=2):
        kw = {"dtype": "float32", **OPTIONS[arch]}
        arch = arch.removesuffix("_cf05")
        self.jcfg = jconfigs.get_config(arch, smoke=True).with_(**kw)
        self.cfg = tconfigs.get_config(arch, smoke=True).with_(**kw)
        self.jmodel, self.model = jbuild(self.jcfg), tregistry.build(self.cfg)
        key = jax.random.PRNGKey(0)
        init = jax.jit(self.jmodel.init)     # one program for the 3 draws, the same values
        jst = jengine.init("stocfl", self.jmodel.loss_fn, init(key), [],
                           jengine.EngineConfig(tau=0.3, seed=0, project_dim=4096))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(textractor, "jl_draws", _jax_draws)
            st = engine.init("stocfl", self.model.loss_fn,
                             convert.to_torch(jst.ctx.init_params), [],
                             engine.EngineConfig(tau=0.3, seed=0, project_dim=4096),
                             device="cpu")
            jcm, cm = {}, {}
            for k in range(clusters):
                ref = synthetic_lm_batch(self.jcfg, HIST_S, HIST_B, seed=100 + k, domain=k)
                jst, jcid = jengine.join(jst, jax.tree.map(jnp.asarray, ref))
                st, cid = engine.join(st, ref)
                assert st.client_root(cid) == jst.client_root(jcid)
                jcm[jst.client_root(jcid)] = init(jax.random.fold_in(key, k))
                cm[st.client_root(cid)] = convert.to_torch(jcm[jst.client_root(jcid)])
        self.jstate = jst.replace(models=jcm)
        self.state = st.replace(models=ClusterBank.from_dict(cm))

    def hist(self, i):
        return synthetic_lm_batch(self.cfg, HIST_S, HIST_B, seed=1000 + i, domain=i % 2)

    def req(self, i, gen=G, plen=P):
        prompt = np.asarray(synthetic_lm_batch(self.cfg, plen, 1, seed=i, domain=i % 2)
                            ["tokens"][0], np.int32)
        return serve.Request(rid=i, client_id=f"c{i}", prompt=prompt, gen=gen,
                             history=self.hist(i))

    def engine(self, slots):
        return serve.ServeEngine(self.model, self.state, serve.ServeConfig(
            slots=slots, max_len=P + G, max_gen=G))

    def loop(self):
        return serve.SequentialLoop(self.model, self.state, max_len=P + G, max_gen=G)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The smoke models are too small for intra-op threads, and under a
    parallel test run their pool's barriers wait on an oversubscribed
    CPU; one thread for this module."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    return _Family(arch)


@pytest.fixture(scope="module")
def qwen():
    return _setup("qwen2_1_5b")


def _agree(ref: serve.RequestResult, got: serve.RequestResult, ties: list):
    """Hold ``got``'s tokens to ``ref``'s (a SequentialLoop result with
    gaps) under the near-tie rule; a stop is recorded in ``ties``."""
    stop = serve.near_tie_compare(ref.tokens, got.tokens, ref.gaps, EPS)
    if stop is not None:
        ties.append((ref.rid, stop))


# ===================================================== routing
def test_route_matches_engine_infer(qwen):
    router = serve.Router(qwen.state)
    for i in range(3):
        h = qwen.hist(i)
        inf = engine.infer(qwen.state, h)
        rt = router.route(f"c{i}", h)
        want = inf["cluster"] if inf["cluster"] is not None else inf["seed_from"]
        assert rt.root == want
        assert rt.accepted == (inf["cluster"] is not None)
        assert rt.similarity == pytest.approx(inf["similarity"], abs=1e-5)


def test_infer_batch_matches_infer(qwen):
    hists = [qwen.hist(i) for i in range(4)]
    batched = engine.infer_batch(qwen.state, hists)
    for h, b in zip(hists, batched):
        one = engine.infer(qwen.state, h)
        assert b["cluster"] == one["cluster"]
        assert b["seed_from"] == one["seed_from"]
        assert b["similarity"] == pytest.approx(one["similarity"], abs=1e-4)


def test_router_cache_hits(qwen):
    router = serve.Router(qwen.state)
    first = router.route("c0", qwen.hist(0))
    assert (router.hits, router.misses) == (0, 1)
    again = router.route("c0")                    # reconnect: no history
    assert (router.hits, router.misses) == (1, 1)
    assert again == first
    with pytest.raises(ValueError, match="no cached route"):
        router.route("never-seen")


# ===================================================== token parity
@pytest.mark.parametrize("arch", FAMILIES)
def test_batched_matches_sequential(arch):
    """More requests than lanes → admission waves + slot reuse, and
    every request's tokens must equal the sequential loop's."""
    fam = _setup(arch)
    eng = fam.engine(slots=2)
    reqs = [fam.req(i) for i in range(6)]         # 6 reqs, 4 lanes total
    eng.submit_many(reqs)
    res = eng.run()
    assert sorted(res) == [r.rid for r in reqs]
    loop, ties = fam.loop(), []
    for r in reqs:
        sr = loop.serve(r)
        assert res[r.rid].cluster == sr.cluster
        _agree(sr, res[r.rid], ties)
    assert eng.stats()["harvested"] == 6
    assert ties == [], f"near-tie stops (rid, step): {ties}"


def test_staggered_gens_and_slot_reuse(qwen):
    """Heterogeneous gen budgets finish at different steps; freed lanes
    are re-admitted mid-flight and the late arrivals still match the
    sequential reference."""
    gens = [2, 5, 3, 4, 5, 1]
    eng = qwen.engine(slots=1)                    # 2 lanes total → reuse
    reqs = [serve.Request(rid=i, client_id=f"c{i}", prompt=qwen.req(i).prompt, gen=g,
                          history=qwen.hist(i)) for i, g in enumerate(gens)]
    eng.submit_many(reqs)
    res = eng.run()
    loop, ties = qwen.loop(), []
    for r in reqs:
        assert len(res[r.rid].tokens) == r.gen
        _agree(loop.serve(r), res[r.rid], ties)
    assert ties == [], ties


# ===================================================== eviction
def test_eviction_partial_output_and_lane_reuse(qwen):
    eng = qwen.engine(slots=1)
    reqs = [qwen.req(i) for i in range(3)]
    eng.submit_many(reqs)
    eng._admit_all()                               # 2 lanes busy, 1 queued
    eng._decode_burst(2)
    eng.sched.tick(2)
    ev = eng.evict(reqs[0].rid)
    assert ev.evicted and len(ev.tokens) == 3      # prefill tok + 2 steps
    loop, ties = qwen.loop(), []
    ref = loop.serve(reqs[0])
    _agree(serve.RequestResult(rid=0, cluster=ref.cluster, similarity=ref.similarity,
                               accepted=ref.accepted, tokens=ref.tokens[:3],
                               gaps=ref.gaps[:3]), ev, ties)   # partial = true prefix
    rest = eng.run()                               # freed lane serves rid 2
    _agree(loop.serve(reqs[2]), rest[reqs[2].rid], ties)
    assert ties == [], ties

    # evicting a queued request drops it with zero tokens
    eng.reset()
    eng.submit_many([qwen.req(10), qwen.req(11), qwen.req(12)])
    gone = eng.evict(12)
    assert gone.evicted and len(gone.tokens) == 0
    assert sorted(eng.run()) == [10, 11]
    assert eng.evict("unknown") is None


# ===================================================== data plane hygiene
@contextlib.contextmanager
def _no_host_reads():
    """Every way a tensor reaches the host (``item``, ``tolist``,
    ``numpy``, ``cpu``, truth and number conversion) raises inside the
    block: the CPU form of the card's sync-debug mode "error"."""
    names = ("item", "tolist", "numpy", "cpu", "__bool__", "__int__", "__float__",
             "__index__")

    def refuse(name):
        def fn(*_a, **_k):
            raise RuntimeError(f"host read Tensor.{name} in the decode burst")
        return fn

    with pytest.MonkeyPatch.context() as mp:
        for name in names:
            mp.setattr(torch.Tensor, name, refuse(name))
        yield


def test_decode_burst_is_transfer_free(qwen):
    """The serve inner loop reads nothing from the device: no host read
    anywhere in the decode data plane (on the card
    ``tests/test_torch_kernels_cuda.py`` runs the captured burst under
    ``torch.cuda.set_sync_debug_mode("error")``)."""
    eng = qwen.engine(slots=2)
    eng.submit_many([qwen.req(i) for i in range(4)])
    eng._admit_all()
    eng._decode_burst(1)
    with _no_host_reads():
        eng._decode_burst(3)
    with pytest.raises(RuntimeError, match="host read"), _no_host_reads():
        eng._harvest_lane(0, 0, eng.sched.running[(0, 0)].req, 4)
    assert eng.stats()["decode_steps"] == 4


def test_reset_keeps_buffers_and_routes(qwen):
    """``reset`` zeroes the lanes in place (the addresses a captured graph
    holds stay valid) and keeps the routing cache: the second wave at
    identical shapes routes from the cache and serves the same tokens."""
    eng = qwen.engine(slots=2)
    warm = [qwen.req(i) for i in range(4)]
    eng.submit_many(warm)
    first = eng.run()
    ptrs = [x.data_ptr() for x in trees.leaves(eng.sl.caches) + list(eng.sl[1:])]
    eng.reset()
    assert [x.data_ptr() for x in trees.leaves(eng.sl.caches) + list(eng.sl[1:])] == ptrs
    assert all(not x.any() for x in trees.leaves(eng.sl.caches) + list(eng.sl[1:]))
    misses = eng.router.misses
    again = [serve.Request(rid=100 + r.rid, client_id=r.client_id,
                           prompt=r.prompt, gen=r.gen) for r in warm]
    eng.submit_many(again)                         # routes from cache
    res = eng.run()
    assert sorted(res) == [100, 101, 102, 103]
    assert eng.router.misses == misses and eng.stats()["router_hits"] == 4
    for r in warm:
        assert list(res[100 + r.rid].tokens) == list(first[r.rid].tokens)


def test_gen_one_finishes_at_admission(qwen):
    eng = qwen.engine(slots=2)
    eng.submit_many([qwen.req(0, gen=1), qwen.req(1, gen=1)])
    res = eng.run()
    assert all(len(r.tokens) == 1 for r in res.values())
    assert eng.stats()["decode_steps"] == 0


def test_cluster_models_stack_as_bank_views_or_copies(qwen):
    """The engine's (K, ...) stack: views of the bank's rows when the bank
    holds the sorted roots first, else a stack of ``cluster_model`` (a
    plain dict of models, a bank in another row order); equal values and
    equal tokens either way."""
    from repro_torch.serve.engine import stack_cluster_models
    roots = sorted(qwen.state.models)
    views = stack_cluster_models(qwen.state, roots)
    assert views["embed"].data_ptr() == qwen.state.models.stacked["embed"].data_ptr()
    as_dict = qwen.state.replace(models={r: qwen.state.models[r] for r in roots})
    flipped = qwen.state.replace(models=ClusterBank(
        trees.tree_map(lambda x: x.flip(0), qwen.state.models.stacked), roots[::-1]))
    reqs = [qwen.req(i) for i in range(4)]
    want = None
    for st in (qwen.state, as_dict, flipped):
        if st is not qwen.state:
            stacked = stack_cluster_models(st, roots)
            assert stacked["embed"].data_ptr() != views["embed"].data_ptr()
            assert all(torch.equal(a, b) for a, b in zip(trees.leaves(stacked),
                                                         trees.leaves(views)))
        eng = serve.ServeEngine(qwen.model, st, serve.ServeConfig(slots=2, max_len=P + G,
                                                                  max_gen=G))
        eng.submit_many(reqs)
        got = {rid: list(r.tokens) for rid, r in eng.run().items()}
        assert want is None or got == want
        want = got


# ===================================================== guards & specs
def test_submit_validation(qwen):
    eng = qwen.engine(slots=1)
    with pytest.raises(ValueError, match="gen"):
        eng.submit(qwen.req(0, gen=G + 1))
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(qwen.req(0, plen=P + G))


def test_sliding_window_guard(qwen):
    """The battery takes zamba2's window; the port has qwen2's smoke
    config with one."""
    model = tregistry.build(qwen.cfg.with_(sliding_window=16))
    with pytest.raises(ValueError, match="sliding"):
        serve.ServeEngine(model, qwen.state, serve.ServeConfig(slots=1, max_len=17,
                                                               max_gen=G))
    serve.ServeEngine(model, qwen.state, serve.ServeConfig(slots=1, max_len=16, max_gen=G))


def test_sliding_window_guard_zamba2():
    """The reference battery's case: zamba2's own 64-token window."""
    fam = _setup("zamba2_1_2b")
    with pytest.raises(ValueError, match="sliding"):
        serve.ServeEngine(fam.model, fam.state, serve.ServeConfig(
            slots=1, max_len=fam.cfg.sliding_window + 1, max_gen=G))
    serve.ServeEngine(fam.model, fam.state, serve.ServeConfig(
        slots=1, max_len=fam.cfg.sliding_window, max_gen=G))


def test_non_token_arch_rejected(qwen):
    """whisper's encoder-decoder (not built by the port's registry yet)."""
    model = types.SimpleNamespace(cfg=tconfigs.get_config("whisper_medium", smoke=True))
    with pytest.raises(ValueError, match="token-LM"):
        serve.ServeEngine(model, qwen.state)


def test_mesh_is_not_ported(qwen):
    """Serving over a mesh is ported now (the name is kept from when it
    raised): on a gloo world of one, ``ServeEngine(mesh=...)`` holds every
    group and serves the tokens of the engine without a mesh. The
    multi-rank worlds are ``tests/test_torch_serve_mesh.py``'s."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_client_mesh
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        eng = serve.ServeEngine(qwen.model, qwen.state, serve.ServeConfig(
            slots=2, max_len=P + G, max_gen=G), mesh=make_client_mesh(device="cpu"))
        reqs = [qwen.req(i) for i in range(4)]
        eng.submit_many(reqs)
        got = eng.run()
    finally:
        dist.destroy_process_group()
    ref = qwen.engine(slots=2)
    ref.submit_many(reqs)
    want = ref.run()
    assert eng.split.sharded and (eng.split.lo, eng.split.hi) == (0, len(eng.roots))
    for r in reqs:
        assert np.array_equal(got[r.rid].tokens, want[r.rid].tokens), r.rid
    assert eng.stats() == ref.stats()


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_cache_specs_shapes(arch):
    """Every leaf gains a leading cluster axis over make_cache(slots,
    max_len); the slot axis stays the cache's own batch axis (axis 1);
    the shapes are the reference's."""
    cfg = tconfigs.get_config(arch, smoke=True)
    model = tregistry.build(cfg)
    K, Bs, S = 3, 4, 16
    specs = tregistry.serve_cache_specs(model, K, Bs, S)
    base = model.make_cache(Bs, S, device="meta")
    for spec, b in zip(trees.leaves(specs), trees.leaves(base)):
        assert spec.shape == (K,) + tuple(b.shape) and spec.dtype == b.dtype
        assert b.shape[1] == Bs
    want = jregistry.serve_cache_specs(jbuild(jconfigs.get_config(arch, smoke=True)), K, Bs, S)
    assert [s.shape for s in trees.leaves(specs)] == \
        [tuple(w.shape) for w in jax.tree.leaves(want)]
    sl = serve.alloc_slots(model, K, Bs, S, G)
    assert [tuple(x.shape) for x in trees.leaves(sl.caches)] == \
        [s.shape for s in trees.leaves(specs)]


# ===================================================== against the JAX engine
def _jax_gaps(fam, params, prompt, tokens):
    """Top-2 logit gaps of the reference stream ``tokens``, teacher-forced
    through the reference model (prefill, then one decode a token)."""
    logits, cache = fam.jmodel.prefill(params, {"tokens": jnp.asarray(prompt[None])})
    cache = jregistry.grow_cache(fam.jmodel, cache, 1, len(prompt) + len(tokens))
    gaps = []
    for i in range(len(tokens)):
        if i:
            logits, cache = fam.jmodel.decode(params, jnp.asarray(tokens[i - 1:i]), cache,
                                              jnp.int32(len(prompt) + i - 1))
        top = np.sort(np.asarray(logits[0], np.float32))[-2:]
        gaps.append(float(top[1] - top[0]))
    return np.asarray(gaps)


def _drive(eng, reqs, evict_rid):
    """Admission waves, a burst, an eviction of a running request, then
    the rest: the same calls on either package's engine."""
    eng.submit_many(reqs)
    eng._admit_all()
    eng._decode_burst(2)
    eng.sched.tick(2)
    out = {evict_rid: eng.evict(evict_rid)}
    out.update(eng.run())
    return out


@pytest.mark.parametrize("arch", FAMILIES + MOE)
def test_engine_matches_jax_engine(arch):
    """The port's ``ServeEngine`` and the JAX package's on the same state
    and requests (staggered gens with a ``gen = 1``, two lanes for six
    requests, an eviction): equal routes and acceptances, similarities
    within 1e-5, tokens equal under the near-tie rule with the JAX stream
    as the reference. The reference's gaps (teacher-forced through the
    JAX model) are checked once against the port's own on a stream both
    produce."""
    fam = _setup(arch)
    gens = [5, 2, 1, 4, 5, 3]
    reqs = [serve.Request(rid=i, client_id=f"c{i}", prompt=fam.req(i).prompt, gen=g,
                          history=fam.hist(i)) for i, g in enumerate(gens)]
    jreqs = [jserve.Request(rid=r.rid, client_id=r.client_id, prompt=r.prompt, gen=r.gen,
                            history=jax.tree.map(jnp.asarray, r.history)) for r in reqs]
    cfg = dict(slots=1, max_len=P + G, max_gen=G)
    got = _drive(serve.ServeEngine(fam.model, fam.state, serve.ServeConfig(**cfg)), reqs, 0)
    want = _drive(jserve.ServeEngine(fam.jmodel, fam.jstate, jserve.ServeConfig(**cfg)),
                  jreqs, 0)
    assert sorted(got) == sorted(want) == list(range(6))
    assert got[0].evicted and want[0].evicted and len(want[0].tokens) == 3
    ties = []
    for rid, w in want.items():
        g = got[rid]
        assert (g.cluster, g.accepted, g.evicted) == (w.cluster, w.accepted, w.evicted)
        assert g.similarity == pytest.approx(w.similarity, abs=SIM_ATOL)
        if list(g.tokens) != list(w.tokens):
            gaps = _jax_gaps(fam, fam.jstate.cluster_model(w.cluster), reqs[rid].prompt,
                             np.asarray(w.tokens))
            stop = serve.near_tie_compare(w.tokens, g.tokens, gaps, EPS)
            ties.append((rid, stop))
    assert all(stop is not None for _, stop in ties), ties
    seq = fam.loop().serve(reqs[1])
    if list(seq.tokens) == list(want[1].tokens):
        np.testing.assert_allclose(
            _jax_gaps(fam, fam.jstate.cluster_model(want[1].cluster), reqs[1].prompt,
                      np.asarray(want[1].tokens)), seq.gaps, rtol=0, atol=SIM_ATOL)


# ===================================================== MoE capacity drops
def test_moe_prefill_groups_keep_requests_apart_under_capacity_drops():
    """phi3.5-moe at capacity factor 0.5, where every routing group drops
    assignments: six requests of one prompt length on 2 x 2 lanes, so
    the scheduler admits them in multi-request prefill groups. Each
    prefill MoE call routes one request a group (asserted from the
    calls' group sizes), drops happen in a multi-request group
    (asserted), and the continuous tokens equal the sequential loop's,
    which prefills each request alone."""
    from repro_torch.models import moe
    fam = _setup("phi35_moe_42b_cf05")
    calls, real = [], moe.moe_ffn

    def recording(params, x, cfg, group_size=0):
        if x.shape[1] == P:             # a prefill (the decode runs under vmap)
            g = group_size or cfg.moe_group_size
            calls.append((tuple(x.shape), moe.group_tokens(x.shape[0] * x.shape[1], g),
                          moe.dropped(params, x, cfg, group_size)))
        return real(params, x, cfg, group_size)

    reqs = [fam.req(i) for i in range(6)]
    eng = fam.engine(slots=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "moe_ffn", recording)
        eng.submit_many(reqs)
        res = eng.run()
    assert any(shape[0] >= 2 and drops > 0 for shape, _, drops in calls), calls
    assert all(g == P for _, g, _ in calls), calls
    loop, ties = fam.loop(), []
    for r in reqs:
        sr = loop.serve(r)
        assert res[r.rid].cluster == sr.cluster
        _agree(sr, res[r.rid], ties)
    assert ties == [], ties


# ===================================================== the serve CLI
def test_smoke_flag_is_a_real_pair():
    ap = launch_serve.build_parser()
    assert ap.parse_args([]).smoke is True
    assert ap.parse_args(["--smoke"]).smoke is True
    assert ap.parse_args(["--full"]).smoke is False
    assert ap.parse_args([]).device == "cuda"
    with pytest.raises(SystemExit):
        ap.parse_args(["--smoke", "--full"])


def test_build_server_state_round_trips():
    cfg = tconfigs.get_config("qwen2_1_5b", smoke=True)
    model = tregistry.build(cfg)
    st = launch_serve.build_server_state(cfg, model, clusters=2, tau=0.3, seed=0, device="cpu")
    assert len(st.models) == 2 and st.ctx.device.type == "cpu"
    again = launch_serve.build_server_state(cfg, model, clusters=2, tau=0.3, seed=0, device="cpu")
    for r in st.models:
        assert all(torch.equal(a, b) for a, b in zip(trees.leaves(st.models[r]),
                                                     trees.leaves(again.models[r])))


def test_cli_prints_the_reference_json_line_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_serve.main(["--device", "cpu", "--requests", "2", "--gen", "4", "--prompt-len", "8"])
    lines = out.getvalue().splitlines()
    rec = json.loads(lines[-1])
    assert lines[0].startswith("req 0: cluster=")
    assert rec["mode"] == "continuous" and rec["requests"] == 2 and rec["tokens"] == 8
    assert set(rec) >= {"first_compile_s", "wall_s", "tok_per_s", "admitted",
                        "prefill_groups", "decode_steps", "harvested", "evicted",
                        "router_hits", "router_misses", "clusters", "slots"}


def test_cli_refuses_to_run_on_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--requests", "2", "--gen", "4"])
