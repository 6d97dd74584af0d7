"""The port's serving engine over a client-axis mesh
(``ServeEngine(mesh=make_client_mesh())``) in ``gloo`` worlds of 1, 2 and
4 ranks on the CPU with K = 4 cluster groups, and of 2 ranks with K = 3,
which do not divide, so nothing is split (the reference's relaxation).

The serving state is the JAX package's (qwen2 smoke in fp32: ω₀, K
joined clients of K domains, a model per cluster root), built here and
carried across by ``convert``, with the Ψ sketch's draws fed to both
packages, so both route on the same Ψ. Each world runs
``tests/_torch_serve_worker.py``: every rank builds the port's state from
those pieces and serves a wave of 8 requests (staggered ``gen``, ``gen =
1`` included, two slots a group, so lanes are reused), an eviction
mid-run, then ``reset`` and the wave again. Meanwhile this process runs
the same waves through the JAX package's ``ServeEngine`` on a one-device
client mesh. The test holds:

- every rank's results, stats and routes equal every other rank's;
- rank 0 against the JAX engine: the routes' roots and acceptances and
  ``stats()`` exactly, similarities within 1e-5, tokens under the
  near-tie rule with the JAX stream as the reference (its gaps
  teacher-forced through the JAX model);
- tokens equal the engine without a mesh under the near-tie rule
  (``serve.near_tie_compare``, the gaps from ``SequentialLoop``), and
  ``stats()`` and the routes equal it exactly;
- each rank holds the ``row_split`` of the groups: K / ranks stacked
  models, cache lanes and output rows where that divides, all K
  otherwise; its bank, placed as ``build_server_state(mesh=...)`` places
  it, holds those groups' models alone, and ``cluster_model`` of another
  rank's group raises naming that rank;
- a state loaded with ``load_server_state(..., mesh=...)`` holds the same
  rows and serves the same routes and tokens;
- after ``reset`` the second wave repeats the first wave's tokens.
"""
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_serve_worker as worker  # noqa: E402
from _torch_world import HERE, start_worlds  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro import engine as jengine  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.launch.mesh import make_client_mesh as jax_client_mesh  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch import convert, engine, serve  # noqa: E402
from repro_torch.core import extractor as textractor  # noqa: E402
from repro_torch.models import registry as tregistry  # noqa: E402

WORKER = os.path.join(HERE, "_torch_serve_worker.py")
WORLDS = [(1, 4), (2, 4), (4, 4), (2, 3)]
IDS = [f"w{w}-k{k}" for w, k in WORLDS]
EPS = serve.NEAR_TIE_EPS["cpu"]
SIM_ATOL = 1e-5
P, G = worker.P, worker.G
# the four worlds' nine single-threaded ranks run at once, ~10 s alone; the
# cap leaves room for a loaded machine and still fails a hung world
WORLDS_TIMEOUT = 120.0


def _reference_state(k, root):
    """The JAX package's serving state for ``k`` groups; writes the pieces
    the workers build the port's from to ``ROOT/reference_{k}.pkl``: ω₀,
    the sketch's draws as the port's extractor asks for them (the
    reference's ``_jl_sketch`` draws), and the models by root."""
    cfg = worker.config()
    jmodel = jbuild(jconfigs.get_config("qwen2-1.5b", smoke=True).with_(dtype="float32"))
    key = jax.random.PRNGKey(0)
    init = jax.jit(jmodel.init)
    jst = jengine.init("stocfl", jmodel.loss_fn, init(key), [],
                       jengine.EngineConfig(**worker.ENGINE_CFG))
    draws = {}

    def jl_draws(n, dim, seed):
        kb, ks = jax.random.split(jax.random.PRNGKey(seed))
        draws[(n, dim, seed)] = (
            np.array(jax.random.randint(kb, (n,), 0, dim), np.int32),
            np.array(jax.random.rademacher(ks, (n,), dtype=jnp.float32)).astype(np.int8))
        return tuple(torch.as_tensor(x) for x in draws[(n, dim, seed)])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(textractor, "jl_draws", jl_draws)
        st = engine.init("stocfl", tregistry.build(cfg).loss_fn,
                         convert.to_torch(jst.ctx.init_params), [],
                         engine.EngineConfig(**worker.ENGINE_CFG), device="cpu")
        roots = []
        for i in range(k):
            hist = worker.joined(cfg, i)
            jst, jcid = jengine.join(jst, jax.tree.map(jnp.asarray, hist))
            st, cid = engine.join(st, hist)
            assert st.client_root(cid) == jst.client_root(jcid)
            roots.append(jst.client_root(jcid))
    assert len(set(roots)) == k, roots
    models = {r: init(jax.random.fold_in(key, i)) for i, r in enumerate(sorted(roots))}
    with open(os.path.join(root, f"reference_{k}.pkl"), "wb") as f:
        pickle.dump({"init": jax.tree.map(np.asarray, jst.ctx.init_params), "draws": draws,
                     "models": {int(r): jax.tree.map(np.asarray, m)
                                for r, m in models.items()}}, f)
    return jmodel, jst.replace(models=models)


def _reference_waves(jmodel, jstate, k):
    """``worker.waves`` through the JAX package's engine on a one-device
    client mesh, on the workers' requests."""
    eng = jserve.ServeEngine(jmodel, jstate, jserve.ServeConfig(
        slots=worker.SLOTS, max_len=P + G, max_gen=G), mesh=jax_client_mesh(1))

    def reqs_of(base):
        return [jserve.Request(rid=r.rid, client_id=r.client_id, prompt=r.prompt, gen=r.gen,
                               history=jax.tree.map(jnp.asarray, r.history))
                for r in worker.requests(worker.config(), k, base)]

    return worker.waves(eng, reqs_of)


def _jax_gaps(jmodel, params, prompt, tokens):
    """Top-2 logit gaps of the reference stream ``tokens``, teacher-forced
    through the reference model (prefill, then one decode a token)."""
    logits, cache = jmodel.prefill(params, {"tokens": jnp.asarray(prompt[None])})
    cache = jregistry.grow_cache(jmodel, cache, 1, len(prompt) + len(tokens))
    gaps = []
    for i in range(len(tokens)):
        if i:
            logits, cache = jmodel.decode(params, jnp.asarray(tokens[i - 1:i]), cache,
                                          jnp.int32(len(prompt) + i - 1))
        top = np.sort(np.asarray(logits[0], np.float32))[-2:]
        gaps.append(float(top[1] - top[0]))
    return np.asarray(gaps)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The worlds' ranks, and the JAX engine's waves run while they run."""
    root = str(tmp_path_factory.mktemp("serve"))
    states = {k: _reference_state(k, root) for k in sorted({k for _, k in WORLDS})}
    running = start_worlds(WORKER, root, WORLDS, timeout=WORLDS_TIMEOUT)
    try:
        ref = {k: (jmodel, jst, _reference_waves(jmodel, jst, k))
               for k, (jmodel, jst) in states.items()}
    except BaseException:
        running.kill()
        raise
    running.wait()
    out = {}
    for w, k in WORLDS:
        ranks = []
        for r in range(w):
            with open(os.path.join(root, f"serve_{w}_{k}_r{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        out[(w, k)] = ranks
    return out, ref


@pytest.fixture(scope="module")
def worlds(run):
    return run[0]


def _same(a, b):
    assert set(a) == set(b)
    for rid in a:
        (ca, sa, aa, ta, ea), (cb, sb, ab, tb, eb) = a[rid], b[rid]
        assert (ca, sa, aa, ea) == (cb, sb, ab, eb), rid
        assert np.array_equal(ta, tb), rid


def _near_tie(ref, got, gaps):
    assert set(ref) == set(got)
    for rid in ref:
        assert ref[rid][:3] == got[rid][:3], rid
        serve.near_tie_compare(ref[rid][3], got[rid][3], gaps[rid % 100], EPS)


@pytest.mark.parametrize("world,k", WORLDS, ids=IDS)
def test_every_rank_returns_the_same(worlds, world, k):
    ranks = [r["mesh"] for r in worlds[(world, k)]]
    assert len(ranks) == world
    for other in ranks[1:]:
        for wave in ("first", "evicted", "rest", "second"):
            _same(ranks[0][wave], other[wave])
        assert other["stats"] == ranks[0]["stats"] and other["routes"] == ranks[0]["routes"]


@pytest.mark.parametrize("world,k", WORLDS, ids=IDS)
def test_rank_zero_matches_the_jax_engine_on_a_mesh(run, world, k):
    r0 = run[0][(world, k)][0]["mesh"]
    jmodel, jstate, want = run[1][k]
    for (root, sim, acc), (wroot, wsim, wacc) in zip(r0["routes"], want["routes"], strict=True):
        assert (root, acc) == (wroot, wacc)
        assert sim == pytest.approx(wsim, abs=SIM_ATOL)
    for key in ("stats", "stats2"):
        assert r0[key] == want[key], key
    prompts = {r.rid: r.prompt for r in worker.requests(worker.config(), k)}
    for wave in ("first", "evicted", "rest", "second"):
        assert set(r0[wave]) == set(want[wave]), wave
        for rid, (wc, ws, wa, wt, we) in want[wave].items():
            c, sim, a, t, e = r0[wave][rid]
            assert (c, a, e) == (wc, wa, we), (wave, rid)
            assert sim == pytest.approx(ws, abs=SIM_ATOL), (wave, rid)
            if not np.array_equal(t, wt):
                gaps = _jax_gaps(jmodel, jstate.cluster_model(wc), prompts[rid % 100], wt)
                serve.near_tie_compare(wt, t, gaps, EPS)


@pytest.mark.parametrize("world,k", WORLDS, ids=IDS)
def test_tokens_match_the_engine_without_a_mesh(worlds, world, k):
    r0 = worlds[(world, k)][0]
    for wave in ("first", "evicted", "rest", "second"):
        _near_tie(r0["nomesh"][wave], r0["mesh"][wave], r0["gaps"])


@pytest.mark.parametrize("world,k", WORLDS, ids=IDS)
def test_stats_and_routes_equal_the_engine_without_a_mesh(worlds, world, k):
    r0 = worlds[(world, k)][0]
    assert r0["groups"] == k
    for key in ("stats", "stats2", "routes"):
        assert r0["mesh"][key] == r0["nomesh"][key], key
    assert len({root for root, _, _ in r0["mesh"]["routes"]}) == k


@pytest.mark.parametrize("world,k", WORLDS, ids=IDS)
def test_each_rank_holds_its_share_of_the_groups(worlds, world, k):
    share = k // world if k % world == 0 else k
    for r in worlds[(world, k)]:
        assert r["mesh"]["held"] == [share] * 3
    assert worlds[(world, k)][0]["nomesh"]["held"] == [k] * 3


@pytest.mark.parametrize("world,k", WORLDS, ids=IDS)
def test_each_rank_bank_holds_its_groups_only(worlds, world, k):
    """The placed bank (built and loaded): K / ranks rows where K divides
    the ranks, the rank's contiguous share of the sorted roots, and every
    other root raising ``RemoteRowError`` that names its rank; the whole
    bank on every rank otherwise."""
    split = k % world == 0
    share = k // world if split else k
    for r, res in enumerate(worlds[(world, k)]):
        for bank in (res["bank"], res["loaded"]["bank"]):
            roots = [root for root, _, _ in res["mesh"]["routes"]]
            order = sorted(set(roots))
            mine = order[r * share:(r + 1) * share] if split else order
            # a whole bank's rows are K and its spare rows up to a power of two
            assert bank["holds"] == mine, bank
            assert bank["rows"] == share if split else bank["rows"] >= k, bank
            assert sorted(bank["remote"]) == sorted(set(order) - set(mine))
            for root, msg in bank["remote"].items():
                assert msg is not None and f"rank {order.index(root) // share} " in msg, msg


@pytest.mark.parametrize("world,k", WORLDS, ids=IDS)
def test_loaded_state_serves_the_same_tokens(worlds, world, k):
    """``load_server_state(..., mesh=...)``'s state serves the first wave as
    the built state does: the same routes, and the same tokens bit for
    bit on every rank."""
    for res in worlds[(world, k)]:
        assert res["loaded"]["routes"] == res["mesh"]["routes"]
        _same(res["mesh"]["first"], res["loaded"]["first"])


@pytest.mark.parametrize("world,k", WORLDS, ids=IDS)
def test_reset_repeats_the_first_wave(worlds, world, k):
    for r in worlds[(world, k)]:
        first, second = r["mesh"]["first"], r["mesh"]["second"]
        assert sorted(second) == [200 + rid for rid in sorted(first)]
        for rid in first:
            assert np.array_equal(first[rid][3], second[200 + rid][3]), rid
        ev = r["mesh"]["evicted"][100]
        assert ev[4] and len(ev[3]) == 3 and np.array_equal(ev[3], first[0][3][:3])
