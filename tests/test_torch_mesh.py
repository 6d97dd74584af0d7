"""The port's engine over a client-axis mesh: worlds of 1, 2 and 4 ranks
under ``gloo`` on the CPU, held to ``tests/test_mesh_engine.py``'s
contract.

- A mesh of one rank is bitwise equal to no mesh.
- At 2 and 4 ranks every piece of integer bookkeeping is exact (PRNG
  keys, the partition, Ψ reps, members, rounds, departures, history
  keys), and floats agree within rtol 2e-5 and atol 1e-6: the ranks' partial
  sums are all-reduced in another order than one process sums its rows.
- After every round every rank's state equals every other rank's.
- The federation has 16 clients sampled at rate 0.5: cohorts of 8 rows,
  which 2 and 4 ranks split (CFL trains all 16), so every world of more
  than one rank runs the split and the partial-sum ``all_reduce``. Churn
  starts from 15 clients, so that its cohorts (8 of 15, 16 and 15 live
  clients) split too; 10 clients (cohorts of 5) hold the fallback.
- The cases: all six strategies eager and through ``run_rounds``, churn
  boundaries, a churn cycle that doubles the arena and compacts it, a
  checkpoint saved at one world size and resumed at another (and with no
  mesh), a cohort that does not divide the ranks, a ragged arena, async
  rounds, async rounds whose buffer grows, loses a departed client's
  entry, flushes and resumes from a checkpoint with its rows on their
  owners, ``psum_segments`` against the dense sum and its fallback; and,
  for each strategy, the world of one against the JAX engine under
  ``repro.launch.mesh.make_client_mesh(1)`` within 1e-5.
- The arena's rows live on their owners: at 2 and 4 ranks each rank holds
  capacity / N rows, the ranks together hold every live row once, bit for
  bit the row of the arena without a mesh, before and after growth and
  compaction; StoCFL's Ψ runs on each rank for its slice's new clients
  only (eagerly) or its slice (in a span), and every rank observes the
  same Ψ rows.

Each world is a set of processes (``tests/_torch_mesh_worker.py``) that
join through a ``FileStore`` under the test's temporary directory, run
every case once and write their snapshots; a module-scoped fixture runs
the worlds one after another (a world resumes the checkpoint the
previous one saved) and every test reads their results. The owned
buffer's cases run in worlds of their own (``owned_worlds``). A world that
does not finish within its timeout fails the tests instead of hanging.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402

from repro import engine as jengine  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.launch.mesh import make_client_mesh as jax_client_mesh  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_mesh_worker.py")
SRC = os.path.join(os.path.dirname(HERE), "src")
WORLDS = (1, 2, 4)
# seconds a world may take before it fails: a world takes 5-7 s on an
# idle 8-core host and up to 34 s beside 24 busy processes
WORLD_TIMEOUT = 120.0
RTOL, ATOL = 2e-5, 1e-6
REF_ATOL = 1e-5
ALL = ("stocfl", "fedavg", "fedprox", "ditto", "ifca", "cfl")
J_TASK = dataclasses.replace(jsimple.SYNTH_MLP, hidden=32)


def _fed(n_clients=16, seed=3):
    clients, _, _ = jsynthetic.rotated(n_clusters=2, n_clients=n_clients, n_per=32,
                                       seed=seed)
    return [{k: np.asarray(v) for k, v in c.items()} for c in clients]


def _jcfg(name):
    kw = dict(lr=0.1, local_steps=2, sample_rate=0.5, seed=0, rng_backend="device")
    if name == "stocfl":
        kw.update(tau=0.3)
    if name == "ifca":
        kw.update(n_models=3)
    if name == "cfl":
        kw.update(sample_rate=1.0, eps_rel=0.9, eps2=1e-4)
    return jengine.EngineConfig(**kw)


def _numpy(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _inputs():
    params = jsimple.init(jax.random.PRNGKey(0), J_TASK)
    clients = _fed()
    ragged = [dict(c) for c in clients]
    ragged[1] = {k: v[:17] for k, v in ragged[1].items()}
    ragged[5] = {k: v[:9] for k, v in ragged[5].items()}
    loss = lambda p, b: jsimple.loss_fn(p, b, J_TASK)
    ifca = jengine.init("ifca", loss, params, clients, _jcfg("ifca"))
    rng = np.random.default_rng(0)
    return {"params": _numpy(params), "clients": clients, "ragged": ragged,
            "churn": clients[:15], "ten": _fed(n_clients=10),
            "extra": _fed(n_clients=14, seed=9)[12],
            "extras": _fed(n_clients=14, seed=9)[9:12],
            "ifca": {int(m): _numpy(ifca.models[m]) for m in ifca.models.roots},
            "psum": {"stacked": {"w": rng.normal(size=(16, 5, 3)).astype(np.float32),
                                 "b": rng.normal(size=(16, 7)).astype(np.float32)},
                     "weights": rng.uniform(1, 4, size=16).astype(np.float32),
                     "seg": rng.integers(0, 4, size=16)}}


def _run_world(root, world, mode="main"):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(world), root, mode],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    deadline = time.monotonic() + WORLD_TIMEOUT
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            logs.append(out.decode(errors="replace")[-4000:])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"the {mode} world of {world} did not finish within {WORLD_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"world {world} rank {r} failed:\n{logs[r]}"
    out = []
    for r in range(world):
        with open(os.path.join(root, f"{mode}_w{world}_r{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, inputs):
    root = str(tmp_path_factory.mktemp("mesh"))
    with open(os.path.join(root, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    return {w: _run_world(root, w) for w in WORLDS}


@pytest.fixture(scope="module")
def owned_worlds(tmp_path_factory, inputs):
    """The worlds of the buffer with its rows on their owners, apart from
    ``worlds`` so that each world keeps its own timeout."""
    root = str(tmp_path_factory.mktemp("owned"))
    with open(os.path.join(root, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    return {w: _run_world(root, w, "owned") for w in WORLDS}


# ------------------------------------------------------------ comparison
def _trees_match(a, b, exact):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.shape == y.shape and x.dtype == y.dtype, k
        if exact or not np.issubdtype(x.dtype, np.floating):
            assert np.array_equal(x, y), k
        else:
            np.testing.assert_allclose(y, x, rtol=RTOL, atol=ATOL, err_msg=k)


def _match(ref, got, exact):
    """``got`` held to ``ref``: bitwise when ``exact``, otherwise integer
    bookkeeping exact and floats within the reduction-order tolerance."""
    for key in ("round", "left", "members", "assignment", "seen"):
        assert ref.get(key) == got.get(key), key
    assert len(ref["history"]) == len(got["history"])
    for hr, hg in zip(ref["history"], got["history"]):
        assert set(hr) == set(hg)
        for k in hr:
            if isinstance(hr[k], float) and not exact:
                assert np.isclose(hg[k], hr[k], rtol=RTOL, atol=ATOL), k
            else:
                assert hr[k] == hg[k], k
    if ref["rng_key"] is not None or got["rng_key"] is not None:
        assert np.array_equal(ref["rng_key"], got["rng_key"]), "PRNG key diverged"
    _trees_match(ref["omega"], got["omega"], exact)
    assert set(ref["models"]) == set(got["models"]), "bank keys diverged"
    for r in ref["models"]:
        _trees_match(ref["models"][r], got["models"][r], exact)
    assert set(ref["personal"]) == set(got["personal"])
    for c in ref["personal"]:
        _trees_match(ref["personal"][c], got["personal"][c], exact)
    if "reps" in ref:                   # Ψ reps are per client: exact everywhere
        assert set(ref["reps"]) == set(got["reps"])
        for c in ref["reps"]:
            assert np.array_equal(ref["reps"][c], got["reps"][c]), f"Ψ rep {c}"


def _hold(worlds, case, world, exact=None):
    """Every rank's snapshots of ``case`` at ``world`` against the world of
    one's run without a mesh; every rank against rank 0 bitwise."""
    ref = worlds[1][0][f"{case}/nomesh"]
    ranks = [w[f"{case}/mesh"] for w in worlds[world]]
    assert len(ranks[0]) == len(ref)
    for want, got in zip(ref, ranks[0]):
        _match(want, got, exact=(world == 1) if exact is None else exact)
    for other in ranks[1:]:
        for a, b in zip(ranks[0], other):
            _match(a, b, exact=True)


GRID = [(n, w) for n in ALL for w in WORLDS]
IDS = [f"{n}-w{w}" for n, w in GRID]


@pytest.mark.parametrize("name,world", GRID, ids=IDS)
def test_eager_rounds_match_no_mesh(worlds, name, world):
    _hold(worlds, f"eager/{name}", world)


@pytest.mark.parametrize("name,world", GRID, ids=IDS)
def test_run_rounds_match_no_mesh(worlds, name, world):
    _hold(worlds, f"scan/{name}", world)


@pytest.mark.parametrize("name,world", [(n, w) for n in ("stocfl", "fedavg", "ditto")
                                        for w in WORLDS])
def test_churn_boundaries(worlds, name, world):
    """Join and leave between spans: the arena append and tombstone and
    the new round programs keep the contract."""
    _hold(worlds, f"churn/{name}", world)


@pytest.mark.parametrize("name,world", [(n, w) for n in ("stocfl", "ditto", "cfl")
                                        for w in WORLDS])
def test_checkpoint_resumes_across_world_sizes(worlds, name, world):
    """Saved after 2 rounds at the previous world size (1 -> 1, 1 -> 2,
    2 -> 4), resumed for 3: the uninterrupted 5 rounds without a mesh;
    and the world of one's checkpoint resumed with no mesh, bitwise."""
    ref = worlds[1][0][f"scan/{name}/nomesh"][-1]
    for rank in worlds[world]:
        _match(ref, rank[f"ckpt/{name}/mesh"][0], exact=(world == 1))
    if world == 1:
        _match(ref, worlds[1][0][f"ckpt/{name}/nomesh"][0], exact=True)


@pytest.mark.parametrize("name,world", [(n, w) for n in ("fedavg", "stocfl")
                                        for w in WORLDS])
def test_cohort_that_does_not_divide(worlds, name, world):
    """10 clients at rate 0.5: a cohort of 5, which 2 and 4 ranks do not
    divide, so every rank runs the whole cohort with no collective: the
    run without a mesh, bitwise, at every world size."""
    _hold(worlds, f"nondiv/{name}", world, exact=True)


@pytest.mark.parametrize("name,world", [(n, w) for n in ALL for w in (2, 4)])
def test_cohorts_split_over_the_ranks(worlds, name, world):
    """At 2 and 4 ranks every strategy's eager rounds and spans split their
    cohorts (8 rows; CFL's 16) and sum partials with ``all_reduce`` on
    every rank; FedAvg's cohort of 5, which does not divide, makes none.
    (Every gather from the arena, whose rows live on their owners, is one
    ``all_reduce`` a leaf: the worker counts those apart, as row moves.)"""
    for rank in worlds[world]:
        assert rank[f"eager/{name}/mesh/collectives"] > 0
        assert rank[f"scan/{name}/mesh/collectives"] > 0
        assert rank["nondiv/fedavg/mesh/collectives"] == 0
        assert rank[f"eager/{name}/mesh/row_moves"] > 0
        assert rank["nondiv/fedavg/mesh/row_moves"] > 0


@pytest.mark.parametrize("name,world", [(n, w) for n in ("stocfl", "fedavg")
                                        for w in WORLDS])
def test_churn_cycle_grows_and_compacts(worlds, name, world):
    """3 joins past the arena's capacity (it doubles) and 10 leaves past
    ``compact_frac`` (it compacts, and its live rows change owners), with
    spans between: the run without a mesh."""
    _hold(worlds, f"cycle/{name}", world)
    after = worlds[world][0][f"cycle/{name}/mesh/layout"][1]
    assert after["n_rows"] == 8 and after["capacity"] == 8, after


def _held_once(ranks, ref):
    """The ranks' arena layouts against ``ref``, the arena without a mesh:
    each rank holds capacity / N rows, every row it holds is its own
    (global row mod N), and together they hold every live row once, bit
    for bit the reference's."""
    world = len(ranks)
    held = {}
    for r, lay in enumerate(ranks):
        assert lay["live"] == ref["live"]
        assert lay["capacity"] % world == 0
        assert lay["held"] == lay["mask_rows"] == lay["capacity"] // world
        for cid, (row, data) in lay["rows"].items():
            assert row % world == r and cid not in held, (r, cid, row)
            held[cid] = data
    assert sorted(held) == ref["live"]
    for cid, (_row, want) in ref["rows"].items():
        for k in want:
            assert np.array_equal(held[cid][k], want[k]), (cid, k)


@pytest.mark.parametrize("world", WORLDS)
def test_arena_rows_live_on_their_owners(worlds, world):
    """At init (16 clients) and through the churn cycle (18 rows in 32
    after the joins, 8 after compaction): each rank's rows are its stride
    of the capacity, capacity / N of them, and the ranks hold every live
    row once."""
    ref = worlds[1][0]
    _held_once([w["layout/mesh"] for w in worlds[world]], ref["layout/nomesh"])
    for name in ("stocfl", "fedavg"):
        for turn in (0, 1):
            _held_once([w[f"cycle/{name}/mesh/layout"][turn] for w in worlds[world]],
                       ref[f"cycle/{name}/nomesh/layout"][turn])
    if world > 1:
        assert worlds[world][0]["layout/mesh"]["held"] == 16 // world


@pytest.mark.parametrize("world", WORLDS)
def test_psi_runs_on_the_rank_of_the_slice(worlds, world):
    """StoCFL's Ψ calls on each rank: eagerly, the new clients of its slice
    of each cohort (the world's ranks together: the run without a mesh's);
    in a span, its slice of every cohort (8 / N of the 8 rows a round)."""
    ranks = [w["psi"] for w in worlds[world]]
    for psi in ranks:
        calls, want = psi["eager/True"]
        assert calls == want, psi
        calls, want = psi["scan/True"]
        assert calls == want == 5 * 8 // world, psi
    nomesh = worlds[1][0]["psi"]["eager/False"][0]
    assert sum(p["eager/True"][0] for p in ranks) == nomesh


@pytest.mark.parametrize("case", ["eager/stocfl", "scan/stocfl", "churn/stocfl",
                                  "cycle/stocfl"])
@pytest.mark.parametrize("world", (2, 4))
def test_every_rank_observes_the_same_reps(worlds, case, world):
    """The Ψ rows each rank observed, from whichever rank took them, are the
    same bits on every rank and the rows of the run without a mesh."""
    ref = worlds[1][0][f"{case}/nomesh"]
    for snaps in (w[f"{case}/mesh"] for w in worlds[world]):
        for want, got in zip(ref, snaps, strict=True):
            assert set(want["reps"]) == set(got["reps"])
            for c in want["reps"]:
                assert np.array_equal(want["reps"][c], got["reps"][c]), (case, c)


@pytest.mark.parametrize("world", WORLDS)
def test_ragged_arena(worlds, world):
    _hold(worlds, "ragged", world)


@pytest.mark.parametrize("name,world", [(n, w) for n in ("stocfl", "fedavg")
                                        for w in WORLDS])
def test_async_rounds(worlds, name, world):
    """Buffered rounds with late reports: the buffer's rows on their
    owners, every rank merging its slice of each flush."""
    _hold(worlds, f"async/{name}", world)


def _owned(worlds, name, world, tag="mesh"):
    return [w[f"owned/{name}/{tag}"] for w in worlds[world]]


@pytest.mark.parametrize("name,world", [(n, w) for n in ("stocfl", "fedavg")
                                        for w in WORLDS])
def test_async_buffer_rows_live_on_their_owners(owned_worlds, name, world):
    """A buffer of 8 rows that round 1 doubles, a departure with its row in
    flight, flushes every 2nd round: each rank holds capacity / N rows of
    each bank, slot s on rank s mod N (its rows are the whole buffer's
    rows s ≡ rank), and its bytes are 1/N of the run without a mesh. The
    buffer moves rows bit for bit: gathered whole, it holds at each slot
    the row the cohort trained for it, as every rank's slice gives it
    (and each handshake's Ψ row), in every round. Against the run without
    a mesh the entries and every integer of the state are exact, and
    floats bitwise on a mesh of one rank, within the reduction-order
    tolerance on more (a slice's rows train in a batch of another size,
    and a flush sums partial sums in another order)."""
    worlds = owned_worlds
    (ref, _), ranks = worlds[1][0][f"owned/{name}/nomesh"], _owned(worlds, name, world)
    ranks = [r[0] for r in ranks]
    for t, (want_state, want) in enumerate(ref):
        assert want["held"] == want["capacity"]
        for rank, rounds in enumerate(ranks):
            state, got = rounds[t]
            _match(want_state, state, exact=world == 1)
            assert got["capacity"] == want["capacity"] and got["entries"] == want["entries"]
            assert got["held"] * world == want["capacity"], (t, got["held"])
            assert got["nbytes"] * world == want["nbytes"], (t, got["nbytes"])
            assert got["writes"], t
            for slots, rows in got["writes"]:
                for c, leaves in rows.items():
                    for k, x in leaves.items():
                        whole = got["whole"][c][k or next(iter(got["whole"][c]))]
                        assert np.array_equal(whole[slots], x), (t, c, k)
            for c, leaves in want["whole"].items():
                for k, x in leaves.items():
                    y = got["whole"][c][k]
                    assert np.array_equal(got["mine"][c][k], y[rank::world]), (t, c, k)
                    if world == 1:
                        assert np.array_equal(x, y), (t, c, k)
                    else:
                        np.testing.assert_allclose(y, x, rtol=RTOL, atol=ATOL)
    caps = [got["capacity"] for _, got in ref]
    assert caps[0] == 8 and caps[1] == 16, caps
    assert ref[1][0]["history"][1]["dropped_left"] == 1


@pytest.mark.parametrize("name,world", [(n, w) for n in ("stocfl", "fedavg")
                                        for w in WORLDS])
def test_async_buffer_checkpoint_across_owners(owned_worlds, name, world):
    """The checkpoint saved with the buffer's rows on their owners: each
    member of its ``async_buffer.npz`` is byte for byte the member a writer
    without a mesh writes for the same state (the zip's timestamps aside):
    the buffer gathered whole, saved with no mesh; on a mesh of one rank
    the run without a mesh's own file. The run resumed from it on the same
    mesh is the uninterrupted run bit for bit."""
    worlds = owned_worlds
    for res in worlds[world]:
        got = res[f"owned/{name}/mesh/file"]
        for want in (res[f"owned/{name}/mesh/file_whole"],) + (
                (worlds[1][0][f"owned/{name}/nomesh/file"],) if world == 1 else ()):
            assert set(got) == set(want) and all(got[k] == want[k] for k in want)
    for rounds, resumed in _owned(worlds, name, world):
        for (state, _), again in zip(rounds[1:], resumed, strict=True):
            _match(state, again, exact=True)


@pytest.mark.parametrize("world", WORLDS)
def test_row_split(worlds, world):
    """12 rows split into contiguous per-rank slices; 5 rows relax to
    whole on every rank (unsplit) when the ranks do not divide them."""
    for rank, res in enumerate(worlds[world]):
        k = 12 // world
        assert res["split"][0] == (rank * k, (rank + 1) * k, True)
        assert res["split"][1] == ((0, 5, True) if world == 1 else (0, 5, False))


@pytest.mark.parametrize("world", WORLDS)
def test_place_cohort_relaxes_non_divisible_rows(worlds, world):
    """4·world rows: each rank holds its 4 contiguous rows; 4·world + 1
    rows: every rank holds all of them."""
    for rank, res in enumerate(worlds[world]):
        ok, bad = res["place"]
        assert ok.shape == (4, 3) and np.array_equal(ok[:, 0], np.arange(4 * rank,
                                                                         4 * rank + 4))
        assert bad.shape == (4 * world + 1, 3)
        assert np.array_equal(bad[:, 0], np.arange(4 * world + 1))


@pytest.mark.parametrize("world", WORLDS)
def test_psum_segments_matches_dense_sum(worlds, inputs, world):
    p = inputs["psum"]
    w = p["weights"]
    for res in worlds[world]:
        for k, x in p["stacked"].items():
            dense = np.zeros((4,) + x.shape[1:], np.float64)
            np.add.at(dense, p["seg"], x * w.reshape((-1,) + (1,) * (x.ndim - 1)))
            np.testing.assert_allclose(res["psum"][k], dense, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_psum_segments_falls_back_when_rows_do_not_divide(worlds, world):
    rows = world + 1 if world > 1 else 3
    odd = np.arange(rows * 2, dtype=np.float32).reshape(rows, 2)
    for res in worlds[world]:
        assert np.array_equal(res["psum_fallback"][0], odd.sum(0))
        assert not res["psum_fallback"][1].any()


# ------------------------------------------------ against the JAX engine
def _jax_snapshots(name, inputs):
    params = {k: jax.numpy.asarray(v) for k, v in inputs["params"].items()}
    loss = lambda p, b: jsimple.loss_fn(p, b, J_TASK)
    js = jengine.init(name, loss, params, inputs["clients"], _jcfg(name), arena=True,
                      mesh=jax_client_mesh(1))
    snaps = []
    for _ in range(3):
        js, _ = jengine.run_round(js)
        snaps.append(js)
    return snaps


@pytest.mark.parametrize("name", ALL)
def test_world_of_one_matches_jax_engine(worlds, inputs, name):
    """The port's eager rounds under a mesh of one rank against the JAX
    engine's under ``make_client_mesh(1)``: cohorts (PRNG keys), records'
    integers, partitions and members exact, floats within 1e-5 (IFCA's
    hypotheses are the reference's, fed in)."""
    def close(want, got):
        for k in want:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0,
                                       atol=REF_ATOL, err_msg=k)

    for js, got in zip(_jax_snapshots(name, inputs), worlds[1][0][f"eager/{name}/mesh"]):
        assert js.round == got["round"]
        assert np.array_equal(np.asarray(jax.random.key_data(js.rng_key)), got["rng_key"])
        for hr, hg in zip(js.history, got["history"]):
            for k, v in hr.items():
                if isinstance(v, float):
                    assert abs(v - hg[k]) <= REF_ATOL, k
                else:
                    assert v == hg[k], k
        close(js.omega, got["omega"])
        assert sorted(js.models.roots) == sorted(got["models"])
        for r in js.models.roots:
            close(js.models[r], got["models"][r])
        for c in js.personal:
            close(js.personal[c], got["personal"][c])
        assert js.members == got["members"]
        if js.clusters is not None:
            assert js.clusters.assignment() == got["assignment"]
