"""The port's device clustering backend (kernels K3 and K4, the
``DeviceClusters`` union-find, the StoCFL round on it) against the JAX
package's, on the CPU.

Inputs are made with numpy from a seed and fed to both packages. Integer
results (``parent``, ``live``, roots, merge lists, partitions, cohorts,
``n_clusters``) must be exactly equal; floats (Ψ bank, means, similarities,
objectives, ω, bank rows) agree within atol 1e-5, because the two
frameworks sum in different orders. K3's 0/1 adjacency and K4's roots are
exactly equal to the reference's Pallas kernels in interpret mode.

Threshold margins. A pair whose cosine lies within ~1e-6 of τ could be
decided differently by the two packages' float sums. Every clustering input
below keeps its pairs at least 1e-4 from τ, and ``_assert_margin`` checks
that in float64 before the comparison: the margin is part of the test's
statement, not a way round a defect.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import engine as jengine  # noqa: E402
from repro.core import device_clustering as jdc  # noqa: E402
from repro.core.clustering import UnionFind  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.engine import bank as jbank  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.cosine_sim import merge_candidates as j_candidates  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import engine as tengine  # noqa: E402
from repro_torch.core import device_clustering as tdc  # noqa: E402
from repro_torch.core.clustering import ClusterState  # noqa: E402
from repro_torch.engine.bank import ClusterBank  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import simple as tsimple  # noqa: E402

ATOL = 1e-5
MARGIN = 1e-4


def _unit_reps(labels, seed=0, d=16, noise=0.02):
    rng = np.random.default_rng(seed)
    anchors = rng.normal(size=(max(labels) + 1, d))
    anchors /= np.linalg.norm(anchors, axis=1, keepdims=True)
    out = []
    for g in labels:
        v = anchors[g] + rng.normal(size=d) * noise
        out.append((v / np.linalg.norm(v)).astype(np.float32))
    return out


def _assert_margin(reps, tau):
    """Every pair of the singletons' Ψ lies at least MARGIN from τ."""
    x = np.stack(reps).astype(np.float64)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    cos = x @ x.T
    iu = np.triu_indices(len(x), 1)
    assert len(iu[0]) == 0 or np.abs(cos[iu] - tau).min() >= MARGIN


def _pair(tau=0.8, n=0):
    return jdc.DeviceClusters(tau=tau, capacity=n), tdc.DeviceClusters(tau=tau, capacity=n)


def _assert_same(a, b):
    """The reference's and the port's DeviceClusters hold one state."""
    assert a.assignment() == b.assignment()
    assert a.clusters() == b.clusters()
    assert a.n_clusters() == b.n_clusters()
    assert a.seen == b.seen
    A, B = a.arrays(), b.arrays()
    assert A["parent"].dtype == B["parent"].dtype == np.int32
    assert np.array_equal(A["parent"], B["parent"])
    assert np.array_equal(A["live"], B["live"])
    np.testing.assert_allclose(B["rep"], A["rep"], rtol=0, atol=ATOL)
    assert np.array_equal(a._parent, b._parent)


# ------------------------------------------------------------ K3 and K4
@pytest.mark.parametrize("n,d,tau", [(13, 24, -1.0), (13, 24, 0.2), (13, 24, 0.95),
                                     (40, 300, 0.5), (64, 257, 0.0)])
def test_merge_candidates_matches_pallas_interpret(n, d, tau):
    rng = np.random.default_rng(n * d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[n // 2] = 0.0                               # a zero row: cosine 0
    live = rng.random(n) > 0.3
    _assert_margin([r for r in x if r.any()], tau)    # a zero row's 0 is exact
    want = np.asarray(j_candidates(jnp.asarray(x), jnp.asarray(live), tau=tau,
                                   bn=8, bk=16, interpret=True))
    got = ops.merge_pairs(torch.from_numpy(x), torch.from_numpy(live), tau)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), np.asarray(jref.merge_candidates_ref(
        jnp.asarray(x), jnp.asarray(live), tau)))
    assert not got.diagonal().any()


def test_merge_candidates_diagonal_and_dead_rows():
    """τ=-1 admits every pair except the diagonal and dead rows."""
    x = np.random.default_rng(1).normal(size=(9, 12)).astype(np.float32)
    live = np.array([1, 1, 0, 1, 1, 1, 0, 1, 1], bool)
    adj = ops.merge_pairs(torch.from_numpy(x), torch.from_numpy(live), -1.0).numpy()
    np.testing.assert_array_equal(adj, np.outer(live, live) * (1 - np.eye(9)))


def _random_forest(n, rng):
    parent = np.arange(n, dtype=np.int32)
    for i in rng.permutation(n)[: n // 2]:
        parent[i] = rng.integers(0, i + 1)
    return parent


@pytest.mark.parametrize("n", [1, 2, 37, 129, 200])
def test_resolve_roots_matches_pallas_interpret(n):
    rng = np.random.default_rng(n)
    order = rng.permutation(n).astype(np.int32)
    chain = np.empty(n, np.int32)
    chain[order] = np.concatenate([order[:1], order[:-1]])
    for parent in (_random_forest(n, rng), chain,
                   np.maximum(np.arange(n, dtype=np.int32) - 1, 0)):
        want = np.asarray(jops._resolve_pallas(jnp.asarray(parent), interpret=True))
        t = torch.from_numpy(parent.copy())
        got = ops.resolve_roots(t)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(t.numpy(), parent)          # input untouched
        assert np.array_equal(ref.resolve_roots_ref(t).numpy(), want)


# ------------------------------------------------------------ union-find
def test_device_unionfind_matches_reference_seeded_sweep():
    """30 seeded random union sequences: the port's parent array equals
    the reference's after every union, and its roots equal UnionFind's."""
    n = 16
    zeros = np.zeros((n, 2), np.float32)
    for seed in range(30):
        rng = np.random.default_rng(seed)
        edges = [tuple(int(v) for v in rng.integers(0, n, 2))
                 for _ in range(rng.integers(0, 40))]
        uf = UnionFind()
        for i in range(n):
            uf.add(i)
        js = jdc.observe(jdc.init_state(n, 2), jnp.arange(n, dtype=jnp.int32),
                         jnp.asarray(zeros))
        ts = tdc.observe(tdc.init_state(n, 2), torch.arange(n), torch.from_numpy(zeros))
        for a, b in edges:
            uf.union(a, b)
            js = jdc._jit_union()(js, jnp.int32(a), jnp.int32(b))
            ts = tdc.union(ts, a, b)
            assert np.array_equal(np.asarray(js.parent), ts.parent.numpy())
        roots = ops.resolve_roots(ts.parent).numpy()
        assert [int(roots[i]) for i in range(n)] == [uf.find(i) for i in range(n)]


def test_component_labels_worst_case_path():
    for n in (2, 3, 17, 64, 129):
        adj = np.zeros((n, n), np.float32)
        for i in range(n - 1):
            adj[i, i + 1] = adj[i + 1, i] = 1.0
        labels = tdc.component_labels(torch.from_numpy(adj))
        assert labels.dtype == torch.int32 and (labels == 0).all()
    adj = np.zeros((5, 5), np.float32)
    adj[0, 1] = adj[1, 0] = adj[2, 3] = adj[3, 2] = 1.0
    got = tdc.component_labels(torch.from_numpy(adj)).tolist()
    assert got == np.asarray(jdc.component_labels(jnp.asarray(adj))).tolist() \
        == [0, 0, 2, 2, 4]


def test_component_labels_permuted_paths():
    """Chains through a random permutation of the ids defeat a fixed
    ⌈log2 N⌉+1 pass count; the fixed-point loop closes them all, as the
    reference's does."""
    for trial in range(25):
        rng = np.random.default_rng(trial)
        n = int(rng.integers(4, 80))
        order = rng.permutation(n)
        adj = np.zeros((n, n), np.float32)
        for x, y in zip(order[:-1], order[1:]):
            adj[x, y] = adj[y, x] = 1.0
        got = tdc.component_labels(torch.from_numpy(adj)).numpy()
        assert (got == 0).all(), (trial, n)
        if trial < 4:                     # each new n compiles the reference anew
            assert np.array_equal(got, np.asarray(jdc.component_labels(jnp.asarray(adj))))


# --------------------------------------------------------------- merging
def test_arc_chain_partition_parity_permuted_ids():
    """16 clusters on a 10° arc with τ=cos(15°): only arc neighbours
    qualify (margins cos 10° − τ and τ − cos 20°, both over 0.01), so the
    τ-graph is a chain through a random id permutation; it collapses to one
    cluster in both packages."""
    tau = float(np.cos(np.deg2rad(15.0)))
    for seed in range(8):
        rng = np.random.default_rng(seed)
        perm = rng.permutation(16)
        ang = {int(cid): 10.0 * pos for pos, cid in enumerate(perm)}
        reps = list(np.stack([[np.cos(np.deg2rad(ang[i])), np.sin(np.deg2rad(ang[i]))]
                              for i in range(16)]).astype(np.float32))
        _assert_margin(reps, tau)
        a, b = _pair(tau=tau, n=16)
        a.observe(range(16), reps)
        b.observe(range(16), reps)
        assert a.merge_round() == b.merge_round()
        _assert_same(a, b)
        assert b.n_clusters() == 1


def test_merge_round_parity_random_groups():
    """Same observations → same merge list, parent and partition as the
    reference, and the same partition as the port's host backend. One
    capacity (32) for every layout keeps the reference's compiles few."""
    for seed in range(12):
        rng = np.random.default_rng(seed + 100)
        labels = rng.integers(0, 4, size=int(rng.integers(2, 24))).tolist()
        reps = _unit_reps(labels, seed)
        _assert_margin(reps, 0.8)
        a, b = _pair(n=32)
        host = ClusterState(0.8)
        for cs in (a, b, host):
            cs.observe(range(len(labels)), reps)
        ma, mb, mh = a.merge_round(), b.merge_round(), host.merge_round()
        assert ma == mb
        assert sorted(mh) == mb
        _assert_same(a, b)
        assert host.assignment() == b.assignment()
        assert abs(a.objective() - b.objective()) <= ATOL
        assert abs(jdc.objective_closed(a.state) - tdc.objective_closed(b.state)) <= ATOL
        ra, means_a = a.cluster_means()
        rb, means_b = b.cluster_means()
        assert ra == rb
        np.testing.assert_allclose(means_b.numpy(), means_a, rtol=0, atol=ATOL)


def test_merge_round_impl_outputs_match_reference():
    """The pass's k_max-row outputs (live roots, new roots, counts),
    padded with the capacity, are the reference's exactly."""
    labels = [0, 1, 2, 0, 1, 2, 0, 3]
    reps = _unit_reps(labels, seed=4)
    _assert_margin(reps, 0.8)
    idx = np.array([0, 1, 2, 3, 4, 5, 6, 7, 16, 16], np.int32)     # 2 pads
    x = np.concatenate([np.stack(reps), np.zeros((2, 16), np.float32)])
    js = jdc.observe(jdc.init_state(16, 16), jnp.asarray(idx), jnp.asarray(x))
    ts = tdc.observe(tdc.init_state(16, 16), torch.from_numpy(idx), torch.from_numpy(x))
    for k_max in (8, 16):
        jout = jdc.merge_round(js, 0.8, k_max=k_max)
        tout = tdc.merge_round(ts, 0.8, k_max=k_max)
        assert np.array_equal(np.asarray(jout[0].parent), tout[0].parent.numpy())
        for j, t in zip(jout[1:], tout[1:]):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_streaming_and_departures_parity():
    """Clients arriving over rounds, then departures of roots and members:
    partitions, remaps, parent, live and the Ψ bank stay equal."""
    labels = [0, 1, 2, 0, 1, 2, 0, 1, 2, 0, 1, 2]
    reps = _unit_reps(labels, seed=7)
    _assert_margin(reps, 0.8)
    a, b = _pair(n=4)                        # the capacity grows on the way
    for lo in range(0, 12, 3):
        ids = list(range(lo, lo + 3))
        a.observe(ids, reps[lo:lo + 3])
        b.observe(ids, reps[lo:lo + 3])
        assert a.merge_round() == b.merge_round()
        _assert_same(a, b)
    for cid in (0, 5, 1, 11):
        assert a.remove(cid) == b.remove(cid)
        assert a.uf.parent == b.uf.parent
        _assert_same(a, b)
        assert np.array_equal(b._parent, b.state.parent.numpy().astype(np.int64))
    a.observe([0], [reps[0]])                # re-join reuses the tombstoned row
    b.observe([0], [reps[0]])
    assert a.merge_round() == b.merge_round()
    _assert_same(a, b)


def test_chain_topology_same_partition_and_bank_merge():
    """Chain τ-graph 0-3-2-1 (τ = cos 45°, pairs 40° apart qualify; margin
    cos 40° − τ = 0.059): the device backend's normalised merge list differs
    from the host scan's, the partition does not, and both lists give the
    same merged bank."""
    angles = np.deg2rad([0.0, 120.0, 80.0, 40.0])
    reps = list(np.stack([np.cos(angles), np.sin(angles)], 1).astype(np.float32))
    tau = float(np.cos(np.deg2rad(45.0)))
    _assert_margin(reps, tau)
    a, b = _pair(tau=tau)
    host = ClusterState(tau)
    for cs in (a, b, host):
        cs.observe(range(4), reps)
    counts = {r: len(m) for r, m in host.clusters().items()}
    mh, ma, mb = host.merge_round(), a.merge_round(), b.merge_round()
    assert ma == mb and sorted(mh) != mb
    assert host.assignment() == b.assignment() == {i: 0 for i in range(4)}
    _assert_same(a, b)
    init = {"w": torch.zeros(3)}
    bank = ClusterBank.empty().put([0, 1, 2, 3], {"w": torch.stack(
        [torch.full((3,), float(i + 1)) for i in range(4)])})
    bank_h, bank_d = bank.merge(mh, counts, init), bank.merge(mb, counts, init)
    want = jbank.ClusterBank.from_dict(
        {i: {"w": jnp.full((3,), float(i + 1))} for i in range(4)}).merge(
        ma, counts, {"w": jnp.zeros(3)})
    assert tuple(bank_h.roots) == tuple(bank_d.roots) == tuple(want.roots)
    for r in bank_d.roots:
        assert torch.equal(bank_h[r]["w"], bank_d[r]["w"])
        np.testing.assert_allclose(bank_d[r]["w"].numpy(), np.asarray(want[r]["w"]),
                                   rtol=0, atol=ATOL)


def test_nearest_and_infer_parity():
    labels = [0, 0, 1, 1, 2, 2]
    reps = _unit_reps(labels, seed=5)
    a, b = _pair()
    a.observe(range(6), reps)
    b.observe(range(6), reps)
    assert a.merge_round() == b.merge_round()
    queries = _unit_reps([0, 1, 2], seed=11) + [np.ones(16, np.float32) / 4]
    for q in queries:
        root_a, near_a, sim_a = a.nearest(q)
        root_b, near_b, sim_b = b.nearest(q)
        assert abs(sim_a - 0.8) >= MARGIN
        assert (root_a, near_a) == (root_b, near_b)
        assert abs(sim_a - sim_b) <= ATOL
        assert a.infer(q)[0] == b.infer(q)[0]
    assert abs(a.objective() - b.objective()) <= ATOL


def test_empty_and_singleton_edge_cases():
    a, b = _pair()
    assert b.merge_round() == [] == a.merge_round()
    assert a.nearest(np.ones(4)) == b.nearest(np.ones(4)) == (None, None, 0.0)
    assert a.remove(3) == b.remove(3) == {}
    assert a.objective() == b.objective() == 0.0
    for k in ("parent", "live", "rep"):
        assert a.arrays()[k].shape == b.arrays()[k].shape
    a.observe([0], _unit_reps([0]))
    b.observe([0], _unit_reps([0]))
    assert a.merge_round() == b.merge_round() == []
    assert a.n_clusters() == b.n_clusters() == 1
    assert tdc.objective_closed(b.state) == 0.0
    _assert_same(a, b)


def test_cluster_means_are_deterministic():
    """The segment sum runs in deterministic mode, scoped to the call: the
    means of one state are bitwise equal computed twice, and the caller's
    setting is left as it was."""
    labels = [0, 1, 0, 1, 2, 2, 0]
    b = tdc.DeviceClusters(0.8)
    b.observe(range(7), _unit_reps(labels, seed=2))
    b.merge_round()
    before = torch.are_deterministic_algorithms_enabled()
    _, m1, c1 = tdc._cluster_means(b.state)
    _, m2, c2 = tdc._cluster_means(b.state)
    assert torch.equal(m1, m2) and torch.equal(c1, c2)
    assert torch.are_deterministic_algorithms_enabled() == before


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="cluster_backend"):
        tdc.make_cluster_state(0.5, "gpu")


# ------------------------------------------------------- the slice end to end
J_TASK = dataclasses.replace(jsimple.SYNTH_MLP, hidden=32)
T_TASK = tsimple.TaskConfig("synth_mlp", "mlp", (64,), 10, hidden=32)


def _jloss(p, b):
    return jsimple.loss_fn(p, b, J_TASK)


def _tloss(p, b):
    return tsimple.loss_fn(p, b, T_TASK)


def _federation():
    clients, _, _ = jsynthetic.rotated(n_clusters=4, n_clients=16, n_per=32, seed=3)
    return clients, jsimple.init(jax.random.PRNGKey(0), J_TASK)


def _engines(fused, chunk, n_rounds=3, start=None):
    """Both engines on the device backend with an arena, run ``n_rounds``;
    returns their per-round (cohort, record, state) lists."""
    clients, params = _federation()
    kw = dict(local_steps=2, sample_rate=0.5, seed=0, fused_step=fused,
              cluster_backend="device", cohort_chunk=chunk)
    js = jengine.init("stocfl", _jloss, params, clients, jengine.EngineConfig(**kw),
                      arena=True)
    ts = tengine.init("stocfl", _tloss, convert.to_torch(params), clients,
                      tengine.EngineConfig(**kw), device="cpu", arena=True)
    if start is not None:
        js, ts = start(js, ts)
    out = []
    for _ in range(n_rounds):
        _, jids = jengine.sample_clients(js)
        _, tids = tengine.sample_clients(ts)
        js, jrec = jengine.run_round(js)
        ts, trec = tengine.run_round(ts)
        out.append((jids, tids, jrec, trec, js, ts))
    return out


def _close(a_tree, t_tree):
    a = convert.to_numpy(convert.to_torch(a_tree))
    b = convert.to_numpy(t_tree)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=ATOL, err_msg=k)


def _assert_states_agree(js, ts):
    _assert_same(js.clusters, ts.clusters)
    _close(js.omega, ts.omega)
    assert tuple(js.models.roots) == tuple(ts.models.roots)
    for r in js.models.roots:
        _close(js.models[r], ts.models[r])


def _merge_closure(merges):
    """Partition of the roots a merge list touches (its transitive closure)."""
    parent = {}

    def find(r):
        while parent.get(r, r) != r:
            r = parent[r]
        return r

    for keep, absorb in merges:
        ra, rb = find(keep), find(absorb)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    return {r: find(r) for pair in merges for r in pair}


@pytest.mark.parametrize("fused,chunk", [(True, 0), (True, 3), (False, 3)])
def test_device_backend_rounds_match_reference(fused, chunk):
    """Cohorts, partition, parent, live, merge lists and n_clusters equal the
    JAX engine's on the same (device) backend; ω, bank rows, the Ψ bank and
    objective_closed agree within 1e-5. Then join, leave, infer and
    infer_batch route like the reference."""
    rounds = _engines(fused, chunk)
    for jids, tids, jrec, trec, js, ts in rounds:
        assert np.array_equal(np.asarray(jids), np.asarray(tids))
        assert jrec["n_clusters"] == trec["n_clusters"]
        assert jrec["sampled"] == trec["sampled"]
        assert abs(jrec["objective"] - trec["objective"]) <= ATOL
        _assert_states_agree(js, ts)
    merges = [m for *_, trec, _js, _ts in rounds for m in trec["merges"]]
    assert merges, "the rounds should merge clusters"

    js, ts = rounds[-1][4], rounds[-1][5]
    fresh, _, _ = jsynthetic.rotated(n_clusters=4, n_clients=8, n_per=32, seed=11)
    jb, tb = jengine.infer_batch(js, fresh[:4]), tengine.infer_batch(ts, fresh[:4])
    for batch, ji, ti in zip(fresh[:4], jb, tb):
        one = tengine.infer(ts, batch)
        assert (ji["cluster"], ji["seed_from"]) == (ti["cluster"], ti["seed_from"]) \
            == (one["cluster"], one["seed_from"])
        assert abs(ji["similarity"] - ti["similarity"]) <= ATOL
        assert abs(one["similarity"] - ti["similarity"]) <= ATOL
        _close(ji["model"], ti["model"])
    for batch in fresh[4:6]:
        js, jcid = jengine.join(js, batch)
        ts, tcid = tengine.join(ts, batch)
        assert jcid == tcid
        _assert_states_agree(js, ts)
    assert ts.ctx.arena.n_clients == js.ctx.arena.n_clients == 18
    for cid in (0, jcid):
        js = jengine.leave(js, cid)
        ts = tengine.leave(ts, cid)
        assert js.left == ts.left
        _assert_states_agree(js, ts)
    js, jrec = jengine.run_round(js)
    ts, trec = tengine.run_round(ts)
    assert jrec["n_clusters"] == trec["n_clusters"]
    _assert_states_agree(js, ts)


def test_device_backend_partition_equals_host_backend():
    """The port's two backends on the same rounds: identical cohorts,
    partitions and n_clusters, merge lists with the same transitive
    closure, and the same floats."""
    clients, params = _federation()
    states = {}
    for backend in ("numpy", "device"):
        cfg = tengine.EngineConfig(local_steps=2, sample_rate=0.5, seed=0,
                                   fused_step=True, cluster_backend=backend)
        st = tengine.init("stocfl", _tloss, convert.to_torch(params), clients, cfg,
                          device="cpu")
        recs = []
        for _ in range(3):
            st, rec = tengine.run_round(st)
            recs.append((rec, st.clusters.assignment()))
        states[backend] = (st, recs)
    (hs, hrecs), (ds, drecs) = states["numpy"], states["device"]
    for (hr, ha), (dr, da) in zip(hrecs, drecs):
        assert ha == da and hr["n_clusters"] == dr["n_clusters"]
        assert _merge_closure(hr["merges"]) == _merge_closure(dr["merges"])
        assert abs(hr["objective"] - dr["objective"]) <= ATOL
    for k in hs.omega:
        assert torch.allclose(hs.omega[k], ds.omega[k], rtol=0, atol=ATOL)
    assert tuple(hs.models.roots) == tuple(ds.models.roots)


def test_rounds_from_a_converted_reference_state():
    """Both engines start from the reference's clustering after two of its
    rounds (carried over by ``convert.device_clusters``) and agree on the
    rounds that follow."""
    def start(js, ts):
        for _ in range(2):
            js, _ = jengine.run_round(js)
        clusters = convert.device_clusters(js.clusters.arrays(), js.clusters.tau)
        assert clusters.assignment() == js.clusters.assignment()
        models = ClusterBank.empty()
        roots = list(js.models.roots)
        if roots:
            models = models.put(roots, {k: torch.stack([torch.from_numpy(np.array(
                js.models[r][k])) for r in roots]) for k in js.omega})
        ts = ts.replace(clusters=clusters, models=models, round=js.round,
                        rng_state=js.rng_state, omega=convert.to_torch(js.omega))
        return js, ts

    for jids, tids, jrec, trec, js, ts in _engines(True, 0, n_rounds=2, start=start):
        assert np.array_equal(np.asarray(jids), np.asarray(tids))
        assert jrec["n_clusters"] == trec["n_clusters"]
        assert abs(jrec["objective"] - trec["objective"]) <= ATOL
        _assert_states_agree(js, ts)


def test_forked_state_is_unchanged_by_the_next_round():
    """Transitions never write a tensor a state holds: after a round, a
    join and a leave from a forked state, the fork's parent, live, Ψ bank,
    host mirrors and arena rows read as before."""
    clients, params = _federation()
    cfg = tengine.EngineConfig(local_steps=1, sample_rate=0.5, seed=0,
                               fused_step=True, cluster_backend="device")
    st = tengine.init("stocfl", _tloss, convert.to_torch(params), clients, cfg,
                      device="cpu", arena=True)
    st, _ = tengine.run_round(st)
    fork = st
    before = {k: v.copy() for k, v in fork.clusters.arrays().items()}
    mirror = (fork.clusters._parent.copy(), set(fork.clusters.seen))
    rows = fork.ctx.arena.gather(range(len(clients)))
    rows = {k: v.clone() for k, v in rows.items()}
    nxt, _ = tengine.run_round(fork)
    nxt, cid = tengine.join(nxt, clients[3])
    nxt = tengine.leave(nxt, 0)
    nxt, _ = tengine.run_round(nxt)
    after = fork.clusters.arrays()
    for k in before:
        assert np.array_equal(before[k], after[k]), k
    assert np.array_equal(mirror[0], fork.clusters._parent)
    assert mirror[1] == fork.clusters.seen
    assert nxt.clusters.seen != fork.clusters.seen
    again = fork.ctx.arena.gather(range(len(clients)))
    for k in rows:
        assert torch.equal(rows[k], again[k]), k
