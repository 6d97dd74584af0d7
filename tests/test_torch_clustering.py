"""The port's host clustering against the JAX package's ``ClusterState``.

Both are fed the same Ψs (the reference's extractor on the four Non-IID
settings), observed in waves like rounds. Merge lists, roots and
n_clusters must be identical; the Eq. 2 objective agrees within 1e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import clustering as jclust  # noqa: E402
from repro.core.extractor import make_extractor  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro_torch.core import clustering as tclust  # noqa: E402

TASK = dataclasses.replace(jsimple.SYNTH_MLP, hidden=32)
SETTINGS = ["pathological", "rotated", "shifted", "hybrid"]


def _reps(setting, n_clients=24, seed=0):
    clients, true_cluster, _ = jsynthetic.make_federation(
        setting, n_clients=n_clients, n_per=48, seed=seed)
    params = jsimple.init(jax.random.PRNGKey(seed), TASK)
    psi = make_extractor(lambda p, b: jsimple.loss_fn(p, b, TASK), params)
    return [np.asarray(psi(c)) for c in clients], true_cluster


@pytest.mark.parametrize("setting", SETTINGS)
def test_merge_rounds_match_reference(setting):
    reps, true_cluster = _reps(setting)
    js, ts = jclust.ClusterState(0.5), tclust.ClusterState(0.5, "cpu")
    order = np.random.default_rng(1).permutation(len(reps))
    for wave in np.array_split(order, 3):
        ids = [int(i) for i in wave]
        assert js.observe(ids, [reps[i] for i in ids]) == \
            ts.observe(ids, [reps[i] for i in ids])
        assert js.merge_round() == ts.merge_round()
        assert js.assignment() == ts.assignment()
        assert js.n_clusters() == ts.n_clusters()
        assert abs(js.objective() - ts.objective()) <= 1e-5
        jroots, jmeans = js.cluster_means()
        troots, tmeans = ts.cluster_means()
        assert jroots == troots
        np.testing.assert_allclose(tmeans.numpy(), jmeans, rtol=0, atol=1e-6)
    assign = ts.assignment()
    ids = sorted(assign)
    got = tclust.adjusted_rand_index([assign[i] for i in ids],
                                     [true_cluster[i] for i in ids])
    want = jclust.adjusted_rand_index([assign[i] for i in ids],
                                      [true_cluster[i] for i in ids])
    assert got == want


@pytest.mark.parametrize("setting", ["rotated", "pathological"])
def test_nearest_infer_remove_match_reference(setting):
    reps, _ = _reps(setting, n_clients=16, seed=2)
    js, ts = jclust.ClusterState(0.5), tclust.ClusterState(0.5, "cpu")
    assert js.nearest(reps[0]) == ts.nearest(reps[0]) == (None, None, 0.0)
    js.observe(range(12), reps[:12])
    ts.observe(range(12), reps[:12])
    js.merge_round()
    ts.merge_round()
    for r in reps[12:]:
        jr, jn, jsim = js.nearest(r)
        tr, tn, tsim = ts.nearest(r)
        assert (jr, jn) == (tr, tn) and abs(jsim - tsim) <= 1e-5
        assert js.infer(r)[0] == ts.infer(r)[0]
    for cid in (0, 5, 11):
        assert js.remove(cid) == ts.remove(cid)
        assert js.assignment() == ts.assignment()
        assert js.uf.parent == ts.uf.parent
    c = ts.copy()
    c.observe([40], [reps[12]])
    assert 40 not in ts.seen and 40 in c.seen


def test_union_find_smaller_root_wins():
    uf = tclust.UnionFind()
    for i in range(6):
        uf.add(i)
    assert uf.union(4, 2) and uf.union(5, 4) and not uf.union(2, 5)
    assert {uf.find(i) for i in (2, 4, 5)} == {2}
    assert uf.find(0) == 0


@pytest.mark.parametrize("seed", range(4))
def test_adjusted_rand_index_matches_reference(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, size=50)
    b = np.where(rng.random(50) < 0.7, a, rng.integers(0, 4, size=50))
    assert tclust.adjusted_rand_index(a, b) == jclust.adjusted_rand_index(a, b)
    assert tclust.adjusted_rand_index(a, a) == 1.0
