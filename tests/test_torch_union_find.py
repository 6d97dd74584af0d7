"""The union-find layer of the port's device merge pass, on the CPU: the
plain component labelling against the JAX package's, K4's early-stopping
loop against the fixed-step reference, the bit arithmetic of the
``component_labels`` kernel, and the merge pass without its
``adj.any()`` branch against the reference's.

The CUDA kernels (``kernels/csrc/resolve_roots.cu``) cannot run here;
``tests/test_torch_kernels_cuda.py`` holds them against their plain
versions on the card. What this file can check is the argument each kernel
rests on, in numpy emulations that follow the kernels' loops: K4 may stop
at the first synchronous step that changes nothing, and the labelling
kernel's packing of ``adj > 0`` into 32-bit words (one ballot a word)
gives the matrix back, and its passes over those words, a few threads a
row, give the plain labels. Labels, roots, parents and step counts are
integers and must be exactly equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import device_clustering as jdc  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import device_clustering as tdc  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.resolve_roots import steps_for  # noqa: E402

GRAPH_KINDS = ("empty", "sparse", "dense", "chain", "cliques")
PARENT_KINDS = ("forest", "chain", "compressed", "cycle", "self")


def _graph(k, kind, seed):
    """A symmetric (k, k) fp32 0/1 adjacency with a zero diagonal, as K3
    writes it."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((k, k), np.float32)
    if kind == "sparse":
        adj[rng.random((k, k)) < 2.0 / max(k, 1)] = 1.0
    elif kind == "dense":
        adj[rng.random((k, k)) < 0.5] = 1.0
    elif kind == "chain":                 # a path through a random order of the ids
        order = rng.permutation(k)
        adj[order[:-1], order[1:]] = 1.0
    elif kind == "cliques":               # ids split at random into a few groups
        group = rng.integers(0, 4, k)
        adj[group[:, None] == group[None, :]] = 1.0
    adj = np.maximum(adj, adj.T)
    np.fill_diagonal(adj, 0.0)
    return adj


_jax_labels = jax.jit(jdc.component_labels)


@pytest.mark.parametrize("kind", GRAPH_KINDS)
@pytest.mark.parametrize("k", [1, 2, 64, 512])
def test_component_labels_ref_matches_jax(k, kind):
    adj = _graph(k, kind, seed=k + 17 * GRAPH_KINDS.index(kind))
    want = np.asarray(_jax_labels(jnp.asarray(adj)))
    got = ref.component_labels_ref(torch.from_numpy(adj))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    if kind == "empty":
        assert np.array_equal(want, np.arange(k))
    if kind == "chain":
        assert not want.any()


@pytest.mark.parametrize("kind", GRAPH_KINDS)
@pytest.mark.parametrize("k", [1, 2, 64, 512])
def test_device_clustering_component_labels_on_cpu_is_plain(k, kind):
    """On a CPU tensor the merge pass's entry dispatches to the plain loop,
    with either backend."""
    adj = torch.from_numpy(_graph(k, kind, seed=3 * k + GRAPH_KINDS.index(kind)))
    want = ref.component_labels_ref(adj)
    for backend in ("auto", "torch"):
        got = tdc.component_labels(adj, backend)
        assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(ops.component_labels(adj), want)


def _parents(n, kind, seed):
    """(N,) int32 arrays with entries in [0, N): a random forest (parents at
    smaller ids), a chain through a random order of the ids, a fully
    compressed array, one cycle through all the ids, and the all-self
    array."""
    rng = np.random.default_rng(seed)
    ids = np.arange(n, dtype=np.int32)
    order = rng.permutation(n).astype(np.int32)
    if kind == "forest":
        p = ids.copy()
        for i in rng.permutation(n)[: n // 2]:
            p[i] = rng.integers(0, i + 1)
        return p
    if kind == "chain":
        p = np.empty(n, np.int32)
        p[order] = np.concatenate([order[:1], order[:-1]])
        return p
    if kind == "compressed":
        roots = order[: max(n // 7, 1)]
        p = roots[rng.integers(0, len(roots), n)]
        p[roots] = roots
        return p
    if kind == "cycle":
        p = np.empty(n, np.int32)
        p[order] = np.roll(order, -1)
        return p
    return ids


def _halving_early_exit(parent):
    """K4's resident loop: synchronous ``p <- p[p]`` steps, stopping after
    the first step that changes nothing, at most ``steps_for(N)``. Returns
    (array, steps run)."""
    p = parent.copy()
    cap = steps_for(len(p))
    for step in range(1, cap + 1):
        nxt = p[p]
        changed = bool((nxt != p).any())
        p = nxt
        if not changed:
            return p, step
    return p, cap


@pytest.mark.parametrize("kind", PARENT_KINDS)
@pytest.mark.parametrize("n", [1, 7, 512, 4096])
def test_resolve_roots_early_exit_matches_fixed_steps(n, kind):
    parent = _parents(n, kind, seed=n + PARENT_KINDS.index(kind))
    got, steps = _halving_early_exit(parent)
    want = np.asarray(jops._resolve_pallas(jnp.asarray(parent), interpret=True))
    assert np.array_equal(got, want)
    assert np.array_equal(ref.resolve_roots_ref(torch.from_numpy(parent)).numpy(), want)
    cap = steps_for(n)
    if kind in ("compressed", "self") or n == 1:
        assert steps == 1                 # the path's inputs: one step
    elif kind == "cycle":
        assert steps == cap               # never a fixed point (or only at the cap)
    elif kind == "chain":                 # depth n - 1: ceil(log2 depth) + 1 steps
        assert steps == min(int(np.ceil(np.log2(n - 1))) + 1, cap)
    assert 1 <= steps <= cap


# ------------------------------------------- the labelling kernel's loops
def _ballot(pred):
    """Ballot over the last axis (32 lanes) -> uint64 words."""
    return (pred.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)


def _pack_words(adj):
    """``pack_rows``: (k, ceil(k / 32)) words, word w of a row the ballot of
    ``adj > 0`` over columns 32w + lane (columns past k read as 0)."""
    k = adj.shape[0]
    words = -(-k // 32)
    padded = np.zeros((k, words * 32), np.float32)
    padded[:, :k] = adj
    return _ballot(padded.reshape(k, words, 32) > 0)


def _row_threads(k, words, shared_bits, block=1024):
    """Threads a row in phase 2, as ``component_labels_f32`` picks them."""
    if not shared_bits:
        return 32
    t = 1
    while t < 32 and t * 2 <= words and k * t * 2 <= block:
        t *= 2
    return t


def _label_passes(words, k, row_threads):
    """Phase 2 over packed words: thread t walks the set bits of words
    t % T, t % T + T, ... of row t // T; the T minima of a row are combined
    (the shuffles), then the jump; until a pass changes nothing."""
    lab = np.arange(k)
    while True:
        mn = np.empty(k, np.int64)
        for row in range(k):
            m = lab[row]
            for sub in range(row_threads):
                for w in range(sub, words.shape[1], row_threads):
                    b = int(words[row, w])
                    while b:
                        low = b & -b
                        m = min(m, lab[(w << 5) + low.bit_length() - 1])
                        b &= b - 1
            mn[row] = m
        nxt = mn[mn]
        if np.array_equal(nxt, lab):
            return lab
        lab = nxt


@pytest.mark.parametrize("kind", ["sparse", "chain", "cliques"])
@pytest.mark.parametrize("k", [1, 2, 33, 64, 128, 160])
def test_label_kernel_loops_give_the_plain_labels(k, kind):
    """The kernel's packing gives the matrix back bit for bit, and its
    passes over the packed words, with the threads a row it picks for a
    shared or a global bit matrix, give the plain loop's labels."""
    adj = _graph(k, kind, seed=k + 5)
    words = _pack_words(adj)
    assert words.max(initial=0) < 2 ** 32
    bits = (words[:, :, None] >> np.arange(32, dtype=np.uint64)) & np.uint64(1)
    back = bits.reshape(k, -1)
    assert np.array_equal(back[:, :k], (adj > 0).astype(np.uint64))
    assert not back[:, k:].any()
    want = ref.component_labels_ref(torch.from_numpy(adj)).numpy()
    for shared in (True, False):
        t = _row_threads(k, words.shape[1], shared)
        assert t & (t - 1) == 0 and 32 % t == 0
        assert np.array_equal(_label_passes(words, k, t), want), (shared, t)


# ------------------------------------------------------------ the merge pass
def _arc_reps(n, seed):
    """Unit vectors 10 degrees apart on an arc, in a random order of the ids:
    at tau = cos 15 degrees only arc neighbours are candidates (a chain)."""
    perm = np.random.default_rng(seed).permutation(n)
    ang = np.deg2rad(10.0 * np.argsort(perm))
    return np.stack([np.cos(ang), np.sin(ang)], 1).astype(np.float32)


@pytest.mark.parametrize("case", ["no_candidates", "chained"])
def test_merge_round_impl_without_branch_matches_reference(case):
    """No candidate pair: the labels are arange(k_max), which the reference's
    lax.cond returns without a pass. Chained candidates: the pass joins the
    chain into one cluster. Parent, roots, new roots and counts equal the
    JAX package's ``merge_round_impl`` exactly."""
    n, cap, k_max = 12, 16, 16
    tau = float(np.cos(np.deg2rad(15.0)))
    reps = _arc_reps(n, seed=5)
    if case == "no_candidates":           # spread 30 degrees apart
        ang = np.deg2rad(30.0 * np.arange(n))
        reps = np.stack([np.cos(ang), np.sin(ang)], 1).astype(np.float32)
    idx = np.arange(n, dtype=np.int32)
    js = jdc.observe(jdc.init_state(cap, 2), jnp.asarray(idx), jnp.asarray(reps))
    ts = tdc.observe(tdc.init_state(cap, 2), torch.from_numpy(idx), torch.from_numpy(reps))
    jout = jdc._jit_merge_round(tau, k_max)(js)
    tout = tdc.merge_round_impl(ts, tau, k_max)
    assert np.array_equal(np.asarray(jout[0].parent), tout[0].parent.numpy())
    for j, t in zip(jout[1:], tout[1:]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    roots = set(tout[0].parent[:n].tolist())
    assert roots == ({0} if case == "chained" else set(range(n)))
