"""The arithmetic and the operand layout of the port's cosine kernels
(K2 ``cosine_sim``, K3 ``merge_candidates``), on the CPU.

The kernels compute X·Xᵀ on the tensor cores in 3xTF32: each operand is
split into hi = tf32(x) and lo = tf32(x − hi), and each 8-column step adds
lo·hi, hi·lo, then hi·hi into a stage accumulator that is fresh for every
k-step of 32 columns and then added into the running fp32 sum; the
contraction is split as ``cosine_sim.plan`` splits it (at 64 rows two
warpgroups take alternate k-steps), and the splits are summed in groups,
in order. A numpy emulation of that arithmetic (tf32 by rounding the fp32
mantissa to 10 bits, nearest-even; each 8-term product sum exact, rounded
to fp32 once as it is added) shows the cosines within 1e-6 of float64 at
the main path's shapes, while single TF32 (hi·hi alone, in the same
structure) moves them by more than that: the merge decision cos ≥ τ is
checked 1e-5 from every pair, so single TF32 could flip it. The rows
spread their cosines over (-1, 1), as ``chip_smoke.py``'s K3 inputs do.

The kernels read their operand through a TMA tensor map, which needs a row
stride that is a multiple of 16 bytes, so both callers build their matrices
with rows D rounded up to 32 floats apart: those must equal the contiguous
means bitwise. The kernels themselves run on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import device_clustering as tdc  # noqa: E402
from repro_torch.core.clustering import ClusterState  # noqa: E402
from repro_torch.kernels import cosine_sim, ops  # noqa: E402

TOL = 1e-6
SMS = 132             # an H100 SXM's SMs, which set the emulated plan


def _spread(n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)) @ rng.normal(size=(3, d)) + 0.05 * rng.normal(size=(n, d))
    return x.astype(np.float32)


def _tf32(x):
    """fp32 -> the nearest tf32 (10 mantissa bits), ties to even, as fp32."""
    b = x.view(np.uint32)
    b = (b + np.uint32(0xFFF) + ((b >> np.uint32(13)) & np.uint32(1))) & np.uint32(0xFFFFE000)
    return b.view(np.float32)


def _emulated_gram(x, single=False):
    """X·Xᵀ as the kernel sums it: per k-step a fresh stage of 4 x 3
    products (or the 4 hi·hi alone), each rounded to fp32 as it is added;
    stages added in fp32 per team, teams added, splits summed per group in
    order, then the groups in order."""
    n, d = x.shape
    p = cosine_sim.plan(n, d, SMS)
    ksteps = -(-d // cosine_sim.KSTEP)
    per = -(-ksteps // p.splits)
    xp = np.pad(x, ((0, 0), (0, ksteps * cosine_sim.KSTEP - d)))
    hi = _tf32(xp)
    lo = _tf32(xp - hi)
    h = hi.astype(np.float64).reshape(n, ksteps, 4, 8).transpose(1, 2, 0, 3)
    lw = lo.astype(np.float64).reshape(n, ksteps, 4, 8).transpose(1, 2, 0, 3)
    teams = 2 if p.tile == 64 else 1
    records = []
    for s in range(p.splits):
        accs = [np.zeros((n, n), np.float32) for _ in range(teams)]
        for local, i in enumerate(range(s * per, min(ksteps, (s + 1) * per))):
            hh = h[i] @ h[i].transpose(0, 2, 1)                  # (4, n, n)
            if single:
                prods = [hh[k] for k in range(4)]
            else:
                lh = lw[i] @ h[i].transpose(0, 2, 1)
                hl = h[i] @ lw[i].transpose(0, 2, 1)
                prods = [q[k] for k in range(4) for q in (lh, hl, hh)]
            stage = prods[0].astype(np.float32)
            for q in prods[1:]:
                stage = (stage + q).astype(np.float32)
            accs[local % teams] += stage
        records.append(accs[0] + accs[1] if teams == 2 else accs[0])
    groups = []
    for g0 in range(0, p.splits, p.group):
        acc = records[g0].copy()
        for r in records[g0 + 1:g0 + p.group]:
            acc += r
        groups.append(acc)
    total = groups[0].copy()
    for g in groups[1:]:
        total += g
    return total


def _cosines(gram, x):
    """G · (inv_i · inv_j), inv = 1 / sqrt(Σ x²) from fp32 sums of squares
    taken over the plan's splits and added in order, as the kernel does."""
    n, d = x.shape
    p = cosine_sim.plan(n, d, SMS)
    ksteps = -(-d // cosine_sim.KSTEP)
    cols = cosine_sim.KSTEP * -(-ksteps // p.splits)          # one split's columns
    sq = np.zeros(n, np.float32)
    for c0 in range(0, d, cols):
        sq += np.square(x[:, c0:c0 + cols]).sum(axis=1, dtype=np.float32)
    inv = np.where(sq > 0, np.float32(1) / np.sqrt(sq), np.float32(0)).astype(np.float32)
    return gram * (inv[:, None] * inv[None, :])


def _cos64(x):
    x64 = x.astype(np.float64)
    nrm = np.linalg.norm(x64, axis=1, keepdims=True)
    xn = x64 / np.where(nrm > 0, nrm, 1.0)
    return xn @ xn.T


@pytest.fixture(scope="module")
def emulated():
    out = {}
    for n, d in ((64, 153610), (512, 20000)):
        x = _spread(n, d, seed=n + d)
        out[(n, d)] = (_cosines(_emulated_gram(x), x), _cosines(_emulated_gram(x, True), x),
                       _cos64(x))
    return out


@pytest.mark.parametrize("n,d", [(64, 153610), (512, 20000)])
def test_3xtf32_cosines_within_1e6_of_float64(emulated, n, d):
    three, _one, exact = emulated[(n, d)]
    assert np.abs(exact).max() <= 1.0 + 1e-12
    assert np.abs(three.astype(np.float64) - exact).max() <= TOL


@pytest.mark.parametrize("n,d", [(64, 153610), (512, 20000)])
def test_single_tf32_exceeds_the_bound_3xtf32_keeps(emulated, n, d):
    three, one, exact = emulated[(n, d)]
    err1 = np.abs(one.astype(np.float64) - exact).max()
    err3 = np.abs(three.astype(np.float64) - exact).max()
    assert err1 > TOL and err1 > 10 * err3


def test_tf32_split_is_exact_to_fp32():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=4096) * 10.0 ** rng.integers(-6, 6, size=4096)).astype(np.float32)
    hi = _tf32(x)
    lo = _tf32(x - hi)
    assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()
    # hi + lo carries 22 of fp32's 24 significant bits
    rel = np.abs((hi.astype(np.float64) + lo) - x) / np.abs(x)
    assert rel.max() <= 2.0 ** -21


@pytest.mark.parametrize("k,d,pad_to", [(5, 40, 64), (64, 153610, 64), (6, 8192, 0),
                                        (3, 7, 4)])
def test_padded_means_rows_are_mappable_and_equal_the_means(k, d, pad_to):
    rng = np.random.default_rng(k + d)
    cs = ClusterState(tau=0.5)
    reps = rng.normal(size=(k + 1, d)).astype(np.float32)
    cs.observe(range(k + 1), list(reps))
    cs.uf.union(0, k)                                 # k clusters
    roots, x = cs.padded_means(pad_to)
    _, means = cs.cluster_means()
    assert means.is_contiguous() and len(roots) == k
    assert x.stride(1) == 1 and x.stride(0) % cosine_sim.ROW_ALIGN == 0
    assert x.stride(0) >= d and x.shape[1] == d
    assert torch.equal(x[:k], means) and not x[k:].any()
    assert x.shape[0] == (-(-k // pad_to) * pad_to if pad_to else k)


@pytest.mark.parametrize("d", [16, 153610])
def test_device_merge_input_rows_are_mappable_and_equal_the_gather(monkeypatch, d):
    rng = np.random.default_rng(d)
    state = tdc.init_state(16, d)
    reps = torch.from_numpy(rng.normal(size=(11, d)).astype(np.float32))
    state = tdc.observe(state, torch.arange(11, dtype=torch.int32), reps)
    state = tdc.union(state, 2, 7)
    state = tdc.union(state, 3, 9)
    k_max = 12
    seen = []
    real = ops.merge_pairs

    def record(means, live, tau, backend="auto"):
        seen.append(means)
        return real(means, live, tau, backend=backend)

    monkeypatch.setattr(ops, "merge_pairs", record)
    tdc.merge_round_impl(state, 0.99, k_max)
    (x,) = seen
    # the contiguous gather of the same rows
    _root, means_ext, counts_ext = tdc._segment_means(state)
    rows = tdc._live_rows(counts_ext, state.capacity, k_max).long()
    want = means_ext[rows]
    assert want.is_contiguous() and x.shape == want.shape
    assert x.stride(1) == 1 and x.stride(0) % cosine_sim.ROW_ALIGN == 0
    assert torch.equal(x, want)


def test_wrapper_maps_padded_rows_and_copies_the_rest(monkeypatch):
    """The operand rule, on tensors whose data pointers the CPU gives: a
    row-padded view is taken as it is, a contiguous matrix whose row stride
    is not a multiple of 16 bytes is copied once and counted, and a matrix
    without contiguous rows is refused."""
    x = cosine_sim.row_padded(5, 7, "cpu")
    x.copy_(torch.arange(35, dtype=torch.float32).view(5, 7))
    before = cosine_sim.padded_copies
    y, stride = cosine_sim._mappable(x)
    assert y is x and stride == 32 and cosine_sim.padded_copies == before
    z = torch.arange(35, dtype=torch.float32).view(5, 7)
    y, stride = cosine_sim._mappable(z)
    assert stride == 32 and torch.equal(y, z) and cosine_sim.padded_copies == before + 1
    y, stride = cosine_sim._mappable(torch.zeros(5, 8))
    assert stride == 8 and cosine_sim.padded_copies == before + 1
    with pytest.raises(ValueError):
        cosine_sim._mappable(torch.zeros(8, 5).T)
