"""The port's kernel functions on the CPU, held against the JAX package.

On a CPU tensor each wrapper runs its plain version, so these tests pin
the plain versions (and the dispatch and in-place contract around them) to
the reference's Pallas kernels in interpret mode and to its ``ref``
oracles. The CUDA kernels themselves are held against the plain versions
on the card (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.cosine_sim import cosine_sim as j_cosine  # noqa: E402
from repro.kernels.prox_update import prox_update_flat as j_prox  # noqa: E402
from repro_torch.core.clustering import ClusterState  # noqa: E402
from repro_torch.kernels import cosine_sim, ops, prox_update, ref  # noqa: E402

ETA, LAM = 0.1, 0.05


def _operands(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=n).astype(np.float32) for _ in range(4)]


def _bf16_bits(x):
    """bf16 bit patterns as int32, from a JAX array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().astype(np.int32)
    return np.asarray(x).view(np.int16).astype(np.int32)


@pytest.mark.parametrize("n", [1, 7, 256, 1000, 4099])
def test_prox_update_fp32_matches_pallas_and_oracle(n):
    ops_np = _operands(n, seed=n)
    pal_t, pal_o = j_prox(*map(jnp.asarray, ops_np), ETA, LAM, block=256,
                          interpret=True)
    orc_t, orc_o = jref.prox_update_ref(*map(jnp.asarray, ops_np), ETA, LAM)
    th, om, gt, go = (torch.from_numpy(a.copy()) for a in ops_np)
    got_t, got_o = ops.prox_update_flat(th, om, gt, go, ETA, LAM)
    assert got_t is th and got_o is om             # in place
    for want_t, want_o in ((pal_t, pal_o), (orc_t, orc_o)):
        np.testing.assert_allclose(th.numpy(), np.asarray(want_t), rtol=0, atol=1e-6)
        np.testing.assert_allclose(om.numpy(), np.asarray(want_o), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [1, 255, 1000, 4099])
def test_prox_update_bf16_within_one_ulp(n):
    ops_np = _operands(n, seed=100 + n)
    j_ops = [jnp.asarray(a).astype(jnp.bfloat16) for a in ops_np]
    pal_t, pal_o = j_prox(*j_ops, ETA, LAM, block=256, interpret=True)
    orc_t, orc_o = jref.prox_update_ref(*j_ops, ETA, LAM)
    t_ops = [torch.from_numpy(a.copy()).to(torch.bfloat16) for a in ops_np]
    th, om = prox_update.prox_update_flat(*t_ops, ETA, LAM)
    assert th.dtype == om.dtype == torch.bfloat16
    for want_t, want_o in ((pal_t, pal_o), (orc_t, orc_o)):
        assert np.abs(_bf16_bits(th) - _bf16_bits(want_t)).max() <= 1
        assert np.abs(_bf16_bits(om) - _bf16_bits(want_o)).max() <= 1


@pytest.mark.parametrize("backend", ["auto", "torch"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prox_update_flat_writes_in_place_on_both_backends(backend, dtype):
    dt = getattr(torch, dtype)
    th, om, gt, go = (torch.from_numpy(a).to(dt) for a in _operands(513, seed=7))
    want_t, want_o = ref.prox_update_ref(th, om, gt, go, ETA, LAM)
    ptrs = (th.data_ptr(), om.data_ptr())
    got_t, got_o = ops.prox_update_flat(th, om, gt, go, ETA, LAM, backend=backend)
    assert got_t is th and got_o is om
    assert (th.data_ptr(), om.data_ptr()) == ptrs
    assert torch.equal(th, want_t) and torch.equal(om, want_o)


def test_prox_update_tree_matches_flat():
    rng = np.random.default_rng(3)
    shapes = {"w": (4, 5), "b": (5,)}
    mk = lambda: {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  for k, s in shapes.items()}
    th, om, gt, go = mk(), mk(), mk(), mk()
    keep = {k: v.clone() for k, v in th.items()}
    for backend in ("auto", "torch"):
        nt, no = ops.prox_update_tree(th, om, gt, go, ETA, LAM, backend=backend)
        for k in shapes:
            assert torch.equal(th[k], keep[k])      # inputs untouched
            ft, fo = ref.prox_update_ref(th[k].reshape(-1), om[k].reshape(-1),
                                         gt[k].reshape(-1), go[k].reshape(-1),
                                         ETA, LAM)
            assert torch.equal(nt[k].reshape(-1), ft)
            assert torch.equal(no[k].reshape(-1), fo)


@pytest.mark.parametrize("bad", ["shape", "dtype", "length", "layout"])
def test_prox_update_rejects_bad_operands(bad):
    t = [torch.zeros(8) for _ in range(4)]
    if bad == "shape":
        t[0] = torch.zeros(2, 4)
    elif bad == "dtype":
        t[2] = torch.zeros(8, dtype=torch.float64)
    elif bad == "length":
        t[3] = torch.zeros(9)
    else:
        t[1] = torch.zeros(16)[::2]
    with pytest.raises((ValueError, TypeError)):
        prox_update.prox_update_flat(*t, ETA, LAM)


@pytest.mark.parametrize("n,d,zero_rows", [(5, 7, (4,)), (20, 300, (0, 13)),
                                           (33, 129, ())])
def test_cosine_matches_pallas_interpret(n, d, zero_rows):
    rng = np.random.default_rng(n * d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[list(zero_rows)] = 0.0
    want = np.asarray(j_cosine(jnp.asarray(x), bn=16, bk=64, interpret=True))
    oracle = np.asarray(jref.cosine_sim_ref(jnp.asarray(x)))
    for backend in ("auto", "torch"):
        got = ops.pairwise_cosine(torch.from_numpy(x), backend=backend).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, oracle, rtol=0, atol=1e-5)
        for r in zero_rows:
            assert not got[r].any() and not got[:, r].any()


def test_similarity_matrix_pad_rows_are_inert():
    rng = np.random.default_rng(0)
    cs = ClusterState(tau=0.5)
    reps = rng.normal(size=(5, 40)).astype(np.float32)
    cs.observe(range(5), list(reps))
    roots, M = cs.similarity_matrix(pad_to=64)
    assert roots == list(range(5)) and M.shape == (5, 5)
    full = ops.pairwise_cosine(torch.cat([torch.from_numpy(reps),
                                          torch.zeros(59, 40)])).numpy()
    assert not full[5:].any() and not full[:, 5:].any()
    np.testing.assert_array_equal(M, full[:5, :5])


@pytest.mark.parametrize("pad_to,rows", [(64, 64), (4, 8), (5, 5), (0, 5)])
def test_padded_means_is_the_similarity_input(pad_to, rows):
    rng = np.random.default_rng(1)
    cs = ClusterState(tau=0.5)
    reps = rng.normal(size=(6, 40)).astype(np.float32)
    cs.observe(range(6), list(reps))
    cs.uf.union(0, 3)                              # 5 clusters
    roots, x = cs.padded_means(pad_to)
    assert roots == [0, 1, 2, 4, 5] and tuple(x.shape) == (rows, 40)
    _, means = cs.cluster_means()
    assert torch.equal(x[:5], means) and not x[5:].any()
    np.testing.assert_array_equal(cs.similarity_matrix(pad_to)[1],
                                  ops.pairwise_cosine(x).numpy()[:5, :5])


@pytest.mark.parametrize("n,d,sms", [(5, 7, 132), (64, 153610, 132),
                                     (300, 4096, 132), (64, 153610, 114),
                                     (1, 1, 1), (200, 100000, 132)])
def test_cosine_split_plan_covers_the_contraction(n, d, sms):
    """The kernels' plan: every k-step of 32 columns in exactly one split,
    no split empty or (with more than one) under MIN_STEPS k-steps, and
    where D allows two splits' worth a SM, the waves of blocks over the
    upper tiles at least 90% full, so every SM is given work."""
    p = cosine_sim.plan(n, d, sms)
    assert p.tile == (64 if n <= 64 else 128)
    ksteps = -(-d // cosine_sim.KSTEP)
    per = -(-ksteps // p.splits)
    assert p.splits >= 1 and p.splits * per >= ksteps > (p.splits - 1) * per
    assert p.splits == 1 or per >= cosine_sim.MIN_STEPS
    assert p.group * p.group >= p.splits > (p.group - 1) * (p.group - 1)
    tiles = -(-n // p.tile)
    blocks = tiles * (tiles + 1) // 2 * p.splits
    if ksteps >= 2 * sms * cosine_sim.MIN_STEPS:
        assert blocks >= 0.9 * sms * -(-blocks // sms)


def test_cosine_rejects_non_matrix_and_backend():
    with pytest.raises(ValueError):
        cosine_sim.cosine_sim(torch.zeros(4))
    with pytest.raises(ValueError):
        ops.pairwise_cosine(torch.zeros(2, 2), backend="jnp")
