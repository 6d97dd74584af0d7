"""The port's CUDA kernels against their plain versions, on the card, and
the device clustering backend's purity there.

Marked ``cuda``: they skip without a GPU and run there with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py

This file imports only torch and the port (the GPU machine has no JAX).
Tolerances: prox_update fp32 within 1e-6 abs (the kernel rounds the same
operations in the same order), bf16 within 1 ulp; its local-SGD form
(prox_theta) bitwise equal to its plain version in fp32 and bf16, the
anchor's bytes unchanged; cosine_sim within 1e-5
(3xTF32 on the tensor cores, summed in another order than the plain
matmul; within ~1e-6 of float64, as tests/test_torch_cosine_tf32.py
emulates). ssm_scan's saved
states and its gradients of dA and dBx must equal the plain versions
exactly (the same roundings in the same order); y and the gradient of C
within 1e-5 of their largest magnitude plus 1e-5 (sums over n and over d
in another order: the error scales with the summed magnitudes, not with
an entry that cancels). merge_candidates,
resolve_roots and component_labels must be exactly equal. The candidate inputs spread their
cosines over (-1, 1) and each τ sits between two neighbouring float64
cosines, at least 1e-5 from every pair (checked before the comparison):
the ~1e-6 difference between the kernel's and the plain version's cosines
cannot flip a pair, while an error in the kernel's arithmetic larger than
the gap to τ does. The serving engine's captured decode burst must equal
the same steps run eagerly, bitwise (the same kernels on the same inputs).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (cosine_sim, prox_update, ref,  # noqa: E402
                                 resolve_roots, ssm_scan)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,offset", [(1, 0), (1001, 0), (65537, 1), (300000, 0)])
def test_prox_update_kernel_in_place(dev, dtype, n, offset):
    g = torch.Generator().manual_seed(n)
    ops_ = [torch.randn(n + offset, generator=g).to(dtype).to(dev)[offset:]
            for _ in range(4)]
    want_t, want_o = ref.prox_update_ref(*ops_, 0.1, 0.05)
    th, om = ops_[0], ops_[1]
    ptrs = (th.data_ptr(), om.data_ptr())
    before = prox_update.launches
    prox_update.prox_update_flat(th, om, ops_[2], ops_[3], 0.1, 0.05)
    torch.cuda.synchronize()
    assert prox_update.launches == before + 1
    assert (th.data_ptr(), om.data_ptr()) == ptrs
    if dtype == torch.float32:
        assert float((th - want_t).abs().max()) <= 1e-6
        assert float((om - want_o).abs().max()) <= 1e-6
    else:
        bits = lambda a: a.view(torch.int16).to(torch.int32)
        assert int((bits(th) - bits(want_t)).abs().max()) <= 1
        assert int((bits(om) - bits(want_o)).abs().max()) <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,period,offset,anchor", [
    (1, 1001, 0, "theta"), (1, 65537, 1, "theta"), (40, 153610, 0, "theta"),
    (1, 1001, 0, "full"), (3, 65537, 1, "full"),
    (40, 153610, 0, "broadcast"), (7, 1001, 1, "broadcast"), (5, 1, 0, "broadcast")])
def test_prox_theta_kernel_matches_plain(dev, dtype, rows, period, offset, anchor):
    """K1's local-SGD form, θ only, in place: λ = 0 with the anchor θ
    itself, λ = μ with an anchor of θ's length or a (P,) anchor broadcast
    over the rows; ragged lengths and misaligned starts take the tail and
    the scalar loop."""
    n = rows * period
    g = torch.Generator().manual_seed(n + offset)
    th, gr = (torch.randn(n + offset, generator=g).to(dtype).to(dev)[offset:]
              for _ in range(2))
    a = {"theta": th, "full": torch.randn(n, generator=g),
         "broadcast": torch.randn(period, generator=g)}[anchor]
    a = a.to(dtype).to(dev)
    lam = 0.0 if anchor == "theta" else 0.05
    want = ref.prox_theta_ref(th, a, gr, 0.1, lam)
    keep = a.clone()
    ptr = th.data_ptr()
    before = prox_update.theta_launches
    prox_update.prox_theta_flat(th, a, gr, 0.1, lam)
    torch.cuda.synchronize()
    assert prox_update.theta_launches == before + 1
    assert th.data_ptr() == ptr
    assert torch.equal(th.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    if anchor != "theta":
        assert torch.equal(a, keep)


@pytest.mark.parametrize("n,d,zero_from", [(5, 7, 4), (64, 20000, 44),
                                           (130, 1000, 129), (300, 4096, 290)])
def test_cosine_kernel_matches_plain(dev, n, d, zero_from):
    g = torch.Generator().manual_seed(d)
    x = torch.randn(n, d, generator=g)
    x[zero_from:] = 0.0
    x = x.to(dev)
    got = cosine_sim.cosine_sim(x)
    want = ref.cosine_sim_ref(x)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5
    assert bool((got[zero_from:] == 0).all() and (got[:, zero_from:] == 0).all())


@pytest.mark.parametrize("name", ["cosine_sim", "merge_candidates"])
@pytest.mark.parametrize("d,layout,copies", [(153610, "contiguous", 1), (153610, "padded", 0),
                                             (1001, "contiguous", 1), (8192, "contiguous", 0)])
def test_cosine_kernels_map_rows_or_copy_them_once(dev, name, d, layout, copies):
    """TMA needs a row stride that is a multiple of 16 bytes: a contiguous
    (N, D) with D·4 not a multiple of 16 is copied into the row-padded
    layout once, counted in ``padded_copies``; a row-padded view, or a
    contiguous matrix whose rows are already 16-byte multiples, is mapped
    as it is. One launch a call either way."""
    x_np, live_np = _spread_means(64, d, 14, seed=d)   # rows 50, 55, 60 zero
    x = torch.from_numpy(x_np)
    if layout == "padded":
        x = cosine_sim.row_padded(64, d, dev).copy_(x)
        assert x.stride(0) % cosine_sim.ROW_ALIGN == 0 and not x.is_contiguous()
    else:
        x = x.to(dev)
    live = torch.from_numpy(live_np).to(dev)
    (tau,) = _taus_between(_cos64(x_np), live_np, 1)
    before = (cosine_sim.padded_copies, cosine_sim.launches, cosine_sim.candidate_launches)
    if name == "cosine_sim":
        got, want = cosine_sim.cosine_sim(x), ref.cosine_sim_ref(x)
    else:
        got, want = cosine_sim.merge_candidates(x, live, tau), ref.merge_candidates_ref(x, live, tau)
    torch.cuda.synchronize()
    after = (cosine_sim.padded_copies, cosine_sim.launches, cosine_sim.candidate_launches)
    assert after[0] - before[0] == copies
    assert (after[1] - before[1], after[2] - before[2]) == \
        ((1, 0) if name == "cosine_sim" else (0, 1))
    if name == "cosine_sim":
        zero = torch.tensor([50, 55, 60], device=dev)
        assert float((got - want).abs().max()) <= (1e-4 if d >= 100_000 else 1e-5)
        assert not bool(got[zero].any() or got[:, zero].any())
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("n,d", [(64, 153610), (300, 4096), (512, 20000)])
def test_cosine_kernels_are_bitwise_repeatable_one_launch_a_call(dev, n, d):
    """The split-K partials are summed in a fixed order whichever block
    arrives last: two calls give the same bits, each one launch."""
    g = torch.Generator().manual_seed(n + d)
    x = cosine_sim.row_padded(n, d, dev)
    x.copy_(torch.randn(n, d, generator=g))
    live = torch.ones(n, dtype=torch.bool, device=dev)
    k2, k3 = cosine_sim.launches, cosine_sim.candidate_launches
    a, b = cosine_sim.cosine_sim(x), cosine_sim.cosine_sim(x)
    c, e = cosine_sim.merge_candidates(x, live, 0.01), cosine_sim.merge_candidates(x, live, 0.01)
    torch.cuda.synchronize()
    assert (cosine_sim.launches - k2, cosine_sim.candidate_launches - k3) == (2, 2)
    assert torch.equal(a, b) and torch.equal(c, e)
    assert torch.equal(a, a.T) and torch.equal(c, c.T)


def test_cosine_kernel_rejects_bf16(dev):
    with pytest.raises(TypeError):
        cosine_sim.cosine_sim(torch.zeros(4, 4, dtype=torch.bfloat16, device=dev))


def _spread_means(n, d, n_dead, seed):
    """n rows mixing three shared directions with per-row weights, plus a
    little noise: their cosines spread evenly over (-1, 1). The last
    ``n_dead`` rows are dead and every fifth dead row is zero."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)) @ rng.normal(size=(3, d)) + 0.05 * rng.normal(size=(n, d))
    live = np.ones(n, bool)
    live[n - n_dead:] = False
    x[n - n_dead::5] = 0.0
    return x.astype(np.float32), live


def _cos64(x):
    x64 = x.astype(np.float64)
    nrm = np.linalg.norm(x64, axis=1, keepdims=True)
    xn = np.where(nrm > 0, x64 / np.where(nrm > 0, nrm, 1), 0.0)
    return xn @ xn.T


def _taus_between(cos, live, count, gap=2e-5):
    """``count`` thresholds spread over the live pairs' float64 cosines,
    each the midpoint of two neighbouring cosines at least ``gap`` apart,
    so every pair lies at least gap/2 = 1e-5 from it."""
    i, j = np.triu_indices(len(cos), 1)
    c = np.unique(cos[i, j][live[i] & live[j]])
    ok = np.flatnonzero(np.diff(c) >= gap)
    picks = ok[np.linspace(0, len(ok) - 1, count).round().astype(int)]
    return sorted({float((c[k] + c[k + 1]) / 2) for k in picks})


@pytest.mark.parametrize("n,d,n_dead", [(5, 7, 1), (64, 20000, 20),
                                        (130, 1000, 3), (512, 4096, 0)])
def test_merge_candidates_kernel_matches_plain(dev, n, d, n_dead):
    """At thresholds placed between neighbouring cosines (so a cosine off
    by more than its gap to τ flips a pair), and at τ = -1.5 (every live
    off-diagonal pair), the kernel equals the plain version and the float64
    decision."""
    x_np, live_np = _spread_means(n, d, n_dead, seed=n + d)
    cos = _cos64(x_np)
    x, live = torch.from_numpy(x_np).to(dev), torch.from_numpy(live_np).to(dev)
    both = live_np[:, None] & live_np[None, :] & ~np.eye(n, dtype=bool)
    for tau in _taus_between(cos, live_np, 16) + [-1.5]:
        assert np.abs(cos[both] - tau).min() >= 1e-5
        before = cosine_sim.candidate_launches
        got = cosine_sim.merge_candidates(x, live, tau)
        want = ref.merge_candidates_ref(x, live, tau)
        torch.cuda.synchronize()
        assert cosine_sim.candidate_launches == before + 1
        assert got.dtype == torch.float32 and got.shape == (n, n)
        assert torch.equal(got, want), tau
        assert np.array_equal(got.cpu().numpy() > 0, both & (cos >= tau)), tau
        assert not bool(got.diagonal().any())


def _forests(n, rng):
    """A random forest (parents point at smaller ids), a chain through a
    random permutation of the ids (the deepest tree), an array that is
    already fully compressed (what the path hands K4), a permutation cycle
    through all the ids (never a fixed point: every step runs) and the
    all-self array."""
    forest = np.arange(n, dtype=np.int32)
    for i in rng.permutation(n)[: n // 2]:
        forest[i] = rng.integers(0, i + 1)
    order = rng.permutation(n).astype(np.int32)
    chain = np.empty(n, np.int32)
    chain[order] = np.concatenate([order[:1], order[:-1]])
    roots = rng.choice(n, size=max(n // 7, 1), replace=False).astype(np.int32)
    compressed = roots[rng.integers(0, len(roots), n)]
    compressed[roots] = roots
    cycle = np.empty(n, np.int32)
    cycle[order] = np.roll(order, -1)
    return {"forest": forest, "chain": chain, "compressed": compressed,
            "cycle": cycle, "self": np.arange(n, dtype=np.int32)}


@pytest.mark.parametrize("n", [1, 31, 37, 512, 4096, 32768, 32769, 65536])
def test_resolve_roots_kernel_matches_plain(dev, n):
    rng = np.random.default_rng(n)
    for kind, parent_np in _forests(n, rng).items():
        parent = torch.from_numpy(parent_np).to(dev)
        before = resolve_roots.launches
        got = resolve_roots.resolve_roots(parent)
        want = ref.resolve_roots_ref(parent)
        torch.cuda.synchronize()
        assert resolve_roots.launches == before + 1
        assert got.dtype == torch.int32
        assert torch.equal(got, want), kind
        assert torch.equal(parent.cpu(), torch.from_numpy(parent_np)), "input written"
        if kind != "cycle":                 # a forest: every entry is a root
            assert torch.equal(got[got.long()], got), kind


def test_resolve_roots_kernel_rejects_int64(dev):
    with pytest.raises(TypeError):
        resolve_roots.resolve_roots(torch.zeros(4, dtype=torch.int64, device=dev))


def _graphs(k, rng):
    """Symmetric (k, k) fp32 0/1 adjacencies with a zero diagonal, as K3
    writes them: none, sparse, dense, a chain through a random order of the
    ids (the most passes), and a few disjoint cliques."""
    order = rng.permutation(k)
    group = rng.integers(0, 4, k)
    out = {"empty": np.zeros((k, k), bool),
           "sparse": rng.random((k, k)) < 2.0 / k,
           "dense": rng.random((k, k)) < 0.5,
           "chain": np.zeros((k, k), bool),
           "cliques": group[:, None] == group[None, :]}
    out["chain"][order[:-1], order[1:]] = True
    for kind, a in out.items():
        a = a | a.T
        np.fill_diagonal(a, False)
        out[kind] = a.astype(np.float32)
    return out


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("k", [1, 64, 512, 1024, 2048, 4096])
def test_component_labels_kernel_matches_plain(dev, k, shared, monkeypatch):
    """Exact labels, one launch a call. The passes read the bit matrix from
    shared memory while k <= 1024 and from the global scratch above; the
    label arrays sit in shared memory up to k = 16,384 and in the scratch
    above. ``shared=False`` forces both global routes at these sizes."""
    if not shared:
        monkeypatch.setattr(resolve_roots, "BITS_SHARED_MAX", 0)
        monkeypatch.setattr(resolve_roots, "LABELS_SHARED_MAX", 0)
    rng = np.random.default_rng(k)
    for kind, adj_np in _graphs(k, rng).items():
        adj = torch.from_numpy(adj_np).to(dev)
        before = resolve_roots.label_launches
        got = resolve_roots.component_labels(adj)
        want = ref.component_labels_ref(adj)
        torch.cuda.synchronize()
        assert resolve_roots.label_launches == before + 1
        assert got.dtype == torch.int32 and got.shape == (k,)
        assert torch.equal(got, want), kind
        if kind == "chain":
            assert not bool(got.any())


def test_component_labels_makes_no_host_sync(dev):
    from repro_torch.kernels import ops
    adj = torch.from_numpy(_graphs(512, np.random.default_rng(0))["cliques"]).to(dev)
    want = ref.component_labels_ref(adj)
    ops.component_labels(adj)                 # builds and loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ops.component_labels(adj)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, want)


def test_component_labels_kernel_rejects_what_it_does_not_take(dev):
    sq = torch.zeros((8, 8), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError):
        resolve_roots.component_labels(torch.zeros((8, 4), device=dev))
    with pytest.raises(TypeError):
        resolve_roots.component_labels(sq.double())
    with pytest.raises(TypeError):
        resolve_roots.component_labels(sq.bfloat16())
    with pytest.raises(ValueError):
        resolve_roots.component_labels(torch.zeros((8, 16), device=dev)[:, ::2])


def test_forked_state_unchanged_by_next_round_on_card(dev):
    """On the card, as on the CPU: a state forked before a round keeps its
    parent, live, Ψ bank and arena rows through the next round, a join and
    a leave (no transition writes a tensor a state holds)."""
    import dataclasses

    from repro_torch import engine
    from repro_torch.data.synthetic import rotated
    from repro_torch.models import simple

    clients, _, _ = rotated(n_clusters=4, n_clients=16, n_per=32, seed=3)
    task = dataclasses.replace(simple.SYNTH_MLP, hidden=32)
    params = simple.init(torch.Generator().manual_seed(0), task)
    loss = lambda p, b: simple.loss_fn(p, b, task)
    cfg = engine.EngineConfig(local_steps=1, sample_rate=0.5, seed=0, fused_step=True,
                              cluster_backend="device")
    st = engine.init("stocfl", loss, params, clients, cfg, device=dev, arena=True)
    st, _ = engine.run_round(st)
    fork = st
    before = {k: v.copy() for k, v in fork.clusters.arrays().items()}
    rows = {k: v.clone() for k, v in fork.ctx.arena.gather(range(16)).items()}
    nxt, _ = engine.run_round(fork)
    nxt, _ = engine.join(nxt, clients[3])
    nxt = engine.leave(nxt, 0)
    nxt, _ = engine.run_round(nxt)
    torch.cuda.synchronize()
    for k, v in fork.clusters.arrays().items():
        assert np.array_equal(before[k], v), k
    again = fork.ctx.arena.gather(range(16))
    for k in rows:
        assert torch.equal(rows[k], again[k]), k
    assert nxt.clusters.seen != fork.clusters.seen


def _near(got, want, rel=1e-5):
    """|got − want| ≤ rel·max|want| + rel, entry by entry."""
    err = float((got.cpu() - want.cpu()).abs().max())
    assert err <= rel * float(want.abs().max()) + rel, err


def _scan_inputs(shape, seed, dev):
    B, S, D, N = shape
    g = torch.Generator().manual_seed(seed)
    dA = torch.rand(shape, generator=g) * 0.5 + 0.5
    dBx, C = torch.randn(shape, generator=g), torch.randn((B, S, N), generator=g)
    g_y = torch.randn((B, S, D), generator=g)
    return [t.to(dev) for t in (dA, dBx, C, g_y)]


@pytest.mark.parametrize("shape", [(2, 32, 32, 16), (1, 37, 48, 16), (3, 19, 45, 16),
                                   (4, 256, 1000, 16), (1, 1, 1, 16)])
def test_ssm_scan_kernels_match_plain(dev, shape):
    dA, dBx, C, g_y = _scan_inputs(shape, sum(shape), dev)
    f0, b0 = ssm_scan.fwd_launches, ssm_scan.bwd_launches
    y, hs = ssm_scan.scan_fwd(dA, dBx, C)
    grads = ssm_scan.scan_bwd(dA, dBx, C, hs, g_y)
    torch.cuda.synchronize()
    assert (ssm_scan.fwd_launches, ssm_scan.bwd_launches) == (f0 + 1, b0 + 1)
    want_y, want_hs = ref.ssm_scan_states_ref(dA, dBx, C, ssm_scan.CHUNK)
    want = ref.ssm_scan_bwd_ref(dA, dBx, C, want_hs, g_y, ssm_scan.CHUNK)
    assert torch.equal(hs, want_hs)
    _near(y, want_y)
    assert torch.equal(grads[0], want[0]) and torch.equal(grads[1], want[1])
    _near(grads[2], want[2])


def test_ssm_scan_backward_is_bitwise_repeatable(dev):
    dA, dBx, C, g_y = _scan_inputs((2, 64, 2000, 16), 7, dev)
    _, hs = ssm_scan.scan_fwd(dA, dBx, C)
    first = ssm_scan.scan_bwd(dA, dBx, C, hs, g_y)
    second = ssm_scan.scan_bwd(dA, dBx, C, hs, g_y)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_ssm_scan_op_under_vmap_launches_once_each_way(dev):
    """The autograd op under torch.func.vmap, as the engine runs the loss:
    one forward and one backward launch for the whole vmapped batch, and
    the gradients of the CPU run (plain versions)."""
    from torch.func import vmap
    shape = (2, 3, 40, 50, 16)
    g = torch.Generator().manual_seed(3)
    dA = torch.rand(shape, generator=g) * 0.5 + 0.5
    dBx, C = torch.randn(shape, generator=g), torch.randn(shape[:3] + (16,), generator=g)
    g_y = torch.randn(shape[:4], generator=g)

    def run(device):
        ins = [t.to(device).requires_grad_(True) for t in (dA, dBx, C)]
        with torch.enable_grad():
            y = vmap(ssm_scan.ssm_scan)(*ins)
            return [y] + list(torch.autograd.grad(y, ins, grad_outputs=g_y.to(device)))

    f0, b0 = ssm_scan.fwd_launches, ssm_scan.bwd_launches
    got = run(dev)
    torch.cuda.synchronize()
    assert (ssm_scan.fwd_launches, ssm_scan.bwd_launches) == (f0 + 1, b0 + 1)
    for a, b in zip(got, run("cpu")):
        _near(a.detach(), b.detach())


def test_ssm_scan_kernels_reject_what_they_do_not_take(dev):
    dA, dBx, C, _ = _scan_inputs((1, 8, 8, 16), 1, dev)
    with pytest.raises(TypeError):
        ssm_scan.scan_fwd(dA.double(), dBx, C)
    with pytest.raises(ValueError):
        ssm_scan.scan_fwd(dA[..., :8], dBx[..., :8], C[..., :8])


def test_falcon_mamba_smoke_loss_and_gradient_on_card(dev):
    """The fp32 smoke model with use_pallas on the card (K5 both ways)
    against the same model on the CPU (plain versions)."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build
    from repro_torch.utils import trees

    cfg = get_config("falcon-mamba-7b", smoke=True, dtype="float32", use_pallas=True)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40)),
                           dtype=torch.int32)

    def run(device):
        p = trees.tree_map(lambda x: x.to(device).requires_grad_(True), params)
        loss = model.loss_fn(p, {"tokens": toks.to(device)})
        return [loss] + list(torch.autograd.grad(loss, trees.leaves(p)))

    f0, b0 = ssm_scan.fwd_launches, ssm_scan.bwd_launches
    got = run(dev)
    torch.cuda.synchronize()
    assert (ssm_scan.fwd_launches - f0, ssm_scan.bwd_launches - b0) == (2, 2)
    for a, b in zip(got, run("cpu")):
        _near(a.detach(), b.detach(), rel=1e-4)


def test_captured_merge_pass_replays_give_the_same_labels(dev):
    """A step of K3 and ``component_labels`` captured in a CUDA graph
    (``engine.api.RoundProgram``: round 0 runs eagerly on the capture
    stream, which allocates the kernels' arrival counters, then one step is
    captured) and replayed twice in a row gives the plain labels each time;
    the kernels leave their arrival counters 0 between replays, and the
    launch counters count the launches that ran (one a round each). The
    labels are held against an eager call of the same kernels."""
    from repro_torch.engine.api import RoundProgram
    from repro_torch.kernels import _build, ops
    k, d, tau = 512, 4096, 0.2
    gen = torch.Generator().manual_seed(5)
    x = cosine_sim.row_padded(k, d, dev)
    x.copy_(torch.randn(k, 3, generator=gen) @ torch.randn(3, d, generator=gen))
    live = torch.rand(k, generator=gen) < 0.8
    want = ops.component_labels(ops.merge_pairs(x, live.to(dev), tau)).cpu()

    def step(carry, cs):
        adj = ops.merge_pairs(cs["x"], cs["live"], tau)
        return carry, {"labels": ops.component_labels(adj)}

    program = RoundProgram(step, dev)
    before = (cosine_sim.candidate_launches, resolve_roots.label_launches)
    carry, ys = program((torch.zeros(1, device=dev),), {"x": x, "live": live.to(dev)}, 3)
    torch.cuda.synchronize()
    assert program.graph is not None and program.capture_s is not None
    for t in range(3):
        assert torch.equal(ys["labels"][t].cpu(), want), t
    assert program.per_round == {"cosine_sim.candidate_launches": 1,
                                 "resolve_roots.label_launches": 1}
    assert (cosine_sim.candidate_launches, resolve_roots.label_launches) == \
        (before[0] + 3, before[1] + 3)
    assert all(int(c.abs().sum()) == 0 for c in _build._counters.values())
    _, ys = program(carry, {"x": x, "live": live.to(dev)}, 2)    # replays only
    torch.cuda.synchronize()
    assert all(torch.equal(ys["labels"][t].cpu(), want) for t in range(2))


def test_arrival_counters_are_not_allocated_under_capture(dev):
    from repro_torch.kernels import _build
    stream = torch.cuda.Stream(dev)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="arrival counters"):
        with torch.cuda.graph(graph, stream=stream):
            _build.arrival_counters(dev, stream.cuda_stream, 1)


@pytest.mark.parametrize("name", ["stocfl", "fedavg", "fedprox", "ditto", "ifca", "cfl"])
def test_run_rounds_on_card_matches_eager(dev, name):
    """``run_rounds`` on the card (a captured round body) against the eager
    loop on the card: cohorts, records, partitions and members equal; ω,
    bank and personal rows within 1e-5 (segment sums use atomics on the
    card, in an order that changes between runs)."""
    from repro_torch import engine
    from repro_torch.data.synthetic import pathological
    from repro_torch.models import simple
    from repro_torch.utils import trees
    task = simple.TaskConfig("synth_mlp", "mlp", (64,), 10, hidden=32)
    clients, _, _ = pathological(n_clients=12, n_per=16, seed=5)
    params = simple.init(torch.Generator().manual_seed(0), task)
    knobs = {"stocfl": {"cluster_backend": "device", "tau": 0.3}, "fedprox": {"mu": 0.05},
             "ditto": {"mu": 0.05}, "ifca": {"n_models": 3},
             "cfl": {"eps_rel": 0.7, "eps2": 0.01}}.get(name, {})
    cfg = engine.EngineConfig(lr=0.1, local_steps=2, sample_rate=0.5, seed=0,
                              rng_backend="device", fused_step=True, **knobs)
    start = engine.init(name, lambda p, b: simple.loss_fn(p, b, task), params, clients,
                        cfg, device=dev, arena=True)
    eager = start
    for _ in range(4):
        eager, _ = engine.run_round(eager)
    scanned = engine.run_rounds(start, 4)
    strip = lambda h: [{k: v for k, v in r.items() if k not in ("merges", "objective")}
                       for r in h]
    assert strip(eager.history) == strip(scanned.history)
    assert torch.equal(eager.rng_key, scanned.rng_key) if eager.rng_key is not None else True
    pairs = [(eager.omega, scanned.omega)]
    assert sorted(eager.models.roots) == sorted(scanned.models.roots)
    pairs += [(eager.models[r], scanned.models[r]) for r in eager.models.roots]
    pairs += [(eager.personal[c], scanned.personal[c]) for c in eager.personal]
    for a, b in pairs:
        for x, y in zip(trees.leaves(a), trees.leaves(b)):
            assert float((x - y).abs().max()) <= 1e-5
    assert eager.members == scanned.members
    if name == "stocfl":
        assert eager.clusters.assignment() == scanned.clusters.assignment()
        assert torch.equal(eager.clusters.state.parent, scanned.clusters.state.parent)


@functools.lru_cache(maxsize=None)
def _serving(arch="qwen2_1_5b"):
    """A smoke model in fp32 served on the card from the serve CLI's state
    (2 clusters), with 6 requests of its request stream."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.registry import build
    cfg = get_config(arch, smoke=True).with_(dtype="float32")
    model = build(cfg)
    state = launch_serve.build_server_state(cfg, model, 2, 0.3, 0, device="cuda")
    return cfg, model, state, launch_serve.make_requests(cfg, 6, 8, 6, 2)


def _engine(slots=2, arch="qwen2_1_5b"):
    from repro_torch import serve
    cfg, model, state, reqs = _serving(arch)
    return serve.ServeEngine(model, state, serve.ServeConfig(slots=slots, max_len=14,
                                                             max_gen=6)), reqs


def _slot_buffers(sl):
    from repro_torch.utils import trees
    return trees.leaves(sl.caches) + list(sl[1:])


def test_captured_decode_burst_equals_eager_steps(dev):
    """The serving engine's burst on the card (one eager warm-up step, the
    capture, then replays of the captured step) against the same steps
    run eagerly from a copy of the lanes: tokens, positions, counters and
    the output buffer equal; the KV caches bitwise equal (the same kernels
    on the same inputs)."""
    from repro_torch.serve import slots
    from repro_torch.utils import trees
    eng, reqs = _engine()
    eng.submit_many(reqs[:4])
    eng._admit_all()
    copy = slots.DecodeSlots(*[trees.tree_map(torch.clone, x) for x in eng.sl])
    eng._decode_burst(4)
    for _ in range(4):
        eng._step(eng._stacked, copy)
    torch.cuda.synchronize()
    assert eng.captures == 1 and eng._graph().graph is not None
    for a, b in zip(_slot_buffers(eng.sl), _slot_buffers(copy)):
        assert torch.equal(a, b)
    assert set(eng.sl.emitted.flatten().tolist()) <= {0, 5} and int(eng.sl.emitted.max()) == 5


def test_decode_burst_makes_no_host_sync(dev):
    """Once captured, a burst is replays only: under sync-debug mode
    "error" it runs without raising; a host read there raises."""
    eng, reqs = _engine()
    eng.submit_many(reqs[:4])
    eng._admit_all()
    eng._decode_burst(1)                       # warm-up and capture
    was = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._decode_burst(3)
        with pytest.raises(RuntimeError):
            eng.sl.token.cpu()
    finally:
        torch.cuda.set_sync_debug_mode(was)
    assert eng.stats()["decode_steps"] == 4


def test_reset_reuses_the_captured_graph(dev):
    """``reset`` keeps the graph (the lanes are zeroed in place): a second
    wave of the same requests captures nothing and serves the same tokens;
    a wave with fewer requests than lanes, the same."""
    from repro_torch import serve
    eng, reqs = _engine()
    eng.submit_many(reqs)
    first = eng.run()
    graph = eng._graph().graph
    eng.reset()
    again = [serve.Request(rid=100 + r.rid, client_id=r.client_id, prompt=r.prompt,
                           gen=r.gen) for r in reqs]
    eng.submit_many(again[:3])
    res = eng.run()
    eng.submit_many(again[3:])
    res.update(eng.run())
    assert eng.captures == 1 and eng._graph().graph is graph
    for r in reqs:
        assert list(res[100 + r.rid].tokens) == list(first[r.rid].tokens)


@pytest.mark.parametrize("arch", ["phi35_moe_42b", "zamba2_1_2b"])
def test_captured_decode_burst_equals_eager_steps_moe_and_hybrid(dev, arch):
    """The captured burst over phi3.5-moe's smoke model (MoE routing per
    row under the cluster vmap) and zamba2's (Mamba2 states and the shared
    block's ring cache) against the same steps run eagerly from a copy of
    the lanes: every buffer bitwise equal; then 3 more replays under
    sync-debug mode "error" make no host sync."""
    from repro_torch.serve import slots
    from repro_torch.utils import trees
    eng, reqs = _engine(arch=arch)
    eng.submit_many(reqs[:4])
    eng._admit_all()
    copy = slots.DecodeSlots(*[trees.tree_map(torch.clone, x) for x in eng.sl])
    eng._decode_burst(2)
    for _ in range(2):
        eng._step(eng._stacked, copy)
    torch.cuda.synchronize()
    assert eng.captures == 1 and eng._graph().graph is not None
    for a, b in zip(_slot_buffers(eng.sl), _slot_buffers(copy)):
        assert torch.equal(a, b)
    was = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._decode_burst(3)
    finally:
        torch.cuda.set_sync_debug_mode(was)
    for _ in range(3):
        eng._step(eng._stacked, copy)
    torch.cuda.synchronize()
    for a, b in zip(_slot_buffers(eng.sl), _slot_buffers(copy)):
        assert torch.equal(a, b)
    assert eng.stats()["decode_steps"] == 5
