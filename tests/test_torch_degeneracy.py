"""§3.4 degeneracy claims on the port, as trajectory tests (the port's
counterpart of ``tests/test_degeneracy.py``): StoCFL's knobs collapse it
onto each baseline, and the port's engine reproduces the baseline's
trajectory round for round.

  τ=1          → Ditto  (no merges: every client is its own cluster, the
                 θ-prox to ω is Ditto's personal prox to the broadcast
                 global; exact at local_steps=1)
  λ=0          → CFL    (with the partition frozen to the same clusters,
                 per-cluster θ updates are plain local SGD + per-cluster
                 FedAvg, CFL's step)
  λ=0 ∧ τ=−1   → FedAvg (single cluster + no prox)

Each pair runs 3 rounds and must match within rtol 2e-6, atol 1e-6 (the
reference test's tolerance) at every round. Then the legacy class shims
(``FedAvg``, ``IFCA``, ``CFLSattler``, ``StoCFL``) must give exactly what
their engine strategies give: the same code runs underneath.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import engine  # noqa: E402
from repro_torch.core import (CFLSattler, FedAvg, FLConfig, IFCA,  # noqa: E402
                              StoCFL, StoCFLConfig)
from repro_torch.data.synthetic import rotated  # noqa: E402
from repro_torch.models import simple  # noqa: E402
from repro_torch.utils import trees  # noqa: E402

TASK = simple.SYNTH_MLP
LOSS = lambda p, b: simple.loss_fn(p, b, TASK)  # noqa: E731

RTOL, ATOL = 2e-6, 1e-6


def _fed(n_clients=8, n_per=24, seed=5):
    clients, tc, tests = rotated(n_clusters=2, n_clients=n_clients,
                                 n_per=n_per, seed=seed)
    return clients, tc


def _params(seed=0):
    return simple.init(torch.Generator().manual_seed(seed), TASK)


def _init(name, cfg, clients, arena=False):
    return engine.init(name, LOSS, _params(), clients, cfg, device="cpu", arena=arena)


def _close(a, b):
    la, lb = trees.leaves(a), trees.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=RTOL, atol=ATOL)


def _equal(a, b):
    la, lb = trees.leaves(a), trees.leaves(b)
    assert len(la) == len(lb)
    assert all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("arena", [False, True], ids=["restack", "arena"])
def test_tau_one_equals_ditto(arena):
    """τ=1, E=1: per-client cluster models ≡ Ditto personal models and
    both ω trajectories coincide, round by round."""
    clients, _ = _fed()
    cfg_s = engine.EngineConfig(tau=1.0, lam=0.05, lr=0.1, local_steps=1,
                                sample_rate=0.5, seed=0)
    cfg_d = engine.EngineConfig(lr=0.1, local_steps=1, sample_rate=0.5, seed=0,
                                mu=0.05)
    sto = _init("stocfl", cfg_s, clients, arena)
    dit = _init("ditto", cfg_d, clients, arena)
    for _ in range(3):
        sto, rs = engine.run_round(sto)
        dit, rd = engine.run_round(dit)
        assert rs["sampled"] == rd["sampled"]
        assert rs["n_clusters"] == len(sto.clusters.seen)   # never merges
        _close(sto.omega, dit.omega)
        for cid in range(len(clients)):                     # singleton root == cid
            _close(sto.cluster_model(cid), dit.personal[cid])


@pytest.mark.parametrize("arena", [False, True], ids=["restack", "arena"])
def test_lam_zero_equals_cfl(arena):
    """λ=0 with the partition frozen: StoCFL discovers it in round 1; CFL
    starts from it (members preset, splits disabled by a huge eps2) with
    the same per-cluster models, and both stay in lockstep for 3 rounds."""
    clients, _ = _fed()
    cfg_s = engine.EngineConfig(tau=0.5, lam=0.0, lr=0.1, local_steps=2,
                                sample_rate=1.0, seed=0)
    sto = _init("stocfl", cfg_s, clients, arena)
    sto, _ = engine.run_round(sto)

    part = {}
    for cid, root in sto.clusters.assignment().items():
        part.setdefault(root, []).append(cid)
    roots = sorted(part)
    assert len(roots) >= 2

    cfg_c = engine.EngineConfig(lr=0.1, local_steps=2, sample_rate=1.0, seed=0,
                                eps2=1e9)
    cfl = _init("cfl", cfg_c, clients, arena)
    cfl = cfl.replace(
        members=tuple(tuple(sorted(part[r])) for r in roots),
        models=engine.ClusterBank.from_dict({k: sto.models[r] for k, r in enumerate(roots)}))
    for _ in range(3):
        sto, _ = engine.run_round(sto)
        cfl, rc = engine.run_round(cfl)
        assert rc["n_clusters"] == len(roots)
        now = {}
        for cid, root in sto.clusters.assignment().items():
            now.setdefault(root, []).append(cid)
        assert sorted(now) == roots
        for k, r in enumerate(roots):
            _close(sto.models[r], cfl.models[k])


@pytest.mark.parametrize("arena", [False, True], ids=["restack", "arena"])
def test_lam_zero_tau_minus_one_equals_fedavg(arena):
    """λ=0 ∧ τ=−1 at full participation: StoCFL's single θ and its ω both
    follow the FedAvg recursion."""
    clients, _ = _fed()
    cfg_s = engine.EngineConfig(tau=-1.0, lam=0.0, lr=0.1, local_steps=2,
                                sample_rate=1.0, seed=0)
    cfg_f = engine.EngineConfig(lr=0.1, local_steps=2, sample_rate=1.0, seed=0)
    sto = _init("stocfl", cfg_s, clients, arena)
    fed = _init("fedavg", cfg_f, clients, arena)
    for _ in range(3):
        sto, rs = engine.run_round(sto)
        fed, rf = engine.run_round(fed)
        assert rs["sampled"] == rf["sampled"] and rs["n_clusters"] == 1
        _close(sto.omega, fed.omega)
        _close(sto.models[min(sto.clusters.seen)], fed.omega)


def test_lam_zero_tau_minus_one_omega_tracks_fedavg_partial():
    """Partial participation (0.5): ω still follows FedAvg exactly."""
    clients, _ = _fed()
    cfg_s = engine.EngineConfig(tau=-1.0, lam=0.0, lr=0.1, local_steps=2,
                                sample_rate=0.5, seed=0)
    cfg_f = engine.EngineConfig(lr=0.1, local_steps=2, sample_rate=0.5, seed=0)
    sto = _init("stocfl", cfg_s, clients)
    fed = _init("fedavg", cfg_f, clients)
    for _ in range(3):
        sto, rs = engine.run_round(sto)
        fed, rf = engine.run_round(fed)
        assert rs["sampled"] == rf["sampled"] and rs["n_clusters"] == 1
        _close(sto.omega, fed.omega)


# ----------------------------------------------------------------- the shims
FL = FLConfig(lr=0.1, local_steps=2, sample_rate=0.5, seed=0, mu=0.05)


def _engine_cfg(**kw):
    return engine.EngineConfig(lr=FL.lr, local_steps=FL.local_steps,
                               sample_rate=FL.sample_rate, seed=FL.seed, mu=FL.mu, **kw)


def test_fedavg_shim_is_its_strategy():
    clients, _ = _fed()
    shim = FedAvg(LOSS, _params(), clients, FL, device="cpu")
    st = _init("fedavg", _engine_cfg(), clients)
    ids = shim.sample()                          # advances the shim's rng
    _, want = engine.sample_clients(st)
    assert np.array_equal(ids, want)
    st = engine.advance_rng(st, engine.sample_clients(st)[0])
    shim.fit(2)
    for _ in range(2):
        st, _ = engine.run_round(st)
    _equal(shim.global_params, st.omega)
    assert shim.n == len(clients) and shim.server_state.round == 2


def test_ifca_shim_is_its_strategy():
    clients, _ = _fed()
    shim = IFCA(LOSS, _params(), clients, FL, n_models=3, init_key=1, device="cpu")
    st = _init("ifca", _engine_cfg(n_models=3, init_key=1), clients)
    assert len(shim.models) == 3
    for m in range(3):
        _equal(shim.models[m], st.models[m])
    shim.fit(2)
    for _ in range(2):
        st, _ = engine.run_round(st)
    for m in range(3):
        _equal(shim.models[m], st.models[m])


def test_cfl_shim_is_its_strategy():
    clients, _ = _fed()
    shim = CFLSattler(LOSS, _params(), clients, FL, eps_rel=0.7, eps2=0.01,
                      device="cpu")
    st = _init("cfl", _engine_cfg(eps_rel=0.7, eps2=0.01), clients)
    for _ in range(2):
        rec = shim.round()
        st, want = engine.run_round(st)
        assert rec == want
    assert shim.clusters == [list(m) for m in st.members]
    for k, model in enumerate(shim.models):
        _equal(model, st.models[k])
    for cid in range(len(clients)):
        assert st.members[shim.cluster_of(cid)].count(cid) == 1


def test_stocfl_shim_is_its_strategy():
    clients, tc = _fed()
    cfg = StoCFLConfig(tau=0.5, lam=0.05, lr=0.1, local_steps=2, sample_rate=0.5,
                       seed=0)
    shim = StoCFL(LOSS, _params(), clients, cfg, device="cpu")
    st = _init("stocfl", engine.EngineConfig(tau=0.5, lam=0.05, lr=0.1, local_steps=2,
                                             sample_rate=0.5, seed=0), clients)
    shim.fit(2)
    for _ in range(2):
        st, _ = engine.run_round(st)
    _equal(shim.omega, st.omega)
    assert shim.state.assignment() == st.clusters.assignment()
    assert tuple(shim.models.roots) == tuple(st.models.roots)
    for r in st.models.roots:
        _equal(shim.models[r], st.models[r])
        assert shim.client_root(r) == st.client_root(r)
    assert len(shim.history) == 2
    fresh, _, _ = rotated(n_clusters=2, n_clients=2, n_per=24, seed=9)
    inf = shim.infer_new_client(fresh[0])
    assert inf["seed_from"] == engine.infer(st, fresh[0])["seed_from"]
    cid = shim.join_client(fresh[0])
    st, want = engine.join(st, fresh[0])
    assert cid == want == len(clients)
    shim.leave_client(cid)
    assert cid in shim.server_state.left
