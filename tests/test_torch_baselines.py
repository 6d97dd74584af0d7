"""The port's baseline strategies (FedAvg, FedProx, Ditto, IFCA, CFL),
held against the JAX engine round by round on the CPU.

Both engines start from one federation (numpy, one seed) and the same
initial parameters (the reference's, converted); IFCA's hypotheses, which
the reference perturbs with ``jax.random`` draws, are fed in from the
reference. Integer bookkeeping must match exactly every round: cohorts,
``sampled``, IFCA's choices, CFL's ``members`` and ``n_clusters``. Floats
(ω, bank rows, Ditto's personal rows) agree within atol 1e-5: the two
frameworks sum in different orders, and after a few fp32 SGD steps the
models differ by ~1e-7. Accuracies from ``evaluate`` agree within 1e-6.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import engine as jengine  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.engine import strategies as jstrategies  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import engine as tengine  # noqa: E402
from repro_torch.kernels import prox_update  # noqa: E402
from repro_torch.models import simple as tsimple  # noqa: E402

ATOL = 1e-5
ROUNDS = 3
J_TASK = dataclasses.replace(jsimple.SYNTH_MLP, hidden=32)
T_TASK = tsimple.TaskConfig("synth_mlp", "mlp", (64,), 10, hidden=32)
# eps_rel 0.7 makes the reference's CFL split in each of the 3 rounds here
KNOBS = {"fedavg": {}, "fedprox": {"mu": 0.05}, "ditto": {"mu": 0.05},
         "ifca": {"n_models": 3}, "cfl": {"eps_rel": 0.7, "eps2": 0.01}}


def _jloss(p, b):
    return jsimple.loss_fn(p, b, J_TASK)


def _tloss(p, b):
    return tsimple.loss_fn(p, b, T_TASK)


def _jacc(p, b):
    return jsimple.accuracy(p, b, J_TASK)


def _tacc(p, b):
    return tsimple.accuracy(p, b, T_TASK)


def _pair(name, fused, arena, chunk=0):
    """Both engines at round 0, from the same start."""
    clients, tc, tests = jsynthetic.pathological(n_clients=12, n_per=16, seed=5)
    params = jsimple.init(jax.random.PRNGKey(0), J_TASK)
    kw = dict(lr=0.1, local_steps=2, sample_rate=0.5, seed=0, fused_step=fused,
              cohort_chunk=chunk, **KNOBS[name])
    js = jengine.init(name, _jloss, params, clients, jengine.EngineConfig(**kw),
                      eval_fn=jax.jit(_jacc), arena=arena)
    ts = tengine.init(name, _tloss, convert.to_torch(params), clients,
                      tengine.EngineConfig(**kw), eval_fn=_tacc, device="cpu",
                      arena=arena)
    if name == "ifca":
        ts = ts.replace(models=tengine.ClusterBank.from_dict(
            {m: convert.to_torch(js.models[m]) for m in js.models.roots}))
    return js, ts, tc, tests


def _close(j_tree, t_tree, what):
    a = convert.to_numpy(convert.to_torch(j_tree))
    b = convert.to_numpy(t_tree)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=ATOL,
                                   err_msg=f"{what}/{k}")


def _assert_states_agree(js, ts):
    _close(js.omega, ts.omega, "omega")
    assert tuple(js.models.roots) == tuple(ts.models.roots)
    for r in js.models.roots:
        _close(js.models[r], ts.models[r], f"bank row {r}")
    assert sorted(js.personal) == sorted(ts.personal)
    for c in js.personal:
        _close(js.personal[c], ts.personal[c], f"personal {c}")
    assert js.members == ts.members


def _ifca_choices(js, ts, ids):
    m = js.ctx.cfg.n_models
    hyps = js.models.take(np.arange(m), js.ctx.init_params)
    losses = jstrategies.IFCAStrategy()._choice(js.ctx)(
        hyps, jstrategies._batches(js.ctx, ids))
    want = np.argmin(np.asarray(losses), axis=1)
    got = tengine.get_strategy("ifca").choices(ts.ctx, ts, ids)
    return want, got


def _step(js, ts):
    """One round of both engines; asserts the bookkeeping and returns the
    new states."""
    strat = tengine.get_strategy(ts.strategy)
    if strat.full_participation:
        jids = tids = None
    else:
        _, jids = jengine.sample_clients(js)
        _, tids = tengine.sample_clients(ts)
        assert np.array_equal(np.asarray(jids), np.asarray(tids))
    if ts.strategy == "ifca":
        want, got = _ifca_choices(js, ts, np.asarray(jids))
        assert np.array_equal(want, got)
    js, jrec = jengine.run_round(js)
    ts, trec = tengine.run_round(ts)
    assert jrec == trec
    _assert_states_agree(js, ts)
    return js, ts


CASES = [(name, fused, arena) for name in sorted(KNOBS)
         for fused in (True, False) for arena in (False, True)]


@pytest.mark.parametrize("name,fused,arena", CASES,
                         ids=[f"{n}-{'fused' if f else 'tree'}-{'arena' if a else 'restack'}"
                              for n, f, a in CASES])
def test_rounds_match_reference(name, fused, arena):
    js, ts, _, _ = _pair(name, fused, arena)
    _assert_states_agree(js, ts)
    before = prox_update.theta_launches
    splits = []
    for _ in range(ROUNDS):
        js, ts = _step(js, ts)
        splits.append(len(ts.members or ()))
    assert prox_update.theta_launches == before     # CPU: no kernel launch
    assert ts.round == js.round == ROUNDS
    if name == "cfl":
        assert splits[-1] > 1, splits              # the reference split


@pytest.mark.parametrize("name", ["ifca", "cfl"])
def test_cohort_chunk_smaller_than_cohort(name):
    """cohort_chunk 4 under cohorts of 6 (IFCA) and 12 (CFL): the chunked
    steps run padded, on both engines."""
    js, ts, _, _ = _pair(name, True, True, chunk=4)
    for _ in range(2):
        js, ts = _step(js, ts)


@pytest.mark.parametrize("name", sorted(KNOBS))
def test_evaluate_join_leave_match_reference(name):
    js, ts, tc, tests = _pair(name, True, False)
    for _ in range(2):
        js, ts = _step(js, ts)
    jev = jengine.evaluate(js, tests, tc)
    tev = tengine.evaluate(ts, {k: convert.to_torch(b) for k, b in tests.items()}, tc)
    assert sorted(jev) == sorted(tev)
    assert abs(jev["cluster_avg"] - tev["cluster_avg"]) <= 1e-6
    for k in jev["per"]:
        assert abs(jev["per"][k] - tev["per"][k]) <= 1e-6
    if name not in ("ditto", "cfl"):
        return
    fresh, _, _ = jsynthetic.pathological(n_clients=4, n_per=16, seed=9)
    js, jcid = jengine.join(js, fresh[0])
    ts, tcid = tengine.join(ts, fresh[0])
    assert jcid == tcid == 12
    js = jengine.leave(js, 4)
    ts = tengine.leave(ts, 4)
    assert js.left == ts.left
    _assert_states_agree(js, ts)
    js, ts = _step(js, ts)
