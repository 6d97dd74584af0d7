"""Compile-set pinning battery of the port: ``sanitize.compile_budget`` as a
regression gate on the round programs the port builds, the counterpart of
the reference's ``tests/test_compile_budget.py`` at its sizes
(``rotated(2, 12 × 32)``, the synthetic MLP).

A round program (``engine.api.RoundProgram``, on the card a captured CUDA
graph of 2.8 GiB under churn) is built on each miss in ``scan_program``'s
cache, keyed on the strategy, the cohort size, the carry and const shapes
and the step's statics, as the reference keys its compiled scans. The
pow2-padded pool, sizes vector and arena rows bound that set to O(log
population). So:

* re-running the same transition builds nothing (all six strategies);
* joins inside one pow2 bracket at a constant cohort size build nothing;
* steady async rounds build nothing (they run eagerly), and neither does
  a doubling of the buffer's capacity;
* a warmed join / train / leave / train churn cycle re-uses the set, with
  the budgets and their reasons in ``CHURN_BUDGET``.

Then the one comparison with the JAX package: over a base span and one
churn cycle of StoCFL and FedAvg from the same numpy data and parameters,
the port's new round programs are the reference's new ``scan:`` keys,
span by span; and
``nan_guard`` in both packages raises ``FloatingPointError`` on a poisoned
client batch and nothing on a clean round.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import engine as jengine  # noqa: E402
from repro.analysis import sanitize as jsanitize  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.analysis import sanitize  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.models import simple  # noqa: E402

TASK = simple.SYNTH_MLP
ALL = ["stocfl", "fedavg", "fedprox", "ditto", "ifca", "cfl"]

# Programs a third warm churn cycle may build (the reference's
# CHURN_BUDGET: 0, StoCFL 64 for its host bank rebuild, which the port runs
# as eager ops and does not count). StoCFL's step takes the merge pass's
# live-cluster bound k_bound as a static, a power of two that steps down
# as the partition settles (16 -> 8 -> 4 here); each new (cohort size,
# k_bound) pair is a program, so a cycle, which runs two cohort sizes, may
# build one for each. The others' steps have no data-dependent static: 0.
CHURN_BUDGET = {name: 0 for name in ALL}
CHURN_BUDGET["stocfl"] = 2
# A doubling of the async buffer's capacity (the reference's budget 16:
# its per-capacity row programs): the port's buffer rows move by eager
# ops, so growth builds no program.
GROWTH_BUDGET = 0


@pytest.fixture(autouse=True)
def _one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _loss(p, b):
    return simple.loss_fn(p, b, TASK)


def _fed(n_clients=12, n_per=32, seed=3):
    clients, _, _ = synthetic.rotated(n_clusters=2, n_clients=n_clients, n_per=n_per,
                                      seed=seed)
    return clients


def _knobs(name, **kw):
    kw.setdefault("local_steps", 2)
    kw.setdefault("sample_rate", 0.5)
    kw.setdefault("seed", 0)
    kw.setdefault("rng_backend", "device")
    if name == "stocfl":
        kw.setdefault("cluster_backend", "device")
    if name == "cfl":
        kw["sample_rate"] = 1.0
        kw.setdefault("eps_rel", 0.9)
        kw.setdefault("eps2", 1e-4)
    return kw


def _jparams():
    return jsimple.init(jax.random.PRNGKey(0), jsimple.SYNTH_MLP)


def _init(name, clients, params=None, **kw):
    params = convert.to_torch(_jparams()) if params is None else params
    return engine.init(name, _loss, params, clients, engine.EngineConfig(**_knobs(name, **kw)),
                       device="cpu", arena=True)


def _churn_cycle(st, batch):
    """join -> train -> leave -> train: the canonical population churn."""
    st, cid = engine.join(st, batch)
    st = engine.run_rounds(st, 2)
    st = engine.leave(st, cid)
    return engine.run_rounds(st, 2)


@pytest.mark.parametrize("name", ALL)
def test_rerun_same_transition_pins_to_zero(name):
    """``run_rounds`` is a pure transition: replaying it on the same state
    builds nothing."""
    st = _init(name, _fed())
    engine.run_rounds(st, 2)
    with sanitize.compile_budget(0):
        st2 = engine.run_rounds(st, 2)
        st3 = engine.run_rounds(st, 5)          # the span length is not a key
    assert st2.round == st.round + 2 and st3.round == st.round + 5


def test_joins_within_pow2_bracket_add_zero_programs():
    """12 -> 16 clients stays in the pow2-16 pool / sizes / row bracket, and
    sample_rate 0.25 keeps the cohort at 4: three joins and six rounds
    re-use every program."""
    extra = _fed(n_clients=4, seed=11)
    st = _init("fedavg", _fed(), sample_rate=0.25)
    st = engine.run_rounds(st, 2)
    st, _ = engine.join(st, extra[0])           # n = 13: warms join + arena growth
    st = engine.run_rounds(st, 2)
    with sanitize.compile_budget(0) as log:
        for batch in extra[1:]:                 # n = 14, 15, 16
            st, _ = engine.join(st, batch)
            st = engine.run_rounds(st, 2)
    assert log.count == 0
    assert st.n_clients == 16 and st.round == 10


@pytest.mark.parametrize("name", ["stocfl", "fedavg"])
def test_steady_async_rounds_compile_zero_programs(name):
    """Steady async rounds (constant cohort and delay) build no program."""
    st = _init(name, _fed(), async_cfg=engine.AsyncConfig())
    d = np.ones(6, np.int64)
    for _ in range(6):
        st, _ = engine.run_round_async(st, delays=d)
    with sanitize.compile_budget(0):
        for _ in range(3):
            st, rec = engine.run_round_async(st, delays=d)
            assert rec["merged"] == 6
    assert st.round == 9


def test_async_buffer_capacity_brackets_bound_programs():
    """A delay burst that doubles the buffer's row capacity stays within
    ``GROWTH_BUDGET``, and the grown buffer is steady again."""
    st = _init("fedavg", _fed(), async_cfg=engine.AsyncConfig(buffer_capacity=8,
                                                              staleness_cap=8))
    z = np.zeros(6, np.int64)
    for _ in range(3):
        st, _ = engine.run_round_async(st, delays=z)
    assert st.buffer.capacity == 8
    with sanitize.compile_budget(GROWTH_BUDGET, log_names=True) as log:
        st, _ = engine.run_round_async(st, delays=np.full(6, 4, np.int64))
        st, _ = engine.run_round_async(st, delays=np.full(6, 4, np.int64))
    assert st.buffer.capacity == 16
    assert log.count <= GROWTH_BUDGET, log.describe()
    for _ in range(4):
        st, _ = engine.run_round_async(st, delays=z)
    with sanitize.compile_budget(0):
        st, _ = engine.run_round_async(st, delays=z)


@pytest.mark.parametrize("name", ALL)
def test_churn_cycle_compile_set_pinned(name):
    """After two warm churn cycles a third stays within CHURN_BUDGET (n
    grows 13 -> 14 -> 15 under the pow2-16 shape set)."""
    extra = _fed(n_clients=4, seed=11)
    st = _init(name, _fed())
    st = engine.run_rounds(st, 2)
    st = _churn_cycle(st, extra[0])
    st = _churn_cycle(st, extra[1])
    with sanitize.compile_budget(CHURN_BUDGET[name], log_names=True) as log:
        st = _churn_cycle(st, extra[2])
    assert log.count <= CHURN_BUDGET[name], log.describe()
    assert st.n_clients == 15


# ===================================================== against the JAX package
def _jinit(name, clients, **kw):
    jclients = [jax.tree.map(jnp.asarray, c) for c in clients]
    cfg = jengine.EngineConfig(**_knobs(name, **kw))
    return jengine.init(name, lambda p, b: jsimple.loss_fn(p, b, jsimple.SYNTH_MLP),
                        _jparams(), jclients, cfg, arena=True)


def _scan_ms(keys):
    """(strategy, cohort size) of each ``scan:`` key, port (``scan:s:m:h``)
    or reference (``scan:s:rounds:m:h``)."""
    out = []
    for k in keys:
        parts = k.split(":")
        out.append((parts[1], int(parts[-2])))
    return sorted(out)


@pytest.mark.parametrize("name", ["stocfl", "fedavg"])
def test_new_round_programs_match_the_reference_scan_keys(name):
    """Over a base span and one churn cycle from the same numpy data and
    parameters (one local step, to keep the reference's compiles short),
    the port's new round programs are the reference's new ``scan:`` keys,
    span by span, by strategy and cohort size. The one difference by
    design: the reference keys a scan on its span length too
    (``scan:s:rounds:m:…``), the port's program holds one round and is
    keyed without it; every span here runs 2 rounds, so the sets agree."""
    clients, extra = _fed(), _fed(n_clients=4, seed=11)
    st, jst = _init(name, clients, local_steps=1), _jinit(name, clients, local_steps=1)
    seen = set()

    def new_jax_keys(state):
        keys = {k for k in state.ctx.cache if k.startswith("scan:")}
        fresh = keys - seen
        seen.update(keys)
        return _scan_ms(fresh)

    with sanitize.compile_budget(log_names=True) as log:
        st = engine.run_rounds(st, 2)
    jst = jengine.run_rounds(jst, 2)
    per_cycle = [(_scan_ms(log.names), new_jax_keys(jst))]
    for batch in extra[:1]:
        with sanitize.compile_budget(log_names=True) as log:
            st = _churn_cycle(st, batch)
        jst, cid = jengine.join(jst, jax.tree.map(jnp.asarray, batch))
        jst = jengine.run_rounds(jst, 2)
        jst = jengine.leave(jst, cid)
        jst = jengine.run_rounds(jst, 2)
        per_cycle.append((_scan_ms(log.names), new_jax_keys(jst)))
    for ours, theirs in per_cycle:
        assert ours == theirs, per_cycle
    assert [len(o) for o, _ in per_cycle] == [1, 2]


def test_nan_guard_in_both_packages_on_a_poisoned_batch():
    """The same numpy clients, one of them poisoned with a NaN feature:
    ``nan_guard`` raises ``FloatingPointError`` in both packages on a
    round that trains it, and nothing on a clean round."""
    clients = _fed()
    bad = [dict(c) for c in clients]
    x = np.array(bad[0]["x"], copy=True)
    x[0, 0] = np.nan
    bad[0]["x"] = x
    ids = np.arange(6)
    st, jst = _init("fedavg", clients, local_steps=1), _jinit("fedavg", clients, local_steps=1)
    with sanitize.nan_guard():
        engine.run_round(st, ids)
    with jsanitize.nan_guard():
        jengine.run_round(jst, ids)
    st, jst = _init("fedavg", bad, local_steps=1), _jinit("fedavg", bad, local_steps=1)
    with pytest.raises(FloatingPointError):
        with sanitize.nan_guard():
            engine.run_round(st, ids)
    with pytest.raises(FloatingPointError):
        with jsanitize.nan_guard():
            jengine.run_round(jst, ids)
