"""The port's device cohort sampler (``repro_torch.engine.sampler``) against
the JAX package's ``repro.engine.sampler`` and ``jax.random``, on the CPU.

threefry-2x32 is integer arithmetic, so the port's ``split``, ``uniform``
and ``draw`` must give the reference's bits exactly: the same keys, the
same float32 uniforms, the same cohort ids in the same order, the same
advanced keys. The properties of ``tests/test_sampler_properties.py`` (no
duplicate, ⌈rate·live⌉ ids clipped to the pool, masked ids never drawn,
the same sequence from the same key) are checked over a seeded sweep and,
where hypothesis is installed, over hypothesis-chosen cases.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import engine as jengine  # noqa: E402
from repro.engine import sampler as jsampler  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import engine as tengine  # noqa: E402
from repro_torch.engine import sampler  # noqa: E402
from repro_torch.models import simple as tsimple  # noqa: E402

SEEDS = (0, 1, 7, 123, 2**31 - 1)


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _words(jkey) -> np.ndarray:
    return np.asarray(jax.random.key_data(jkey)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_fresh_key_is_the_reference_key(seed):
    assert np.array_equal(tengine.fresh_rng_key(seed).numpy(), _words(_jkey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_matches_jax_bitwise(seed):
    key = tengine.fresh_rng_key(seed)
    jk = _jkey(seed)
    for num in (2, 3, 8):
        got = sampler.split(key, num).numpy()
        want = _words(jax.random.split(jk, num))
        assert np.array_equal(got, want), num
    # a chain of splits stays on the reference's keys
    for _ in range(4):
        key, jk = sampler.split(key)[0], jax.random.split(jk)[0]
    assert np.array_equal(key.numpy(), _words(jk))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 7, 4096])
def test_uniform_matches_jax_bitwise(seed, n):
    got = sampler.uniform(tengine.fresh_rng_key(seed), n).numpy()
    want = np.asarray(jax.random.uniform(_jkey(seed), (n,)))
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert ((got >= 0) & (got < 1)).all()


def _sweep_case(i):
    """Case i of the seeded sweep: (population, departed, unavailable,
    rate, seed), populations up to 5000."""
    rng = np.random.default_rng(1000 + i)
    n = int(rng.integers(2, 5000)) if i % 4 else int(rng.integers(2, 64))
    left = set(rng.choice(n, size=int(rng.integers(0, n // 3 + 1)), replace=False).tolist())
    avail = sorted(set(range(n)) - left)
    busy = set(rng.choice(avail, size=int(rng.integers(0, len(avail) // 2 + 1)),
                          replace=False).tolist()) if len(avail) > 1 else set()
    return n, left, busy, float(rng.uniform(0.05, 1.0)), int(rng.integers(0, 2**31 - 1))


@pytest.mark.parametrize("case", range(20))
def test_draw_matches_reference(case):
    """The ids and the advanced key of the reference's ``draw`` over the
    engine's pow2-padded pool, for the cohort size the engine draws."""
    n, left, busy, rate, seed = _sweep_case(case)
    cap = sampler.pool_capacity(n)
    pool = sampler.cohort_pool(n, left, busy, capacity=cap)
    assert np.array_equal(pool, jsampler.cohort_pool(n, left, busy, capacity=cap))
    m = sampler.cohort_size(rate, n - len(left), int(pool.sum()))
    assert m == jsampler.cohort_size(rate, n - len(left), int(pool.sum())) > 0
    key, ids = sampler.draw_cohort(tengine.fresh_rng_key(seed), pool, m)
    jkey, jids = jsampler.draw(_jkey(seed), jnp.asarray(pool), m)
    assert ids.dtype == torch.int64
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    assert np.array_equal(key.numpy(), _words(jkey))


def _check_properties(n, left, busy, rate, seed):
    pool = sampler.cohort_pool(n, left, busy)
    live = n - len(left)
    m = sampler.cohort_size(rate, live, int(pool.sum()))
    assert m == min(int(np.ceil(rate * live)), int(pool.sum()))
    if m == 0:
        return
    _, ids = sampler.draw_cohort(tengine.fresh_rng_key(seed), pool, m)
    ids = set(ids.tolist())
    assert len(ids) == m, "duplicate draw"
    assert not (ids & left), "drew a departed client"
    assert not (ids & busy), "drew an unavailable client"


@pytest.mark.parametrize("case", range(20))
def test_sampler_properties_seeded(case):
    _check_properties(*_sweep_case(case))


def test_sampler_properties_hypothesis():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as hst

    @settings(deadline=None, max_examples=40)
    @given(n=hst.integers(2, 64), rate=hst.floats(0.05, 1.0),
           seed=hst.integers(0, 2**31 - 1), data=hst.data())
    def prop(n, rate, seed, data):
        left = set(data.draw(hst.sets(hst.integers(0, n - 1), max_size=n - 1)))
        avail = sorted(set(range(n)) - left)
        busy = (set(data.draw(hst.sets(hst.sampled_from(avail),
                                       max_size=len(avail) - 1)))
                if len(avail) > 1 else set())
        _check_properties(n, left, busy, rate, seed)

    prop()


@pytest.mark.parametrize("seed", SEEDS)
def test_draws_are_deterministic_from_the_key(seed):
    pool = sampler.cohort_pool(16, {1, 5}, {2})
    k1 = k2 = tengine.fresh_rng_key(seed)
    for _ in range(3):
        k1, a = sampler.draw_cohort(k1, pool, 4)
        k2, b = sampler.draw_cohort(k2, pool, 4)
        assert torch.equal(a, b) and torch.equal(k1, k2)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 400, 4000, 4096, 4097])
def test_pool_capacity_matches_reference(n):
    assert sampler.pool_capacity(n) == jsampler.pool_capacity(n)


@pytest.mark.parametrize("rate,live,pool", [(0.1, 400, 400), (0.1, 4000, 3990),
                                            (0.5, 12, 3), (0.05, 1, 1), (1.0, 7, 0),
                                            (0.3, 0, 5), (0.33, 10, 10)])
def test_cohort_size_matches_reference(rate, live, pool):
    assert sampler.cohort_size(rate, live, pool) == jsampler.cohort_size(rate, live, pool)


def test_engine_device_draw_matches_reference_engine():
    """``sample_clients`` under ``rng_backend="device"``: the JAX engine's
    cohorts and keys over three rounds' draws, with a departed client and
    an unavailable one."""
    j_task = jsimple.SYNTH_MLP
    t_task = tsimple.SYNTH_MLP
    rng = np.random.default_rng(0)
    clients = [{"x": rng.normal(size=(4, 64)).astype(np.float32),
                "y": rng.integers(0, 10, 4).astype(np.int32)} for _ in range(37)]
    params = jsimple.init(jax.random.PRNGKey(0), j_task)
    js = jengine.init("fedavg", lambda p, b: jsimple.loss_fn(p, b, j_task), params,
                      clients, jengine.EngineConfig(sample_rate=0.3, seed=11,
                                                    rng_backend="device"))
    ts = tengine.init("fedavg", lambda p, b: tsimple.loss_fn(p, b, t_task),
                      convert.to_torch(params), clients,
                      tengine.EngineConfig(sample_rate=0.3, seed=11, rng_backend="device"),
                      device="cpu")
    js, ts = jengine.leave(js, 4), tengine.leave(ts, 4)
    for _ in range(3):
        jk, jids = jengine.sample_clients(js, unavailable={9})
        tk, tids = tengine.sample_clients(ts, unavailable={9})
        assert tids.dtype == np.int64 and np.array_equal(tids, np.asarray(jids))
        assert np.array_equal(tk.numpy(), _words(jk))
        js, ts = jengine.advance_rng(js, jk), tengine.advance_rng(ts, tk)
