"""The port's optimisers (``repro_torch.optim``) against the JAX package's
``repro.optim`` on the CPU, on the same inputs made with numpy.

The reference's quadratic (``tests/test_optim_ckpt.py``): both packages
start from zeros and take each optimiser's steps on their own gradients;
both converge, and after 1 and 10 steps every leaf of the port's iterate
is within 1e-6 of the largest magnitude of the reference's. Adam's
``params=None`` branch (m standing in for the parameters, weight decay
included) and bf16 parameters are held likewise (bf16: the same dtypes,
within one bf16 ulp of the largest magnitude: the float32 arithmetic
before the cast rounds differently in the last bits). ``clip_by_global_norm``'s
norm and clipped tree within 1e-6, a schedule's value at every count from
0 to 120 within 1e-7.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.optim.sgd import apply_updates as japply  # noqa: E402
from repro.optim.sgd import clip_by_global_norm as jclip  # noqa: E402
from repro.utils import trees as jtrees  # noqa: E402
from repro_torch import convert, optim  # noqa: E402
from repro_torch.optim.sgd import apply_updates, clip_by_global_norm  # noqa: E402
from repro_torch.utils import trees  # noqa: E402

TOL = 1e-6
SCHEDULE_TOL = 1e-7
BF16_ULP = 2.0 ** -7          # one bf16 ulp, relative to the largest magnitude


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _close(got, want, tol, what):
    """Every leaf of ``got`` (torch) within ``tol`` of the largest
    magnitude of its leaf in ``want`` (JAX), the same dtype."""
    dtypes = [str(x.dtype).removeprefix("torch.") for x in trees.leaves(got)]
    g, w = convert.to_numpy(got), jax.tree.map(np.asarray, want)
    gl, wl = jax.tree.leaves(g), jax.tree.leaves(w)
    assert jax.tree.structure(g) == jax.tree.structure(w), what
    for a, b, dtype in zip(gl, wl, dtypes):
        assert dtype == b.dtype.name and a.shape == b.shape, (what, dtype, b.dtype)
        a64, b64 = a.astype(np.float64), b.astype(np.float64)
        err = float(np.max(np.abs(a64 - b64))) if b.size else 0.0
        assert err <= tol * max(float(np.max(np.abs(b64))), 1e-30), (what, err)


# the reference's quadratic, and each optimiser under both packages' names
TARGET = {"a": np.array([1.0, -2.0, 3.0], np.float32), "b": np.array([[0.5]], np.float32)}
OPTIMISERS = {
    "sgd": lambda o: o.sgd(0.1),
    "sgd_momentum": lambda o: o.sgd_momentum(0.05),
    "nesterov": lambda o: o.sgd_momentum(0.05, 0.9, nesterov=True),
    "adam": lambda o: o.adam(0.1),
    "adamw": lambda o: o.adam(0.1, weight_decay=0.01),
    "sgd_scheduled": lambda o: o.sgd(o.warmup_cosine(0.2, 5, 200)),
    "adam_scheduled": lambda o: o.adam(o.cosine_decay(0.1, 200, alpha=0.1)),
}


def _jax_run(name, steps):
    target = jax.tree.map(jnp.asarray, TARGET)
    loss = lambda p: jtrees.tree_dot(jtrees.tree_sub(p, target), jtrees.tree_sub(p, target))
    opt = OPTIMISERS[name](joptim)

    @jax.jit
    def step(params, state):
        updates, state = opt.update(jax.grad(loss)(params), state, params)
        return japply(params, updates), state

    params = jax.tree.map(jnp.zeros_like, target)
    state, seen = opt.init(params), {}
    for t in range(1, steps + 1):
        params, state = step(params, state)
        seen[t] = params
    return seen, float(loss(params))


def _torch_run(name, steps):
    target = convert.to_torch(TARGET)
    loss = lambda p: trees.tree_dot(trees.tree_sub(p, target), trees.tree_sub(p, target))
    opt = OPTIMISERS[name](optim)
    params = trees.tree_zeros_like(target)
    state, seen = opt.init(params), {}
    for t in range(1, steps + 1):
        updates, state = opt.update(torch.func.grad(loss)(params), state, params)
        params = apply_updates(params, updates)
        seen[t] = params
    return seen, float(loss(params)), state


@pytest.mark.parametrize("name", list(OPTIMISERS))
def test_optimisers_match_the_reference_on_the_quadratic(name):
    want, jloss = _jax_run(name, 200)
    got, tloss, state = _torch_run(name, 200)
    assert jloss < 1e-2 and tloss < 1e-2, (jloss, tloss)
    for t in (1, 10):
        _close(got[t], want[t], TOL, f"{name} step {t}")
    assert state["count"].dtype == torch.int32 and int(state["count"]) == 200


def test_adam_without_params_matches_the_reference():
    """``update(grads, state)`` with no parameters: m stands in for them,
    weight decay included, the updates float32."""
    rng = np.random.default_rng(0)
    grads = [{"w": rng.standard_normal((3, 4)).astype(np.float32),
              "b": {"c": rng.standard_normal((5,)).astype(np.float32)}} for _ in range(3)]
    jopt, topt = joptim.adam(0.05, weight_decay=0.1), optim.adam(0.05, weight_decay=0.1)
    jstate = jopt.init(jax.tree.map(jnp.asarray, grads[0]))
    tstate = topt.init(convert.to_torch(grads[0]))
    for g in grads:
        jup, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate)
        tup, tstate = topt.update(convert.to_torch(g), tstate)
        _close(tup, jup, TOL, "updates")
    _close(tstate["m"], jstate["m"], TOL, "m")
    _close(tstate["v"], jstate["v"], TOL, "v")


@pytest.mark.parametrize("name", ["sgd", "nesterov", "adamw", "sgd_scheduled"])
def test_bf16_parameters_match_the_reference(name):
    """bf16 parameters and gradients, five steps from the same start: the
    same dtypes (a schedule's float32 value promotes SGD's update, as in
    the reference), values within one bf16 ulp of the largest magnitude."""
    rng = np.random.default_rng(1)
    p0 = {"w": rng.standard_normal((8, 16)).astype(np.float32),
          "n": {"s": np.float32(rng.standard_normal())}}
    grads = [jax.tree.map(lambda x: rng.standard_normal(np.shape(x)).astype(np.float32), p0)
             for _ in range(5)]
    jb = lambda tree: jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), tree)
    tb = lambda tree: trees.tree_cast(convert.to_torch(tree), torch.bfloat16)
    jopt, topt = OPTIMISERS[name](joptim), OPTIMISERS[name](optim)
    jp, tp = jb(p0), tb(p0)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jup, js = jopt.update(jb(g), js, jp)
        tup, ts = topt.update(tb(g), ts, tp)
        _close(tup, jup, BF16_ULP, f"{name} updates")
        jp, tp = japply(jp, jup), apply_updates(tp, tup)
        _close(tp, jp, BF16_ULP, f"{name} params")


@pytest.mark.parametrize("scale", [10.0, 0.01])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_by_global_norm_matches_the_reference(scale, dtype):
    rng = np.random.default_rng(2)
    g = {"x": (scale * rng.standard_normal((4, 7))).astype(np.float32),
         "y": {"z": (scale * rng.standard_normal((3,))).astype(np.float32)}}
    jg = jax.tree.map(lambda x: jnp.asarray(x, dtype), g)
    tg = trees.tree_cast(convert.to_torch(g), getattr(torch, dtype))
    jclipped, jnorm = jclip(jg, 1.0)
    tclipped, tnorm = clip_by_global_norm(tg, 1.0)
    assert tnorm.dtype == torch.float32 and tnorm.dim() == 0
    assert abs(float(tnorm) - float(jnorm)) <= TOL * float(jnorm)
    _close(tclipped, jclipped, TOL, "clipped")


COUNTS = np.arange(121, dtype=np.int32)
SCHEDULES = {
    "constant": lambda o: o.constant(0.5),
    "cosine": lambda o: o.cosine_decay(1.0, 100),
    "cosine_alpha": lambda o: o.cosine_decay(0.1, 100, alpha=0.1),
    "warmup_cosine": lambda o: o.warmup_cosine(1.0, 10, 100),
    "warmup_cosine_floor": lambda o: o.warmup_cosine(3e-4, 10, 100, floor=1e-5),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_the_reference(name):
    jfn, tfn = SCHEDULES[name](joptim), SCHEDULES[name](optim)
    want = np.array([float(jfn(jnp.int32(c))) for c in COUNTS])
    got = [tfn(torch.tensor(c, dtype=torch.int32)) for c in COUNTS]
    assert all(v.dtype == torch.float32 and v.dim() == 0 for v in got)
    err = np.abs(np.array([float(v) for v in got]) - want)
    assert float(err.max()) <= SCHEDULE_TOL, (name, int(err.argmax()), float(err.max()))
