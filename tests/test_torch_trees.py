"""The port's tree helpers (``repro_torch.utils.trees``) against the JAX
package's ``repro.utils.trees`` on the CPU: mixed-shape nested trees made
with numpy, a 0-d leaf among them. Elementwise helpers within 1e-6 of the
largest magnitude, the reductions (``tree_dot``, ``tree_norm``) within
1e-6 relative (float32 sums in another order), ``tree_size`` and
``tree_bytes`` exactly, ``tree_has_nan`` exactly, with and without a NaN."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.utils import trees as jtrees  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.utils import trees  # noqa: E402

TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((5, 7)).astype(dtype),
            "b": rng.standard_normal((7,)).astype(dtype),
            "blk": {"s": np.asarray(rng.standard_normal(), dtype),
                    "k": rng.standard_normal((2, 3, 4)).astype(dtype)}}


def _pair(seed, dtype=np.float32):
    t = _tree(seed, dtype)
    return t, jax.tree.map(jnp.asarray, t), convert.to_torch(t)


def _close(got, want, what):
    g, w = convert.to_numpy(got), jax.tree.map(np.asarray, want)
    assert jax.tree.structure(g) == jax.tree.structure(w), what
    for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
        assert a.shape == b.shape, what
        assert np.max(np.abs(a - b), initial=0.0) <= TOL * max(np.max(np.abs(b)), 1e-30), what


ELEMENTWISE = {
    "zeros_like": (lambda m, a, b: m.tree_zeros_like(a)),
    "add": (lambda m, a, b: m.tree_add(a, b)),
    "sub": (lambda m, a, b: m.tree_sub(a, b)),
    "scale": (lambda m, a, b: m.tree_scale(a, 0.37)),
    "axpy": (lambda m, a, b: m.tree_axpy(-1.5, a, b)),
}


@pytest.mark.parametrize("name", list(ELEMENTWISE))
def test_elementwise_helpers_match_the_reference(name):
    _, ja, ta = _pair(0)
    _, jb, tb = _pair(1)
    fn = ELEMENTWISE[name]
    got, want = fn(trees, ta, tb), fn(jtrees, ja, jb)
    _close(got, want, name)
    assert all(x.dtype == torch.float32 for x in trees.leaves(got))


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_dot_and_norm_match_the_reference(dtype):
    _, ja, ta = _pair(2, dtype)
    _, jb, tb = _pair(3, dtype)
    dot, norm = trees.tree_dot(ta, tb), trees.tree_norm(ta)
    for got, want in ((dot, jtrees.tree_dot(ja, jb)), (norm, jtrees.tree_norm(ja))):
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(float(got) - float(want)) <= TOL * abs(float(want)), (float(got), float(want))


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int32])
def test_size_and_bytes_are_exact(dtype):
    _, jt, tt = _pair(4, dtype)
    size, nbytes = trees.tree_size(tt), trees.tree_bytes(tt)
    assert type(size) is int and type(nbytes) is int
    assert size == jtrees.tree_size(jt) == 35 + 7 + 1 + 24
    assert nbytes == int(jtrees.tree_bytes(jt)) == size * np.dtype(dtype).itemsize


@pytest.mark.parametrize("where", [None, "w", "s"])
def test_has_nan_matches_the_reference(where):
    t = _tree(5)
    if where == "w":
        t["w"][3, 2] = np.nan
    elif where == "s":
        t["blk"]["s"] = np.asarray(np.nan, np.float32)
    got = trees.tree_has_nan(convert.to_torch(t))
    assert got.dtype == torch.bool and got.dim() == 0
    want = bool(jtrees.tree_has_nan(jax.tree.map(jnp.asarray, t)))
    assert bool(got) == want == (where is not None)
