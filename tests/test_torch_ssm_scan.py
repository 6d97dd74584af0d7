"""The port's selective scan (K5: ``ops.ssm_scan``, the ``SSMScan``
autograd op) against the JAX package, on the CPU.

Inputs are made with numpy from a seed. The forward is held against the
JAX Pallas kernel in interpret mode (``bd=16, chunk=16``, as
``tests/test_pallas_integration.py`` runs it) and against JAX's
``ssm_scan_ref``; the gradients of dA, dBx and C against ``jax.grad`` of
``ssm_scan_ref`` (the JAX Pallas kernel has no gradient), alone and under
``torch.func.vmap``. Tolerances: rtol 1e-5 / atol 1e-5 in fp32 — h is the
same sequence of roundings, only the sums over n (y) and over d (g_C) run
in another order. On the CPU the op runs the plain versions in ``ref``;
the CUDA kernels are held against those in ``test_torch_kernels_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.func import vmap  # noqa: E402

from repro.kernels.ref import ssm_scan_ref as j_ref  # noqa: E402
from repro.kernels.ssm_scan import ssm_scan as j_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssm_scan as scan  # noqa: E402

RTOL, ATOL = 1e-5, 1e-5

SHAPES = {                      # (B, S, D, N): even, ragged S, ragged D, both
    "even": (2, 32, 32, 16),
    "ragged_s": (1, 37, 32, 16),
    "ragged_d": (2, 24, 21, 16),
    "ragged_both": (3, 19, 45, 8),
}


def _inputs(shape, seed=0, lead=()):
    """dA in (0.5, 1) (a decaying state, as exp(δ·A) gives), dBx, C and an
    output gradient g_y, fp32 numpy."""
    B, S, D, N = shape
    rng = np.random.default_rng(seed)
    dA = rng.uniform(0.5, 1.0, size=lead + (B, S, D, N)).astype(np.float32)
    dBx = rng.normal(size=lead + (B, S, D, N)).astype(np.float32)
    C = rng.normal(size=lead + (B, S, N)).astype(np.float32)
    gy = rng.normal(size=lead + (B, S, D)).astype(np.float32)
    return dA, dBx, C, gy


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_forward_matches_jax_kernel_and_reference(name):
    dA, dBx, C, _ = _inputs(SHAPES[name])
    want_kernel = j_kernel(jnp.asarray(dA), jnp.asarray(dBx), jnp.asarray(C),
                           bd=16, chunk=16, interpret=True)
    want_ref = j_ref(jnp.asarray(dA), jnp.asarray(dBx), jnp.asarray(C))
    got = ops.ssm_scan(*_t(dA, dBx, C))
    plain = ops.ssm_scan(*_t(dA, dBx, C), backend="torch")
    assert got.dtype == torch.float32 and got.shape == SHAPES[name][:3]
    _close(got, want_kernel)
    _close(got, want_ref)
    assert torch.equal(got, plain)


def _jax_grads(dA, dBx, C, gy):
    f = lambda a, b, c: jnp.sum(j_ref(a, b, c) * gy)
    return jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(dA), jnp.asarray(dBx),
                                          jnp.asarray(C))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_gradient_matches_jax_grad_of_reference(name):
    dA, dBx, C, gy = _inputs(SHAPES[name], seed=1)
    ins = [x.requires_grad_(True) for x in _t(dA, dBx, C)]
    y = ops.ssm_scan(*ins)
    grads = torch.autograd.grad(y, ins, grad_outputs=torch.as_tensor(gy))
    for got, want in zip(grads, _jax_grads(dA, dBx, C, gy)):
        _close(got, want)


def test_gradient_under_vmap_folds_into_one_call(monkeypatch):
    """The engine vmaps the loss over a cohort: the op's vmap rule folds
    the client axis into B (one call of each plain version here, one
    launch each on the card), and every client's gradient matches JAX."""
    shape = SHAPES["ragged_both"]
    dA, dBx, C, gy = _inputs(shape, seed=2, lead=(3,))
    calls = {"fwd": 0, "bwd": 0}

    def counted(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(ref, "ssm_scan_states_ref",
                        counted("fwd", ref.ssm_scan_states_ref))
    monkeypatch.setattr(ref, "ssm_scan_bwd_ref", counted("bwd", ref.ssm_scan_bwd_ref))
    ins = [x.requires_grad_(True) for x in _t(dA, dBx, C)]
    with torch.enable_grad():
        y = vmap(ops.ssm_scan)(*ins)
        grads = torch.autograd.grad(y, ins, grad_outputs=torch.as_tensor(gy))
    assert calls == {"fwd": 1, "bwd": 1}
    assert y.shape == (3,) + shape[:3]
    for v in range(3):
        want = _jax_grads(dA[v], dBx[v], C[v], gy[v])
        for got, w in zip(grads, want):
            _close(got[v], w)


def test_vmap_with_a_shared_operand():
    """An operand vmapped with in_dim None (C shared by every client) is
    broadcast before the fold; its gradient sums over the clients."""
    dA, dBx, _, gy = _inputs(SHAPES["even"], seed=3, lead=(2,))
    _, _, C, _ = _inputs(SHAPES["even"], seed=4)
    ins = [x.requires_grad_(True) for x in _t(dA, dBx, C)]
    with torch.enable_grad():
        y = vmap(ops.ssm_scan, in_dims=(0, 0, None))(*ins)
        g_c = torch.autograd.grad(y, ins[2], grad_outputs=torch.as_tensor(gy))[0]
    want = sum(np.asarray(_jax_grads(dA[v], dBx[v], C, gy[v])[2]) for v in range(2))
    _close(g_c, want)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_backward_is_autograd_of_plain_forward(name):
    """The plain backward (the kernel's arithmetic: chunk states restarted
    from ``hs``) equals autograd through the plain sequential forward."""
    dA, dBx, C, gy = _inputs(SHAPES[name], seed=5)
    y, hs = ref.ssm_scan_states_ref(*_t(dA, dBx, C), scan.CHUNK)
    assert hs.shape == (dA.shape[0], -(-dA.shape[1] // scan.CHUNK)) + dA.shape[2:]
    assert torch.equal(hs[:, 0], torch.zeros_like(hs[:, 0]))
    got = ref.ssm_scan_bwd_ref(*_t(dA, dBx, C), hs, torch.as_tensor(gy), scan.CHUNK)
    ins = [x.requires_grad_(True) for x in _t(dA, dBx, C)]
    want = torch.autograd.grad(ref.ssm_scan_ref(*ins), ins,
                               grad_outputs=torch.as_tensor(gy))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)


def test_scan_rejects_mismatched_shapes():
    dA, dBx, C, _ = _t(*_inputs(SHAPES["even"]))
    with pytest.raises(ValueError):
        scan.scan_fwd(dA, dBx[:, :-1], C)
    with pytest.raises(ValueError):
        scan.scan_fwd(dA, dBx, C[..., :-1])
