"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip without a GPU and run there with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py

This file imports only torch and the port (the GPU machine has no JAX).
Tolerances: prox_update fp32 within 1e-6 abs (the kernel rounds the same
operations in the same order), bf16 within 1 ulp; cosine_sim within 1e-5
(split-K sums in another order than the plain matmul).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import cosine_sim, prox_update, ref  # noqa: E402

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


def test_cosine_kernel_rejects_bf16(dev):
    with pytest.raises(TypeError):
        cosine_sim.cosine_sim(torch.zeros(4, 4, dtype=torch.bfloat16, device=dev))
