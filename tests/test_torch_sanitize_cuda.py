"""The port's sanitizers on the card (``repro_torch.analysis.sanitize``).

Marked ``cuda``: they skip without a GPU and run there with

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_sanitize_cuda.py

This file imports only torch and the port (the GPU machine has no JAX).
``no_transfer`` raises at ``.item()`` of a CUDA tensor (its Python guard)
and at an upload from pageable memory (sync-debug mode "error"); a
``run_rounds`` replay passes under it, and its capture is counted in
``compile_budget``'s ``captures``; ``nan_guard`` catches a NaN from each
kernel with floating outputs through its wrapper (K3's 0/1 adjacency, K4's
roots and the labels are integers and cannot carry one).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import sanitize  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import _build
    _build.load()           # built or found before any budget opens
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_no_transfer_raises_at_a_device_read(dev):
    x = torch.arange(4.0, device=dev)
    with pytest.raises(sanitize.HostTransferError):
        with sanitize.no_transfer():
            x[0].item()
    with pytest.raises(sanitize.HostTransferError):
        with sanitize.no_transfer():
            x.cpu()
    with sanitize.no_transfer():                    # a host tensor is no transfer
        assert torch.ones(2)[0].item() == 1.0
        y = (x * 2).sum()
    assert y.item() == 12.0
    assert torch.cuda.get_sync_debug_mode() == 0


def test_no_transfer_raises_at_a_pageable_upload(dev):
    host = torch.ones(1 << 16)
    with pytest.raises(RuntimeError):
        with sanitize.no_transfer():
            assert torch.cuda.get_sync_debug_mode() == 2
            host.to(dev)
    assert torch.cuda.get_sync_debug_mode() == 0


def _fed(n=16):
    from repro_torch.data import synthetic
    clients, _, _ = synthetic.rotated(n_clusters=2, n_clients=n, n_per=32, seed=3)
    return clients


def _state(dev, name="fedavg"):
    from repro_torch import engine
    from repro_torch.models import simple
    task = simple.SYNTH_MLP
    params = simple.init(torch.Generator().manual_seed(0), task)
    cfg = engine.EngineConfig(local_steps=2, sample_rate=0.5, seed=0, rng_backend="device",
                              cluster_backend="device", fused_step=True)
    return engine.init(name, lambda p, b: simple.loss_fn(p, b, task), params, _fed(), cfg,
                       device=dev, arena=True)


@pytest.mark.parametrize("name", ["fedavg", "stocfl"])
def test_run_rounds_capture_counts_and_replays_pass_no_transfer(dev, name):
    from repro_torch import engine
    st = _state(dev, name)
    with sanitize.compile_budget(log_names=True) as log:
        first = engine.run_rounds(st, 3)
        torch.cuda.synchronize()
    assert (log.count, log.captures) == (1, 1), log.describe()
    assert log.names[0].startswith(f"scan:{name}:")
    with sanitize.compile_budget(0) as again:
        fn, carry0, consts, finalize = engine.scan_program(st, 3)
        with sanitize.no_transfer():
            carry, ys = fn(carry0, consts)
            torch.cuda.synchronize()
    assert (again.count, again.captures) == (0, 0)
    second = finalize(st, carry, ys, 3)
    assert [r["sampled"] for r in second.history] == [r["sampled"] for r in first.history]


def test_nan_guard_checks_each_replay(dev):
    """Under capture the per-op check cannot run; the program checks each
    replay's carry and records after it."""
    from repro_torch.engine.api import RoundProgram

    def step(carry, cs):
        new = carry / cs["d"]
        return new, {"s": new.sum()}

    program = RoundProgram(step, dev)
    ones, zeros = torch.ones(4, device=dev), torch.zeros(4, device=dev)
    program(ones, {"d": ones}, 2)                       # warm-up and capture
    with sanitize.nan_guard():
        program(ones, {"d": ones}, 2)
        # finite operands, a NaN (0 / 0) made inside the replay
        with pytest.raises(FloatingPointError, match="^RoundProgram produced a NaN"):
            program(zeros, {"d": zeros}, 3)


def test_nan_guard_catches_each_kernel_through_its_wrapper(dev):
    from repro_torch.kernels import cosine_sim, prox_update, ssm_scan
    n = 4096
    z = torch.zeros(n, device=dev)
    g = torch.zeros(n, device=dev)
    g[7] = float("nan")
    zb, gb = z.to(torch.bfloat16), g.to(torch.bfloat16)
    cases = {
        "prox_update": lambda: prox_update.prox_update_flat(z.clone(), z.clone(), g, z, 0.1, 0.05),
        "prox_theta": lambda: prox_update.prox_theta_flat(z.clone(), z, g, 0.1, 0.05),
        "prox_update_bf16": lambda: prox_update.prox_update_flat(
            zb.clone(), zb.clone(), gb, zb, 0.1, 0.05),
    }
    x = torch.randn(64, 256, device=dev)
    x[3, 5] = float("nan")
    cases["cosine_sim"] = lambda: cosine_sim.cosine_sim(x)
    B, S, D, N = 2, 32, 64, 16
    dA = torch.rand(B, S, D, N, device=dev)
    dBx = torch.randn(B, S, D, N, device=dev)
    C = torch.randn(B, S, N, device=dev)
    bad = dBx.clone()
    bad[0, 3, 5, 2] = float("nan")
    cases["ssm_scan_fwd"] = lambda: ssm_scan.scan_fwd(dA, bad, C)
    _y, hs = ssm_scan.scan_fwd(dA, dBx, C)
    g_y = torch.randn(B, S, D, device=dev)
    g_y[1, 4, 6] = float("nan")
    cases["ssm_scan_bwd"] = lambda: ssm_scan.scan_bwd(dA, dBx, C, hs, g_y)
    for op, call in cases.items():
        want = op.replace("_bf16", "")
        with pytest.raises(FloatingPointError, match=f"^{want} produced a NaN"):
            with sanitize.nan_guard():
                call()
        call()                                          # outside the guard: quiet
    with sanitize.nan_guard():                          # clean inputs raise nothing
        prox_update.prox_update_flat(z.clone(), z.clone(), z, z, 0.1, 0.05)
        ssm_scan.scan_fwd(dA, dBx, C)
