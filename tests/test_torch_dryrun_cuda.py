"""The dry run's pieces on the card (``repro_torch.launch.dryrun``).

Marked ``cuda``: they skip without a GPU and run there with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_dryrun_cuda.py

This file imports only torch and the port (the GPU machine has no JAX).

- K1 and K5 on fake CUDA tensors: one op each, through their shape-only
  paths, which launch nothing; on real tensors the same op launches the
  kernel once.
- ``model_axis_blocker`` passes the fake group of a CUDA production mesh
  and refuses an unrouted gloo group on a CUDA ``DeviceMesh`` (run in a
  child process, whose default group is its own).
"""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import prox_update, ref, ssm_scan  # noqa: E402

pytestmark = pytest.mark.cuda

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_kernels_take_their_shape_only_path_on_fake_cuda_tensors(dev):
    from torch._subclasses.fake_tensor import FakeTensorMode
    before = (prox_update.launches, ssm_scan.fwd_launches, ssm_scan.bwd_launches)
    with FakeTensorMode():
        th, om, gt, go = (torch.empty(4096, device=dev) for _ in range(4))
        prox_update.prox_update_flat(th, om, gt, go, 0.1, 0.05)
        dA, dBx = (torch.empty(2, 32, 64, 16, device=dev, requires_grad=True)
                   for _ in range(2))
        C = torch.empty(2, 32, 16, device=dev, requires_grad=True)
        y = ssm_scan.ssm_scan(dA, dBx, C)
        grads = torch.autograd.grad(y.sum(), (dA, dBx, C))
    assert tuple(y.shape) == (2, 32, 64) and y.device.type == "cuda"
    assert [tuple(g.shape) for g in grads] == [(2, 32, 64, 16)] * 2 + [(2, 32, 16)]
    assert (prox_update.launches, ssm_scan.fwd_launches, ssm_scan.bwd_launches) == before


def test_the_op_launches_the_kernel_on_real_tensors(dev):
    g = torch.Generator().manual_seed(0)
    ops_ = [torch.randn(65537, generator=g).to(dev) for _ in range(4)]
    want_t, want_o = ref.prox_update_ref(*ops_, 0.1, 0.05)
    before = prox_update.launches
    torch.ops.repro_torch.prox_update_(ops_[0], ops_[1], ops_[2], ops_[3], 0.1, 0.05)
    torch.cuda.synchronize()
    assert prox_update.launches == before + 1
    assert float((ops_[0] - want_t).abs().max()) <= 1e-6
    assert float((ops_[1] - want_o).abs().max()) <= 1e-6


_CHILD = """
import sys
import torch, torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding import model_axis_blocker
if sys.argv[1] == "fake":
    mesh = make_production_mesh(multi_pod=True, device="cuda")
else:
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    mesh = DeviceMesh("cuda", [0], mesh_dim_names=("data",))
print(repr(model_axis_blocker(mesh)))
dist.destroy_process_group()
"""


@pytest.mark.parametrize("group", ["fake", "gloo"])
def test_model_axis_blocker_on_cuda_meshes(dev, group):
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _CHILD, group], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    reason = out.stdout.strip().splitlines()[-1]
    if group == "fake":
        assert reason == "None"
    else:
        assert "'gloo' group on CUDA tensors" in reason, reason
