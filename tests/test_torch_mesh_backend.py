"""``sharding.model_axis_blocker``: the check that refuses a model-axis
mesh DTensor cannot run on. It refuses a CUDA mesh whose group is not
``nccl`` while ``_c10d_functional``'s collectives have no CUDA kernel
(their wait crashes gloo ranks on CUDA tensors), and passes a CPU mesh,
anything that is not a ``DeviceMesh``, an ``nccl`` group, and a gloo
group once the caller has registered CUDA kernels for the four
collectives DTensor issues. There is no card here, so a CUDA mesh is
a stand-in with ``device_type == "cuda"`` over a real gloo group; a
registration lasts for the whole process, so the routed cases run in a
fresh one. ``param_shardings`` and ``make_host_mesh`` raise with the
check's reason."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.sharding import model_axis_blocker, param_shardings, specs  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


class CudaMesh:
    """A stand-in for a CUDA ``DeviceMesh`` over the default group."""
    device_type = "cuda"
    mesh_dim_names = ("data", "model")
    shape = (1, 1)

    def get_group(self, dim=0):
        return dist.group.WORLD


@pytest.fixture(scope="module")
def world():
    made = not dist.is_initialized()
    if made:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield
    if made:
        dist.destroy_process_group()


_ROUTED = """
import sys
import torch, torch.distributed as dist
sys.path.insert(0, sys.argv[1])
from test_torch_mesh_backend import CudaMesh
from repro_torch.sharding import model_axis_blocker, specs
dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
lib = torch.library.Library("_c10d_functional", "IMPL")
for ops in (specs.FUNCTIONAL_COLLECTIVES[:1], specs.FUNCTIONAL_COLLECTIVES[1:]):
    for op in ops:
        lib.impl(op, lambda x, *a: x, "CUDA")
    print(repr(model_axis_blocker(CudaMesh())))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def routed():
    """The check's reasons in one fresh process: after registering a CUDA
    kernel for ``all_reduce`` alone, then for all four collectives."""
    run = subprocess.run([sys.executable, "-c", _ROUTED, os.path.dirname(__file__)],
                         env=dict(os.environ, PYTHONPATH=SRC), capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stderr[-3000:]
    half, full = (eval(line) for line in run.stdout.strip().splitlines()[-2:])
    return {"cuda-gloo-all-reduce-only": half, "cuda-gloo-routed": full}


# case: None when the check passes, else the collectives its reason names
CASES = {
    "cpu-mesh": None,
    "not-a-mesh": None,
    "cuda-gloo-unrouted": specs.FUNCTIONAL_COLLECTIVES,
    "cuda-nccl": None,
    "cuda-gloo-all-reduce-only": specs.FUNCTIONAL_COLLECTIVES[1:],
    "cuda-gloo-routed": None,
}


@pytest.mark.parametrize("case", list(CASES))
def test_the_check_decides(world, routed, monkeypatch, case):
    if case == "cpu-mesh":
        reason = model_axis_blocker(make_host_mesh(1, device="cpu"))
    elif case == "not-a-mesh":
        reason = model_axis_blocker(object())
    elif case == "cuda-nccl":
        monkeypatch.setattr(specs.dist, "get_backend", lambda group: "nccl")
        reason = model_axis_blocker(CudaMesh())
    elif case == "cuda-gloo-unrouted":
        reason = model_axis_blocker(CudaMesh())
    else:
        reason = routed[case]
    names = CASES[case]
    if names is None:
        assert reason is None, reason
        return
    assert "'gloo'" in reason and "'nccl'" in reason and "_c10d_functional" in reason
    named = reason[reason.index("(") + 1:reason.index(" have no CUDA kernel")].split(", ")
    assert named == list(names), named


def test_param_shardings_and_make_host_mesh_raise_the_reason(world, monkeypatch):
    params = {"layers": {"attn": {"wq": torch.empty(4, 8, 8, device="meta")}}}
    with pytest.raises(RuntimeError, match="_c10d_functional"):
        param_shardings(params, CudaMesh())
    assert param_shardings(params, make_host_mesh(1, device="cpu"))
    from repro_torch.launch import mesh as mesh_mod
    monkeypatch.setattr(mesh_mod, "_device_type", lambda device: "cuda")
    monkeypatch.setattr(mesh_mod, "DeviceMesh", lambda *a, **kw: CudaMesh())
    with pytest.raises(RuntimeError, match="use an 'nccl' group"):
        make_host_mesh(1)
