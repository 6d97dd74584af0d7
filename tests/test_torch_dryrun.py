"""The port's dry run for H100 meshes (``repro_torch.launch.dryrun``).

- ``model_flops`` is the reference's, exactly, for all ten configs and the
  three step kinds; ``variant_config`` and ``pick_kind`` agree with it. The
  reference's numbers come from ``jax.eval_shape`` alone (no compile).
- The production meshes are (32, 8) and (2, 32, 8) over a fake process
  group, and ``model_axis_blocker`` passes a fake group (its refusal of an
  unrouted gloo group is held by ``tests/test_torch_mesh_backend.py`` here
  and by ``tests/test_torch_dryrun_cuda.py`` on a card).
- The trace's own consistency, on smoke configs over fake CPU meshes of at
  most 8 ranks: on a data-only mesh one rank's FLOPs times the ranks are
  the trace without a mesh's, exactly; hand-built redistributions report
  the result bytes their formulas give, by kind and by mesh axis; the
  affine probes give the FLOPs and the argument and output bytes a
  full-depth trace gives for an SSM, a hybrid, a MoE and the audio config
  and, on a mesh, a dense config's, its collective bytes and temp bytes
  too (bytes accessed have a term that grows with the square of the
  depth, which the probes under-count; temp bytes are exact for the MoE,
  audio and dense configs and under-counted, by a bounded share, for the
  SSM and the hybrid); K1 and K5 are one op each on fake
  tensors; a record has the reference's keys, and the CLI writes it.

Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices;
the variable is restored at once, so that later test files and worlds on
the same worker do not inherit it.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

_XLA_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdry  # noqa: E402  (sets XLA_FLAGS on import)

if _XLA_FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _XLA_FLAGS

import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import fake_mesh, fake_world, make_production_mesh  # noqa: E402
from repro_torch.models.config import INPUT_SHAPES, InputShape  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.sharding import model_axis_blocker  # noqa: E402
from repro_torch.sharding.specs import DTensor, Partial, Replicate, Shard  # noqa: E402

SMALL = InputShape("small_train", 64, 8, "train")
TINY = InputShape("tiny_train", 8, 4, "train")
COST_KEYS = ("flops", "bytes", "coll_total") + tuple(f"coll_{k}" for k in dryrun.KINDS)


def test_xla_flags_restored_after_the_reference_import():
    assert os.environ.get("XLA_FLAGS") == _XLA_FLAGS


@pytest.fixture(scope="module")
def world():
    """A fake default process group for this module, torn down after it."""
    torch.set_num_threads(1)
    assert not dist.is_initialized()
    fake_world()
    try:
        yield
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------- the reference's
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_is_the_reference(arch):
    """6·N_active·tokens (×2 bi-level) or 2·N_active·tokens with N from the
    port's parameter specs: the reference's value bit for bit."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    model, jmodel = build(cfg), jbuild(jcfg)
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        kind = dryrun.pick_kind(INPUT_SHAPES[name])
        assert kind == jdry.pick_kind(JSHAPES[name])
        got = dryrun.model_flops(cfg, model, INPUT_SHAPES[name], kind)
        assert got == jdry.model_flops(jcfg, jmodel, JSHAPES[name], kind), (arch, name)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_variant_config_is_the_reference(arch):
    for name in INPUT_SHAPES:
        (cfg, variant), (jcfg, jvariant) = (dryrun.variant_config(arch, name),
                                            jdry.variant_config(arch, name))
        assert variant == jvariant and cfg.sliding_window == jcfg.sliding_window


# ------------------------------------------------------------- the meshes
def test_production_meshes(world):
    single = make_production_mesh(device="cpu")
    multi = make_production_mesh(multi_pod=True, device="cpu")
    assert (tuple(single.shape), single.mesh_dim_names) == ((32, 8), ("data", "model"))
    assert (tuple(multi.shape), multi.mesh_dim_names) == ((2, 32, 8),
                                                         ("pod", "data", "model"))
    assert dist.get_backend() == "fake" and dist.get_world_size() == 512


def test_model_axis_blocker_passes_a_fake_group(world):
    class CudaMesh:
        """A stand-in for a CUDA ``DeviceMesh`` over the fake group."""
        device_type = "cuda"

        def get_group(self, dim=0):
            return dist.group.WORLD

    assert model_axis_blocker(CudaMesh()) is None


# ------------------------------------------------------- the trace itself
def test_data_axis_splits_the_flops_exactly(world):
    """On a (4, 1) data-only mesh each rank takes a quarter of the batch:
    four ranks' FLOPs are the whole step's, bit for bit."""
    cfg = get_config("qwen2-1.5b", smoke=True)
    mesh = fake_mesh((4, 1), ("data", "model"), "cpu")
    one = dryrun.trace_step(cfg, TINY, mesh, "train")
    whole = dryrun.trace_step(cfg, TINY, None, "train", device="cpu")
    assert one["flops"] > 0 and 4 * one["flops"] == whole["flops"]


def test_redistributions_report_their_result_bytes(world):
    """Replicating a row-split (8, 6) fp32 tensor over ``data`` all-gathers
    its 192 bytes; a partial sum over ``model`` scattered by rows receives
    its (4, 6) half, 96 bytes, and replicated all-reduces all 192."""
    mesh = fake_mesh((2, 2), ("data", "model"), "cpu")
    costs = dryrun.StepCosts(mesh)
    with FakeTensorMode():
        rows = DTensor.from_local(torch.empty(4, 6), mesh, (Shard(0), Replicate()),
                                  run_check=False)
        part = DTensor.from_local(torch.empty(8, 6), mesh, (Replicate(), Partial()),
                                  run_check=False)
        with dryrun._Internals(costs), costs:
            rows.redistribute(mesh, (Replicate(), Replicate()))
            part.redistribute(mesh, (Replicate(), Shard(0)))
            part.redistribute(mesh, (Replicate(), Replicate()))
    assert costs.coll == {"all-gather": 192, "reduce-scatter": 96, "all-reduce": 192,
                          "all-to-all": 0, "collective-permute": 0}
    assert dict(costs.coll_axes) == {"data": 192, "model": 288}
    assert costs.flops == 0


CASES = {
    "ssm": ("falcon-mamba-7b", dict(n_layers=5, use_pallas=True)),
    "hybrid": ("zamba2-1.2b", dict(n_layers=4, attn_every=2, sliding_window=8)),
    "moe": ("deepseek-v2-236b", dict(n_layers=4)),
    "audio": ("whisper-medium", dict(n_layers=4, n_enc_layers=5)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_probes_extrapolate_to_the_full_trace(world, case):
    """The reference's affine probe plans, traced shallow and extrapolated,
    give the full-depth trace's FLOPs and argument and output bytes
    exactly. Bytes accessed have one term that grows with the square of
    the depth, which an affine plan cannot see: each layer reads its
    weights as a slice of the stacked leaves (``x[i]``), whose backward
    fills a zero stack of all the layers (``select_backward``), and the
    stacks are summed. So probes extrapolated past their depths
    under-count bytes, by up to ~17% at 4-5 layers of these smoke configs
    (the more, the larger the weights' share of the bytes; 0.02% for
    qwen2-1.5b's train_4k at its 28).

    Temp bytes (the step's peak of live storage) are the largest of the
    step's phases' live sizes, each affine in depth, so they are convex in
    depth, and an affine plan extrapolated past its deepest probe can only
    under-count them: exactly where one phase holds the peak at every
    depth (the MoE and audio configs here), by 2.8% for the SSM at 5
    layers and 9.7% for the hybrid at 4, whose peak moves to another phase
    between the probes' depths and the full one."""
    arch, kw = CASES[case]
    cfg = get_config(arch, smoke=True).with_(**kw)
    full = dryrun.trace_step(cfg, TINY, None, "train", device="cpu")
    probed = dryrun.probe_metrics(cfg, TINY, None, "train", 0.1, 0.05, device="cpu")
    for k in ("flops", "argument_bytes", "output_bytes"):
        assert probed[k] == full[k], (case, k, probed[k], full[k])
    assert 0 < full["bytes"] - probed["bytes"], (probed["bytes"], full["bytes"])
    temp, want = probed["temp_bytes"], full["temp_bytes"]
    if case in ("moe", "audio"):
        assert temp == want, (case, temp, want)
    else:
        assert 0.9 * want <= temp <= want, (case, temp, want)


def test_probes_extrapolate_a_dense_config_on_a_mesh(world):
    """The dense case, on a (2, 2) mesh: the probes give the full trace's
    FLOPs, argument, output and temp bytes and collective bytes, kind by
    kind and axis by axis, exactly (bytes accessed as above)."""
    cfg = get_config("qwen2-1.5b", smoke=True).with_(n_layers=5)
    mesh = fake_mesh((2, 2), ("data", "model"), "cpu")
    full = dryrun.trace_step(cfg, TINY, mesh, "train")
    probed = dryrun.probe_metrics(cfg, TINY, mesh, "train", 0.1, 0.05)
    keys = [k for k in full if k.startswith(("coll_", "axis_"))] + [
        "flops", "argument_bytes", "output_bytes", "temp_bytes"]
    assert full["coll_total"] > 0 and {k: probed[k] for k in keys} == {k: full[k]
                                                                        for k in keys}
    assert 0 < full["bytes"] - probed["bytes"]


def test_kernels_are_one_op_each_on_fake_tensors(world):
    """On fake tensors K1 runs once a parameter leaf and K5 once a layer and
    direction and loss: each is the one op of its shape-only path."""
    cfg = get_config("falcon-mamba-7b", smoke=True).with_(use_pallas=True)
    met = dryrun.trace_step(cfg, SMALL, None, "train", device="cpu")
    leaves = len(dryrun.trees.leaves(dryrun.steps.param_specs(build(cfg))))
    assert met["kernels"] == {"prox_update_": leaves, "ssm_scan_fwd": 2 * cfg.n_layers,
                              "ssm_scan_bwd": 2 * cfg.n_layers}


def test_record_has_the_reference_keys(world):
    mesh = fake_mesh((2, 2), ("data", "model"), "cpu")
    recs = [dryrun.run_one("qwen2-1.5b", "decode_32k", False, None, probe=False, mesh=mesh,
                           overrides={"n_layers": 2})]
    keys = {"arch", "shape", "mesh", "variant", "kind", "status", "n_devices", "lower_s",
            "compile_s", "probe_s", "cost_source", "flops_per_device", "bytes_per_device",
            "collective_bytes_per_device", "raw_loop_once", "memory", "terms", "dominant",
            "model_flops_global", "model_flops_per_device", "useful_flops_ratio",
            "hlo_bytes"}
    for rec, src in zip(recs, ("traced_full_depth",)):
        assert keys <= set(rec) and rec["status"] == "ok" and rec["cost_source"] == src
        assert rec["compile_s"] is None and rec["hlo_bytes"] is None
        assert rec["n_devices"] == 4 and rec["dominant"] in rec["terms"]
        assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                      "alias_bytes", "generated_code_bytes"}
        assert set(rec["collective_bytes_per_device"]) == set(dryrun.KINDS) | {"total"}


def test_cli_writes_a_record(world, tmp_path, capsys):
    out = str(tmp_path / "dry")
    assert dryrun.main(["--arch", "qwen2-1.5b", "--shape", "long_500k", "--device", "cpu",
                        "--out", out]) == 0
    assert "ALL DRY-RUNS PASSED" in capsys.readouterr().out
    with open(os.path.join(out, "qwen2-1.5b_long_500k_single.json")) as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["n_devices"] == 256 and rec["variant"] == "sliding8k"
    assert rec["cost_source"] == "probe_extrapolated" and rec["raw_loop_once"] is None
