"""The port's LLM parameter rule table (``repro_torch.sharding``) against
the JAX package's (``repro.sharding.specs``), with no process group but
the last test's world of one.

- ``spec_for_path`` and ``param_shardings``' relaxed specs equal the
  reference's exactly, as tuples, for every parameter leaf of each of the
  ten smoke configurations, under the reference's default logical map and
  with ``fsdp`` unmapped (the serving layout), on fake meshes ``(data,
  model)`` of (1,1), (2,1), (1,2), (2,2), (4,2), (2,4) and ``(pod, data,
  model)`` = (2,2,2). The reference's side is its ``spec_for_path``
  relaxed dimension by dimension by its own ``_divisible``; on the
  one-device host mesh it is its ``param_shardings``.
- The spec → DTensor placement map, case by case.
- The cases of ``tests/test_sharding_launch.py``'s rule tests.
- The hooks return their input when no ``ShardCtx`` over a mesh is
  entered, and ``make_host_mesh`` builds its 2-D mesh.
"""
import contextlib
import functools
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch.mesh import make_host_mesh as jax_host_mesh  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.sharding import specs as jspecs  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.core.extractor import leaf_paths  # noqa: E402
from repro_torch.launch.steps import param_specs  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402
from repro_torch.sharding.specs import Replicate, Shard  # noqa: E402
from repro_torch.utils import trees  # noqa: E402

MESHES = {"1x1": {"data": 1, "model": 1}, "2x1": {"data": 2, "model": 1},
          "1x2": {"data": 1, "model": 2}, "2x2": {"data": 2, "model": 2},
          "4x2": {"data": 4, "model": 2}, "2x4": {"data": 2, "model": 4},
          "pod2x2x2": {"pod": 2, "data": 2, "model": 2}}
MAPS = ("default", "fsdp-none")


def _fake(shape):
    return SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))


@functools.lru_cache(maxsize=None)
def _leaves(arch):
    """(path, shape) of every parameter leaf of ``arch``'s smoke config:
    the reference's (its ``_path_str`` of ``eval_shape``'s tree) and the
    port's (``leaf_paths`` of ``param_specs``)."""
    ref = jax.eval_shape(jbuild(jget_config(arch, smoke=True)).init, jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    want = [(jspecs._path_str(kp), tuple(x.shape)) for kp, x in flat]
    tree = param_specs(build(get_config(arch, smoke=True)))
    got = list(zip(leaf_paths(tree), [tuple(s.shape) for s in trees.leaves(tree)]))
    return want, got, ref, tree


def _ctxs(mesh, which):
    """The port's and the reference's ``ShardCtx`` for ``mesh``."""
    ctx, jctx = specs.ShardCtx(mesh), jspecs.ShardCtx(mesh)
    if which == "fsdp-none":
        ctx = specs.ShardCtx(mesh, {**ctx.logical_map, "fsdp": None})
        jctx = jspecs.ShardCtx(mesh, {**jctx.logical_map, "fsdp": None})
    return ctx, jctx


def _ref_relaxed(spec, shape, mesh):
    """The reference's spec with each dimension its ``_divisible`` rejects
    replicated."""
    return tuple(e if e is None or jspecs._divisible(SimpleNamespace(shape=(d,)), P(e), mesh)
                 else None for d, e in zip(shape, spec))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_leaves_are_the_references(arch):
    want, got, _, _ = _leaves(arch)
    assert got == want


GRID = [(a, m, w) for a in ARCH_IDS for m in MESHES for w in MAPS]


@pytest.mark.parametrize("arch,mesh,which", GRID, ids=[f"{a}-{m}-{w}" for a, m, w in GRID])
def test_specs_are_the_references(arch, mesh, which):
    mesh = _fake(MESHES[mesh])
    ctx, jctx = _ctxs(mesh, which)
    want, _, _, tree = _leaves(arch)
    shardings = dict(zip(leaf_paths(tree), trees.leaves(specs.param_shardings(tree, mesh, ctx))))
    for path, shape in want:
        ref = tuple(jspecs.spec_for_path(path, len(shape), jctx))
        assert specs.spec_for_path(path, len(shape), ctx) == ref, path
        assert shardings[path].spec == _ref_relaxed(ref, shape, mesh), path


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_host_mesh_shardings_are_the_references(arch):
    """On the reference's one-device host mesh its ``param_shardings``
    gives the port's specs, leaf for leaf."""
    _, _, ref, tree = _leaves(arch)
    want = [tuple(s.spec) for s in jax.tree.leaves(jspecs.param_shardings(ref, jax_host_mesh()))]
    got = specs.param_shardings(tree, _fake({"data": 1, "model": 1}))
    assert [s.spec for s in trees.leaves(got)] == want


R = Replicate()
PLACEMENT_CASES = [
    ({"data": 2, "model": 2}, ("data", "model"), (Shard(0), Shard(1))),
    ({"data": 2, "model": 2}, ("model", "data"), (Shard(1), Shard(0))),
    ({"data": 2, "model": 2}, (None, "model"), (R, Shard(1))),
    ({"data": 2, "model": 2}, (None, "data", "model"), (Shard(1), Shard(2))),
    ({"data": 2, "model": 2}, (None, None), (R, R)),
    ({"data": 2, "model": 2}, (), (R, R)),
    ({"pod": 2, "data": 2, "model": 2}, (("pod", "data"), None, "model"),
     (Shard(0), Shard(0), Shard(2))),
    ({"pod": 2, "data": 2, "model": 2}, ("data", None), (R, Shard(0), R)),
    ({"clients": 4}, ("clients", None), (Shard(0),)),
]


@pytest.mark.parametrize("shape,spec,want", PLACEMENT_CASES,
                         ids=[f"{'x'.join(s)}-{p}" for s, p, _ in PLACEMENT_CASES])
def test_spec_to_placements(shape, spec, want):
    got = specs.placements(spec, _fake(shape))
    assert got == want
    assert specs.NamedSharding(_fake(shape), spec).placements == want


@pytest.mark.parametrize("spec", [(("data", "pod"), None), ("data", "data")],
                         ids=["out-of-order", "axis-twice"])
def test_spec_to_placements_raises(spec):
    with pytest.raises(ValueError):
        specs.placements(spec, _fake({"pod": 2, "data": 2, "model": 2}))


def test_spec_rules():
    """``tests/test_sharding_launch.py::test_spec_rules`` on the port."""
    ctx = specs.ShardCtx(None, {"tp": "model", "fsdp": "data", "batch": ("pod", "data"),
                                "expert": "model"})
    assert specs.spec_for_path("layers/attn/wq", 2, ctx) == ("data", "model")
    assert specs.spec_for_path("layers/mlp/w_down", 2, ctx) == ("model", "data")
    assert specs.spec_for_path("embed", 2, ctx) == ("model", None)
    assert specs.spec_for_path("lm_head", 2, ctx) == (None, "model")
    assert specs.spec_for_path("layers/attn/wq", 3, ctx) == (None, "data", "model")
    assert specs.spec_for_path("layers/mlp/experts/w_gate", 4, ctx) == (
        None, "model", "data", None)
    assert specs.spec_for_path("final_norm/scale", 1, ctx) == (None,)
    assert ctx.resolve(["batch", None, "tp"]) == (("pod", "data"), None, "model")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_shardings_divisibility_relaxed(mesh):
    """``tests/test_sharding_launch.py::
    test_param_shardings_divisibility_relaxed`` on the port, on every
    mesh: every sharded dim divides its axes' product."""
    fake = _fake(MESHES[mesh])
    tree = param_specs(build(get_config("qwen2-1.5b", smoke=True)))
    for s, sh in zip(trees.leaves(tree), trees.leaves(specs.param_shardings(tree, fake))):
        for dim, ax in zip(s.shape, sh.spec):
            if ax is not None:
                n = 1
                for a in (ax if isinstance(ax, tuple) else (ax,)):
                    n *= MESHES[mesh][a]
                assert dim % n == 0


def test_resolve_is_the_references():
    for shape in MESHES.values():
        mesh = _fake(shape)
        for which in MAPS:
            ctx, jctx = _ctxs(mesh, which)
            for logical in (["batch", None, "tp"], ["fsdp", "tp"], ["expert", None],
                            [None], ["unmapped"]):
                assert ctx.resolve(logical) == tuple(jctx.resolve(logical)), (shape, logical)


def test_hooks_are_no_ops_without_a_ctx():
    x = torch.zeros(4, 6)
    tree = {"attn": {"wq": torch.zeros(8, 8)}}
    assert specs.current_ctx() is None
    assert specs.shard(x, "batch", "tp") is x
    assert specs.unshard_fsdp(tree) is tree
    with specs.ShardCtx(None):
        assert specs.shard(x, "batch", "tp") is x and specs.unshard_fsdp(tree) is tree
    with specs.ShardCtx(_fake({"data": 2, "model": 2})) as ctx:
        assert specs.current_ctx() is ctx
        assert specs.shard(x, "batch", "tp") is x          # a plain tensor stays as it is
        assert specs.unshard_fsdp(tree)["attn"]["wq"] is tree["attn"]["wq"]
    assert specs.current_ctx() is None


def test_place_decode_state_takes_the_ranks_groups():
    mesh = SimpleNamespace(axis_names=("clients",), shape={"clients": 2},
                           get_coordinate=lambda: [1])
    tree = {"k": torch.arange(12.0).reshape(4, 3), "s": torch.zeros(())}
    got = specs.place_decode_state(tree, mesh)
    assert torch.equal(got["k"], tree["k"][2:]) and got["s"] is tree["s"]
    odd = torch.zeros(3, 2)
    assert specs.place_decode_state(odd, mesh) is odd


def test_make_host_mesh_world_of_one():
    from repro_torch.launch.mesh import make_host_mesh
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_host_mesh(device="cpu")
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.mesh.shape) == (1, 1)
        assert tuple(make_host_mesh(4, device="cpu").mesh.shape) == (1, 1)
        ctx = specs.ShardCtx(mesh)
        assert ctx.logical_map == {"batch": ("data",), "fsdp": "data", "tp": "model",
                                   "expert": "model"}
        assert ctx.resolve(["batch", "tp"]) == ("data", "model")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("entered", [True, False], ids=["ctx", "no-ctx"])
def test_remat_recomputes_under_the_forward_ctx_on_another_thread(entered):
    """``layers.remat``'s backward may run on autograd's own thread (on the
    card it does): the recompute re-enters the forward's ``ShardCtx``
    there, so the layer's hooks place its values as the forward did."""
    import threading

    from repro_torch.models import layers
    seen = []

    def body(x):
        seen.append(specs.current_ctx())
        return x * 2.0

    x = torch.ones(3, requires_grad=True)
    ctx = specs.ShardCtx(_fake({"data": 1, "model": 1})) if entered else None
    with ctx or contextlib.nullcontext():
        y = layers.remat(SimpleNamespace(remat=True), body, x)
    out = {}
    worker = threading.Thread(target=lambda: out.update(g=torch.autograd.grad(y.sum(), x)[0]))
    worker.start()
    worker.join()
    assert seen == [ctx, ctx] and torch.equal(out["g"], torch.full((3,), 2.0))
    assert specs.current_ctx() is None


def test_exports_are_the_references():
    """``repro_torch.sharding`` exports every public name of
    ``repro.sharding``; ``repro_torch.launch`` has ``make_host_mesh`` and
    ``steps`` with the reference's step builders."""
    import repro.sharding as jsharding
    import repro_torch.launch as launch
    import repro_torch.sharding as sharding
    from repro.launch import steps as jsteps
    assert set(jsharding.__all__) <= set(sharding.__all__)
    assert all(hasattr(sharding, name) for name in sharding.__all__)
    assert callable(launch.make_host_mesh)
    for name in ("batch_shardings", "cache_shardings", "stocfl_train_step", "lm_train_step",
                 "prefill_step", "decode_step", "repr_step", "lower_step"):
        assert hasattr(jsteps, name) and callable(getattr(launch.steps, name)), name
