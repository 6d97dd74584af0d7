"""The port's client-axis sharding helpers (``repro_torch.sharding``)
against the JAX package's (``repro.sharding.specs``), and the port's
rank-0 logger.

The axis helpers (``client_axes``, ``mesh_client_count``,
``align_cohort_chunk``, ``cohort_spec``, the divisibility rule) read only
axis names and sizes, so, as ``tests/test_shard_properties.py`` does,
the properties sweep fake meshes over arbitrary axis layouts and hold
the port's answers to the reference's on each. ``mesh_fingerprint`` and
``place_cohort`` run on a real ``DeviceMesh`` over a ``gloo`` world of
one; the logger runs in a world of two processes.
"""
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.launch.mesh import make_client_mesh as jax_client_mesh  # noqa: E402
from repro.sharding import specs as jspecs  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402
from repro_torch.sharding.specs import Replicate, Shard  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
CLIENT_AXES = ("pod", "data", "clients")
OTHER_AXES = ("model", "expert")


@st.composite
def fake_meshes(draw):
    """1-4 named axes of sizes 1-16, client-carrying and other axes mixed,
    in any order."""
    n_axes = draw(st.integers(1, 4))
    names = draw(st.permutations(CLIENT_AXES + OTHER_AXES))[:n_axes]
    shape = {a: draw(st.integers(1, 16)) for a in names}
    return SimpleNamespace(axis_names=tuple(names), shape=shape)


@settings(max_examples=150, deadline=None)
@given(fake_meshes(), st.integers(0, 4096))
def test_align_cohort_chunk_is_the_reference(mesh, chunk):
    got = specs.align_cohort_chunk(chunk, mesh)
    assert got == jspecs.align_cohort_chunk(chunk, mesh)
    n = specs.mesh_client_count(mesh)
    if chunk > 0:
        assert got % n == 0 and 0 <= got - chunk < n


@settings(max_examples=50, deadline=None)
@given(st.integers(0, 4096))
def test_align_is_the_identity_without_a_mesh(chunk):
    assert specs.align_cohort_chunk(chunk, None) == chunk


@settings(max_examples=150, deadline=None)
@given(fake_meshes())
def test_client_axes_and_count_are_the_reference(mesh):
    assert specs.client_axes(mesh) == jspecs.client_axes(mesh)
    assert specs.mesh_client_count(mesh) == jspecs.mesh_client_count(mesh)


@settings(max_examples=150, deadline=None)
@given(fake_meshes(), st.integers(0, 5))
def test_cohort_spec_is_the_reference(mesh, ndim):
    """``Shard(0)`` exactly where the reference shards the leading axis,
    ``Replicate()`` where it gives ``P()``."""
    ref = jspecs.cohort_spec(mesh, ndim)
    got = specs.cohort_spec(mesh, ndim)
    if len(ref) == 0:
        assert isinstance(got, Replicate)
    else:
        assert isinstance(got, Shard) and got.dim == 0
        assert all(s is None for s in ref[1:])


@settings(max_examples=150, deadline=None)
@given(fake_meshes(), st.integers(1, 64), st.integers(0, 3))
def test_divisibility_rule_is_the_reference(mesh, rows, trailing):
    x = SimpleNamespace(shape=(rows,) + (3,) * trailing, ndim=1 + trailing)
    ref = jspecs._divisible(x, jspecs.cohort_spec(mesh, x.ndim), mesh)
    assert specs._divisible(x, specs.cohort_spec(mesh, x.ndim), mesh) == ref


@settings(max_examples=100, deadline=None)
@given(st.integers(1, 64), st.integers(1, 8))
def test_row_split_relaxes_exactly_where_rows_do_not_divide(rows, ranks):
    mesh = SimpleNamespace(axis_names=("clients",), shape={"clients": ranks},
                           get_coordinate=lambda: [ranks - 1])
    split = specs.row_split(rows, mesh)
    assert split.sharded == (rows % ranks == 0)
    if split.sharded:
        k = rows // ranks
        assert (split.lo, split.hi) == ((ranks - 1) * k, rows)
    else:
        assert (split.lo, split.hi) == (0, rows)


@pytest.fixture(scope="module")
def world_of_one():
    """A ``gloo`` world of one for this module, torn down after it."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mesh_fingerprint_is_the_reference(world_of_one):
    from repro_torch.launch.mesh import make_client_mesh, make_cohort_mesh
    assert specs.mesh_fingerprint(None) is None is jspecs.mesh_fingerprint(None)
    m = make_client_mesh(1, device="cpu")
    assert specs.mesh_fingerprint(m) == jspecs.mesh_fingerprint(jax_client_mesh(1))
    assert specs.mesh_fingerprint(m) == specs.mesh_fingerprint(
        make_client_mesh(1, device="cpu"))
    assert hash(specs.mesh_fingerprint(m)) is not None
    d = make_cohort_mesh(1, device="cpu")
    assert specs.mesh_fingerprint(d)[0] == ("data",)
    assert specs.mesh_fingerprint(m) != specs.mesh_fingerprint(d)


def test_place_cohort_relaxes_non_divisible_rows(world_of_one):
    """On a real mesh every rank's slice of rows that divide, the whole
    tensor for rows that do not, with no error either way (the multi-rank
    slices are held in ``tests/test_torch_mesh.py``)."""
    from repro_torch.launch.mesh import make_client_mesh
    mesh = make_client_mesh(device="cpu")
    n = specs.mesh_client_count(mesh)
    ok = torch.zeros((4 * n, 3))
    placed = specs.place_cohort({"x": ok, "s": torch.zeros(())}, mesh)
    assert placed["x"].shape == (4, 3) and placed["s"].shape == ()
    assert isinstance(specs.cohort_spec(mesh, 2), Shard)
    bad = torch.zeros((4 * n + 1, 3))
    assert specs.place_cohort(bad, mesh) is bad
    assert specs.place_buffer_rows(bad, mesh) is bad
    assert specs.constrain_cohort(ok, None) is ok


def test_psum_segments_dense_fallback_without_a_mesh():
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=(6, 4)).astype(np.float32))
    w = torch.as_tensor(rng.uniform(1, 3, size=6).astype(np.float32))
    seg = torch.as_tensor([0, 2, 1, 0, 2, 2])
    got = specs.psum_segments(x, w, seg, 3, None)
    want = jax.ops.segment_sum(np.asarray(x) * np.asarray(w)[:, None], np.asarray(seg),
                               num_segments=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_aggregate_segments_runs_segment_sum():
    """The engine's per-cluster FedAvg is ``segment_sum`` of the rows under
    their normalised weights, bit for bit, and without a mesh the
    weighted mean it always was (weights over their segment's total, one
    ``index_add_``)."""
    from repro_torch.core import bilevel
    rng = np.random.default_rng(2)
    x = {"w": torch.as_tensor(rng.normal(size=(8, 3, 2)).astype(np.float32)),
         "b": torch.as_tensor(rng.normal(size=(8, 5)).astype(np.float32))}
    w = torch.as_tensor(rng.uniform(1, 3, size=8).astype(np.float32))
    seg = torch.as_tensor([0, 2, 1, 0, 2, 2, 1, 3])
    got = bilevel.aggregate_segments(x, w, seg, 5)
    denom = torch.zeros(5).index_add_(0, seg, w)
    for k, v in x.items():
        wn = (w / denom[seg]).reshape((-1,) + (1,) * (v.dim() - 1))
        want = torch.zeros((5,) + v.shape[1:]).index_add_(0, seg, v * wn)
        assert torch.equal(got[k], want), k
        assert torch.equal(got[k], specs.segment_sum(x, w / denom[seg], seg, 5)[k]), k
    assert not got["b"][4].any()                 # a segment with no rows


@pytest.mark.parametrize("shape", [(9,), (9, 4), (9, 40000)])
def test_ordered_index_add_is_index_add(shape):
    """The fixed-order segment add sums each index's rows in index order,
    as ``index_add_`` does on the CPU: the same bits, repeated indices,
    empty segments and rows enough for several threads included, with no
    global mode switched on."""
    rng = np.random.default_rng(3)
    src = torch.as_tensor(rng.normal(size=shape).astype(np.float32)) * 1e3
    idx = torch.as_tensor([4, 0, 4, 4, 1, 0, 4, 1, 4])
    before = torch.are_deterministic_algorithms_enabled()
    want = torch.zeros((6,) + shape[1:]).index_add_(0, idx, src)
    got = specs.ordered_index_add_(torch.zeros((6,) + shape[1:]), idx, src)
    assert torch.equal(got, want) and not got[2:4].any()
    assert torch.are_deterministic_algorithms_enabled() == before


def test_unsplit_rows_keep_the_mesh():
    """Rows that do not divide the ranks are not split, but still know
    their mesh, so their sums (every rank's own) run in one fixed order
    (``segment_sum``)."""
    mesh = SimpleNamespace(axis_names=("clients",), shape={"clients": 2},
                           get_coordinate=lambda: [1])
    split = specs.row_split(5, mesh)
    assert not split.sharded and split.mesh is mesh
    x = torch.arange(10.0).reshape(5, 2)
    assert split.take(x) is x and split.reduce_(x) is x and split.gather(x) is x
    assert specs.row_split(4, mesh).sharded and specs.row_split(4, None).mesh is None


_LOGGER = """
import datetime, sys, torch.distributed as dist
rank, path = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", store=dist.FileStore(path, 2), rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=60))
from repro_torch.utils.logging import get_logger
log = get_logger("mesh")
log.info("hello", rank=rank)
log.metric("loss", value=1.5)
dist.barrier()
dist.destroy_process_group()
"""


def test_logger_emits_on_rank_zero_only(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", _LOGGER, str(r), store], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=60))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    records = [[ln for ln in err.splitlines() if ln.startswith("{")] for _out, err in outs]
    assert len(records[0]) == 2 and '"rank": 0' in records[0][0]
    assert records[1] == []


def test_logger_emits_without_a_group(capsys):
    from repro_torch.utils.logging import Logger
    Logger("solo", stream=sys.stdout).warn("careful", n=1)
    line = capsys.readouterr().out.strip()
    assert '"lvl": "warn"' in line and '"n": 1' in line
