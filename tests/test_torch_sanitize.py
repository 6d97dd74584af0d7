"""The port's runtime sanitizers (``repro_torch.analysis.sanitize``) on the
CPU: the reference's ``tests/test_sanitizers.py`` in the port's terms.

``compile_budget`` counts the programs the port builds at run time (a new
``RoundProgram`` on a miss in ``scan_program``'s cache, a new
``DecodeGraph``, a build of the kernel library) and the libraries found
already built; ``no_transfer`` forbids device-to-host reads; ``nan_guard``
raises at the first op whose floating output holds a NaN. Then the
zero-transfer battery: the scanned rounds of all six strategies and the
async buffer's data plane run under ``no_transfer()``, and so does the
serving engine's decode step (its warm-up and capture run under the guard
on the card). Torch runs on one intra-op thread here.
"""
import stat
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import engine, serve  # noqa: E402
from repro_torch.analysis import sanitize  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.engine.api import RoundProgram  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.models import simple  # noqa: E402
from repro_torch.utils import events, trees  # noqa: E402

TASK = simple.SYNTH_MLP
ALL = ["stocfl", "fedavg", "fedprox", "ditto", "ifca", "cfl"]


@pytest.fixture(autouse=True)
def _one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _loss(p, b):
    return simple.loss_fn(p, b, TASK)


def _acc(p, b):
    return simple.accuracy(p, b, TASK)


def _fed(n_clients=12, n_per=32, seed=3):
    clients, _, _ = synthetic.rotated(n_clusters=2, n_clients=n_clients, n_per=n_per,
                                      seed=seed)
    return clients


def _cfg(name, **kw):
    kw.setdefault("local_steps", 2)
    kw.setdefault("sample_rate", 0.5)
    kw.setdefault("seed", 0)
    kw.setdefault("rng_backend", "device")
    if name == "stocfl":
        kw.setdefault("cluster_backend", "device")
    if name == "cfl":
        kw["sample_rate"] = 1.0
        kw.setdefault("eps_rel", 0.9)
        kw.setdefault("eps2", 1e-4)
    return engine.EngineConfig(**kw)


def _init(name, clients, **kw):
    params = simple.init(torch.Generator().manual_seed(0), TASK)
    return engine.init(name, _loss, params, clients, _cfg(name, **kw), eval_fn=_acc,
                       device="cpu", arena=True)


def _step(carry, consts):
    return carry * consts + 1.0, {"s": carry.sum()}


# ============================================== compile_budget unit tests
def test_compile_budget_counts_fresh_programs():
    """A never-seen round program is counted; re-running the same span
    hits ``scan_program``'s cache and adds nothing."""
    st = _init("fedavg", _fed())
    with sanitize.compile_budget() as log:
        engine.run_rounds(st, 2)
        first = log.count
        engine.run_rounds(st, 2)
    assert first == 1, log.describe()
    assert log.count == first, "a cache hit was counted as a program"
    assert log.captures == 0 and log.cache_hits == 0      # no capture on the CPU


def test_compile_budget_overrun_raises():
    with pytest.raises(sanitize.CompileBudgetExceeded, match="budget 0"):
        with sanitize.compile_budget(0):
            RoundProgram(_step, "cpu")


def test_compile_budget_names_when_logging():
    """``log_names=True`` keeps each program's name: the round program's
    cache key, under the strategy and the cohort size."""
    st = _init("fedavg", _fed(), sample_rate=0.25)
    with sanitize.compile_budget(log_names=True) as log:
        engine.run_rounds(st, 1)
        RoundProgram(_step, "cpu", name="tagged_program")
    assert len(log.names) == 2, log.names
    assert log.names[0].startswith("scan:fedavg:3:"), log.names
    assert log.names[1] == "tagged_program"
    with sanitize.compile_budget() as quiet:
        RoundProgram(_step, "cpu", name="tagged_program")
    assert quiet.count == 1 and quiet.names == []


def test_compile_budget_nests_without_double_counting():
    """Stacked budgets each see the inner program once, and after exit the
    listeners are gone: new programs do not change the logs."""
    with sanitize.compile_budget() as outer:
        with sanitize.compile_budget() as inner:
            RoundProgram(_step, "cpu")
        n_in, n_out = inner.count, outer.count
    assert n_in == 1 and n_in == n_out
    RoundProgram(_step, "cpu")
    assert outer.count == n_out and inner.count == n_in
    assert events._listeners == []


def test_round_program_runs_the_step_as_a_plain_loop():
    carry, ys = RoundProgram(_step, "cpu")(torch.zeros(3), torch.full((3,), 2.0), 3)
    assert carry.tolist() == [7.0, 7.0, 7.0]
    assert ys["s"].tolist() == [0.0, 3.0, 9.0]


def _fake_nvcc(tmp_path):
    """A stand-in ``nvcc`` that writes each ``-o`` file it is asked for, so
    ``_build.build`` runs its whole path without a CUDA toolkit."""
    exe = tmp_path / "nvcc"
    exe.write_text(f"#!{sys.executable}\nimport sys\n"
                   "argv = sys.argv\n"
                   "open(argv[argv.index('-o') + 1], 'wb').close()\n")
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    return str(exe)


class _FakeLib:
    def __getattr__(self, name):
        return type("Fn", (), {})()


def test_kernel_library_build_is_a_program_and_a_warm_load_a_cache_hit(
        tmp_path, monkeypatch):
    """A build of the kernel library counts as a program (``_build.builds``
    agrees); a fresh process's first ``load`` that finds it already built
    (``launch.train --compile-cache``) is a cache hit, not a program."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "lib")
    monkeypatch.setattr(_build, "nvcc", lambda: _fake_nvcc(tmp_path))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: _FakeLib())
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_built", set())
    builds = _build.builds
    with sanitize.compile_budget(log_names=True) as cold:
        _build.load()
    assert (cold.count, cold.cache_hits) == (1, 0), cold.describe()
    assert _build.builds == builds + 1
    assert cold.names == [_build.library_path().name]
    # a new process: nothing built here, the library on disk
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_built", set())
    with sanitize.compile_budget(0) as warm:
        _build.load()
    assert (warm.count, warm.cache_hits) == (0, 1), warm.describe()
    assert _build.builds == builds + 1
    # the process that built it binds it again: neither a program nor a hit
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_built", {_build.library_path()})
    with sanitize.compile_budget(0) as again:
        _build.load()
    assert (again.count, again.cache_hits) == (0, 0)


# ================================================= no_transfer unit tests
@pytest.mark.parametrize("read", [
    lambda x: x[0].item(), lambda x: bool(x[0]), lambda x: x.tolist(),
    lambda x: torch.nonzero(x), lambda x: x.nonzero(), lambda x: float(x[1]),
    lambda x: int(x[1]), lambda x: x.numpy(), lambda x: np.asarray(x),
    lambda x: [0, 1, 2][x[1].long()], lambda x: torch.equal(x, x),
], ids=["item", "bool", "tolist", "nonzero", "nonzero_method", "float", "int",
        "numpy", "np_asarray", "index", "equal"])
def test_no_transfer_blocks_host_reads(read):
    x = torch.arange(4.0)
    with pytest.raises(sanitize.HostTransferError, match="no_transfer"):
        with sanitize.no_transfer():
            read(x)
    read(x)                                 # outside the guard: allowed again


def test_no_transfer_allows_pure_tensor_compute():
    x = torch.arange(37.0)
    with sanitize.no_transfer():
        y = torch.where(x > 3, x * 2, -x).sum() + x.mean()
        z = torch.func.vmap(lambda r: r.exp().sum())(x.reshape(37, 1))
        g = torch.func.grad(lambda r: (r.sin() ** 2).sum())(x)
    assert y.shape == () and z.shape == (37,) and g.shape == (37,)


def test_no_transfer_exempts_plain_versions_on_cpu_only():
    """``component_labels_ref``'s pass loop reads the host once a pass; as
    a kernel's plain version on CPU tensors it is exempt (on the card the
    kernel runs in its place). The same loop unmarked raises."""
    adj = torch.zeros((6, 6))
    adj[0, 3] = adj[3, 0] = adj[1, 2] = adj[2, 1] = 1.0
    with sanitize.no_transfer():
        labels = ref.component_labels_ref(adj)
        labels2 = ops.component_labels(adj)
    assert labels.tolist() == [0, 1, 1, 0, 4, 5]
    assert torch.equal(labels, labels2)
    unmarked = ref.component_labels_ref.__wrapped__
    with pytest.raises(sanitize.HostTransferError):
        with sanitize.no_transfer():
            unmarked(adj)
    assert not events.host_reads_exempt()


def test_no_transfer_leaves_no_mode_behind():
    with pytest.raises(sanitize.HostTransferError):
        with sanitize.no_transfer():
            torch.ones(2)[0].item()
    assert torch.ones(2)[0].item() == 1.0
    assert torch.ones(2).nonzero().shape == (2, 1)


# =================================================== nan_guard unit tests
def test_nan_guard_raises_on_a_nan_forward_and_restores():
    x = torch.tensor([-1.0, 2.0])
    with pytest.raises(FloatingPointError, match="aten.log"):
        with sanitize.nan_guard():
            torch.log(x)
    assert events.nan_checks == 0
    assert torch.isnan(torch.log(x)[0])     # outside the guard: quiet again


def test_nan_guard_raises_on_a_nan_backward():
    """sqrt(x)·0 at x = 0 is 0 forward; its backward divides 0 by 0."""
    x = torch.zeros(3, requires_grad=True)
    with sanitize.nan_guard():
        y = (x.sqrt() * 0.0).sum()
        assert y.item() == 0.0
        with pytest.raises(FloatingPointError, match="NaN"):
            y.backward()
    with pytest.raises(FloatingPointError):
        with sanitize.nan_guard():
            torch.func.grad(lambda v: (v.sqrt() * 0.0).sum())(torch.zeros(3))


def test_nan_guard_under_vmap_and_infinities():
    with pytest.raises(FloatingPointError):
        with sanitize.nan_guard():
            torch.func.vmap(lambda r: r / r)(torch.zeros(4, 2))
    with sanitize.nan_guard():                   # ±inf is a sentinel on the path
        torch.full((3,), float("inf"))
        torch.where(torch.ones(3) > 0, torch.full((3,), float("-inf")), 0.0)


def test_nan_guard_skips_views_and_uninitialised_allocations():
    buf = torch.full((4,), float("nan"))
    with sanitize.nan_guard():
        torch.empty(1000)
        buf[1:3]
        buf.view(2, 2)


def test_nan_guard_catches_a_kernel_wrapper_output_on_the_cpu():
    """On CPU tensors K1's wrapper runs its plain version, whose ops the
    guard checks: a NaN gradient raises."""
    th, om = torch.zeros(8), torch.zeros(8)
    g = torch.zeros(8)
    g[3] = float("nan")
    with pytest.raises(FloatingPointError):
        with sanitize.nan_guard():
            ops.prox_update_flat(th, om, g, torch.zeros(8), 0.1, 0.05)


def test_nan_guard_clean_stocfl_round():
    """A healthy StoCFL round under nan_guard, scanned and eager: no false
    positive from the engine's own math (masked divisions divide by 1)."""
    st = _init("stocfl", _fed())
    with sanitize.nan_guard():
        st2 = engine.run_rounds(st, 1)
        st3, rec = engine.run_round(st)
    assert st2.round == 1 and st3.round == 1 and rec["sampled"] == 6


def test_guards_nest_and_compose():
    st = _init("fedavg", _fed())
    engine.run_rounds(st, 2)
    with sanitize.no_transfer(), sanitize.nan_guard(), sanitize.compile_budget(0) as log:
        fn, carry0, consts, _finalize = engine.scan_program(st, 2)
        fn(carry0, consts)
    assert log.count == 0
    assert events.nan_checks == 0 and not events.host_reads_exempt()


# ======================================= zero-transfer battery, six strategies
@pytest.mark.parametrize("name", ALL)
def test_scanned_rounds_zero_host_transfers(name):
    """The scanned rounds of every strategy make no host read: after a
    warm-up call of the span, re-running it under ``no_transfer()``
    completes (draw, gather, train, cluster, aggregate). ``finalize`` is
    the host hand-off and stays outside the guard."""
    st = _init(name, _fed())
    rounds = 3
    prog = engine.scan_program(st, rounds)
    assert prog is not None
    fn, carry0, consts, finalize = prog
    fn(carry0, consts)
    with sanitize.no_transfer():
        carry, ys = fn(carry0, consts)
    st2 = finalize(st, carry, ys, rounds)
    assert st2.round == st.round + rounds
    assert len(st2.history) == len(st.history) + rounds


def test_async_buffer_data_plane_zero_host_transfers():
    """The async buffer's data plane (slot scatter at dispatch, row gather
    at flush, the weighted mean of the flushed stack) on device slot
    indices runs under ``no_transfer()``; the control plane (entries,
    staleness weights) is host-side by design."""
    from repro_torch.core import bilevel
    from repro_torch.engine.async_agg import _gather_rows
    from repro_torch.sharding.specs import RowOwners
    st = _init("fedavg", _fed(), async_cfg=engine.AsyncConfig())
    st, _ = engine.run_round_async(st)
    rows = st.buffer.payload
    slots = torch.arange(4)
    upd = trees.tree_map(lambda r: r[:4], rows)
    w = torch.ones(4)
    with sanitize.no_transfer():
        rows2 = RowOwners().scatter(rows, slots, upd)
        merged = bilevel.aggregate_stacked(_gather_rows(rows2, slots), w)
    assert merged is not None


def test_scan_program_skipped_pool_returns_none():
    st = _init("fedavg", _fed())
    assert engine.scan_program(st, 2, unavailable=set(range(12))) is None
    st2 = engine.run_rounds(st, 2, unavailable=set(range(12)))
    assert [r.get("skipped") for r in st2.history[-2:]] == [True, True]


def test_decode_step_makes_no_host_read():
    """The serving engine's decode bursts (on the card: the warm-up step
    and the capture of ``DecodeGraph``, both under ``no_transfer``) read
    nothing back on the CPU either: qwen2 smoke, two clusters."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.registry import build
    cfg = get_config("qwen2-1.5b", smoke=True)
    model = build(cfg)
    st = launch_serve.build_server_state(cfg, model, 2, 0.3, 0, device="cpu")
    eng = serve.ServeEngine(model, st, serve.ServeConfig(slots=2, max_len=16, max_gen=4))
    burst = eng._decode_burst

    def guarded(n):
        with sanitize.no_transfer():
            burst(n)

    eng._decode_burst = guarded
    eng.submit_many(launch_serve.make_requests(cfg, 2, 8, 4, 2))
    res = eng.run()
    assert len(res) == 2 and all(len(r.tokens) == 4 for r in res.values())
    assert eng.stats()["decode_steps"] > 0
