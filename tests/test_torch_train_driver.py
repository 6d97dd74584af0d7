"""The port's training driver ``python -m repro_torch.launch.train``
against the JAX package's ``repro.launch.train``, on the CPU.

Classification mode at ``--rounds 3 --clients 24`` (the rotated setting,
StoCFL, the numpy cohort sampler both packages draw alike): torch cannot
reproduce ``jax.random``'s parameter draws, so the port's ``simple.init``
is replaced here by one that hands over the reference's initial MLP
parameters through numpy. Then ``ari`` and ``n_clusters`` are equal and
the accuracies agree within 1e-5. Also: the printed JSON has the
reference's keys in both modes, ``--save`` writes the reference's
checkpoint files, ``--compile-cache`` raises naming its ROADMAP.md item,
``--mesh`` runs a world of one (and, under ``torchrun``, two ranks) that
prints the JSON once, and without ``--device cpu`` and without a GPU the
driver raises instead of running on the CPU.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.launch import train as jtrain  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import load_server_state  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import simple as tsimple  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ATOL = 1e-5
CLASSIFY = ["--rounds", "3", "--clients", "24", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _last_json(text):
    """The JSON object the driver prints last (indented over lines)."""
    return json.loads(text[text.rindex("\n{") + 1:])


def _reference_init(generator, task, device="cpu"):
    """The reference's initial parameters for the driver's seed (0), in
    place of a torch draw."""
    del generator
    return convert.to_torch(jsimple.init(jax.random.PRNGKey(0), task), device)


@pytest.fixture(scope="module")
def classification(tmp_path_factory):
    """Both drivers' classification runs on the same parameters, with
    their printed output; the port's also saves a checkpoint."""
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    args = ttrain.build_parser().parse_args(CLASSIFY + ["--save", ckpt])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsimple, "init", _reference_init)
        got = ttrain.run_classification(args)
    want = jtrain.run_classification(ttrain.build_parser().parse_args(CLASSIFY))
    return got, want, ckpt


def test_classification_matches_reference(classification):
    got, want, _ = classification
    assert sorted(got) == sorted(want)
    assert got["ari"] == want["ari"] and got["n_clusters"] == want["n_clusters"]
    assert (got["algo"], got["rounds"]) == (want["algo"], want["rounds"]) == ("stocfl", 3)
    for key in ("cluster_avg_acc", "global_avg_acc"):
        assert abs(got[key] - want[key]) <= ATOL, (key, got[key], want[key])


def test_save_writes_the_reference_checkpoint_files(classification):
    _, _, ckpt = classification
    assert {"arrays.npz", "manifest.json", "reps.npz"} <= set(os.listdir(ckpt))
    with open(os.path.join(ckpt, "manifest.json")) as f:
        assert json.load(f)["strategy"] == "stocfl"
    params = tsimple.init(torch.Generator().manual_seed(0), tsimple.SYNTH_MLP)
    from repro_torch import engine
    st = engine.init("stocfl", lambda p, b: tsimple.loss_fn(p, b, tsimple.SYNTH_MLP),
                     params, [], engine.EngineConfig(), device="cpu")
    st = load_server_state(ckpt, st)
    assert st.round == 3 and st.clusters.n_clusters() >= 1


def test_main_prints_the_reference_json_in_both_modes(capsys):
    out = ttrain.main(["--rounds", "1", "--clients", "8", "--device", "cpu"])
    printed = _last_json(capsys.readouterr().out)
    assert printed == out
    assert set(out) == {"algo", "rounds", "cluster_avg_acc", "wall_s", "ari",
                        "n_clusters", "global_avg_acc"}
    out = ttrain.main(["--arch", "zamba2-1.2b", "--smoke", "--rounds", "1", "--clients", "2",
                       "--seq-len", "16", "--batch", "1", "--device", "cpu"])
    text = capsys.readouterr().out
    assert text.startswith("round 0: clusters=")
    assert _last_json(text) == out
    assert set(out) == {"arch", "ari", "n_clusters", "rounds", "wall_s"}
    assert out["arch"] == "zamba2-1.2b" and np.isfinite(out["ari"])


@pytest.mark.parametrize("flag,item", [(["--compile-cache", "auto"], "queue 1 item 1"),
                                       (["--compile-cache"], "queue 1 item 1"),
                                       (["--compile-cache", "/nonexistent"], "queue 1 item 1")])
def test_unported_flags_raise_naming_their_item(flag, item):
    with pytest.raises(NotImplementedError, match=item):
        ttrain.main(CLASSIFY + flag)


def _same_but_wall(a, b):
    return {k: v for k, v in a.items() if k != "wall_s"} == \
        {k: v for k, v in b.items() if k != "wall_s"}


def test_mesh_runs_a_world_of_one_and_prints_the_json_once(capsys):
    """Without ``torchrun`` ``--mesh`` is a world of one over an in-process
    store, which the driver tears down again; its result is the run
    without a mesh."""
    out = ttrain.main(CLASSIFY + ["--sample-rate", "0.5", "--mesh"])
    text = capsys.readouterr().out
    assert text.count('"algo"') == 1 and _last_json(text) == out
    assert not torch.distributed.is_initialized()
    assert _same_but_wall(out, ttrain.main(CLASSIFY + ["--sample-rate", "0.5"]))


def test_mesh_under_torchrun_prints_one_json_from_rank_zero(tmp_path):
    """Two CPU ranks under ``torchrun --standalone``: one JSON, rank 0's,
    with the world of one's clustering."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    argv = CLASSIFY + ["--sample-rate", "0.5", "--mesh"]
    run = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", "2", "-m", "repro_torch.launch.train"] + argv,
                         env=env, cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stderr[-4000:]
    assert run.stdout.count('"algo"') == 1
    out = _last_json(run.stdout)
    assert out["n_clusters"] == 4 and out["ari"] == 1.0


def test_async_with_scan_rounds_is_refused():
    with pytest.raises(SystemExit):
        ttrain.main(CLASSIFY + ["--async", "--scan-rounds"])


@pytest.mark.parametrize("argv", [["--rounds", "1", "--clients", "8"],
                                  ["--arch", "zamba2-1.2b", "--smoke", "--rounds", "1"]])
def test_refuses_to_run_on_cpu_unasked(monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ttrain.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(argv)
