"""Spawns ``gloo`` worlds of worker processes on the CPU for the port's
mesh tests: ``start_worlds(worker, root, [(world, *args), ...])`` starts
``python WORKER RANK WORLD ROOT *args`` once per rank of every world, all
at once, with one intra-op thread each; ``Worlds.wait`` waits at most
``timeout`` seconds from the start for all of them, fails the test (with
the rank's log) if one exits non-zero, and kills every process it
started on the way out (``run_worlds`` does both). The
ranks of a world join through a ``FileStore`` under ``ROOT`` named by
their arguments and write their results there. ``close`` holds one
tree of results against another, leaf by leaf, relative to the largest
magnitude of each reference leaf."""
import os
import subprocess
import sys
import time

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
WORLD_TIMEOUT = 60.0          # seconds the worlds may take before they fail


class Worlds:
    def __init__(self, worker, root: str, worlds, timeout: float):
        env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        self.worlds, self.timeout = worlds, timeout
        self.deadline = time.monotonic() + timeout
        self.procs = []
        for world, *args in worlds:
            for r in range(world):
                cmd = [sys.executable, worker, str(r), str(world), root, *map(str, args)]
                self.procs.append(((world, *args), r, subprocess.Popen(
                    cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))

    def wait(self) -> None:
        logs = []
        try:
            for _, _, p in self.procs:
                out, _ = p.communicate(timeout=max(self.deadline - time.monotonic(), 1.0))
                logs.append(out.decode(errors="replace")[-4000:])
        except subprocess.TimeoutExpired:
            pytest.fail(f"the worlds {self.worlds} did not finish within {self.timeout} s")
        finally:
            self.kill()
        for (world, r, p), log in zip(self.procs, logs):
            assert p.returncode == 0, f"world {world} rank {r} failed:\n{log}"

    def kill(self) -> None:
        for _, _, p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def start_worlds(worker, root: str, worlds, timeout: float = WORLD_TIMEOUT) -> Worlds:
    return Worlds(worker, root, worlds, timeout)


def run_worlds(worker, root: str, worlds, timeout: float = WORLD_TIMEOUT) -> None:
    start_worlds(worker, root, worlds, timeout).wait()


def flat(tree, prefix=""):
    """A nested dict of arrays as ``{"a/b": float64 array}``."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in flat(tree[key], f"{prefix}{key}/").items()}
    return {prefix[:-1]: np.asarray(tree, np.float64)}


def close(got, want, tol, what):
    """Every leaf of ``got`` within ``tol`` of the largest magnitude of its
    leaf in ``want``; returns the largest such relative error."""
    g, w = flat(got), flat(want)
    assert set(g) == set(w), what
    worst = 0.0
    for k in w:
        assert g[k].shape == w[k].shape, (what, k)
        err = float(np.max(np.abs(g[k] - w[k]))) if w[k].size else 0.0
        scale = max(float(np.max(np.abs(w[k]))), 1e-30) if w[k].size else 1.0
        assert err <= tol * scale, (what, k, err / scale)
        worst = max(worst, err / scale)
    return worst
