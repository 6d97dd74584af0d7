"""``repro_torch.utils.cache``: the persistent cache of the CUDA kernel
library, the port's counterpart of the JAX package's XLA compilation
cache. ``enable_compilation_cache`` returns and creates its directory and
points ``kernels._build.BUILD_DIR`` at it; the default honours
``$REPRO_TORCH_COMPILATION_CACHE_DIR``, then ``~/.cache``. The warm
start runs in a fresh process: with a library already at
``library_path()`` in the cache, ``build()`` returns it and compiles
nothing (``nvcc`` is replaced by a function that fails, so a cold build
would raise), while an empty cache does try to build."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.utils import cache  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


@pytest.fixture(autouse=True)
def _keep_build_dir(monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)


def test_returns_and_creates_the_directory(tmp_path):
    where = str(tmp_path / "a" / "b")
    assert cache.enable_compilation_cache(where) == where
    assert os.path.isdir(where) and str(_build.BUILD_DIR) == where
    assert cache.enable_compilation_cache(where) == where        # twice is fine
    assert _build.library_path().parent == _build.BUILD_DIR


def test_default_honours_its_environment_variable(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert cache.default_cache_dir() == str(tmp_path / "env")
    assert cache.enable_compilation_cache() == str(tmp_path / "env")
    assert os.path.isdir(tmp_path / "env")
    monkeypatch.delenv("REPRO_TORCH_COMPILATION_CACHE_DIR")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert cache.default_cache_dir() == str(tmp_path / "home" / ".cache" / "repro-torch-cache")


_WARM = """
import sys
from repro_torch.kernels import _build
from repro_torch.utils.cache import enable_compilation_cache

def no_nvcc():
    raise RuntimeError("nvcc was called")

_build.nvcc = no_nvcc
enable_compilation_cache(sys.argv[1])
lib = _build.library_path()
if sys.argv[2] == "warm":
    lib.write_bytes(b"placeholder")
    assert _build.build() == lib and _build.builds == 0
else:
    try:
        _build.build()
    except RuntimeError as e:
        assert "nvcc was called" in str(e) and _build.builds == 0
    else:
        raise AssertionError("a cold cache did not build")
print(lib)
"""


@pytest.mark.parametrize("start", ["warm", "cold"])
def test_a_fresh_process_finds_the_cached_library(tmp_path, start):
    where = tmp_path / "cache"
    run = subprocess.run([sys.executable, "-c", _WARM, str(where), start],
                         env=dict(os.environ, PYTHONPATH=SRC), capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stderr[-3000:]
    lib = run.stdout.strip()
    assert os.path.dirname(lib) == str(where) and os.path.basename(lib).startswith("libreprotorch")
    assert os.path.exists(lib) == (start == "warm")
