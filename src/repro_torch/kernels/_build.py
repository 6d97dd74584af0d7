"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into an
object, all sources at once, and the objects are linked into one shared
library with a plain C interface, cached under ``BUILD_DIR`` by a hash of
the sources and flags: ``kernels/_build/`` (listed in ``.gitignore``), or
the directory ``utils.cache.enable_compilation_cache`` points it at. No
PyTorch header is compiled, which keeps a build to seconds. A failed
build raises; ``builds`` counts the builds this process ran. A build is
reported to ``analysis.sanitize.compile_budget`` as a program, and a
first ``load`` that finds the library already built as a cache hit.

The wrappers call the exported C functions with raw pointers from
``tensor.data_ptr()`` and the stream from
``torch.cuda.current_stream().cuda_stream``; every C function returns the
CUDA error of its launches (0 when they were accepted).

Under CUDA graph capture a wrapper's launch is recorded, not run, and
runs at each replay. The wrappers count launches in Python when they are
called, so a graph's owner takes the counts its capture added
(``launch_counts`` before and after), takes them back off, and adds them
once per replay (``add_launches``): the counters then count the launches
that ran.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

from repro_torch.utils import events

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_SIGNATURES = {
    "prox_update_f32": [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_float,
                        ctypes.c_float, _P],
    "prox_update_bf16": [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_float,
                         ctypes.c_float, _P],
    "prox_theta_f32": [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_float, ctypes.c_float, _P],
    "prox_theta_bf16": [_P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
                        ctypes.c_float, ctypes.c_float, _P],
    "cosine_sim_f32": [_P] + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3
                      + [_P] * 4,
    "merge_candidates_f32": [_P, _P] + [ctypes.c_longlong] * 3
                            + [ctypes.c_int] * 3 + [ctypes.c_float] + [_P] * 4,
    "resolve_roots_i32": [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P],
    "component_labels_f32": [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_int, _P],
    "ssm_scan_fwd_f32": [_P, _P, _P, _P, _P] + [ctypes.c_int] * 5 + [_P],
    "ssm_scan_bwd_f32": [_P] * 9 + [ctypes.c_int] * 5 + [_P],
}

# every wrapper's counter of the work it puts on the card: module, attribute
LAUNCH_COUNTERS = (("prox_update", "launches"), ("prox_update", "theta_launches"),
                   ("cosine_sim", "launches"), ("cosine_sim", "candidate_launches"),
                   ("cosine_sim", "padded_copies"), ("resolve_roots", "launches"),
                   ("resolve_roots", "label_launches"), ("ssm_scan", "fwd_launches"),
                   ("ssm_scan", "bwd_launches"))

_lib: Optional[ctypes.CDLL] = None
last_build_log = ""
builds = 0       # libraries this process compiled (a cached one found is not counted)
_built = set()   # their paths
_counters = {}   # (device index, stream) -> int32 arrival counters, all 0 between launches


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``. Raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from kernels/csrc at first use")


def sources():
    return sorted(SRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libreprotorch_kernels-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile every source (in parallel, one ``nvcc`` each) and link the
    shared library, unless the cached one for these sources exists.
    ``verbose`` adds ``-Xptxas -v`` and keeps the compiler's report in
    ``last_build_log``. Returns the library's path."""
    global last_build_log, builds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources():
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [exe, *NVCC_FLAGS, *extra, "-c", str(src), "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _obj, p in procs:
            log, _ = p.communicate()
            logs.append(f"== {src.name}\n{log}")
            if p.returncode != 0:
                failed.append(src.name)
        last_build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{last_build_log}")
        tmp_so = os.path.join(tmp, out.name)
        link = subprocess.run(
            [exe, *ARCH_FLAGS, "-shared", "-o", tmp_so,
             *[obj for _src, obj, _p in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, out)
    builds += 1
    _built.add(out)
    events.report("program", out.name)
    return out


def load() -> ctypes.CDLL:
    """The bound kernel library (built on first call)."""
    global _lib
    if _lib is None:
        path = library_path()
        if path.exists() and path not in _built:
            events.report("cache_hit", path.name)
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def arrival_counters(device, stream: int, need: int):
    """At least ``need`` int32 counters on ``device`` for kernels launched on
    ``stream`` whose blocks count themselves in, the last to arrive finishing
    the work. They are 0 at every launch: each kernel leaves them 0, and
    launches on one stream run in order (a graph's replays too).

    They are allocated outside any graph capture, on the first launch on
    the stream: during a capture, an allocation would come from the
    graph's private pool, so a missing or short buffer raises there; the
    captured work must first run once on the capture stream."""
    import torch
    key = (device.index, stream)
    cnt = _counters.get(key)
    if cnt is None or cnt.numel() < need:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "arrival counters for this stream do not exist yet: run the "
                "captured work once on the capture stream before capturing it")
        cnt = torch.zeros((max(need, 4096),), dtype=torch.int32, device=device)
        _counters[key] = cnt
    return cnt


def _counter_module(name: str):
    return importlib.import_module(f"repro_torch.kernels.{name}")


def launch_counts() -> dict:
    """``{"module.counter": value}`` of every wrapper's counter
    (``LAUNCH_COUNTERS``)."""
    return {f"{mod}.{attr}": getattr(_counter_module(mod), attr)
            for mod, attr in LAUNCH_COUNTERS}


def add_launches(delta: dict, times: int = 1) -> None:
    """Add ``times`` × ``delta`` (``launch_counts``-keyed) to the counters."""
    for name, n in delta.items():
        mod, attr = name.split(".")
        module = _counter_module(mod)
        setattr(module, attr, getattr(module, attr) + times * n)


def check(err: int, name: str) -> None:
    """Raise when a kernel's C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
