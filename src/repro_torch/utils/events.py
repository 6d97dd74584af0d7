"""What the port's runtime reports to its sanitizers
(``repro_torch.analysis.sanitize``), in one module that ``engine/``,
``serve/`` and ``kernels/`` import without an import cycle: it imports
nothing of the package.

- **Programs.** ``report(kind, name)`` tells every open listener that the
  runtime built something the reference would compile: ``"program"`` (a
  new ``engine.api.RoundProgram``, a new ``serve.slots.DecodeGraph``, a
  build of the kernel library), ``"capture"`` (a CUDA graph captured) or
  ``"cache_hit"`` (a kernel library found already built). Each open
  ``compile_budget`` block holds one listener, so nested blocks each see
  an event once.
- **NaN checks.** While a ``nan_guard`` block is open, ``nan_checks``
  is above 0 and ``check_nan`` raises ``FloatingPointError`` on a
  floating tensor that holds a NaN. The kernel wrappers call it on
  their outputs (a ctypes launch passes no dispatcher), and a captured
  program on each replay's outputs.
- **Host reads.** ``no_transfer`` raises on a device-to-host read unless
  ``host_reads_exempt()``: inside a kernel's plain version run on CPU
  tensors (``plain_version``; on the card the kernel runs in its place and
  makes no read), or inside a sanitizer's own check (``own_reads``).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, List

_listeners: List[Callable[[str, str], None]] = []
nan_checks = 0        # open nan_guard blocks
_exempt = 0           # open exemptions from no_transfer's host-read guard

KINDS = ("program", "capture", "cache_hit")


def listen(fn: Callable[[str, str], None]) -> None:
    """Call ``fn(kind, name)`` on every event from now on."""
    _listeners.append(fn)


def unlisten(fn: Callable[[str, str], None]) -> None:
    """Stop calling ``fn`` (the listener ``listen`` was given)."""
    _listeners.remove(fn)


def report(kind: str, name: str = "") -> None:
    """Tell every listener that the runtime made a ``kind`` event
    (``KINDS``) called ``name``."""
    if kind not in KINDS:
        raise ValueError(f"unknown event kind {kind!r}; expected one of {KINDS}")
    for fn in list(_listeners):
        fn(kind, name)


def host_reads_exempt() -> bool:
    """True inside ``plain_version`` on CPU tensors or ``own_reads``."""
    return _exempt > 0


@contextlib.contextmanager
def own_reads():
    """A sanitizer's own reads of the values it checks: exempt from
    ``no_transfer``, and on the card from sync-debug mode "error"."""
    global _exempt
    import torch
    was = None
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        was = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
    _exempt += 1
    try:
        yield
    finally:
        _exempt -= 1
        if was is not None:
            torch.cuda.set_sync_debug_mode(was)


def _tensors(values):
    import torch
    for v in values:
        if isinstance(v, torch.Tensor):
            yield v
        elif isinstance(v, (tuple, list)):
            yield from _tensors(v)


def plain_version(fn):
    """Mark ``fn`` as a kernel's plain version. Called with tensors that
    all lie on the CPU, its host reads are exempt from ``no_transfer``: on
    the card the kernel runs in its place, and the card's runs show that
    the kernel makes none. On any other tensor nothing is exempt."""
    @functools.wraps(fn)
    def plain(*args, **kwargs):
        global _exempt
        ts = list(_tensors(list(args) + list(kwargs.values())))
        if not ts or any(t.device.type != "cpu" for t in ts):
            return fn(*args, **kwargs)
        _exempt += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _exempt -= 1
    return plain


def _capturing(t) -> bool:
    import torch
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def check_nan(op: str, *values) -> None:
    """While a ``nan_guard`` is open, raise ``FloatingPointError`` naming
    ``op`` when a floating tensor among ``values`` (tensors, or tuples and
    lists of them) holds a NaN. Skipped under CUDA graph capture, where a
    read cannot run: the graph's owner checks each replay's outputs
    instead."""
    if nan_checks <= 0:
        return
    import torch
    for t in _tensors(values):
        if not t.is_floating_point() or t.numel() == 0 or _capturing(t):
            continue
        with own_reads():
            bad = bool(torch.isnan(t).any())
        if bad:
            raise FloatingPointError(f"{op} produced a NaN (nan_guard): "
                                     f"{tuple(t.shape)} {t.dtype} on {t.device}")
