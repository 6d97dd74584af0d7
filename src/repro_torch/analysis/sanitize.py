"""Runtime sanitizers: context managers that turn the port's claims about
its programs, its host reads and its values into hard failures.

Three guards, as in the reference's ``repro.analysis.sanitize``, each
with its meaning taken from the port's runtime (CUDA graphs, the ctypes
kernel library, eager PyTorch):

- ``compile_budget(n)`` counts the programs the port builds at run time
  where the reference compiles: a new ``engine.api.RoundProgram`` (a miss
  in ``scan_program``'s cache, keyed on the cohort size as the reference's
  is), a new ``serve.slots.DecodeGraph`` and a build of the kernel
  library (``kernels._build``). On the card a ``RoundProgram`` captures a
  CUDA graph at its first span of two rounds or more, and each capture is
  also counted in ``captures``; a kernel library found already built is a
  ``cache_hit``, not a program. The closures ``ctx.cached`` memoises for
  the eager path are not programs. The count works on the CPU too, where
  a ``RoundProgram`` is made as on the card. Over the budget it raises
  ``CompileBudgetExceeded``.
- ``no_transfer()`` forbids device-to-host reads in the block: on the
  card ``torch.cuda.set_sync_debug_mode("error")`` (any host sync raises,
  an upload from pageable memory included), and on every device a guard
  in Python that raises ``HostTransferError`` at ``.item()``, ``.tolist()``,
  ``.numpy()``, ``__array__``, ``bool()`` / ``float()`` / ``int()`` /
  ``__index__`` of a device tensor, and at the dispatcher's
  ``_local_scalar_dense``, ``nonzero``, ``equal`` of one and any copy
  between devices. A device tensor is one on the card; where there is no
  card, the CPU plays the device and every tensor counts. A kernel's plain version run on CPU tensors is exempt
  (``utils.events.plain_version``): on the card the kernel runs in its
  place. ``engine.api.capture_graph`` and ``RoundProgram``'s warm-up run
  under it.
- ``nan_guard()`` raises ``FloatingPointError`` naming the op at the first
  op in the block, forward or backward, whose floating output holds a NaN
  (the counterpart of ``jax_debug_nans``, which catches NaNs only: the
  port, like the reference, uses ±inf as sentinels on its path, such as
  the sampler's off-pool slots): a dispatch mode checks each op's new values (views and
  uninitialised allocations are not checked), and the kernel wrappers,
  whose ctypes launches pass no dispatcher, check their outputs. Inside a
  CUDA graph capture the per-op check cannot run (it reads the device);
  there the program checks each replay's outputs (the carry and the
  records of a ``RoundProgram``, the lanes of a ``DecodeGraph``) after the
  replay. Every check syncs: it is a debugging guard, off by default.

All three restore the state they change on exit and nest freely::

    with sanitize.no_transfer(), sanitize.compile_budget(0) as log:
        state = engine.run_rounds(state, 20)
    assert log.count == 0
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, List, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.utils import events

__all__ = ["CompileLog", "CompileBudgetExceeded", "HostTransferError",
           "compile_budget", "no_transfer", "nan_guard"]


class CompileBudgetExceeded(AssertionError):
    """Raised when a ``compile_budget(n)`` block builds more than ``n``
    programs."""


class HostTransferError(RuntimeError):
    """Raised by ``no_transfer`` at a device-to-host read."""


@dataclasses.dataclass
class CompileLog:
    """Live tally of a ``compile_budget`` block: ``count`` programs built
    (round programs, decode graphs, kernel library builds), ``captures``
    CUDA graphs captured (on the card only), ``cache_hits`` kernel
    libraries found already built, and with ``log_names=True`` the
    ``names`` of the programs (a round program's cache key,
    ``DecodeGraph (K, slots, max_len)``, the library's file)."""
    budget: Optional[int] = None
    count: int = 0
    captures: int = 0
    cache_hits: int = 0
    names: List[str] = dataclasses.field(default_factory=list)
    log_names: bool = False

    def _on_event(self, kind: str, name: str) -> None:
        if kind == "program":
            self.count += 1
            if self.log_names:
                self.names.append(name)
        elif kind == "capture":
            self.captures += 1
        elif kind == "cache_hit":
            self.cache_hits += 1

    def describe(self) -> str:
        """Human-readable tally, naming the programs when known."""
        head = f"{self.count} program(s)"
        if self.budget is not None:
            head += f" (budget {self.budget})"
        head += f", {self.captures} capture(s), {self.cache_hits} cache hit(s)"
        if self.names:
            head += ": " + ", ".join(self.names)
        return head


@contextlib.contextmanager
def compile_budget(budget: Optional[int] = None, *,
                   log_names: bool = False) -> Iterator[CompileLog]:
    """Count the programs built in the block; raise
    ``CompileBudgetExceeded`` if they exceed ``budget`` (``None``: only
    count). The yielded ``CompileLog`` updates live."""
    log = CompileLog(budget=budget, log_names=log_names)
    events.listen(log._on_event)
    try:
        yield log
    finally:
        events.unlisten(log._on_event)
    if budget is not None and log.count > budget:
        raise CompileBudgetExceeded(f"compile budget exceeded: {log.describe()}")


# ------------------------------------------------------------- no_transfer
_READ_METHODS = frozenset({"item", "tolist", "numpy", "__array__", "__bool__",
                           "__float__", "__int__", "__index__"})
_READ_OPS = frozenset({"_local_scalar_dense", "nonzero", "equal"})


def _host_read(what: str) -> HostTransferError:
    return HostTransferError(f"{what}: a device-to-host read inside no_transfer()")


def _on_device(x, cpu_is_device: bool) -> bool:
    """Is ``x`` a tensor whose values live on the device: on a card, or on
    the CPU where there is no card (the CPU then plays the device)."""
    return isinstance(x, torch.Tensor) and (x.device.type != "cpu" or cpu_is_device)


class _ReadMode(TorchFunctionMode):
    """The Python methods that read a tensor's values into the host."""

    def __init__(self, cpu_is_device: bool):
        super().__init__()
        self.cpu_is_device = cpu_is_device

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in _READ_METHODS and args and _on_device(args[0], self.cpu_is_device) \
                and not events.host_reads_exempt():
            raise _host_read(f"Tensor.{name}")
        return func(*args, **(kwargs or {}))


def _device_of(x):
    return x.device if isinstance(x, torch.Tensor) else None


class _TransferMode(TorchDispatchMode):
    """The dispatcher's host reads and copies between devices."""

    def __init__(self, cpu_is_device: bool):
        super().__init__()
        self.cpu_is_device = cpu_is_device

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not events.host_reads_exempt():
            name = func.overloadpacket.__name__
            if name in _READ_OPS and _on_device(args[0], self.cpu_is_device):
                raise _host_read(f"aten.{name}")
            if name in ("copy_", "_copy_from", "_copy_from_and_resize"):
                src, dst = _device_of(args[1]), _device_of(args[0])
                if src is not None and dst is not None and src.type != dst.type:
                    raise _host_read(f"aten.{name} {src.type} -> {dst.type}")
            elif name == "_to_copy":
                to = kwargs.get("device")
                src = _device_of(args[0])
                if to is not None and src is not None and torch.device(to).type != src.type:
                    raise _host_read(f"aten._to_copy {src.type} -> {torch.device(to).type}")
        return func(*args, **kwargs)


@contextlib.contextmanager
def _sync_debug_error() -> Iterator[None]:
    was = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(was)


@contextlib.contextmanager
def no_transfer() -> Iterator[None]:
    """Forbid device-to-host reads inside the block (see the module's
    docstring): the runtime twin of the lint's R2, and the guard the
    zero-transfer battery runs the scanned rounds under. On the CPU there
    is no upload to catch; on the card sync-debug mode "error" checks
    uploads from pageable memory too."""
    card = torch.cuda.is_available()
    with contextlib.ExitStack() as stack:
        if card:
            stack.enter_context(_sync_debug_error())
        stack.enter_context(_ReadMode(cpu_is_device=not card))
        stack.enter_context(_TransferMode(cpu_is_device=not card))
        yield


# --------------------------------------------------------------- nan_guard
# allocations whose values are whatever the memory held: not checked
_UNINITIALISED = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                            "new_empty_strided", "empty_permuted", "set_",
                            "resize_", "resize_as_"})


def _new_values(func, out, args=()):
    """The tensors among ``out`` that ``func`` wrote: fresh results and
    in-place outputs, not views of its inputs; for an op that returns
    nothing, the arguments it writes (K1's ``repro_torch::prox_update_``)."""
    returns = func._schema.returns
    if not returns:
        return [a for a, spec in zip(args, func._schema.arguments)
                if spec.alias_info is not None and spec.alias_info.is_write]
    if len(returns) == 1:
        alias = returns[0].alias_info
        if alias is not None and not alias.is_write:
            return []
        return tree_leaves(out)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    picked = []
    for ret, o in zip(returns, outs):
        if ret.alias_info is None or ret.alias_info.is_write:
            picked.extend(tree_leaves(o))
    return picked


class _NanMode(TorchDispatchMode):
    """Checks every op's new floating values."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _UNINITIALISED:
            events.check_nan(str(func), *[t for t in _new_values(func, out, args)
                                             if isinstance(t, torch.Tensor)])
        return out


@contextlib.contextmanager
def nan_guard() -> Iterator[None]:
    """Raise ``FloatingPointError`` at the first op in the block whose
    floating output holds a NaN, naming it (see the module's docstring for
    kernels and captured graphs); the state is restored on exit."""
    events.nan_checks += 1
    try:
        with _NanMode():
            yield
    finally:
        events.nan_checks -= 1
