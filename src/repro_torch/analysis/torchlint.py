"""AST-based PyTorch hazard linter for the port (``src/repro_torch``).

The port's claims about its captured programs, its host reads and its
random draws are correctness surfaces: a host sync left in a round step
breaks the CUDA graph capture on the card (and costs a round trip in the
eager loop), a draw from the global generator makes a run depend on what
ran before it, and a tensor made at import time starts CUDA before a test
fixture can decide where to run. This linter makes those properties
checkable statically, the counterpart of the reference's
``repro.analysis.jaxlint`` with the rules' meanings taken from PyTorch.

Rules
-----
R1  A random draw without an explicit ``generator=``: ``torch.rand``,
    ``randn``, ``randint``, ``randperm``, ``normal``, ``bernoulli``,
    ``multinomial``, and the in-place ``.normal_`` / ``.uniform_`` /
    ``.bernoulli_`` / ``.random_`` / ``.exponential_``. The port draws
    from explicit ``torch.Generator`` s (or the device threefry sampler),
    so a draw's stream is the caller's; the reference's rule (a JAX key
    reused) has no meaning for a stateful generator.
R2  A host sync in hot-path code: ``.item()``, ``.cpu()``, ``.numpy()``,
    ``.tolist()`` of a tensor, ``float()`` / ``int()`` / ``bool()`` of a
    tensor, ``np.asarray`` / ``np.array`` of a tensor,
    ``torch.cuda.synchronize``, ``nonzero`` (and one-argument
    ``torch.where``), ``torch.unique`` and ``masked_select``. Each waits
    for the device (an error under CUDA graph capture).
R3  Python ``if`` / ``while`` / ``for`` on a tensor in hot-path code: a
    sync for the bool, an error under capture. Use ``torch.where`` or a
    mask.
R4  Module-scope tensor construction or ``torch.cuda.*`` work: it runs at
    import, starting CUDA before a test fixture (or each of several xdist
    workers, each importing every module) can decide where to run.
    Every kernel import is lazy; so is every tensor.
R5  In ``kernels/``, a tensor factory (``torch.zeros``, ``ones``,
    ``empty``, ``full``, ``arange``, ``tensor``) without ``device=``: it
    puts a tensor on the CPU beside operands on the card. Use
    ``device=x.device`` or a ``*_like``. (The reference's rule, weak-f32
    widening of a float literal, does not apply: PyTorch's scalar
    promotion keeps a bf16 tensor bf16 against a Python float.)

Hot path
--------
The roots are functions handed to ``torch.func.vmap`` / ``grad`` /
``vjp`` (and the other ``torch.func`` transforms), to ``capture_graph``,
``RoundProgram`` or ``DecodeGraph``; the ``step`` each strategy's
``scan_round`` returns; functions named ``step``, ``*_step``, ``core``,
``*_impl`` or ``*_kernel`` (not the ``make_*`` factories that return
them); the kernel wrappers (a function of a ``kernels/`` file, other than
``ref.py``, that calls ``_build.load``); defs marked
``# torchlint: hot-path``; and, transitively, the same-module functions
these call by name or through ``self.`` / ``cls.``.

Without types the linter cannot know which names hold tensors. It takes a
hot function's parameters as tensors (unless they are named or annotated
as host values or default to a constant), results of ``torch.*`` calls,
and names assigned from expressions that hold a tensor name; reads of
static metadata (``.shape``, ``.dtype``, ``.device``, ``.numel()``, …)
and ``len()`` / ``isinstance()`` are not tensors. Where it cannot tell it
stays silent: a missed finding is preferred to a false one.

Waivers
-------
An intentional hazard is *annotated, not silenced*::

    ids = pool.nonzero()  # torchlint: disable=R2 — host draw by design

The waiver sits on the offending line (or the line above, or the ``def``
line to cover a whole function) and MUST carry a reason after the rule
list (``—``, ``--``, ``–`` or ``:``); ``--strict`` fails on reason-less
waivers.

API: ``lint_paths(paths)`` returns a ``LintReport``; the CLI is
``scripts/lint_torch.py``.
"""
from __future__ import annotations

import ast
import dataclasses
import fnmatch
import io
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = ["Finding", "Waiver", "LintReport", "RULES",
           "lint_source", "lint_file", "lint_paths"]

RULES: Dict[str, str] = {
    "R1": "random draw without an explicit generator=",
    "R2": "host sync in hot-path code",
    "R3": "Python control flow on a tensor in hot-path code",
    "R4": "module-scope tensor construction or torch.cuda work at import time",
    "R5": "tensor factory without device= in a kernels/ file",
}

_ENTRY_NAME_PATTERNS = ("step", "*_step", "core", "*_impl", "*_kernel")
_FACTORY_PREFIX = "make_"
# calls whose callable argument runs on the hot path: torch.func.<name>
_FUNC_TRANSFORMS = {"vmap", "grad", "vjp", "jvp", "grad_and_value", "jacrev",
                    "jacfwd", "hessian", "functional_call"}
_TRANSFORM_BARE = {"vmap", "vjp", "capture_graph", "RoundProgram", "DecodeGraph"}

# R1
_DRAW_FUNCS = {"rand", "randn", "randint", "randperm", "normal", "bernoulli",
               "multinomial"}
_DRAW_METHODS = {"normal_", "uniform_", "bernoulli_", "random_", "exponential_"}
# R2
_ALWAYS_SYNC_METHODS = {"item", "cpu", "numpy"}
_TENSOR_SYNC_METHODS = {"tolist", "nonzero", "unique", "masked_select"}
_TORCH_SYNC_FUNCS = {"nonzero", "unique", "masked_select", "unique_consecutive"}
_NP_SYNC_FUNCS = {"asarray", "array"}
# R5
_FACTORIES = {"zeros", "ones", "empty", "full", "arange", "tensor"}

# torch.<name> calls that give no tensor
_TORCH_NON_TENSOR = {
    "cuda", "backends", "distributed", "utils", "device", "dtype", "finfo",
    "iinfo", "is_tensor", "is_grad_enabled", "no_grad", "enable_grad",
    "inference_mode", "set_grad_enabled", "get_default_dtype",
    "set_default_dtype", "is_floating_point", "is_complex", "manual_seed",
    "use_deterministic_algorithms", "are_deterministic_algorithms_enabled",
    "promote_types", "result_type", "can_cast", "broadcast_shapes", "compile",
    "jit", "library", "profiler", "overrides", "testing", "fx", "export",
    "_C", "_dynamo", "get_num_threads", "set_num_threads", "func", "numel",
    "get_rng_state", "set_rng_state", "initial_seed", "seed", "cpu",
}
# attribute reads (and method calls) that give static Python metadata
_STATIC_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "requires_grad",
                 "layout", "dim", "numel", "size", "stride", "is_contiguous",
                 "element_size", "data_ptr", "get_device", "storage_offset",
                 "nelement", "ndimension", "is_floating_point", "is_complex"}
# builtins whose result is static whatever they are given
_STATIC_BUILTINS = {"len", "isinstance", "type", "id", "callable", "hasattr",
                    "repr", "str"}
# parameter names that hold host objects by the port's conventions
_STATIC_PARAM_NAMES = {"self", "cls", "ctx", "cfg", "config", "state", "model",
                       "name", "tag", "device", "dev", "dtype", "mesh", "stream",
                       "strat", "rounds", "m", "n", "k", "verbose", "backend"}
_STATIC_PARAM_ANNOTATIONS = {"bool", "int", "str", "float"}

_WAIVER_RE = re.compile(
    r"#\s*torchlint:\s*disable=([A-Z0-9,\s]+?)"
    r"(?:\s*(?:—|--|–|:)\s*(.*))?$")
_HOT_RE = re.compile(r"#\s*torchlint:\s*hot-path\b")


@dataclasses.dataclass
class Finding:
    """One lint hit: rule id, location, message, and — when an inline
    waiver covers it — the recorded reason."""
    rule: str
    path: str
    line: int
    col: int
    message: str
    waived: bool = False
    waiver_reason: Optional[str] = None

    def format(self) -> str:
        """``path:line:col: RULE message`` (``[waived: reason]`` suffix
        when a waiver covers the finding)."""
        tag = f" [waived: {self.waiver_reason}]" if self.waived else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}{tag}"


@dataclasses.dataclass
class Waiver:
    """One inline ``# torchlint: disable=...`` annotation (rule set,
    reason, and whether any finding matched it)."""
    path: str
    line: int
    rules: Tuple[str, ...]
    reason: str
    used: bool = False


@dataclasses.dataclass
class LintReport:
    """The lint over a path set: every finding (waived ones flagged) and
    the waiver inventory."""
    findings: List[Finding] = dataclasses.field(default_factory=list)
    waivers: List[Waiver] = dataclasses.field(default_factory=list)

    @property
    def errors(self) -> List[Finding]:
        """Unwaived findings: the set ``--strict`` gates on."""
        return [f for f in self.findings if not f.waived]

    def reasonless_waivers(self) -> List[Waiver]:
        """Waivers with no reason (``--strict`` rejects them)."""
        return [w for w in self.waivers if not w.reason.strip()]

    def unused_waivers(self) -> List[Waiver]:
        """Waivers no finding matched (reported, not gated)."""
        return [w for w in self.waivers if not w.used]

    def to_json(self) -> dict:
        """Findings, waivers and a summary as one JSON document."""
        return {
            "findings": [dataclasses.asdict(f) for f in self.findings],
            "waivers": [dataclasses.asdict(w) for w in self.waivers],
            "summary": {
                "files_with_findings": len({f.path for f in self.findings}),
                "errors": len(self.errors),
                "waived": sum(1 for f in self.findings if f.waived),
                "waivers": len(self.waivers),
                "unused_waivers": len(self.unused_waivers()),
            },
        }


# ===================================================================== tokens
def _scan_comments(source: str):
    """(waivers by line, hot-path-marked lines) from the token stream:
    comments are invisible to ``ast``."""
    waivers: Dict[int, Waiver] = {}
    hot_lines: Set[int] = set()
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type != tokenize.COMMENT:
                continue
            line = tok.start[0]
            m = _WAIVER_RE.search(tok.string)
            if m:
                rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
                waivers[line] = Waiver(path="", line=line, rules=rules,
                                       reason=(m.group(2) or "").strip())
            if _HOT_RE.search(tok.string):
                hot_lines.add(line)
    except tokenize.TokenError:
        pass
    return waivers, hot_lines


# ============================================================= AST utilities
def _dotted(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """``a.b.c`` attribute chains as a name tuple (None for anything
    dynamic)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def _is_transform_call(call: ast.Call) -> bool:
    dn = _dotted(call.func)
    if not dn:
        return False
    if len(dn) >= 2 and dn[-2] == "func" and dn[-1] in _FUNC_TRANSFORMS:
        return True
    return len(dn) == 1 and dn[0] in _TRANSFORM_BARE


_FN_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _own_nodes(fn_node: ast.AST) -> Iterable[ast.AST]:
    """A function's body without the nested function definitions (each is
    analysed in its own scope)."""
    stack = [fn_node]
    first = True
    while stack:
        node = stack.pop()
        if not first and isinstance(node, _FN_NODES):
            continue
        first = False
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _assigned_names(target: ast.AST) -> List[str]:
    return [sub.id for sub in ast.walk(target)
            if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Store)]


def _has_kw(call: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in call.keywords) or any(
        kw.arg is None for kw in call.keywords)     # **kwargs may carry it


# ================================================================ call graph
class _FnInfo:
    """One function or lambda: node, qualname, the names it calls
    (same-module resolution only) and its hot-path marks."""

    def __init__(self, node, qualname: str):
        self.node = node
        self.qualname = qualname
        self.calls: Set[str] = set()
        self.refs: Set[str] = set()
        self.hot = False


class _Indexer(ast.NodeVisitor):
    """Every def with its calls and references, and the hot-path roots."""

    def __init__(self, hot_lines: Set[int], wrapper_file: bool):
        self.fns: Dict[ast.AST, _FnInfo] = {}
        self.by_name: Dict[str, List[_FnInfo]] = {}
        self.stack: List[_FnInfo] = []
        self.hot_lines = hot_lines
        self.wrapper_file = wrapper_file
        self.pending_nodes: Set[ast.AST] = set()
        self.entry_names: Set[str] = set()

    def _enter(self, node, name: str):
        qual = self.stack[-1].qualname + "." + name if self.stack else name
        info = _FnInfo(node, qual)
        probe = {node.lineno, node.lineno - 1}
        if isinstance(getattr(node, "body", None), list) and node.body:
            probe.add(node.body[0].lineno - 1)
        if probe & self.hot_lines:
            info.hot = True
        if not name.startswith(_FACTORY_PREFIX) and any(
                fnmatch.fnmatch(name, pat) for pat in _ENTRY_NAME_PATTERNS):
            info.hot = True
        if node in self.pending_nodes:
            info.hot = True
        if self.wrapper_file and not isinstance(node, ast.Lambda) and any(
                isinstance(sub, ast.Call) and (_dotted(sub.func) or ())[-2:] == ("_build", "load")
                for sub in _own_nodes(node)):
            info.hot = True
        if name == "scan_round":
            for sub in _own_nodes(node):
                if (isinstance(sub, ast.Return) and isinstance(sub.value, ast.Tuple)
                        and len(sub.value.elts) >= 3
                        and isinstance(sub.value.elts[2], ast.Name)):
                    self.entry_names.add(sub.value.elts[2].id)
        self.fns[node] = info
        self.by_name.setdefault(name, []).append(info)
        self.stack.append(info)

    def visit_FunctionDef(self, node):
        self._enter(node, node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        self._enter(node, "<lambda>")
        self.generic_visit(node)
        self.stack.pop()

    def visit_Call(self, node):
        if self.stack:
            dn = _dotted(node.func)
            if dn and (len(dn) == 1 or (len(dn) == 2 and dn[0] in ("self", "cls"))):
                self.stack[-1].calls.add(dn[-1])
        if _is_transform_call(node):
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, _FN_NODES):
                    self.pending_nodes.add(arg)
                else:
                    dn = _dotted(arg)
                    if dn and (len(dn) == 1 or dn[0] in ("self", "cls")):
                        self.entry_names.add(dn[-1])
        self.generic_visit(node)

    def finish(self):
        """Resolve the by-name roots (a transform may name a function
        defined later)."""
        for name in self.entry_names:
            for info in self.by_name.get(name, []):
                info.hot = True


def _closure(idx: _Indexer, roots: List[_FnInfo]) -> Set[_FnInfo]:
    """The same-module call closure of ``roots``."""
    seen: Set[_FnInfo] = set()
    work = list(roots)
    while work:
        info = work.pop()
        if info in seen:
            continue
        seen.add(info)
        for name in info.calls | info.refs:
            for callee in idx.by_name.get(name, []):
                if callee not in seen:
                    work.append(callee)
    return seen


# ============================================================ tensor tracking
def _tensor_call(call: ast.Call) -> bool:
    """A ``torch.*`` / ``F.*`` call that gives a tensor."""
    dn = _dotted(call.func)
    if not dn:
        return False
    if dn[0] == "F" and len(dn) == 2:
        return True
    if dn[0] != "torch" or len(dn) < 2:
        return False
    if dn[1] == "nn":
        return len(dn) > 2 and dn[2] == "functional"
    return dn[1] not in _TORCH_NON_TENSOR and not dn[-1][:1].isupper()


def _str_compare(node: ast.AST) -> bool:
    """A comparison with a string (``mode == "train"``, ``name in ("k",
    "v")``): its operands are host values."""
    def is_str(x):
        if isinstance(x, ast.Constant):
            return isinstance(x.value, str)
        return isinstance(x, (ast.Tuple, ast.List, ast.Set)) and bool(x.elts) and all(
            isinstance(e, ast.Constant) and isinstance(e.value, str) for e in x.elts)
    return isinstance(node, ast.Compare) and any(
        is_str(x) for x in [node.left] + list(node.comparators))


def _expr_is_tensor(node: ast.AST, tensor_vars: Set[str]) -> bool:
    """Does this expression (syntactically) hold a tensor? A ``torch.*``
    call, a name that holds one, or a method of one. Static metadata reads
    (``int(x.shape[0])``), comparisons with strings and calls of other
    functions (whose results are unknown without types) are not."""
    stack = [node]
    while stack:
        sub = stack.pop()
        if isinstance(sub, ast.Attribute) and sub.attr in _STATIC_ATTRS:
            continue
        if _str_compare(sub):
            continue
        if isinstance(sub, (ast.GeneratorExp, ast.ListComp, ast.SetComp, ast.DictComp)):
            local = set(tensor_vars)
            for gen in sub.generators:
                if _expr_is_tensor(gen.iter, local):
                    local.update(_assigned_names(gen.target))
            elts = [sub.key, sub.value] if isinstance(sub, ast.DictComp) else [sub.elt]
            if any(_expr_is_tensor(e, local) for e in elts):
                return True
            continue
        if isinstance(sub, ast.Call):
            if _tensor_call(sub):
                return True
            func = sub.func
            if isinstance(func, ast.Attribute) and func.attr not in _STATIC_ATTRS \
                    and _expr_is_tensor(func.value, tensor_vars):
                return True         # a tensor's method
            continue                # any other call: its result is unknown
        if isinstance(sub, ast.Name) and sub.id in tensor_vars:
            return True
        stack.extend(ast.iter_child_nodes(sub))
    return False


def _is_identity_test(test: ast.AST) -> bool:
    """``x is None`` / ``x is not None``: no bool of a tensor."""
    return isinstance(test, ast.Compare) and all(
        isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops)


def _params(fn_node) -> List[str]:
    """A hot function's parameters that may hold tensors."""
    args = getattr(fn_node, "args", None)
    if args is None:
        return []
    pos = list(args.posonlyargs) + list(args.args)
    defaults = dict(zip([a.arg for a in pos[len(pos) - len(args.defaults):]], args.defaults))
    defaults.update({a.arg: d for a, d in zip(args.kwonlyargs, args.kw_defaults) if d is not None})
    names = []
    for a in pos + list(args.kwonlyargs):
        ann = a.annotation
        if a.arg in _STATIC_PARAM_NAMES:
            continue
        if isinstance(ann, ast.Name) and ann.id in _STATIC_PARAM_ANNOTATIONS:
            continue
        if isinstance(defaults.get(a.arg), ast.Constant):
            continue
        names.append(a.arg)
    return names


# ================================================================== rules
class _Linter:
    def __init__(self, path: str, source: str, tree: ast.Module, kernel_file: bool,
                 wrapper_file: bool):
        self.path = path
        self.tree = tree
        self.kernel_file = kernel_file
        self.findings: List[Finding] = []
        waivers, hot_lines = _scan_comments(source)
        for w in waivers.values():
            w.path = path
        self.waivers = waivers
        self.idx = _Indexer(hot_lines, wrapper_file)
        self.idx.visit(tree)
        self.idx.finish()
        for info in self.idx.fns.values():
            # a first-class reference to a def links the call graph; a
            # local variable of the same name does not
            own = list(_own_nodes(info.node))
            local = {sub.id for sub in own
                     if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Store)}
            args = getattr(info.node, "args", None)
            if args is not None:
                local.update(a.arg for a in args.posonlyargs + args.args + args.kwonlyargs)
            for sub in own:
                if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load) \
                        and sub.id in self.idx.by_name and sub.id not in local:
                    info.refs.add(sub.id)
        self.hot = _closure(self.idx, [i for i in self.idx.fns.values() if i.hot])

    def add(self, rule: str, node: ast.AST, message: str):
        self.findings.append(Finding(rule=rule, path=self.path, line=node.lineno,
                                     col=getattr(node, "col_offset", 0), message=message))

    # ----------------------------------------------------------------- R1
    def check_r1(self):
        for sub in ast.walk(self.tree):
            if not isinstance(sub, ast.Call) or _has_kw(sub, "generator"):
                continue
            dn = _dotted(sub.func)
            if dn and len(dn) == 2 and dn[0] == "torch" and dn[1] in _DRAW_FUNCS:
                self.add("R1", sub, f"torch.{dn[1]}() draws from the global generator — "
                         "pass generator= (a seeded torch.Generator)")
            elif isinstance(sub.func, ast.Attribute) and sub.func.attr in _DRAW_METHODS \
                    and not (dn and dn[0] in ("torch", "nn", "init")):
                self.add("R1", sub, f".{sub.func.attr}() draws from the global generator "
                         "— pass generator=")

    # ------------------------------------------------------------- R2 + R3
    def check_r2_r3(self):
        for info in self.hot:
            fn_node = info.node
            tensor_vars: Set[str] = set(_params(fn_node))
            assigned: Set[str] = set()      # names assigned a tensor in the body
            for stmt in sorted((s for s in _own_nodes(fn_node)
                                if isinstance(s, (ast.Assign, ast.AnnAssign, ast.AugAssign,
                                                  ast.For, ast.If, ast.While, ast.Call))),
                               key=lambda s: (s.lineno, s.col_offset)):
                if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                    if stmt.value is not None and _expr_is_tensor(stmt.value, tensor_vars):
                        targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
                        for t in targets:
                            tensor_vars.update(_assigned_names(t))
                            assigned.update(_assigned_names(t))
                elif isinstance(stmt, ast.For):
                    it = stmt.iter
                    # only a tensor iterated directly, made in the body or by a
                    # torch call (a parameter iterated is as often a list of
                    # layers); `zip(names, tensors)` walks a host container
                    direct = ((isinstance(it, ast.Name) and it.id in assigned)
                              or (isinstance(it, ast.Call) and _tensor_call(it)))
                    if direct:
                        self.add("R3", stmt, "Python for-loop over a tensor on the hot path "
                                 "(one host read an element; an error under capture)")
                        tensor_vars.update(_assigned_names(stmt.target))
                elif isinstance(stmt, (ast.If, ast.While)):
                    if not _is_identity_test(stmt.test) and \
                            _expr_is_tensor(stmt.test, tensor_vars):
                        self.add("R3", stmt, "Python branch on a tensor on the hot path "
                                 "(a host sync; an error under capture) — use torch.where "
                                 "or a mask")
                else:
                    self._check_sync_call(stmt, tensor_vars)

    def _check_sync_call(self, call: ast.Call, tensor_vars: Set[str]):
        func = call.func
        if isinstance(func, ast.Attribute):
            recv_tensor = _expr_is_tensor(func.value, tensor_vars)
            dn = _dotted(func)
            if func.attr in _ALWAYS_SYNC_METHODS and not (dn and dn[0] in ("torch", "np")):
                self.add("R2", call, f".{func.attr}() reads the device on the hot path")
                return
            if func.attr in _TENSOR_SYNC_METHODS and recv_tensor and not (
                    dn and dn[0] in ("torch", "np", "numpy")):
                self.add("R2", call, f".{func.attr}() of a tensor syncs the host on the "
                         "hot path")
                return
        dn = _dotted(func)
        if not dn:
            return
        name = dn[-1]
        if dn == (name,) and name in ("float", "int", "bool") and call.args:
            arg = call.args[0]
            if not isinstance(arg, ast.Constant) and _expr_is_tensor(arg, tensor_vars):
                self.add("R2", call, f"{name}() of a tensor reads the device on the hot "
                         "path — keep it a tensor")
            return
        if dn[0] in ("np", "numpy") and len(dn) == 2 and name in _NP_SYNC_FUNCS:
            if call.args and _expr_is_tensor(call.args[0], tensor_vars):
                self.add("R2", call, f"np.{name}() of a tensor copies it to the host on "
                         "the hot path")
            return
        if dn[0] != "torch":
            return
        if dn[1:] == ("cuda", "synchronize"):
            self.add("R2", call, "torch.cuda.synchronize() on the hot path")
        elif len(dn) == 2 and name in _TORCH_SYNC_FUNCS:
            self.add("R2", call, f"torch.{name}() has a data-dependent shape: it syncs "
                     "the host on the hot path")
        elif dn == ("torch", "where") and len(call.args) == 1 and not call.keywords:
            self.add("R2", call, "one-argument torch.where() is nonzero(): it syncs the "
                     "host on the hot path")

    # ----------------------------------------------------------------- R4
    def check_r4(self):
        for stmt in self.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                                 ast.Import, ast.ImportFrom)):
                continue
            if isinstance(stmt, ast.If):
                t = stmt.test
                if isinstance(t, ast.Compare) and isinstance(t.left, ast.Name) \
                        and t.left.id == "__name__":
                    continue
            stack = [stmt]
            while stack:
                sub = stack.pop()
                if isinstance(sub, _FN_NODES):
                    continue
                stack.extend(ast.iter_child_nodes(sub))
                if not isinstance(sub, ast.Call):
                    continue
                dn = _dotted(sub.func)
                if dn and (_tensor_call(sub) or dn[:2] == ("torch", "cuda")):
                    self.add("R4", sub, f"module-scope {'.'.join(dn)}() runs at import: "
                             "it makes a tensor or starts CUDA before a fixture can "
                             "decide — build it lazily")

    # ----------------------------------------------------------------- R5
    def check_r5(self):
        if not self.kernel_file:
            return
        for sub in ast.walk(self.tree):
            if not isinstance(sub, ast.Call):
                continue
            dn = _dotted(sub.func)
            if dn and len(dn) == 2 and dn[0] == "torch" and dn[1] in _FACTORIES \
                    and not _has_kw(sub, "device"):
                self.add("R5", sub, f"torch.{dn[1]}() without device= puts a tensor on the "
                         "CPU beside operands on the card — pass device= or use *_like")

    # =================================================================== run
    def run(self) -> Tuple[List[Finding], List[Waiver]]:
        self.check_r1()
        self.check_r2_r3()
        self.check_r4()
        self.check_r5()
        uniq = {}
        for f in self.findings:
            uniq.setdefault((f.rule, f.line, f.col, f.message), f)
        self.findings = sorted(uniq.values(), key=lambda f: (f.line, f.col, f.rule))
        self._apply_waivers()
        return self.findings, list(self.waivers.values())

    def _def_cover(self) -> Dict[int, ast.AST]:
        """line -> innermost def whose def-line waiver covers it."""
        cover: Dict[int, ast.AST] = {}
        for fn_node in self.idx.fns:
            if isinstance(fn_node, ast.Lambda):
                continue
            for line in range(fn_node.lineno, getattr(fn_node, "end_lineno", fn_node.lineno) + 1):
                prev = cover.get(line)
                if prev is None or fn_node.lineno > prev.lineno:
                    cover[line] = fn_node
        return cover

    def _waive(self, f: Finding, lines) -> bool:
        for line in lines:
            w = self.waivers.get(line)
            if w and f.rule in w.rules:
                f.waived, f.waiver_reason, w.used = True, w.reason, True
                return True
        return False

    def _apply_waivers(self):
        cover = self._def_cover()
        for f in self.findings:
            if self._waive(f, (f.line, f.line - 1)):
                continue
            fn = cover.get(f.line)
            if fn is not None:
                self._waive(f, (fn.lineno, fn.lineno - 1))


# ================================================================ public API
def lint_source(source: str, path: str = "<string>") -> Tuple[List[Finding], List[Waiver]]:
    """Lint one source string; returns ``(findings, waivers)`` with the
    waivers applied (waived findings stay in the list, marked). A path
    with a ``kernels`` directory is a kernel file (R5); its files other
    than ``ref.py`` hold the kernel wrappers."""
    tree = ast.parse(source, filename=path)
    parts = path.replace("\\", "/").split("/")
    kernel_file = "kernels" in parts[:-1]
    wrapper_file = kernel_file and parts[-1] != "ref.py"
    return _Linter(path, source, tree, kernel_file, wrapper_file).run()


def lint_file(path: str) -> Tuple[List[Finding], List[Waiver]]:
    """Lint one file (see ``lint_source``)."""
    with open(path) as f:
        src = f.read()
    return lint_source(src, path)


def lint_paths(paths: Sequence[str]) -> LintReport:
    """Lint every ``*.py`` under ``paths`` (files or directories, walked
    recursively, ``__pycache__`` skipped) into one ``LintReport``."""
    report = LintReport()
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(d for d in dirs if d != "__pycache__")
                files += [os.path.join(root, n) for n in sorted(names) if n.endswith(".py")]
        else:
            files.append(p)
    for path in files:
        findings, waivers = lint_file(path)
        report.findings += findings
        report.waivers += waivers
    return report
