"""Correctness tooling for the port: a static PyTorch hazard linter and
runtime sanitizers, the counterpart of the reference's ``repro.analysis``.

``repro_torch.analysis.torchlint`` is an AST pass over
``src/repro_torch`` with five rules (R1 a random draw without an explicit
``generator=``, R2 a host sync in hot-path code, R3 Python control flow
on a tensor in hot-path code, R4 module-scope tensor or ``torch.cuda``
work, R5 a tensor factory without ``device=`` in ``kernels/``) and an
inline waiver syntax that keeps intentional hazards annotated, not
silenced (``scripts/lint_torch.py`` is its CLI). ``sanitize`` provides
composable runtime context managers: ``compile_budget`` (pin the round
programs, decode graphs and kernel library builds), ``no_transfer`` (no
device-to-host read) and ``nan_guard`` (fail at the first non-finite
value), used by the compile-set and zero-transfer batteries in
``tests/test_torch_{compile_budget,sanitize}.py``.
"""
from repro_torch.analysis.sanitize import (CompileBudgetExceeded, CompileLog,
                                           HostTransferError, compile_budget,
                                           nan_guard, no_transfer)
from repro_torch.analysis.torchlint import (RULES, Finding, LintReport, Waiver,
                                            lint_file, lint_paths, lint_source)

__all__ = [
    "Finding", "Waiver", "LintReport", "RULES",
    "lint_source", "lint_file", "lint_paths",
    "compile_budget", "CompileBudgetExceeded", "CompileLog",
    "no_transfer", "nan_guard", "HostTransferError",
]
