#!/usr/bin/env python
"""CI gate for the PyTorch hazard linter (``repro_torch.analysis.torchlint``).

Usage::

    PYTHONPATH=src python scripts/lint_torch.py [paths...] [--strict]
        [--format text|json] [--waivers OUT.json]

Default path is ``src/repro_torch``. Exit codes: 0 clean, 1 findings (in
``--strict`` mode a reason-less waiver also fails — an unexplained
waiver is a silenced finding, which is exactly what the waiver syntax
exists to prevent). ``--waivers`` writes the full waiver inventory as a
JSON artifact so CI keeps intentional hazards auditable over time.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from repro_torch.analysis import torchlint  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or directories (default: src/repro_torch)")
    ap.add_argument("--strict", action="store_true",
                    help="fail on reason-less waivers too")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--waivers", metavar="OUT",
                    help="write waiver inventory JSON to OUT")
    args = ap.parse_args(argv)

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = args.paths or [os.path.join(repo, "src", "repro_torch")]
    report = torchlint.lint_paths(paths)

    if args.waivers:
        with open(args.waivers, "w") as f:
            json.dump(report.to_json(), f, indent=2, sort_keys=True)

    failures = list(report.errors)
    reasonless = report.reasonless_waivers() if args.strict else []

    if args.format == "json":
        print(json.dumps(report.to_json(), indent=2, sort_keys=True))
    else:
        for f in report.findings:
            print(f.format())
        for w in reasonless:
            print(f"{w.path}:{w.line}: waiver for {','.join(w.rules)} "
                  "has no justification (strict mode requires one)")
        for w in report.unused_waivers():
            print(f"{w.path}:{w.line}: note: unused waiver for "
                  f"{','.join(w.rules)}")
        n_waived = sum(1 for f in report.findings if f.waived)
        print(f"torchlint: {len(failures)} error(s), {n_waived} waived, "
              f"{len(report.waivers)} waiver(s) "
              f"({len(report.unused_waivers())} unused)")

    return 1 if (failures or reasonless) else 0


if __name__ == "__main__":
    sys.exit(main())
