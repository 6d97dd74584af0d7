"""The port's static hazard linter (``repro_torch.analysis.torchlint``) and
its CLI (``scripts/lint_torch.py``): one hazard and one clean form of each
rule, the hot-path roots, the waiver syntax under ``--strict``, and the
lint over ``src/repro_torch`` clean."""
import contextlib
import importlib.util
import io
import json
import os
import textwrap

import pytest

pytest.importorskip("torch")

from repro_torch.analysis import torchlint  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "lint_torch.py")


def _rules(src, path="mod.py"):
    findings, _ = torchlint.lint_source(textwrap.dedent(src), path)
    return sorted(f.rule for f in findings if not f.waived)


# one hazard and its clean form per rule
CASES = {
    "R1": ("""
        import torch
        def init(shape):
            return torch.randn(shape)
        """, """
        import torch
        def init(shape, gen):
            return torch.randn(shape, generator=gen)
        """),
    "R1_inplace": ("""
        def init(w):
            w.normal_(0.0, 0.02)
        """, """
        def init(w, gen):
            w.normal_(0.0, 0.02, generator=gen)
        """),
    "R2": ("""
        import torch
        def step(carry, consts):
            n = carry.sum().item()
            return carry * n, {}
        """, """
        import torch
        def step(carry, consts):
            n = carry.sum()
            return carry * n, {}
        """),
    "R2_float": ("""
        import torch
        def apply_step(x):
            return float(x.max())
        """, """
        import torch
        def apply_step(x):
            return float(x.shape[0])
        """),
    "R2_nonzero": ("""
        import torch
        def merge_impl(adj):
            return torch.nonzero(adj > 0)
        """, """
        import torch
        def merge_impl(adj):
            return torch.where(adj > 0, adj, 0.0)
        """),
    "R3": ("""
        import torch
        def step(carry, consts):
            if carry.any():
                carry = carry + 1
            return carry, {}
        """, """
        import torch
        def step(carry, consts):
            carry = torch.where(carry.any(), carry + 1, carry)
            return carry, {}
        """),
    "R4": ("""
        import torch
        TABLE = torch.arange(16)
        """, """
        import torch
        DTYPES = {torch.float32: "f32"}
        def table(device):
            return torch.arange(16, device=device)
        """),
    "R4_cuda": ("""
        import torch
        HAS_CARD = torch.cuda.is_available()
        """, """
        import torch
        def has_card():
            return torch.cuda.is_available()
        """),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_rule_flags_its_hazard_and_passes_the_clean_form(case):
    rule = case.split("_")[0]
    bad, good = CASES[case]
    assert _rules(bad) == [rule], _rules(bad)
    assert _rules(good) == []


def test_r5_only_in_kernel_files():
    bad = """
        import torch
        def scratch(x):
            return torch.zeros((4,), dtype=torch.int32)
        """
    good = """
        import torch
        def scratch(x):
            return torch.zeros((4,), dtype=torch.int32, device=x.device)
        """
    assert _rules(bad, "src/repro_torch/kernels/k.py") == ["R5"]
    assert _rules(good, "src/repro_torch/kernels/k.py") == []
    assert _rules(bad, "src/repro_torch/models/m.py") == []


@pytest.mark.parametrize("root", [
    # handed to torch.func.vmap
    """
    import torch
    def outer(xs):
        def per(x):
            return x.sum().item()
        return torch.func.vmap(per)(xs)
    """,
    # the step a scan_round returns, under another name
    """
    class S:
        def scan_round(self, ctx, state, pool, m):
            def body(carry, cs):
                return carry.cpu(), {}
            return carry0, consts, body, None, ()
    """,
    # a kernel wrapper: a kernels/ function that loads the library
    """
    from repro_torch.kernels import _build
    def launch(x):
        lib = _build.load()
        return x.tolist()
    """,
    # the hot-path marker, and a same-module callee of a root
    """
    def helper(x):
        return x.numpy()
    def per_round(x):  # torchlint: hot-path
        return helper(x)
    """,
], ids=["vmap", "scan_round_step", "kernel_wrapper", "marker_and_callee"])
def test_hot_path_roots(root):
    assert _rules(root, "src/repro_torch/kernels/k.py") == ["R2"]


def test_host_code_off_the_hot_path_is_not_flagged():
    src = """
        import numpy as np
        def make_decode_step(model):
            n = int(model.x.sum().item())
            def serve_step(p, sl):
                return sl
            return serve_step
        def finalize(state, ys):
            return {k: v.cpu().numpy() for k, v in ys.items()}
        """
    assert _rules(src) == []


def test_metadata_reads_and_string_tests_are_not_syncs():
    src = """
        import torch
        def step(x, mode):
            n = int(x.shape[0])
            if x.dim() != 2 or not x.is_contiguous() or x.device.type == "cpu":
                return x, {}
            if mode == "train":
                x = x * n
            return x, {"n": len(x)}
        """
    assert _rules(src) == []


def _write(tmp_path, src):
    path = tmp_path / "mod.py"
    path.write_text(textwrap.dedent(src))
    return str(path)


def _cli(*args):
    """``scripts/lint_torch.py ARGS`` in this process: (exit code, stdout)."""
    spec = importlib.util.spec_from_file_location("lint_torch", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mod.main(list(args))
    return rc, out.getvalue()


def test_waivers_with_and_without_a_reason_under_strict(tmp_path):
    waived = _write(tmp_path, """
        def step(carry, consts):
            n = carry.item()  # torchlint: disable=R2 — a host flag by design
            return carry, {}
        """)
    rc, out = _cli(waived, "--strict")
    assert rc == 0, out
    assert "[waived: a host flag by design]" in out
    bare = _write(tmp_path, """
        def step(carry, consts):
            n = carry.item()  # torchlint: disable=R2
            return carry, {}
        """)
    assert _cli(bare)[0] == 0                       # waived, reason not gated
    rc, out = _cli(bare, "--strict")
    assert rc == 1 and "has no justification" in out
    unwaived = _write(tmp_path, """
        def step(carry, consts):
            return carry.item(), {}
        """)
    assert _cli(unwaived)[0] == 1


def test_waiver_on_the_def_line_covers_the_function(tmp_path):
    src = """
        def step(carry, consts):  # torchlint: disable=R2,R3 — eager bookkeeping
            if carry.any():
                return carry.cpu(), {}
            return carry, {}
        """
    findings, waivers = torchlint.lint_source(textwrap.dedent(src))
    assert sorted(f.rule for f in findings) == ["R2", "R3"]
    assert all(f.waived for f in findings) and waivers[0].used


def test_json_report_and_waiver_inventory(tmp_path):
    path = _write(tmp_path, """
        def step(carry, consts):
            return carry.item(), {}  # torchlint: disable=R2 — by design
        """)
    inv = tmp_path / "waivers.json"
    _rc, out = _cli(path, "--format", "json", "--waivers", str(inv))
    doc = json.loads(out)
    assert doc["summary"]["waived"] == 1 and doc["summary"]["errors"] == 0
    assert json.loads(inv.read_text())["waivers"][0]["reason"] == "by design"


def test_the_port_lints_clean_under_strict():
    """``scripts/lint_torch.py --strict`` exits 0 on ``src/repro_torch``:
    every finding is repaired or waived with a reason."""
    rc, out = _cli("--strict")
    assert rc == 0, out[-3000:]
    report = torchlint.lint_paths([os.path.join(REPO, "src", "repro_torch")])
    assert report.errors == [] and report.reasonless_waivers() == []
    assert all(w.used for w in report.waivers)
