"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, so they run on a machine without JAX."""
import ast
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro")

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(",".join(names))
print(",".join(bad))
"""

# the falcon-mamba slice's modules, which the walk must reach
SLICE3 = ("repro_torch.configs", "repro_torch.configs.falcon_mamba_7b",
          "repro_torch.models.config", "repro_torch.models.ssm",
          "repro_torch.models.ssm_lm", "repro_torch.models.registry",
          "repro_torch.kernels.ssm_scan", "repro_torch.data.tokens",
          "repro_torch.core.extractor")
# the baselines' slice: the legacy shims and the modules they run through
SLICE6 = ("repro_torch.core.baselines", "repro_torch.core.stocfl",
          "repro_torch.core.bilevel", "repro_torch.engine.strategies",
          "repro_torch.kernels.prox_update", "repro_torch.utils.trees")
# the device sampler and the captured multi-round loop, and what they run
SLICE7 = ("repro_torch.engine.sampler", "repro_torch.engine.api",
          "repro_torch.data.arena", "repro_torch.kernels._build")
# the varying federation: async rounds, the simulator, the checkpoint
SLICE8 = ("repro_torch.engine.async_agg", "repro_torch.sim", "repro_torch.sim.events",
          "repro_torch.sim.timeline", "repro_torch.sim.simulate", "repro_torch.checkpoint",
          "repro_torch.checkpoint.ckpt", "repro_torch.data.dirichlet",
          "repro_torch.data.synthetic")

# cluster-routed serving and the dense transformer family
SLICE9 = ("repro_torch.models.attention", "repro_torch.models.transformer",
          "repro_torch.models.layers", "repro_torch.serve", "repro_torch.serve.engine",
          "repro_torch.serve.router", "repro_torch.serve.scheduler",
          "repro_torch.serve.slots", "repro_torch.serve.baseline",
          "repro_torch.launch", "repro_torch.launch.serve")
# the MoE, MLA and hybrid families and the training driver
SLICE10 = ("repro_torch.models.moe", "repro_torch.models.hybrid",
           "repro_torch.launch.train")
# the encoder-decoder and VLM families
SLICE11 = ("repro_torch.models.encdec", "repro_torch.models.vlm")
# the client-axis mesh
SLICE12 = ("repro_torch.sharding", "repro_torch.sharding.specs",
           "repro_torch.launch.mesh", "repro_torch.utils.logging")
# the model axis: the mesh-aware LLM step builders
SLICE13 = ("repro_torch.launch.steps",)
# the optimisers and the kernel library's persistent cache
SLICE15 = ("repro_torch.optim", "repro_torch.optim.sgd", "repro_torch.optim.adam",
           "repro_torch.optim.schedules", "repro_torch.utils.cache")
# the analysis package: the sanitizers, the lint and the runtime's events
SLICE17 = ("repro_torch.analysis", "repro_torch.analysis.sanitize",
           "repro_torch.analysis.torchlint", "repro_torch.utils.events")


def test_importing_every_module_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names, bad = (out.stdout.splitlines() + [""])[:2]
    names = names.split(",")
    assert len(names) >= 20
    assert set(SLICE3) <= set(names), sorted(set(SLICE3) - set(names))
    assert set(SLICE6) <= set(names), sorted(set(SLICE6) - set(names))
    assert set(SLICE7) <= set(names), sorted(set(SLICE7) - set(names))
    assert set(SLICE8) <= set(names), sorted(set(SLICE8) - set(names))
    assert set(SLICE9) <= set(names), sorted(set(SLICE9) - set(names))
    assert set(SLICE10) <= set(names), sorted(set(SLICE10) - set(names))
    assert set(SLICE11) <= set(names), sorted(set(SLICE11) - set(names))
    assert set(SLICE12) <= set(names), sorted(set(SLICE12) - set(names))
    assert set(SLICE13) <= set(names), sorted(set(SLICE13) - set(names))
    assert set(SLICE15) <= set(names), sorted(set(SLICE15) - set(names))
    assert set(SLICE17) <= set(names), sorted(set(SLICE17) - set(names))
    assert bad == "", f"port imports pulled in {bad}"


def _sources():
    for root, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_no_jax_or_reference(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{os.path.relpath(path, REPO)}:{node.lineno} imports {name}"
