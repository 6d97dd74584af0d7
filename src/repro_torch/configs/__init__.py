"""Architecture configs assigned to this paper (+ the paper's own tasks).

Each module exposes FULL (exact assigned config) and smoke() (reduced
same-family variant: <=2 layers, d_model<=512, <=4 experts). The port's
copy of the JAX package's ``configs/``: plain data, the same values.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "phi35_moe_42b",
    "llama3_8b",
    "whisper_medium",
    "internlm2_1_8b",
    "falcon_mamba_7b",
    "internvl2_26b",
    "zamba2_1_2b",
    "granite_3_8b",
    "deepseek_v2_236b",
    "qwen2_1_5b",
]

# CLI ids (the assignment's spelling) -> module names
CLI_ALIASES = {
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "llama3-8b": "llama3_8b",
    "whisper-medium": "whisper_medium",
    "internlm2-1.8b": "internlm2_1_8b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "internvl2-26b": "internvl2_26b",
    "zamba2-1.2b": "zamba2_1_2b",
    "granite-3-8b": "granite_3_8b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "qwen2-1.5b": "qwen2_1_5b",
}


def get_config(arch: str, smoke: bool = False, **overrides):
    mod_name = CLI_ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    cfg = mod.smoke() if smoke else mod.FULL
    return cfg.with_(**overrides) if overrides else cfg


def all_configs(smoke: bool = False):
    return {a: get_config(a, smoke=smoke) for a in ARCH_IDS}
