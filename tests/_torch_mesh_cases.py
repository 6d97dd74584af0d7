"""Inputs and no-mesh outputs of the port's model-axis worlds, shared by
``test_torch_family_mesh.py`` and ``test_torch_flash_decode.py`` (which
also hold them against the JAX package) and ``test_torch_card_worlds.py``
(on the card's machine, which has no JAX). Imports only numpy, torch and
the port.

Steps: each family's smoke config in fp32, the port's parameters from a
seed, ω a perturbation of them, a batch and a decode cache grown from the
port's prefill, for ``tests/_torch_steps_worker.py``; ``plain_steps`` is
the four steps without a mesh. Flash: qwen2 smoke's decode cases for
``tests/_torch_flash_worker.py`` and ``plain_decode`` of each.
"""
import os
import pickle

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.models.registry import build, grow_cache

# family: (arch, use_pallas, the data-axis sizes of its worlds: 2 for 2×2, 1 for 1×2)
FAMILIES = {
    "falcon-mamba": ("falcon-mamba-7b", True, (2,)),
    "falcon-mamba-plain": ("falcon-mamba-7b", False, (1,)),
    "phi3.5-moe": ("phi3.5-moe-42b-a6.6b", False, (2,)),
    "deepseek-v2": ("deepseek-v2-236b", False, (2,)),
    "zamba2": ("zamba2-1.2b", False, (2,)),
    "whisper": ("whisper-medium", False, (2, 1)),
    "internvl2": ("internvl2-26b", False, (2,)),
}
B, S = 4, 16
KINDS = ("train", "prefill", "decode", "repr")
MESH_TOL = 1e-5
# zamba2's Mamba2 decay ``a_log`` starts at 0, so θ' and Ψ there are its
# gradient alone, a sum over every row, step and head that cancels: on
# these inputs its Ψ measured 1.65e-05 against no mesh on the 2×2 mesh;
# every other family stays within 2.4e-06
MESH_TOLS = {"zamba2": 5e-5}


def mesh_tol(fam) -> float:
    """A family's tolerance against the port without a mesh."""
    return MESH_TOLS.get(fam, MESH_TOL)


def _sorted_map(fn, tree):
    """``fn`` over a nested dict's leaves, visited in sorted-key order (as
    ``jax.tree.map`` visits them, so draws from one generator line up)."""
    if isinstance(tree, dict):
        return {k: _sorted_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def config(arch, pallas):
    return get_config(arch, smoke=True, dtype="float32", use_pallas=pallas)


def batch(cfg, rng):
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    if cfg.arch_type == "audio":
        return {"frames": rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(np.float32),
                "tokens": tokens}
    if cfg.arch_type == "vlm":
        return {"patches": rng.standard_normal((B, cfg.n_patches, cfg.d_model))
                .astype(np.float32), "tokens": tokens[:, :8]}
    return {"tokens": tokens}


def write_inputs(root, arch, pallas):
    """The inputs of one case, written to ``root/inputs.pkl`` for the
    worker and returned: the port's parameters from a seed, ω a
    perturbation of them, a batch, and a decode cache grown from the
    port's prefill."""
    cfg = config(arch, pallas)
    model = build(cfg)
    theta = convert.to_numpy(model.init(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(0)
    omega = _sorted_map(lambda x: x + 0.01 * rng.standard_normal(x.shape).astype(np.float32),
                        theta)
    data = batch(cfg, rng)
    logits, cache = model.prefill(convert.to_torch(theta), convert.to_torch(data))
    seq = S if cfg.arch_type != "vlm" else cfg.n_patches + data["tokens"].shape[1]
    inputs = {"theta": theta, "omega": omega, "batch": data, "pos": seq, "s_max": seq + 8,
              "token": torch.argmax(logits, -1).to(torch.int32).numpy(),
              "cache": convert.to_numpy(grow_cache(model, cache, B, seq + 8))}
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    return inputs


def plain_steps(inputs, arch, pallas):
    """The port's four steps without a mesh, on ``inputs``."""
    model = build(config(arch, pallas))
    theta, omega = convert.to_torch(inputs["theta"]), convert.to_torch(inputs["omega"])
    data = convert.to_torch(inputs["batch"])
    t2, o2, m = steps.stocfl_train_step(model)(theta, omega, data)
    logits, pcache = steps.prefill_step(model)(theta, data)
    dlogits, dcache = steps.decode_step(model)(
        theta, torch.as_tensor(inputs["token"]), convert.to_torch(inputs["cache"]),
        torch.tensor(inputs["pos"], dtype=torch.int32))
    return convert.to_numpy({"train": {"theta": t2, "omega": o2, **m},
                             "prefill": {"logits": logits, "cache": pcache},
                             "decode": {"logits": dlogits, "cache": dcache},
                             "repr": steps.repr_step(model)(theta, data)})


# ------------------------------------------------------------ flash decode
FLASH_TOL = 1e-5
# name: (window, cache length, prefill length, position: a scalar or one a row)
FLASH_CASES = {
    "full-scalar": (None, 16, 12, 12),
    "full-rows": (None, 16, 12, [12, 9, 15, 3]),
    "window-scalar": (8, 8, 11, 11),
    "window-rows": (8, 8, 11, [11, 8, 19, 5]),
    "long-scalar": (None, 32, 12, 12),
    "undivided": (None, 13, 12, 12),
}
DIVIDED = [c for c in FLASH_CASES if c != "undivided"]


def flash_config(window=None):
    return get_config("qwen2-1.5b", smoke=True).with_(dtype="float32", sliding_window=window)


def _flash_case(params, model, tokens, window, cache_len, prefill, pos):
    m = build(model.cfg.with_(sliding_window=window))
    logits, cache = m.prefill(params, {"tokens": tokens[:, :prefill]})
    cache = grow_cache(m, cache, B, cache_len) if cache_len > prefill else cache
    token = torch.argmax(logits, -1).to(torch.int32)
    return {"window": window, "params": convert.to_numpy(params),
            "cache": convert.to_numpy(cache), "token": token.numpy(),
            "pos": np.asarray(pos, np.int32)}


def write_flash_cases(root):
    """Every flash case's inputs (qwen2 smoke's parameters from a seed, a
    prefilled cache, the next token and position), written to
    ``root/inputs.pkl`` for the worker and returned."""
    model = build(flash_config())
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.as_tensor(np.random.default_rng(2).integers(
        0, model.cfg.vocab_size, (B, 16)).astype(np.int32))
    with torch.no_grad():
        cases = {name: _flash_case(params, model, tokens, *spec)
                 for name, spec in FLASH_CASES.items()}
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "inputs.pkl"), "wb") as f:
        pickle.dump(cases, f)
    return cases


def plain_decode(case):
    """The port's plain decode without a mesh on ``case``."""
    with torch.no_grad():
        logits, cache = build(flash_config(case["window"])).decode(
            convert.to_torch(case["params"]), torch.as_tensor(case["token"]),
            convert.to_torch(case["cache"]), torch.as_tensor(case["pos"]))
    return logits.numpy(), convert.to_numpy(cache)


def written(cache_len, window, pos):
    """(B, cache_len) booleans: the entry each row's decode writes."""
    pos = np.broadcast_to(np.asarray(pos), (B,))
    slot = pos % cache_len if window else pos
    return np.arange(cache_len)[None, :] == slot[:, None]


def hold_cache(got, want, where, what):
    """Caches (L, B, S, H_kv, hd): bitwise outside the entries ``where``
    marks, within ``FLASH_TOL`` of the largest |value| in them."""
    for name in want:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        keep = ~where[None, :, :, None, None]
        assert np.array_equal(np.where(keep, g, 0), np.where(keep, w, 0)), (what, name)
        err = float(np.max(np.abs(g - w)))
        assert err <= FLASH_TOL * float(np.max(np.abs(w))), (what, name, err)


def close_logits(got, want, what):
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    assert err <= FLASH_TOL * float(np.max(np.abs(np.asarray(want)))), (what, err)
