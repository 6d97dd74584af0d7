"""Multi-node dry run for H100 meshes: trace every (arch × input shape ×
mesh) step on fake tensors over a fake process group, prove the sharding
config is coherent, and take the roofline terms from the trace.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --device cpu
Results: one JSON per run under results/dryrun_torch/.

The reference lowers and compiles each step for a TPU v5e pod
(``src/repro/launch/dryrun.py``) and reads XLA's cost and memory analyses.
Here the production mesh is the reference's layout on H100 nodes of 8
GPUs (``launch.mesh.make_production_mesh``: (32, 8) and (2, 32, 8), the
model axis inside a node), built over torch's ``fake`` process group, and
the step is ``launch.steps.lower_step``'s, run once on fake tensors (no
storage, no kernel) holding each rank's local shards, seen from rank 0.
A dispatch mode under DTensor (``StepCosts``) sees every local op the
rank would run and counts, per device:

* FLOPs: the products ``torch.utils.flop_counter`` has formulas for, at
  their local shapes (``FlopCounterMode`` itself sees DTensor ops and
  counts them at their global size);
* bytes accessed: each op's local inputs read once and outputs written
  once, views and allocations aside. An UNFUSED count: XLA's ``bytes
  accessed`` is taken after fusion, so the two are not the same measure;
  each hand-written kernel (K1 ``repro_torch::prox_update_``, K5
  ``repro_torch::ssm_scan_fwd`` / ``_bwd``) counts as its one op;
* collective bytes by kind, by the reference's convention: the bytes of
  each collective's RESULT, received per device (``sharding.CollectiveLog``
  sizes by the tensor sent instead), and by the mesh axis its group spans;
* memory: the local bytes of the step's arguments and outputs, and
  ``temp_bytes``, the peak of live storage the step made (its outputs
  while live included, the arguments not): ``argument_bytes +
  temp_bytes`` is the step's predicted peak. The arguments are taken as
  placed already, as the reference's compiled step takes them; a caller
  that hands ``lower_step``'s step whole tensors pays, in addition, the
  copy that places them.

Eager torch traces every layer, so a full-depth trace (``probe=False``)
is exact; ``probe=True`` traces the reference's shallow probes and
extrapolates affinely in depth as it does (``probe_metrics``), memory
included. Every number is a model of a cluster of 256 or 512 H100s, not a
measurement.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref
from collections import defaultdict

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.distributed_c10d import _resolve_process_group
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.config import INPUT_SHAPES
from repro_torch.models.registry import build, decode_specs
from repro_torch.sharding.specs import DTensor, NamedSharding, ShardCtx, _map_paths, to_local
from repro_torch.utils import trees

# ----------------------------------------------------------- HW constants
# one H100 SXM at 700 W (NVIDIA's H100 data sheet); links from the DGX H100
# data sheet: NVLink 900 GB/s both ways a GPU inside a node, one 400 Gb/s
# NIC a GPU across nodes
PEAK_FLOPS = 989e12          # bf16 dense, per GPU
HBM_BW = 3.35e12             # bytes/s per GPU
NVLINK_BW = 450e9            # bytes/s per GPU, one way: the model axis
NIC_BW = 50e9                # bytes/s per GPU: the data and pod axes
AXIS_BW = {"model": NVLINK_BW, "data": NIC_BW, "pod": NIC_BW}

# whisper-medium × long_500k is a pure stress shape (524k decoder
# self-cache against a 448-token real context), kept in the table as the
# reference keeps it. No hard skips.
SKIPS = {}

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
_COLLECTIVE = {"all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced":
               "all-gather", "allgather_": "all-gather", "_allgather_base_": "all-gather",
               "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
               "allreduce_": "all-reduce", "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
               "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
               "alltoall_base_": "all-to-all", "shard_dim_alltoall": "all-to-all",
               "broadcast": "collective-permute", "broadcast_": "collective-permute"}
# ops that move no bytes of their own (allocations, metadata)
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
               "detach", "alias", "lift_fresh", "_local_scalar_dense", "sym_size",
               "sym_stride", "sym_numel", "wait_tensor", "set_"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class StepCosts(TorchDispatchMode):
    """Counts one rank's local work while a step runs on fake tensors.

    Entered inside the ``FakeTensorMode``, it hands every op with a
    DTensor operand on (``NotImplemented``), so DTensor splits it into the
    rank's local ops, which reach this mode as plain tensors: those it
    counts (see the module docstring). DTensor's own bookkeeping is not
    the rank's work and is skipped while ``skip`` is set (``_Internals``).
    A collective's bytes are filed under the mesh axes its group spans
    (``"model"``, ``"data"``, ``"pod"``, or several joined by ``+`` for a
    group DTensor makes over flattened axes), read from the group's ranks'
    coordinates in ``mesh``. ``track`` registers the arguments' storages,
    which ``temp_bytes`` leaves out."""

    def __init__(self, mesh=None):
        super().__init__()
        # the ranks' grid, read now: inside the fake mode it would be fake
        self.grid = None if mesh is None else mesh.mesh.cpu().numpy()
        self.names = () if mesh is None else tuple(mesh.mesh_dim_names)
        self.axes = {}
        self.flops = 0
        self.bytes = 0
        self.coll = {k: 0 for k in KINDS}
        self.coll_axes = defaultdict(int)
        self.kernels = defaultdict(int)
        self.live = 0
        self.peak = 0
        self.skip = 0
        self._held = WeakIdKeyDictionary()

    def track(self, tensors) -> None:
        for t in _tensors(tensors):
            self._held[t.untyped_storage()] = True

    def _freed(self, n: int) -> None:
        self.live -= n

    def _new_storage(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._held:
            return
        self._held[st] = True
        n = st.nbytes()
        self.live += n
        weakref.finalize(st, self._freed, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(isinstance(x, DTensor) for x in tree_leaves((args, kwargs))):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.skip:
            return out
        name = func.__name__.split(".")[0]
        if func.namespace == "repro_torch":
            self.kernels[name] += 1
        if name in _COLLECTIVE and func.namespace in ("_c10d_functional", "c10d", "_dtensor"):
            self._collective(_COLLECTIVE[name], func, args, out)
        elif not (func.namespace == "prim" or func.is_view or name in _NO_TRAFFIC):
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
            if not func._schema.returns:            # a kernel that writes in place
                self.bytes += sum(_nbytes(a) for a, spec in zip(args, func._schema.arguments)
                                  if isinstance(a, torch.Tensor) and spec.alias_info is not None
                                  and spec.alias_info.is_write)
            self.flops += self._flops(func, args, kwargs, out)
        for t in _tensors(out):
            self._new_storage(t)
        self.peak = max(self.peak, self.live)
        return out

    def _collective(self, kind, func, args, out) -> None:
        # the result, received per device; an in-place c10d op's result is
        # its tensors, overwritten
        res = _tensors(out) if func.namespace != "c10d" else _tensors(args[0])
        n = sum(_nbytes(t) for t in res)
        self.coll[kind] += n
        group = next((a for a in reversed(args) if isinstance(a, str)), None)
        if group is None:
            group = next((getattr(a, "group_name", None) for a in args
                          if hasattr(a, "group_name")), None)
        self.coll_axes[self._axes_of(group)] += n

    def _axes_of(self, group) -> str:
        """The mesh axes a group spans: those along which its ranks'
        coordinates differ ("unknown" for a group of no rank of the mesh)."""
        if group not in self.axes:
            label = "unknown"
            if self.grid is not None and group is not None:
                coords = [np.argwhere(self.grid == r) for r in
                          dist.get_process_group_ranks(_resolve_process_group(group))]
                if all(len(c) for c in coords):
                    at = np.stack([c[0] for c in coords])
                    label = "+".join(name for d, name in enumerate(self.names)
                                     if len(set(at[:, d])) > 1) or "none"
            self.axes[group] = label
        return self.axes[group]

    @staticmethod
    def _flops(func, args, kwargs, out) -> int:
        from torch.utils.flop_counter import flop_registry
        formula = flop_registry.get(func._overloadpacket)
        return 0 if formula is None else int(formula(*args, **kwargs, out_val=out))

    def metrics(self) -> dict:
        out = {"flops": float(self.flops), "bytes": float(self.bytes),
               "coll_total": float(sum(self.coll.values()))}
        for k in KINDS:
            out[f"coll_{k}"] = float(self.coll[k])
        for a, n in self.coll_axes.items():
            out[f"axis_{a}"] = float(n)
        return out


def _not_traced() -> bool:
    return False


class _Internals:
    """Within the block, DTensor's own bookkeeping is hidden from ``costs``:
    its shape propagation (each new op run once at its global size, on
    fake tensors) and a strided shard's size arithmetic, which torch does
    on small index tensors and reads back (under a fake mode it raises a
    data-dependent error; here it runs on real ones). And DTensor keeps
    its caches: under a fake mode it takes itself to be traced by the
    compiler (``_functional_collectives._are_we_tracing``) and plans every
    op's sharding and every redistribution anew, which on a 3-D mesh costs
    minutes a layer; it, and the functional collectives it calls, are
    told they are not traced. Each is patched only
    where this torch has it."""

    def __init__(self, costs: StepCosts):
        from torch.distributed.tensor import _sharding_prop, placement_types
        self.sites = [(getattr(_sharding_prop, "ShardingPropagator", None),
                       "_propagate_tensor_meta_non_cached", False),
                      (getattr(placement_types, "_StridedShard", None),
                       "local_shard_size_and_offset", True)]
        self.costs, self.saved = costs, []

    def _hidden(self, fn, real_values):
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        costs = self.costs

        def run(*args, **kwargs):
            costs.skip += 1
            try:
                if real_values:
                    with unset_fake_temporarily():
                        return fn(*args, **kwargs)
                return fn(*args, **kwargs)
            finally:
                costs.skip -= 1

        return run

    def __enter__(self):
        import inspect
        import sys
        from torch.distributed import _functional_collectives as fc
        traced = fc._are_we_tracing
        for mod in [fc] + [m for n, m in sys.modules.items()
                           if n.startswith("torch.distributed.tensor") and m is not None]:
            if getattr(mod, "_are_we_tracing", None) is traced:
                mod._are_we_tracing = _not_traced
                self.saved.append((mod, "_are_we_tracing", traced))
        for cls, name, real_values in self.sites:
            if cls is None or not hasattr(cls, name):
                continue
            raw = inspect.getattr_static(cls, name)
            fn = raw.__func__ if isinstance(raw, (staticmethod, classmethod)) else raw
            hidden = self._hidden(fn, real_values)
            setattr(cls, name, type(raw)(hidden) if isinstance(
                raw, (staticmethod, classmethod)) else hidden)
            self.saved.append((cls, name, raw))
        return self

    def __exit__(self, *exc):
        for cls, name, raw in reversed(self.saved):
            setattr(cls, name, raw)
        self.saved.clear()


def patched_sites() -> list:
    """The DTensor internals ``_Internals`` finds, and so patches, in this
    torch (``module.name``)."""
    with _Internals(StepCosts()) as internals:
        return [f"{getattr(c, '__name__', c)}.{n}" for c, n, _ in internals.saved]


# ------------------------------------------------------------- the trace
def _local_shape(shape, sharding: NamedSharding) -> tuple:
    """The rank's shard of a global ``shape`` (``relax`` keeps every split
    dimension divisible, so every rank's shard is the same size)."""
    out = list(shape)
    for i, p in enumerate(sharding.placements):
        if p.is_shard():
            out[p.dim] //= sharding.mesh.size(i)
    return tuple(out)


def _fake_arg(spec, sharding, device):
    """A fake argument of ``spec``'s global shape and dtype: the rank's
    local shard wrapped as a DTensor of ``sharding`` (plain without one).
    Local shapes are computed before the fake mode is entered."""
    if sharding is None:
        return torch.empty(spec.shape, dtype=spec.dtype, device=device)
    local = torch.empty(_local_shape(spec.shape, sharding), dtype=spec.dtype, device=device)
    stride, n = [], 1
    for d in reversed(spec.shape):
        stride.insert(0, n)
        n *= int(d)
    return DTensor.from_local(local, sharding.mesh, sharding.placements, run_check=False,
                              shape=torch.Size(spec.shape), stride=tuple(stride))


def _step_args(model, shape, kind):
    """The step's argument specs (global shapes and dtypes), in order."""
    pspecs = steps.param_specs(model)
    if kind == "train":
        return (pspecs, pspecs, model.input_specs(shape))
    if kind == "prefill":
        return (pspecs, model.input_specs(shape))
    d = decode_specs(model, shape)
    return (pspecs, d["token"], d["cache"], d["pos"])


def _unbound(model, kind, lr, lam):
    """The step without a mesh: the model's own math on plain tensors,
    inside a ``ShardCtx`` over no mesh, so that it is the program a mesh
    runs (the loss contracts the reference's one-hot, as under a mesh)."""
    step = {"train": lambda: steps.stocfl_train_step(model, lr, lam),
            "prefill": lambda: steps.prefill_step(model),
            "decode": lambda: steps.decode_step(model)}[kind]()

    def run(*args):
        with ShardCtx(None):
            return step(*args)

    return run


def trace_step(cfg, shape, mesh, kind, lr=0.1, lam=0.05, device=None) -> dict:
    """Run ``kind``'s step for ``cfg`` at ``shape`` once on fake tensors:
    bound to ``mesh`` by ``steps.lower_step`` (or unbound, with ``mesh``
    None, on whole fake tensors of ``device``), and count one rank's
    costs. Returns ``StepCosts.metrics()`` plus ``argument_bytes``,
    ``output_bytes``, ``temp_bytes`` and ``kernels`` (the hand-written
    kernels' ops seen)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    model = build(cfg)
    specs = _step_args(model, shape, kind)
    if mesh is not None:
        bound = steps.lower_step(model, shape, mesh, kind, lr=lr, lam=lam)
        fn, shards, device = bound.fn, bound.in_shardings, mesh.device_type
    else:
        fn, shards = _unbound(model, kind, lr, lam), (None,) * len(specs)
        device = device or "cuda"
    costs = StepCosts(mesh)
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = [trees.tree_map(lambda s: _fake_arg(s, None, device), spec) if sh is None
                else trees.tree_map(lambda s, x: _fake_arg(s, x, device), spec, sh)
                for spec, sh in zip(specs, shards)]
        local = [trees.tree_map(to_local, a) for a in args]
        argument_bytes = sum(_nbytes(t) for t in _tensors(local))
        costs.track(local)
        with _Internals(costs), costs:
            out = fn(*args)
        output_bytes = sum(_nbytes(to_local(t)) for t in tree_leaves(out)
                           if isinstance(t, torch.Tensor))
        met = costs.metrics()
        met.update(argument_bytes=float(argument_bytes), output_bytes=float(output_bytes),
                   temp_bytes=float(costs.peak))
        del out, args, local
    return dict(met, kernels=dict(costs.kernels))


def model_flops(cfg, model, shape, kind: str) -> float:
    """6·N_active·tokens (train; ×2 for the bi-level pair) or 2·N_active·tokens,
    N counted from ``steps.param_specs`` (the reference's definition)."""
    sizes = []

    def leaf(path, spec):
        n = 1
        for d in spec.shape:
            n *= int(d)
        sizes.append((path, n))

    _map_paths(leaf, steps.param_specs(model))
    total = sum(n for _, n in sizes)
    expert = sum(n for p, n in sizes if "experts" in p)
    active = total - expert + (expert * cfg.moe_top_k // max(cfg.n_experts, 1)
                               if cfg.n_experts else 0)
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 2 * 6.0 * active * tokens          # bi-level: θ and ω both trained
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens
    tokens = shape.global_batch                   # decode: one token per sequence
    return 2.0 * active * tokens


def pick_kind(shape) -> str:
    return {"train": "train", "prefill": "prefill", "decode": "decode"}[shape.kind]


# ----------------------------------------------------------- cost probes
# The reference probes shallow unrolled copies because XLA counts a loop's
# body once; eager torch traces every layer, so the probes here only save
# time, and the affine plans are the reference's.
_MEMORY = ("argument_bytes", "output_bytes", "temp_bytes")


def _measure(cfg, shape, mesh, kind, lr, lam, device=None) -> dict:
    met = trace_step(cfg, shape, mesh, kind, lr, lam, device)
    return {k: v for k, v in met.items() if isinstance(v, float)}


def _lin(a: dict, b: dict, sa: float, sb: float) -> dict:
    return {k: sa * a.get(k, 0.0) + sb * b.get(k, 0.0) for k in set(a) | set(b)}


def probe_metrics(cfg0, shape, mesh, kind, lr, lam, device=None) -> dict:
    """Per-device cost metrics at full depth, extrapolated from shallow
    probes by the reference's affine plans (audio, hybrid, MoE with dense
    leading layers, linear)."""
    base = dict(scan_unroll=True)
    at = cfg0.arch_type
    L = cfg0.n_layers
    m = lambda **kw: _measure(cfg0.with_(**kw, **base), shape, mesh, kind, lr, lam, device)
    if at in ("ssm", "hybrid") and shape.seq_len > 512:
        base["ssm_chunk"] = max(shape.seq_len // 4, 128)
    if at == "audio":
        f22 = m(n_layers=2, n_enc_layers=2)
        f42 = m(n_layers=2, n_enc_layers=4)
        f24 = m(n_layers=4, n_enc_layers=2)
        enc = _lin(f42, f22, 0.5, -0.5)
        dec = _lin(f24, f22, 0.5, -0.5)
        out = _lin(f22, enc, 1.0, cfg0.n_enc_layers - 2)
        return _lin(out, dec, 1.0, L - 2)
    if at == "hybrid":
        # full(L, every=g) = o + L·m + (L//g)·s, from an attention-free pair
        # (attn_every > L disables the shared block) and one 2-layer group
        fA = m(n_layers=2, attn_every=64)
        fB = m(n_layers=4, attn_every=64)
        fC = m(n_layers=2, attn_every=2)
        layer = _lin(fB, fA, 0.5, -0.5)
        s_blk = _lin(fC, fA, 1.0, -1.0)
        out = _lin(fA, layer, 1.0, L - 2)
        return _lin(out, s_blk, 1.0, L // cfg0.attn_every)
    if at == "moe" and cfg0.moe_layer_start > 0:
        s0 = cfg0.moe_layer_start
        f2 = m(n_layers=s0 + 1)
        f3 = m(n_layers=s0 + 2)
        body = _lin(f3, f2, 1.0, -1.0)
        return _lin(f2, body, 1.0, (L - s0) - 1)
    # linear families: dense, moe(start=0), ssm, vlm
    f2 = m(n_layers=2)
    f4 = m(n_layers=4)
    body = _lin(f4, f2, 0.5, -0.5)
    return _lin(f2, body, 1.0, L - 2)


def variant_config(arch: str, shape_name: str, smoke=False):
    """Apply the long_500k sub-quadratic variant for attention archs."""
    cfg = get_config(arch, smoke=smoke)
    variant = "baseline"
    if shape_name == "long_500k" and cfg.arch_type in ("dense", "moe", "vlm"):
        cfg = cfg.with_(sliding_window=8192)
        variant = "sliding8k"
    return cfg, variant


def roofline(met: dict) -> tuple:
    """(terms, dominant): compute, memory and collective seconds, the last
    each axis' collective bytes over that axis' link (``AXIS_BW``: NVLink
    for the model axis alone; a group that spans the data or pod axis, or
    several axes, crosses nodes at the NIC rate)."""
    coll = sum(v / AXIS_BW.get(k[5:], NIC_BW) for k, v in met.items()
               if k.startswith("axis_"))
    terms = {"compute_s": met["flops"] / PEAK_FLOPS, "memory_s": met["bytes"] / HBM_BW,
             "collective_s": coll}
    return terms, max(terms, key=terms.get)


def run_one(arch: str, shape_name: str, multi_pod: bool, out_dir: str, lr=0.1, lam=0.05,
            probe: bool = True, mesh=None, overrides=None, device=None) -> dict:
    """Trace (arch, shape) on the production mesh (``multi_pod``: the
    (2, 32, 8) one) or on ``mesh``, write its record to ``out_dir`` (None:
    no file) and return it. ``device`` is the fake tensors' device
    (``"cuda"`` by default)."""
    shape = INPUT_SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    tag = f"{arch}_{shape_name}_{mesh_name}"
    if (arch, shape_name) in SKIPS:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "skipped", "reason": SKIPS[(arch, shape_name)]}
        _write(out_dir, tag, rec)
        print(f"[dryrun] SKIP {tag}: {rec['reason']}")
        return rec

    cfg, variant = variant_config(arch, shape_name)
    if overrides:
        cfg = cfg.with_(**overrides)
        variant += "+" + ",".join(f"{k}={v}" for k, v in overrides.items())
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    else:
        variant += "+mesh" + "x".join(str(d) for d in mesh.shape)
    n_dev = mesh.size()
    kind = pick_kind(shape)
    model = build(cfg)

    t0 = time.time()
    full = None if probe else trace_step(cfg, shape, mesh, kind, lr, lam)
    t_lower = time.time() - t0
    t0 = time.time()
    if probe:
        met = probe_metrics(cfg, shape, mesh, kind, lr, lam)
        cost_src = "probe_extrapolated"
    else:
        met = {k: v for k, v in full.items() if isinstance(v, float)}
        cost_src = "traced_full_depth"
    t_probe = time.time() - t0

    terms, dominant = roofline(met)
    mf = model_flops(cfg, model, shape, kind)
    coll = {k[5:]: v for k, v in met.items() if k.startswith("coll_")}
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "variant": variant,
        "kind": kind, "status": "ok", "n_devices": int(n_dev), "device": mesh.device_type,
        "lower_s": round(t_lower, 2), "compile_s": None, "probe_s": round(t_probe, 2),
        "cost_source": cost_src,
        "flops_per_device": met["flops"], "bytes_per_device": met["bytes"],
        "collective_bytes_per_device": coll,
        "collective_bytes_by_axis": {k[5:]: v for k, v in met.items() if k.startswith("axis_")},
        "raw_loop_once": None if full is None else {
            "flops": full["flops"], "bytes": full["bytes"], "coll": coll},
        "memory": {k: met[k] for k in _MEMORY} | {"alias_bytes": None,
                                                    "generated_code_bytes": None},
        "kernel_ops": None if full is None else full["kernels"],
        "terms": terms, "dominant": dominant,
        "model_flops_global": mf,
        "model_flops_per_device": mf / n_dev,
        "useful_flops_ratio": (mf / n_dev) / met["flops"] if met["flops"] else None,
        "hlo_bytes": None,
    }
    _write(out_dir, tag, rec)
    print(f"[dryrun] OK {tag}: dominant={dominant} "
          f"compute={terms['compute_s'] * 1e3:.2f}ms memory={terms['memory_s'] * 1e3:.2f}ms "
          f"collective={terms['collective_s'] * 1e3:.2f}ms "
          f"(trace {t_lower:.1f}s probe {t_probe:.1f}s)")
    return rec


def _write(out_dir, tag, rec):
    if out_dir is None:
        return
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-probe", action="store_true",
                    help="trace at full depth instead of extrapolating shallow probes")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--resume", action="store_true",
                    help="skip (arch, shape, mesh) combos with existing JSON")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="the fake tensors' device (default cuda)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.mesh == "both" else [args.mesh == "multi"]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}_{shape}_{'multi' if mp else 'single'}.json"
                if args.resume and os.path.exists(os.path.join(args.out, tag)):
                    continue
                try:
                    run_one(arch, shape, mp, args.out, probe=not args.no_probe,
                            device=args.device)
                except Exception as e:
                    failures.append((arch, shape, mp, repr(e)))
                    print(f"[dryrun] FAIL {arch} {shape} multi={mp}: {e}")
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        return 1
    print("\nALL DRY-RUNS PASSED")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
