"""Engine state: the federated server as a value.

``ServerState`` is the only thing a strategy transition reads and the only
thing it produces — transitions never mutate their input; they return a
new state (``dataclasses.replace`` with copied containers).
``EngineContext`` is the static world the state refers to: the loss and
eval functions, the client datasets on the engine's device, the Ψ
extractor and memoised cohort updates.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils import trees


def resolve_device(device=None) -> torch.device:
    """The engine's device: ``cuda`` unless the caller names another. With
    no device given and no GPU present this raises — the engine never
    falls back to the CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "to run the engine on the CPU")
        device = "cuda"
    return torch.device(device)


@dataclasses.dataclass
class EngineConfig:
    """The knobs of every registered strategy, the JAX package's
    ``EngineConfig`` fields. StoCFL reads ``tau``, ``lam``, ``lr``,
    ``local_steps``, ``sample_rate``, ``aggregator`` and ``project_dim``
    (Ψ's JL sketch width, ``extractor.JLSketch``; None keeps the full
    gradient); FedProx and Ditto read ``mu``; IFCA reads ``n_models`` and ``init_key``; CFL
    reads ``eps_rel`` and ``eps2`` and always runs full participation.
    ``fused_step`` routes every strategy's local update through the flat
    (C, P) path and K1 (``prox_update``, or its local-SGD form for the
    baselines). ``cluster_backend`` picks where StoCFL's partition lives:
    ``"numpy"``, the host ``ClusterState``, or ``"device"``, the
    ``DeviceClusters`` union-find (kernels ``merge_candidates`` and
    ``resolve_roots``). ``cohort_chunk`` bounds how many clients one
    cohort step runs (``bilevel.chunk_map``; 0 = off).
    ``rng_backend`` picks where cohort sampling lives: ``"device"`` draws
    from a threefry key carried in ``ServerState.rng_key``
    (``engine.sampler``: required by ``run_rounds``, identical draws eager
    or captured, and the reference's draws for one seed); ``"numpy"`` is
    the host bit-generator (the reference's numpy backend, bit for bit).
    ``dtype`` is the compute precision of params, grads and batches
    ("float32" | "bfloat16"); Ψ, the cluster means and the Eq. 2
    objective always stay fp32 (see ``engine.init``). ``async_cfg``
    (``engine.AsyncConfig``) holds the knobs of ``run_round_async``, the
    buffered asynchronous round (None: the defaults)."""
    tau: float = 0.5
    lam: float = 0.05
    lr: float = 0.1
    local_steps: int = 5
    sample_rate: float = 0.1
    seed: int = 0
    aggregator: str = "mean"          # G(·): mean | median | trimmed_mean | krum
    project_dim: Optional[int] = None  # Ψ's JL sketch width (None = off)
    mu: float = 0.05                  # FedProx / Ditto prox weight
    n_models: int = 4                 # IFCA hypothesis count
    init_key: int = 0                 # IFCA perturbation seed
    eps_rel: float = 0.35             # CFL split thresholds
    eps2: float = 0.01
    cohort_chunk: int = 0             # max clients per cohort step (0 = off)
    cluster_backend: str = "numpy"    # StoCFL partition: numpy | device
    rng_backend: str = "numpy"        # cohort sampling: numpy | device
    fused_step: bool = False          # flat fused local update
    dtype: str = "float32"            # param/grad compute precision
    async_cfg: Optional[Any] = None   # AsyncConfig of run_round_async


@dataclasses.dataclass
class EngineContext:
    """Static (non-checkpointed) world: functions, data, cached updates,
    the optional Ψ leaf filter, the optional device-resident
    ``ClientArena`` of every shard and the optional client-axis ``mesh``
    (a ``torch.distributed`` ``DeviceMesh``, ``launch.mesh``) whose ranks
    split each cohort's rows. With ``host_clients`` (a mesh and an arena:
    the arena's rows live on their owners) the client list stays on the
    host, as the reference keeps the list it was given, and a reader that
    needs one client on the device moves it (``device_batch``).
    ``psi_dim`` is the width of a Ψ row."""
    loss_fn: Callable
    init_params: Any
    clients: List[dict]
    cfg: EngineConfig
    device: torch.device
    eval_fn: Optional[Callable] = None
    leaf_filter: Optional[Callable] = None
    extractor: Optional[Callable] = None
    batched_extractor: Optional[Callable] = None   # Ψ of a stacked batch: (J, dim)
    arena: Optional[Any] = None       # ClientArena: device-resident shards
    mesh: Optional[Any] = None        # DeviceMesh: cohort rows split over its ranks
    host_clients: bool = False        # clients kept on the host (mesh + arena)
    psi_dim: int = 0
    cache: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def mesh_devices(self) -> int:
        """Ranks along the mesh's client axes (1 without a mesh): the
        count every split cohort axis is divided by
        (``sharding.mesh_client_count``)."""
        if self.mesh is None:
            return 1
        from repro_torch.sharding import specs
        return max(specs.mesh_client_count(self.mesh), 1)

    def client_batch(self, batch):
        """A client batch as the engine holds its world: tensors on the
        engine's device (on the host with ``host_clients``), floating
        leaves in the compute dtype."""
        batch = on_device(batch, "cpu" if self.host_clients else self.device)
        if self.cfg.dtype != "float32":
            batch = cast_floating(batch, compute_dtype(self.cfg.dtype))
        return batch

    def device_batch(self, cid: int):
        """Client ``cid``'s batch on the engine's device."""
        return on_device(self.clients[int(cid)], self.device)

    def cached(self, key: str, builder: Callable) -> Callable:
        """Memoise a built update or round program under ``key``
        (per-context cache)."""
        if key not in self.cache:
            self.cache[key] = builder()
        return self.cache[key]


@dataclasses.dataclass
class ServerState:
    """The federated server as a value: ``omega`` (global model),
    ``models`` (cluster or hypothesis models keyed by int) and ``personal``
    (Ditto's per-client models) are trees of tensors on the engine's
    device; the rest is host bookkeeping — strategy name, round counter,
    numpy bit-generator state (so sampling is checkpoint-exact), per-client
    sample counts, the departed set, the Ψ clustering state, CFL's
    membership and the metric history. Under ``rng_backend="device"`` the
    sampling state is instead ``rng_key``, a (2,) int64 threefry key on
    the engine's device (``engine.sampler``), so a captured multi-round
    loop (``engine.run_rounds``) samples with no host round trip.
    ``buffer`` is the ``AsyncBuffer`` of in-flight deltas that
    ``run_round_async`` keeps (None until its first round)."""
    ctx: EngineContext
    strategy: str
    round: int
    rng_state: dict
    sizes: Tuple[int, ...]
    left: frozenset
    omega: Any
    models: Any
    personal: Dict[int, Any] = dataclasses.field(default_factory=dict)
    clusters: Optional[Any] = None    # ClusterState or DeviceClusters
    members: Optional[Tuple[Tuple[int, ...], ...]] = None   # CFL partition
    history: Tuple[dict, ...] = ()
    rng_key: Optional[torch.Tensor] = None   # device sampling key (rng_backend="device")
    buffer: Optional[Any] = None      # AsyncBuffer (run_round_async)

    @property
    def n_clients(self) -> int:
        """Registered clients, departed included."""
        return len(self.ctx.clients)

    def cluster_model(self, root: int):
        """θ_k for a cluster root (lazy: ω₀ until first aggregate)."""
        return self.models.get(root, self.ctx.init_params)

    def client_root(self, cid: int) -> int:
        """Union-find root (= cluster id) of an observed client."""
        assert self.clusters is not None
        return self.clusters.uf.find(int(cid))

    def rng(self) -> np.random.Generator:
        """The sampling generator at this state's position."""
        g = np.random.default_rng(0)
        g.bit_generator.state = self.rng_state
        return g

    def replace(self, **kw) -> "ServerState":
        return dataclasses.replace(self, **kw)


def on_device(tree, device):
    """Arrays or tensors -> tensors on ``device`` (dtypes kept)."""
    def leaf(x):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.array(x))
        return x.to(device)

    return trees.tree_map(leaf, tree)


def cast_floating(tree, dt: torch.dtype):
    """Every floating leaf cast to ``dt``; integer and bool leaves (labels,
    masks, counters) keep their dtype."""
    return trees.tree_map(lambda x: x.to(dt) if x.is_floating_point() else x, tree)


def fresh_rng_state(seed: int) -> dict:
    return np.random.default_rng(seed).bit_generator.state


def fresh_rng_key(seed: int, device="cpu") -> torch.Tensor:
    """Device sampling key for ``rng_backend="device"``: the key words of
    the reference's ``jax.random.PRNGKey(seed)``, (0, seed) for
    0 <= seed < 2³², as a (2,) int64 tensor on ``device``."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                        dtype=torch.int64, device=device)


def compute_dtype(name: str) -> torch.dtype:
    """The torch dtype of ``EngineConfig.dtype``; raises for a name that
    is not a floating dtype."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"EngineConfig.dtype must be a float dtype, got {name!r}")
    return dt
