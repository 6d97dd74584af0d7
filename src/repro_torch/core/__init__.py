"""StoCFL core: the Ψ extractor (§3.1), stochastic client clustering
(§3.2: the host ``ClusterState`` and the device-resident
``DeviceClusters``), the bi-level cohort update (§3.3,
``repro_torch.core.bilevel``), robust aggregators, and the deprecated class
shims (``StoCFL`` and the baselines) over ``repro_torch.engine``."""
from repro_torch.core.clustering import (ClusterState, UnionFind,  # noqa: F401
                                         adjusted_rand_index)
from repro_torch.core.device_clustering import (DeviceClusters,  # noqa: F401
                                                DeviceClusterState,
                                                make_cluster_state)
from repro_torch.core.extractor import make_extractor, representation  # noqa: F401
from repro_torch.core.stocfl import StoCFL, StoCFLConfig  # noqa: F401
from repro_torch.core.baselines import (CFLSattler, Ditto, FLConfig,  # noqa: F401
                                        FedAvg, FedProx, IFCA)

__all__ = [
    "ClusterState", "UnionFind", "adjusted_rand_index",
    "DeviceClusters", "DeviceClusterState", "make_cluster_state",
    "make_extractor", "representation",
    "StoCFL", "StoCFLConfig",
    "CFLSattler", "Ditto", "FLConfig", "FedAvg", "FedProx", "IFCA",
]
