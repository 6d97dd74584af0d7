"""Synthetic Non-IID federations (numpy), as the JAX package makes them,
the device-resident ``ClientArena`` and the LM token streams."""
from repro_torch.data.synthetic import (  # noqa: F401
    SETTING_FACTORIES,
    SETTINGS,
    drift_batch,
    femnist_like,
    hybrid,
    make_federation,
    pathological,
    rotated,
    rotated_factory,
    rotated_pathological,
    shifted,
)
from repro_torch.data.arena import ClientArena  # noqa: F401
from repro_torch.data.tokens import synthetic_lm_batch, token_stream  # noqa: F401
from repro_torch.data.dirichlet import dirichlet_label_skew, quantity_skew  # noqa: F401
