"""Optimisers as (init, update) pure-function pairs over parameter trees,
the port of the JAX package's ``repro.optim``: state and updates stay on
the parameters' device, so an ``update`` makes no host read.
``apply_updates`` and ``clip_by_global_norm`` live in ``optim.sgd``."""
from repro_torch.optim.sgd import sgd, sgd_momentum  # noqa: F401
from repro_torch.optim.adam import adam  # noqa: F401
from repro_torch.optim.schedules import constant, cosine_decay, warmup_cosine  # noqa: F401
