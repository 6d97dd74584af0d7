"""Checkpoints of trees, of the engine's ``ServerState`` (async buffer
included) and of the legacy StoCFL shim, in the JAX package's file
format: each package reads what the other writes."""
from repro_torch.checkpoint.ckpt import (load_pytree, load_server_state,  # noqa: F401
                                         load_stocfl, save_pytree,
                                         save_server_state, save_stocfl,
                                         wait_pending)
