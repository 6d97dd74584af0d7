"""Synthetic Non-IID federations (numpy), as the JAX package makes them."""
