"""Synthetic token streams for LLM-arch training paths.

Markov-chain token generator with per-cluster transition structure — gives
the LLM federated paths the same "clusterable distributions" property the
classification settings have (clients from the same latent domain share a
transition matrix), while staying fully offline.

The port's copy of the JAX package's ``data/tokens.py``: numpy only, so the
same seed gives byte-identical batches in both packages.
"""
from __future__ import annotations

import numpy as np


def token_stream(vocab_size: int, seq_len: int, batch: int, seed: int = 0,
                 n_states: int = 64, domain: int = 0):
    """(batch, seq_len) int32 tokens from a domain-specific Markov chain.

    The chain STRUCTURE (bands, transitions) depends only on `domain` —
    all clients of a domain share one distribution; `seed` only drives the
    stochastic draws."""
    rng_dom = np.random.default_rng(7_777 + domain)
    rng = np.random.default_rng(seed * 1000 + domain)
    # low-rank transition structure: state -> preferred token band.
    # Domains are "topical": each draws its bands from a half-vocab window
    # offset by domain (50% overlap between adjacent domains), so domains
    # differ in token MARGINALS — the signal Ψ picks up via the vocab-
    # matrix gradients — not just in transition structure.
    lo = (domain * vocab_size // 4) % max(vocab_size // 2, 1)
    bands = lo + rng_dom.integers(0, max(vocab_size // 2, 1), size=n_states)
    width = max(vocab_size // n_states, 1)
    out = np.empty((batch, seq_len), np.int64)
    state = rng.integers(0, n_states, size=batch)
    trans = rng_dom.integers(0, n_states, size=(n_states, 4))
    for t in range(seq_len):
        tok = (bands[state] + rng.integers(0, width, size=batch)) % vocab_size
        out[:, t] = tok
        state = trans[state, rng.integers(0, 4, size=batch)]
    return out.astype(np.int32)


def synthetic_lm_batch(cfg, seq_len: int, batch: int, seed: int = 0, domain: int = 0):
    """Batch dict matching the registry's input_specs for any arch family."""
    toks = token_stream(cfg.vocab_size, seq_len, batch, seed, domain=domain)
    if cfg.arch_type == "audio":
        rng = np.random.default_rng(seed + 7)
        frames = rng.normal(size=(batch, cfg.enc_seq, cfg.d_model)).astype(np.float32) * 0.02
        return {"frames": frames, "tokens": toks}
    if cfg.arch_type == "vlm":
        rng = np.random.default_rng(seed + 7)
        patches = rng.normal(size=(batch, cfg.n_patches, cfg.d_model)).astype(np.float32) * 0.02
        n_text = max(seq_len - cfg.n_patches, 8)
        return {"patches": patches, "tokens": toks[:, :n_text]}
    return {"tokens": toks}
