"""Typed events for the dynamic-federation simulator (paper §5).

StoCFL's headline claim is support for "an arbitrary proportion of
client participation and newly joined clients for a varying FL system";
these event types are the vocabulary a ``Timeline`` drives the engine
with. Each event is a frozen dataclass carrying the round it fires at
(``t``) plus its payload; ``Availability`` is a *window*, not a
round-event — it constrains when a client may be sampled at all.

Events serialize to/from plain dicts (``to_dict`` / ``event_from_dict``)
so timelines round-trip through JSON trace files; a ``Join`` carrying an
in-memory ``batch`` payload is the one thing that cannot (hand it a
``cluster`` id and let the simulator's ``client_factory`` build the data
instead).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Join:
    """A new client enters the federation at round ``t`` (§5 joins).

    ``batch`` is the client's dataset; leave it ``None`` and set
    ``cluster`` (its latent distribution id) to have the simulator build
    the data via its ``client_factory(cluster, rng)`` — the only form
    that survives a trace-file round-trip.
    """
    t: int
    cluster: Optional[int] = None
    batch: Any = None


@dataclasses.dataclass(frozen=True)
class Leave:
    """Client ``cid`` departs at round ``t`` (§5 departures).

    ``cid=None`` means "a uniformly random live client", resolved by the
    simulator's seeded rng at fire time — the form stochastic churn
    generators emit.
    """
    t: int
    cid: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Straggle:
    """Stragglers at round ``t``: each sampled client independently drops
    out of the cohort with probability ``rate`` *after* sampling — the
    cross-device reality that a sampled device may never report back.
    """
    t: int
    rate: float


@dataclasses.dataclass(frozen=True)
class Drift:
    """Distribution drift at round ``t``: the data of ``cids`` (``None``
    = every live client) is rewritten by the simulator's ``drift_fn``
    (see ``repro_torch.data.synthetic.drift_batch``) with the given
    ``strength``. The clients' Ψ representations are NOT re-extracted —
    like the real system, the server only learns about drift through the
    training signal.
    """
    t: int
    cids: Optional[Tuple[int, ...]] = None
    strength: float = 0.05


@dataclasses.dataclass(frozen=True)
class Delay:
    """Async report-back latency at round ``t`` (``simulate(...,
    async_mode=True)`` only): the cohort members in ``cids`` (``None`` =
    the whole cohort) return their trained contribution ``rounds``
    rounds late — the delta sits in the engine's ``AsyncBuffer`` and
    merges at its arrival flush with weight ``count · γ^staleness``.
    Delays accumulate with Straggle-induced latency in the same round.
    """
    t: int
    rounds: int = 1
    cids: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass(frozen=True)
class Availability:
    """Client ``cid`` is only available for sampling in rounds
    ``start <= t < end``. A client with no window is always available; a
    client with several is available inside any of them.
    """
    cid: int
    start: int
    end: int


_KINDS = {"join": Join, "leave": Leave, "straggle": Straggle,
          "drift": Drift, "availability": Availability, "delay": Delay}


def to_dict(ev) -> dict:
    """Serialize an event to a plain JSON-able dict (``kind`` + fields)."""
    kind = type(ev).__name__.lower()
    if kind not in _KINDS:
        raise TypeError(f"not a simulator event: {ev!r}")
    d = dataclasses.asdict(ev)
    if kind == "join":
        if d.pop("batch", None) is not None:
            raise ValueError("Join events carrying an in-memory batch "
                             "cannot be serialized; use cluster= instead")
    if kind in ("drift", "delay") and d["cids"] is not None:
        d["cids"] = list(d["cids"])
    return {"kind": kind, **{k: v for k, v in d.items() if v is not None}}


def event_from_dict(d: dict):
    """Inverse of ``to_dict``: build the typed event a trace row names."""
    d = dict(d)
    kind = d.pop("kind")
    if kind not in _KINDS:
        raise ValueError(f"unknown event kind {kind!r} "
                         f"(expected one of {sorted(_KINDS)})")
    if kind in ("drift", "delay") and d.get("cids") is not None:
        d["cids"] = tuple(int(c) for c in d["cids"])
    return _KINDS[kind](**d)
