"""Event timelines: what happens to the federation, round by round.

A ``Timeline`` is an immutable schedule of typed events
(``repro_torch.sim.events``) plus availability windows. Three ways to build
one:

  explicit      ``Timeline([Join(t=3, cluster=1), Leave(t=5, cid=7)])``
  stochastic    ``Timeline.from_poisson(rounds=50, join_rate=2.0,
                leave_rate=1.5, n_clusters=4, seed=0)`` — Poisson
                arrivals/departures, the standard open-system churn model
  trace file    ``Timeline.from_trace("churn.json")`` — replayable JSON,
                written by ``to_trace`` (schema documented there)

``Timeline.from_spec`` parses the JAX package's ``train.py --churn`` mini-language:
either a path to a trace file, or ``"join=2.0,leave=1.5,straggle=0.1"``
key=value pairs forwarded to ``from_poisson``.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from repro_torch.sim.events import (Availability, Drift, Join, Leave, Straggle,
                              event_from_dict, to_dict)


class Timeline:
    """An immutable, per-round schedule of federation events.

    ``events``: any iterable of event dataclasses (rounds need not be
    contiguous or sorted — they are bucketed by ``t``); ``windows``:
    ``Availability`` constraints. The simulator asks ``at(t)`` for the
    round's events and ``unavailable(t)`` for the clients it must not
    sample that round.
    """

    def __init__(self, events: Iterable = (), windows: Sequence[Availability] = ()):
        self._by_round: Dict[int, List] = {}
        n = 0
        for ev in events:
            if isinstance(ev, Availability):
                raise TypeError("Availability is a window, not a round "
                                "event — pass it via windows=")
            self._by_round.setdefault(int(ev.t), []).append(ev)
            n += 1
        self._n_events = n
        self.windows: Tuple[Availability, ...] = tuple(windows)

    # --------------------------------------------------------------- views
    def at(self, t: int) -> tuple:
        """Events firing at round ``t`` (in insertion order)."""
        return tuple(self._by_round.get(int(t), ()))

    def unavailable(self, t: int) -> frozenset:
        """Cids whose availability windows exclude round ``t``. Clients
        with no window are never in this set."""
        windowed: Dict[int, bool] = {}
        for w in self.windows:
            ok = windowed.get(w.cid, False) or (w.start <= t < w.end)
            windowed[w.cid] = ok
        return frozenset(cid for cid, ok in windowed.items() if not ok)

    @property
    def horizon(self) -> int:
        """Last round anything happens (max event ``t`` / window end)."""
        ts = list(self._by_round) + [w.end - 1 for w in self.windows]
        return max(ts) if ts else 0

    def __len__(self) -> int:
        return self._n_events

    def events(self) -> list:
        """All events, ordered by round then insertion order."""
        return [ev for t in sorted(self._by_round)
                for ev in self._by_round[t]]

    def counts(self) -> Dict[str, int]:
        """{event kind: count} — the quick shape of a churn schedule."""
        out: Dict[str, int] = {}
        for ev in self.events():
            k = type(ev).__name__.lower()
            out[k] = out.get(k, 0) + 1
        return out

    def __repr__(self) -> str:
        kinds = ", ".join(f"{k}={v}" for k, v in sorted(self.counts().items()))
        return (f"Timeline(horizon={self.horizon}, {kinds or 'empty'}, "
                f"windows={len(self.windows)})")

    # ------------------------------------------------------- constructors
    @classmethod
    def from_poisson(cls, rounds: int, join_rate: float = 0.0,
                     leave_rate: float = 0.0, straggle: float = 0.0,
                     drift_every: int = 0, drift_strength: float = 0.05,
                     n_clusters: int = 0, seed: int = 0,
                     start: int = 1) -> "Timeline":
        """Open-system stochastic churn: per round ``t >= start``, the
        number of joins ~ Poisson(``join_rate``) and departures ~
        Poisson(``leave_rate``) — arrivals get a uniform latent
        ``cluster`` in ``[0, n_clusters)`` (0 leaves it unset), departures
        pick their victim at simulation time. ``straggle`` > 0 adds a
        per-round dropout event at that rate; ``drift_every`` > 0 drifts
        every live client's data each that-many rounds. Deterministic in
        ``seed``. ``start`` defaults to 1 so round 0 can onboard the
        initial federation undisturbed.
        """
        rng = np.random.default_rng(seed)
        evs: List = []
        for t in range(start, rounds):
            for _ in range(int(rng.poisson(join_rate))):
                cluster = int(rng.integers(n_clusters)) if n_clusters else None
                evs.append(Join(t=t, cluster=cluster))
            for _ in range(int(rng.poisson(leave_rate))):
                evs.append(Leave(t=t))
            if straggle > 0:
                evs.append(Straggle(t=t, rate=float(straggle)))
            if drift_every > 0 and t % drift_every == 0:
                evs.append(Drift(t=t, strength=float(drift_strength)))
        return cls(evs)

    @classmethod
    def from_trace(cls, path: str) -> "Timeline":
        """Load a JSON trace written by ``to_trace``."""
        with open(path) as f:
            doc = json.load(f)
        events = [event_from_dict(d) for d in doc.get("events", [])]
        windows = [Availability(int(c), int(s), int(e))
                   for c, s, e in doc.get("windows", [])]
        return cls(events, windows)

    def to_trace(self, path: str) -> None:
        """Write the replayable JSON trace: ``{"events": [{"kind": ...,
        "t": ..., ...}, ...], "windows": [[cid, start, end], ...]}`` —
        the schema ``from_trace`` reads and EXPERIMENTS.md documents."""
        doc = {"events": [to_dict(ev) for ev in self.events()],
               "windows": [[w.cid, w.start, w.end] for w in self.windows]}
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)

    @classmethod
    def from_spec(cls, spec: str, rounds: int, seed: int = 0,
                  n_clusters: int = 0) -> "Timeline":
        """Parse the ``train.py --churn`` argument: a trace-file path, or
        ``key=value`` pairs (``join``, ``leave``, ``straggle``,
        ``drift_every``, ``drift_strength``, ``seed``, ``start``)
        forwarded to ``from_poisson`` — e.g.
        ``--churn join=2.0,leave=1.5,straggle=0.1``."""
        if os.path.exists(spec):
            return cls.from_trace(spec)
        kw: Dict[str, float] = {}
        for part in spec.split(","):
            if not part.strip():
                continue
            if "=" not in part:
                raise ValueError(f"bad --churn component {part!r} "
                                 "(expected key=value or a trace path)")
            k, v = part.split("=", 1)
            kw[k.strip()] = float(v)
        kw.setdefault("seed", seed)
        kw.setdefault("n_clusters", n_clusters)
        rename = {"join": "join_rate", "leave": "leave_rate"}
        kw = {rename.get(k, k): v for k, v in kw.items()}
        for k in ("seed", "n_clusters", "drift_every", "start"):
            if k in kw:
                kw[k] = int(kw[k])
        return cls.from_poisson(rounds=rounds, **kw)
