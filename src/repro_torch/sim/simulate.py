"""The dynamic-federation simulation loop (paper §5 at scale).

``simulate(state, timeline, rounds)`` interleaves a ``Timeline``'s events
with ``engine.run_round``: joins go through ``engine.join`` (Ψ inference
against the live partition), departures through ``engine.leave`` (the
partition and the arena stay consistent), drift rewrites client shards
in place, and availability windows and stragglers constrain each round's
cohort before it trains. Every transition is the engine's own API; the
simulator only drives it. Both clustering backends churn the same way:
with ``cluster_backend="device"`` a join grows the union-find capacity
and a leave tombstones the departed row.

The loop records a per-round log (population, cohort, wall times, event
labels, cluster count) and the §5 joined-client accuracy curve: at each
eval point, the routed-model accuracy of newly joined clients beside a
sample of incumbents. On the card a round's wall ends in
``torch.cuda.synchronize``; the rounds themselves add no host sync.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import convert, engine
from repro_torch.engine.registry import get_strategy
from repro_torch.engine.state import on_device
from repro_torch.engine.strategies import eval_model
from repro_torch.sim.events import Delay, Drift, Join, Leave, Straggle
from repro_torch.sim.timeline import Timeline


@dataclasses.dataclass
class SimLog:
    """What a simulation run recorded.

    ``records``: one dict per round: ``t``, ``events`` (short labels),
    ``n_registered`` / ``n_live`` population, ``cohort`` size trained,
    ``sec_train`` (the round call alone) and ``sec_round`` (with the
    events) host walls in seconds, ``skipped`` (no available cohort),
    ``scanned`` (the round ran inside a ``run_rounds`` span; its times
    are then the span's average), ``n_clusters`` and, at eval points,
    ``joined_acc`` / ``incumbent_acc`` / ``gap``. ``joined``: cid ->
    latent cluster of every client that joined mid-run; ``departed``: the
    cids that left."""
    records: List[dict] = dataclasses.field(default_factory=list)
    joined: Dict[int, Optional[int]] = dataclasses.field(default_factory=dict)
    departed: List[int] = dataclasses.field(default_factory=list)

    def curve(self, key: str):
        """(rounds, values) of a recorded metric, skipping the rounds where
        it was not measured."""
        ts = [r["t"] for r in self.records if r.get(key) is not None]
        vs = [r[key] for r in self.records if r.get(key) is not None]
        return ts, vs

    def to_json(self) -> dict:
        """JSON-able view (the JAX package's ``BENCH_churn.json`` event-log
        schema)."""
        return {"records": self.records,
                "joined": {str(k): v for k, v in self.joined.items()},
                "departed": list(self.departed)}


def routed_model(state, cid: int):
    """The model the server would serve client ``cid`` now: its cluster's
    model when the strategy keeps a partition (StoCFL's Ψ, CFL's
    membership), its personal model (Ditto), the hypothesis of least local
    loss (IFCA, which keeps no assignment), the global ω otherwise."""
    if state.clusters is not None and cid in state.clusters.reps:
        return state.cluster_model(state.clusters.uf.find(int(cid)))
    if state.members is not None:
        for k, group in enumerate(state.members):
            if cid in group:
                return state.models.get(k, state.omega)
    if cid in state.personal:
        return state.personal[cid]
    if len(state.models):                    # IFCA: hypotheses, no partition
        batch = state.ctx.device_batch(cid)
        losses = {m: float(state.ctx.loss_fn(state.models[m], batch))
                  for m in state.models}
        return state.models[min(losses, key=losses.get)]
    return state.omega


def routed_accuracy(state, cids, tc_of: Dict[int, int], test_sets) -> Optional[float]:
    """Mean routed-model accuracy over ``cids``, each on its latent
    cluster's held-out set (``tc_of``), through the engine's evaluation
    (``strategies.eval_model``: bf16 models are up-cast for fp32 test
    sets); None when no cid has a known latent cluster."""
    dev = state.ctx.device
    accs = [eval_model(state.ctx, routed_model(state, c), on_device(test_sets[tc_of[c]], dev))
            for c in cids if tc_of.get(c) is not None and tc_of[c] in test_sets]
    return float(np.mean(accs)) if accs else None


def _resolve_leave(state, ev: Leave, rng) -> Optional[int]:
    live = [i for i in range(state.n_clients) if i not in state.left]
    if ev.cid is not None:
        return int(ev.cid) if int(ev.cid) in live else None
    if len(live) <= 1:          # never empty the federation
        return None
    return int(rng.choice(live))


def _sync(state) -> None:
    """Wait for the engine's device, so a host wall covers the device work."""
    dev = state.ctx.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def simulate(state, timeline: Timeline, rounds: Optional[int] = None,
             client_factory: Optional[Callable] = None,
             drift_fn: Optional[Callable] = None, seed: int = 0,
             cohort_quantum: int = 0, eval_every: int = 0,
             test_sets: Optional[dict] = None,
             true_cluster: Optional[Any] = None,
             incumbent_sample: int = 64, scan_spans: bool = False,
             async_mode: bool = False):
    """Drive ``rounds`` engine rounds through a churn ``Timeline``.

    Args:
      state: a fresh or mid-run ``ServerState`` (any strategy).
      timeline: the event schedule (``repro_torch.sim.Timeline``).
      rounds: how many rounds (default ``timeline.horizon + 1``).
      client_factory: ``(cluster, rng) -> batch`` building a joining
        client's data (needed for ``Join`` events without a ``batch``),
        e.g. ``repro_torch.data.rotated_factory(...)``.
      drift_fn: ``(batch, rng, strength) -> batch`` over numpy batches
        (default ``repro_torch.data.drift_batch``).
      seed: the simulator's rng (leave victims, stragglers, drift, factory
        draws), apart from the engine's sampling rng, so a timeline
        replays the same over different strategies. Full-participation
        strategies (CFL) train their whole partition every round, so
        windows, stragglers and ``cohort_quantum`` do not apply to them
        (the round's labels say so).
      cohort_quantum: truncate each sampled cohort to a multiple of this
        (0 = off), which bounds the set of cohort shapes under churn.
      eval_every: record the §5 joined-vs-incumbent routed accuracy every
        this many rounds (0 = never; needs ``test_sets`` and an engine
        ``eval_fn``).
      test_sets: {latent cluster id: held-out batch}.
      true_cluster: latent cluster per initial client (joined clients
        carry theirs on the ``Join`` event).
      incumbent_sample: cap on the incumbents evaluated per eval point.
      scan_spans: run event-free spans (no event, no availability window,
        no eval point, no cohort quantum) through ``engine.run_rounds`` in
        power-of-two chunks: on the card each is a replay of the captured
        round. States that ``run_rounds`` refuses (``scan_blockers``) run
        the span eagerly. When the state's context carries a client-axis
        mesh, rounds and spans run over it unchanged: every rank makes the
        same seeded draws, joins and leaves, so churn boundaries hold on
        every rank (a ``gloo`` group on the card is refused by
        ``scan_blockers`` and runs its spans eagerly).
      async_mode: drive every round through ``engine.run_round_async``
        (stocfl, fedavg, fedprox). A ``Straggle`` no longer drops its
        victims: each reports back one round late (the same seeded draw),
        and ``Delay`` events add ``ev.rounds`` of latency to their ``cids``
        (or the whole cohort). Records gain ``merged`` /
        ``dropped_stale`` / ``dropped_left`` / ``in_flight`` /
        ``max_staleness``. Spans are not scanned in this mode.

    Returns:
      (final ``ServerState``, ``SimLog``).
    """
    rng = np.random.default_rng(seed)
    rounds = timeline.horizon + 1 if rounds is None else int(rounds)
    log = SimLog()
    tc_of: Dict[int, Optional[int]] = (
        {i: int(c) for i, c in enumerate(true_cluster)}
        if true_cluster is not None else {})
    incumbents = list(range(state.n_clients))
    if len(incumbents) > incumbent_sample:
        incumbents = [int(i) for i in
                      rng.choice(incumbents, incumbent_sample, replace=False)]
    if drift_fn is None:
        from repro_torch.data.synthetic import drift_batch
        drift_fn = drift_batch
    strat = get_strategy(state.strategy)
    eval_on = bool(eval_every and test_sets is not None
                   and state.ctx.eval_fn is not None)
    if eval_on:
        test_sets = {k: on_device(b, state.ctx.device) for k, b in test_sets.items()}

    def _plain(t2: int) -> bool:
        """Round ``t2`` has no event, no availability window and no eval
        point, so it can ride a scanned span."""
        if timeline.at(t2) or timeline.unavailable(t2):
            return False
        return not (eval_on and (t2 % eval_every == 0 or t2 == rounds - 1))

    t = 0
    while t < rounds:
        # ---- an event-free span: run_rounds calls instead of eager rounds
        if scan_spans and not async_mode and cohort_quantum <= 1:
            span = 0
            while t + span < rounds and _plain(t + span):
                span += 1
            if span >= 2 and engine.scan_blockers(state) is None:
                t1 = time.perf_counter()
                # power-of-two chunks, largest first, so the span lengths
                # seen stay few (run_rounds(a); run_rounds(b) equals
                # run_rounds(a + b))
                ran = 0
                while ran < span:
                    chunk = 1 << ((span - ran).bit_length() - 1)
                    state = engine.run_rounds(state, chunk)
                    ran += chunk
                _sync(state)
                dt = (time.perf_counter() - t1) / span
                for i, met in enumerate(state.history[-span:]):
                    rec = {"t": t + i, "events": [], "scanned": True,
                           "n_registered": state.n_clients,
                           "n_live": state.n_clients - len(state.left),
                           "cohort": int(met.get("sampled", 0)),
                           "skipped": bool(met.get("skipped", False)),
                           "had_events": False,
                           "sec_train": dt, "sec_round": dt}
                    if "n_clusters" in met:
                        rec["n_clusters"] = met["n_clusters"]
                    log.records.append(rec)
                t += span
                continue

        evs = timeline.at(t)
        labels, drop_rate, delay_evs = [], 0.0, []
        t0 = time.perf_counter()
        for ev in evs:
            if isinstance(ev, Join):
                batch = ev.batch
                if batch is None:
                    if client_factory is None:
                        raise ValueError("Join without batch needs a client_factory")
                    batch = client_factory(ev.cluster, rng)
                state, cid = engine.join(state, batch)
                tc_of[cid] = ev.cluster
                log.joined[cid] = ev.cluster
                labels.append(f"join:{cid}")
            elif isinstance(ev, Leave):
                cid = _resolve_leave(state, ev, rng)
                if cid is None:
                    labels.append("leave:skipped")
                    continue
                state = engine.leave(state, cid)
                log.departed.append(cid)
                labels.append(f"leave:{cid}")
            elif isinstance(ev, Straggle):
                drop_rate = max(drop_rate, float(ev.rate))
                labels.append(f"straggle:{ev.rate}")
            elif isinstance(ev, Delay):
                if async_mode:
                    delay_evs.append(ev)
                    labels.append(f"delay:{ev.rounds}")
                else:
                    labels.append("delay:inapplicable-sync")
            elif isinstance(ev, Drift):
                ctx = state.ctx
                cids = ev.cids if ev.cids is not None else tuple(
                    i for i in range(state.n_clients) if i not in state.left)
                for c in cids:
                    nb = ctx.client_batch(drift_fn(convert.to_numpy(ctx.clients[c]), rng,
                                                    ev.strength))
                    ctx.clients[c] = nb
                    if ctx.arena is not None:     # the row's owner rewrites it
                        ctx.arena = ctx.arena.update(c, nb)
                labels.append(f"drift:{len(cids)}")
            else:
                raise TypeError(f"unknown event {ev!r}")

        # ---- cohort: availability -> sampling -> stragglers -> quantum
        busy = timeline.unavailable(t)
        if strat.full_participation:
            ids = np.array([i for i in range(state.n_clients) if i not in state.left])
            delays = np.zeros(len(ids), np.int64)
            if busy or drop_rate > 0:
                labels.append("full-participation:cohort-events-inapplicable")
        else:
            adv, ids = engine.sample_clients(state, unavailable=busy)
            state = engine.advance_rng(state, adv)
            delays = np.zeros(len(ids), np.int64)
            if drop_rate > 0 and len(ids):
                # one seeded draw either way, so a timeline replays the
                # same sync and async
                straggled = rng.random(len(ids)) < drop_rate
                victims = [int(c) for c in np.asarray(ids)[straggled]]
                if victims:
                    labels.append("straggle-victims:" + ",".join(str(c) for c in victims))
                if async_mode:
                    delays[straggled] += 1   # report back late, not never
                else:
                    ids = ids[~straggled]
                    delays = delays[~straggled]
            for ev in delay_evs:
                hit = (np.ones(len(ids), bool) if ev.cids is None
                       else np.isin(np.asarray(ids), np.asarray(ev.cids)))
                delays[hit] += int(ev.rounds)
            if cohort_quantum > 1 and len(ids) > cohort_quantum:
                ids = ids[: (len(ids) // cohort_quantum) * cohort_quantum]
                delays = delays[: len(ids)]

        rec: dict = {"t": t, "events": labels,
                     "n_registered": state.n_clients,
                     "n_live": state.n_clients - len(state.left),
                     "cohort": int(len(ids)), "skipped": len(ids) == 0,
                     "had_events": bool(labels)}
        if len(ids) == 0:
            rec["sec_round"] = time.perf_counter() - t0
            log.records.append(rec)
            t += 1
            continue
        t1 = time.perf_counter()
        if async_mode:
            state, metrics = engine.run_round_async(state, ids, delays=delays)
        else:
            state, metrics = engine.run_round(state, ids)
        _sync(state)
        t2 = time.perf_counter()
        rec["sec_train"] = t2 - t1              # the round call alone
        rec["sec_round"] = t2 - t0              # with the events
        if "n_clusters" in metrics:
            rec["n_clusters"] = metrics["n_clusters"]
        if async_mode:
            for k in ("merged", "dropped_stale", "dropped_left", "in_flight",
                      "max_staleness"):
                if k in metrics:
                    rec[k] = int(metrics[k])

        # ---- §5 joined-vs-incumbent routed-accuracy curve
        if eval_on and (t % eval_every == 0 or t == rounds - 1):
            alive_inc = [c for c in incumbents if c not in state.left]
            rec["incumbent_acc"] = routed_accuracy(state, alive_inc, tc_of, test_sets)
            alive_join = [c for c in log.joined if c not in state.left]
            rec["joined_acc"] = routed_accuracy(state, alive_join, tc_of, test_sets)
            if rec["incumbent_acc"] is not None and rec["joined_acc"] is not None:
                rec["gap"] = round(rec["incumbent_acc"] - rec["joined_acc"], 5)
        log.records.append(rec)
        t += 1
    return state, log
