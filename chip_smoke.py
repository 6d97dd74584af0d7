#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Seven phases, each printing its lines; any failure exits non-zero and
prints no result.

1. Build: compile the CUDA kernels of ``kernels/csrc`` with nvcc.
2. Kernel checks: hold each kernel (K1 prox_update, K2 cosine_sim, K3
   merge_candidates, K4 resolve_roots) against its plain PyTorch version on
   the card (TF32 off), then time the kernel, the plain version and, where
   one exists, a single PyTorch call computing the same function. K3's
   inputs spread their cosines over (-1, 1) and it is held at thresholds
   placed between neighbouring float64 cosines.
3. Path 1: five eager StoCFL rounds at the paper's cross-device setting
   (400 clients × 128 samples × 64 features, the 2048-hidden MLP with
   153,610 parameters, sample rate 0.1, E=5, fused_step=True) through
   ``repro_torch.engine.init`` / ``run_round`` on ``cuda`` with the host
   clustering backend, every kernel launch counted. Their host walls are
   the round time. Then the cosine kernel is held against its plain version
   on each round's real merge-pass input, and the first rounds are run on
   the CPU, whose cohorts, partition and merges must be identical and whose
   ω and bank rows must agree within 1e-4.
4. Trace of path 1: the same rounds twice more from a fresh start, once
   untouched and once with rounds 1.. under ``torch.profiler``: the host
   time of each phase of the round and the device's busy share.
5. Path 2: the same five rounds with ``cluster_backend="device"`` over a
   ``ClientArena`` (``engine.init(..., arena=True)``), launches counted.
   Cohorts, partitions and n_clusters must equal path 1's, merge lists must
   have the same transitive closure, ω and bank rows agree within 1e-4; K3
   is held against its plain version on each round's real merge-pass input;
   the first rounds are repeated on the CPU with the same comparison.
6. Trace of path 2, as phase 4. Its untouched pass is a second run of the
   same rounds: parent arrays and merge lists must be identical to phase
   5's, and the cluster means of one state computed twice bitwise equal.
7. Path 2 at 4,000 clients (capacity 4,096): two rounds on each clustering
   backend, launches asserted, whose cohorts, partitions and n_clusters
   must be identical; K3 held against its plain version on each merge-pass
   input the device backend received.

The line before the last is one JSON object describing every kernel of the
paths; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

ROUNDS = 5                # rounds on the card
CPU_ROUNDS = 3            # rounds the CPU run repeats for the comparison
MAIN_ATOL = 1e-4          # ω and bank rows, card against CPU, after 3 rounds
TIMED_CALLS = 50          # calls per CUDA-event timing, after 3 warm-up calls
SCALE_CLIENTS = 4000      # phase 7's federation (capacity 4096)
SCALE_ROUNDS = 2
SCALE_CHUNK = 128         # cohort_chunk at 4000 clients (400-client cohorts)


def card_peaks(name: str):
    """(bytes/s, fp32 FLOP/s outside the tensor cores) of the card, from
    NVIDIA's data sheets: H100 SXM 3.35 TB/s and 67 TFLOP/s, H100 PCIe
    2.0 TB/s and 51 TFLOP/s."""
    if "PCIe" in name:
        return 2.0e12, 51.2e12
    return 3.35e12, 67.0e12


def time_ms(fn) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events over TIMED_CALLS
    calls. A spin kernel of about 50 ms runs first, so the host has queued
    every call before the device reaches the first: the events then time
    the device's work, not the host's rate of launching it."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(TIMED_CALLS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / TIMED_CALLS


def segments() -> int:
    """Device-memory segments the caching allocator has taken (cudaMalloc
    calls) so far in this process."""
    import torch
    return torch.cuda.memory_stats().get("segment.all.allocated", 0)


def bf16_ulps(a, b) -> int:
    """Largest distance in bf16 units in the last place between two bf16
    tensors of equal sign pattern (bit patterns are monotone per sign)."""
    import torch
    ia = a.view(torch.int16).to(torch.int32)
    ib = b.view(torch.int16).to(torch.int32)
    return int((ia - ib).abs().max()) if a.numel() else 0


# ------------------------------------------------------------------ phase 1
def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    path = _build.build(verbose=True)
    secs = time.perf_counter() - t0
    regs = [ln.strip() for ln in _build.last_build_log.splitlines()
            if "registers" in ln]
    print(f"[build] {len(_build.sources())} sources -> {os.path.basename(path)} "
          f"in {secs:.2f} s")
    for ln in regs:
        print(f"[build] ptxas: {ln}")
    _build.load()


# ------------------------------------------------------------------ phase 2
def phase_kernels(dev, peaks):
    import torch
    from repro_torch.kernels import cosine_sim, prox_update, ref

    bw, flops = peaks
    gen = torch.Generator().manual_seed(0)
    rand = lambda *shape: torch.randn(*shape, generator=gen)
    eta, lam = 0.1, 0.05
    results = {}

    # --- K1 prox_update: fp32 within 1e-6 abs, bf16 within 1 ulp, in place
    main_err = None
    for dtype in (torch.float32, torch.bfloat16):
        for n in (1, 1000, 65537, 40 * 153610):
            for offset in ((0, 1) if n == 65537 else (0,)):
                ops = [rand(n + offset).to(dtype).to(dev)[offset:] for _ in range(4)]
                want_t, want_o = ref.prox_update_ref(*ops, eta, lam)
                th, om = ops[0].clone(), ops[1].clone()
                if offset:
                    th, om = (torch.cat([t.new_zeros(1), t])[1:] for t in (th, om))
                ptrs = (th.data_ptr(), om.data_ptr())
                got_t, got_o = prox_update.prox_update_flat(th, om, ops[2], ops[3],
                                                            eta, lam)
                torch.cuda.synchronize()
                assert (got_t.data_ptr(), got_o.data_ptr()) == ptrs, "not in place"
                assert (th.data_ptr(), om.data_ptr()) == ptrs
                err = max(float((th.float() - want_t.float()).abs().max()),
                          float((om.float() - want_o.float()).abs().max()))
                if dtype == torch.float32:
                    ok, tol = err <= 1e-6, "1e-6 abs"
                else:
                    ulps = max(bf16_ulps(th, want_t), bf16_ulps(om, want_o))
                    ok, tol = ulps <= 1, f"1 ulp (got {ulps} ulp)"
                tag = f" offset={offset}" if offset else ""
                print(f"[check] prox_update {str(dtype)[6:]} n={n}{tag}: "
                      f"max_abs_err={err:.3e} tol {tol} in_place=yes")
                assert ok, f"prox_update {dtype} n={n} disagrees with plain"
                if dtype == torch.float32 and n == 40 * 153610:
                    main_err = err

    n = 40 * 153610
    th, om, gt, go = (rand(n).to(dev) for _ in range(4))
    k_ms = time_ms(lambda: prox_update.prox_update_flat(th, om, gt, go, eta, lam))
    p_ms = time_ms(lambda: ref.prox_update_ref(th, om, gt, go, eta, lam))
    bound = max(6 * n * 4 / bw, 7 * n / flops) * 1e3
    results["prox_update"] = dict(
        name="prox_update", route="cuda",
        source="src/repro_torch/kernels/csrc/prox_update.cu",
        replaces="src/repro/kernels/prox_update.py:29",
        max_abs_err=main_err, ms=k_ms, plain_ms=p_ms, bound_ms=bound,
        bound_by="bytes" if 6 * n * 4 / bw >= 7 * n / flops else "operations",
        library_ms=None)
    print(f"[time] prox_update fp32 n={n}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
          f"bound {bound:.4f} ms ({6 * n * 4 / 1e6:.1f} MB)")

    # --- K2 cosine_sim: fp32, zero rows exactly 0
    main_err = None
    for (N, D, zero_from) in ((5, 7, 4), (64, 153610, 44), (300, 4096, 290)):
        x = rand(N, D)
        x[zero_from:] = 0.0
        x = x.to(dev)
        got = cosine_sim.cosine_sim(x)
        want = ref.cosine_sim_ref(x)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = 1e-4 if D >= 100_000 else 1e-5
        pad_zero = bool((got[zero_from:] == 0).all() and (got[:, zero_from:] == 0).all())
        print(f"[check] cosine_sim fp32 ({N}, {D}) zero rows {zero_from}..{N - 1}: "
              f"max_abs_err={err:.3e} tol {tol:g} pad_exactly_0={pad_zero}")
        assert err <= tol and pad_zero, f"cosine_sim ({N}, {D}) disagrees with plain"
        if (N, D) == (64, 153610):
            main_err = err

    N, D = 64, 153610
    x = rand(N, D)
    x[44:] = 0.0
    x = x.to(dev)
    norms = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    xn = torch.where(norms > 0, x / norms, torch.zeros_like(x))
    k_ms = time_ms(lambda: cosine_sim.cosine_sim(x))
    p_ms = time_ms(lambda: ref.cosine_sim_ref(x))
    l_ms = time_ms(lambda: torch.mm(xn, xn.T))
    # X·Xᵀ is symmetric: the function needs the N(N+1)/2 distinct dot
    # products, 2·D operations each; it reads X once and writes N×N
    t_bytes = (N * D + N * N) * 4 / bw
    t_ops = N * (N + 1) * D / flops
    results["cosine_sim"] = dict(
        name="cosine_sim", route="cuda",
        source="src/repro_torch/kernels/csrc/cosine_sim.cu",
        replaces="src/repro/kernels/cosine_sim.py:30",
        max_abs_err=main_err, ms=k_ms, plain_ms=p_ms,
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=l_ms)
    print(f"[time] cosine_sim fp32 ({N}, {D}): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
          f"torch.mm on normalised rows {l_ms:.4f} ms, bound "
          f"{max(t_bytes, t_ops) * 1e3:.4f} ms ({(N * D + N * N) * 4 / 1e6:.1f} MB, "
          f"{N * (N + 1) * D / 1e9:.3f} GFLOP)")

    results["merge_candidates"] = check_merge_candidates(dev, bw, flops)
    results["resolve_roots"] = check_resolve_roots(dev, bw)
    return results


def spread_means(n, d, n_dead, seed, dev):
    """(x, live): n rows mixing three shared directions with per-row
    weights, plus a little noise, so their cosines spread evenly over
    (-1, 1); the last ``n_dead`` rows dead and every fifth of those zero."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(n, 3, generator=gen) @ torch.randn(3, d, generator=gen)
         + 0.05 * torch.randn(n, d, generator=gen))
    live = torch.ones(n, dtype=torch.bool)
    live[n - n_dead:] = False
    x[n - n_dead::5] = 0.0
    return x.to(dev), live.to(dev)


def live_cosines(x, live):
    """(cos, both): float64 cosines of the rows (a zero row's are 0),
    computed on the card, and the mask of distinct live pairs."""
    import torch
    x64 = x.double()
    nrm = torch.linalg.vector_norm(x64, dim=1, keepdim=True)
    xn = x64 / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    n = x.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    return xn @ xn.T, live[:, None] & live[None, :] & ~eye


def taus_between(cos, both, count, gap=2e-5):
    """``count`` thresholds spread over the live pairs' float64 cosines,
    each the midpoint of two neighbouring cosines at least ``gap`` apart:
    every pair lies at least gap/2 = 1e-5 from it, so a kernel whose
    cosine is off by more than that pair's distance to τ flips it."""
    import numpy as np
    c = np.unique(cos[both].cpu().numpy())
    ok = np.flatnonzero(np.diff(c) >= gap)
    if not len(ok):
        return []
    picks = ok[np.linspace(0, len(ok) - 1, count).round().astype(int)]
    return sorted({float((c[k] + c[k + 1]) / 2) for k in picks})


def hold_candidates(x, live, taus):
    """K3 against its plain version on (x, live) at each τ: the 0/1
    matrices must be equal, and where every live pair lies at least 1e-5
    from τ, equal to the float64 decision too. Returns (smallest |cos - τ|
    over live pairs at each τ, pairs over each τ)."""
    import torch
    from repro_torch.kernels import cosine_sim, ref
    cos, both = live_cosines(x, live)
    margins, pairs = [], []
    for tau in taus:
        got = cosine_sim.merge_candidates(x, live, tau)
        want = ref.merge_candidates_ref(x, live, tau)
        margin = float((cos[both] - tau).abs().min()) if bool(both.any()) else float("inf")
        assert torch.equal(got, want), f"merge_candidates disagrees with plain at tau {tau}"
        if margin >= 1e-5:
            assert torch.equal(got > 0, both & (cos >= tau)), \
                f"merge_candidates disagrees with the float64 decision at tau {tau}"
        margins.append(margin)
        pairs.append(int(want.sum()))
    return margins, pairs


def check_merge_candidates(dev, bw, flops):
    """K3 against its plain version, exact as 0/1 matrices, at the two
    path-2 shapes, on rows whose cosines spread over (-1, 1): at 16
    thresholds between neighbouring float64 cosines, each at least 1e-5
    from every pair, and at τ = -1.5 (every live off-diagonal pair). Then
    timed at both shapes at τ = 0.5. Returns the kernel's JSON entry (the
    400-client path's shape, (64, 153610))."""
    import torch
    from repro_torch.kernels import cosine_sim, ref

    tau = 0.5
    entry = None
    for (N, D, n_dead) in ((5, 7, 1), (64, 153610, 20), (512, 153610, 0)):
        x, live = spread_means(N, D, n_dead, N + D, dev)
        taus = taus_between(*live_cosines(x, live), 16)
        margins, pairs = hold_candidates(x, live, taus + [-1.5])
        print(f"[check] merge_candidates ({N}, {D}) dead rows {N - n_dead}..{N - 1}: exact "
              f"at {len(taus)} tau in [{taus[0]:.4f}, {taus[-1]:.4f}] between neighbouring "
              f"cosines (closest |cos - tau| {min(margins[:-1]):.3e}, must be >= 1e-5; "
              f"{min(pairs[:-1])}..{max(pairs[:-1])} pairs) and at tau -1.5 ({pairs[-1]} pairs)")
        assert min(margins[:-1]) >= 1e-5
        if N < 64:
            continue
        torch.cuda.synchronize()
        norms = torch.linalg.vector_norm(x, dim=1, keepdim=True)
        xn = torch.where(norms > 0, x / norms, torch.zeros_like(x))
        k_ms = time_ms(lambda: cosine_sim.merge_candidates(x, live, tau))
        p_ms = time_ms(lambda: ref.merge_candidates_ref(x, live, tau))
        l_ms = time_ms(lambda: torch.mm(xn, xn.T) >= tau)
        # reads X and the mask once, writes the (N, N) fp32 0/1 matrix; the
        # symmetric product needs N(N+1)·D operations
        t_bytes = (N * D * 4 + N + N * N * 4) / bw
        t_ops = N * (N + 1) * D / flops
        print(f"[time] merge_candidates fp32 ({N}, {D}): kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, torch.mm on normalised rows + threshold {l_ms:.4f} ms, "
              f"bound {max(t_bytes, t_ops) * 1e3:.4f} ms by "
              f"{'bytes' if t_bytes >= t_ops else 'operations'} "
              f"({(N * D * 4 + N + N * N * 4) / 1e6:.1f} MB, {N * (N + 1) * D / 1e9:.3f} GFLOP)")
        if N == 64:
            entry = dict(name="merge_candidates", route="cuda",
                         source="src/repro_torch/kernels/csrc/cosine_sim.cu",
                         replaces="src/repro/kernels/cosine_sim.py:79",
                         max_abs_err=0.0, ms=k_ms, plain_ms=p_ms,
                         bound_ms=max(t_bytes, t_ops) * 1e3,
                         bound_by="bytes" if t_bytes >= t_ops else "operations",
                         library_ms=l_ms)
    return entry


def forests(n, gen):
    """A random forest (parents at smaller ids), a chain through a random
    permutation of the ids (the deepest tree) and a fully compressed array."""
    import torch
    forest = torch.arange(n, dtype=torch.int32)
    picks = torch.randperm(n, generator=gen)[: n // 2]
    forest[picks] = (torch.rand(len(picks), generator=gen) * (picks + 1)).to(torch.int32)
    order = torch.randperm(n, generator=gen).to(torch.int32)
    chain = torch.empty(n, dtype=torch.int32)
    chain[order.long()] = torch.cat([order[:1], order[:-1]])
    roots = torch.randperm(n, generator=gen)[: max(n // 7, 1)].to(torch.int32)
    compressed = roots[torch.randint(0, len(roots), (n,), generator=gen)]
    compressed[roots.long()] = roots
    return {"forest": forest, "chain": chain, "compressed": compressed}


def check_resolve_roots(dev, bw):
    """K4 against its plain version, exactly, on random forests, chains and
    fully compressed arrays at N in {1, 512, 4096, 65536} (the last one the
    multi-launch route); timed at 512 and 4096. Returns the JSON entry at
    the 400-client path's capacity, 512."""
    import torch
    from repro_torch.kernels import ref, resolve_roots

    gen = torch.Generator().manual_seed(4)
    for n in (1, 512, 4096, 65536):
        for kind, parent in forests(n, gen).items():
            parent = parent.to(dev)
            got = resolve_roots.resolve_roots(parent)
            want = ref.resolve_roots_ref(parent)
            torch.cuda.synchronize()
            same = bool(torch.equal(got, want))
            print(f"[check] resolve_roots int32 N={n} {kind}: exact={same}, "
                  f"{resolve_roots.steps_for(n)} steps, "
                  f"{'one block' if n <= resolve_roots.RESIDENT_MAX else 'one launch a step'}")
            assert same, f"resolve_roots N={n} {kind} disagrees with plain"
    entry = None
    for n in (512, 4096):
        parent = forests(n, gen)["chain"].to(dev)
        k_ms = time_ms(lambda: resolve_roots.resolve_roots(parent))
        p_ms = time_ms(lambda: ref.resolve_roots_ref(parent))
        bound = 8 * n / bw * 1e3
        print(f"[time] resolve_roots int32 N={n}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
              f"({resolve_roots.steps_for(n)} gathers), bound {bound:.6f} ms by bytes "
              f"({8 * n} B); no single PyTorch call computes it")
        if n == 512:
            entry = dict(name="resolve_roots", route="cuda",
                         source="src/repro_torch/kernels/csrc/resolve_roots.cu",
                         replaces="src/repro/kernels/ops.py:46",
                         max_abs_err=0.0, ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                         bound_by="bytes", library_ms=None)
    return entry


def check_cosine_on_path(start, gpu, tau):
    """Hold K2 against its plain version on the matrices the main path's
    merge passes gave it: for each round, the clusters before it plus Ψ of
    the cohort's new clients, as cluster means padded to 64 rows. Both
    must take the same merge decisions (cosine ≥ τ). Returns the largest
    error."""
    import numpy as np
    import torch
    from repro_torch.kernels import cosine_sim, ref

    worst = 0.0
    for t, r in enumerate(gpu):
        state = start if t == 0 else gpu[t - 1]["state"]
        clusters = state.clusters.copy()
        new = [int(c) for c in r["cohort"] if c not in clusters.seen]
        clusters.observe(new, [state.ctx.extractor(state.ctx.clients[c]) for c in new])
        roots, x = clusters.padded_means()
        k = len(roots)
        got = cosine_sim.cosine_sim(x)
        want = ref.cosine_sim_ref(x)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        pad_zero = bool((got[k:] == 0).all() and (got[:, k:] == 0).all())
        iu = np.triu_indices(k, 1)
        g, w = got[:k, :k].cpu().numpy()[iu], want[:k, :k].cpu().numpy()[iu]
        same = bool(((g >= tau) == (w >= tau)).all())
        margin = float(np.abs(w - tau).min()) if len(w) else float("nan")
        print(f"[check] cosine_sim on round {t}'s merge-pass input {tuple(x.shape)} "
              f"({k} clusters): max_abs_err={err:.3e} tol 1e-4 pad_exactly_0={pad_zero} "
              f"merge decisions equal={same} ({int((w >= tau).sum())} pairs >= tau, "
              f"closest |cos - tau| {margin:.3e})")
        assert err <= 1e-4 and pad_zero and same, f"cosine_sim disagrees on round {t}"
        worst = max(worst, err)
    return worst


# ------------------------------------------------------------------ phase 3
def _run_rounds(device, rounds, clients, params, loss, cfg, sync, arena=False):
    """(initial state, one record per round: cohort, host wall ending in
    ``sync``, metrics, partition and the state after the round)."""
    from repro_torch import engine
    state = start = engine.init("stocfl", loss, params, clients, cfg, device=device,
                                arena=arena)
    trace = []
    for _ in range(rounds):
        _, cohort = engine.sample_clients(state)
        t0 = time.perf_counter()
        state, rec = engine.run_round(state)
        sync()
        trace.append(dict(cohort=[int(c) for c in cohort], wall=time.perf_counter() - t0,
                          n_clusters=rec["n_clusters"], merges=list(rec["merges"]),
                          objective=rec["objective"],
                          partition=state.clusters.assignment(), state=state))
    return start, trace


def main_setting():
    """(clients, latent cluster of each, params, loss, cfg) of the main path."""
    import dataclasses

    import torch
    from repro_torch.data.synthetic import pathological
    from repro_torch.engine import EngineConfig
    from repro_torch.models import simple

    clients, true_cluster, _tests = pathological(n_clients=400, n_per=128, seed=0)
    task = dataclasses.replace(simple.MNIST_MLP, input_shape=(64,), name="mlp2048")
    params = simple.init(torch.Generator().manual_seed(0), task)
    loss = lambda p, b: simple.loss_fn(p, b, task)
    cfg = EngineConfig(tau=0.5, lam=0.05, lr=0.1, local_steps=5, sample_rate=0.1,
                       seed=0, fused_step=True)
    return clients, true_cluster, params, loss, cfg


def phase_main_path(dev):
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.core.clustering import adjusted_rand_index
    from repro_torch.kernels import cosine_sim, prox_update

    clients, true_cluster, params, loss, cfg = main_setting()
    n_params = sum(p.numel() for p in params.values())
    print(f"[main] pathological 400 clients x 128 x 64, MLP 2048 hidden "
          f"({n_params} params), sample rate 0.1, E=5, fused_step=True")
    assert n_params == 153610

    seg = segments()
    prox_update.launches = 0
    cosine_sim.launches = 0
    start, gpu = _run_rounds(dev, ROUNDS, clients, params, loss, cfg,
                             torch.cuda.synchronize)
    launches = {"prox_update": prox_update.launches, "cosine_sim": cosine_sim.launches}
    seg = segments() - seg
    for t, r in enumerate(gpu):
        print(f"[main] cuda round {t}: wall {r['wall'] * 1e3:.1f} ms, sampled "
              f"{len(r['cohort'])}, n_clusters {r['n_clusters']}, merges "
              f"{len(r['merges'])}, objective {r['objective']:.6f}")
    steady = [r["wall"] * 1e3 for r in gpu[1:]]
    print(f"[main] round wall, rounds 1..{ROUNDS - 1}: mean {np.mean(steady):.1f} ms, "
          f"min {min(steady):.1f}, max {max(steady):.1f}; {seg} new device-memory "
          f"segments in the {ROUNDS} rounds")
    print(f"[main] launches on the main path: {launches}")
    # one K1 launch per local step; K2 once in the merge pass, once in the objective
    assert launches["prox_update"] == ROUNDS * cfg.local_steps, launches
    assert launches["cosine_sim"] == 2 * ROUNDS, launches
    path_err = check_cosine_on_path(start, gpu, cfg.tau)

    final = gpu[-1]["state"]
    for leaf in list(final.omega.values()) + list(final.models.stacked.values()):
        assert bool(torch.isfinite(leaf).all()), "non-finite model values"
    assign = final.clusters.assignment()
    ids = sorted(assign)
    ari = adjusted_rand_index([assign[i] for i in ids], [true_cluster[i] for i in ids])
    print(f"[main] after {ROUNDS} rounds: {len(ids)} clients observed, "
          f"{final.clusters.n_clusters()} clusters, ARI vs latent clusters {ari:.4f}")

    _, cpu = _run_rounds("cpu", CPU_ROUNDS, clients, params, loss, cfg, lambda: None)
    for t in range(CPU_ROUNDS):
        g, c = gpu[t], cpu[t]
        for key in ("cohort", "n_clusters", "partition", "merges"):
            assert g[key] == c[key], f"round {t}: {key} differs from the CPU run"
        print(f"[main] round {t}: cohort, n_clusters, partition, merges equal the "
              f"CPU run's (CPU wall {c['wall'] * 1e3:.1f} ms)")
    gs, cs = gpu[CPU_ROUNDS - 1]["state"], cpu[CPU_ROUNDS - 1]["state"]
    err = max(float(np.abs(a - b).max()) for a, b in zip(
        convert.to_numpy(gs.omega).values(), convert.to_numpy(cs.omega).values()))
    assert tuple(gs.models.roots) == tuple(cs.models.roots)
    for r in gs.models.roots:
        gm, cm = convert.to_numpy(gs.models[r]), convert.to_numpy(cs.models[r])
        err = max([err] + [float(np.abs(gm[k] - cm[k]).max()) for k in gm])
    print(f"[main] omega and {len(gs.models.roots)} bank rows after round "
          f"{CPU_ROUNDS - 1}: max |cuda - cpu| = {err:.3e} (tol {MAIN_ATOL:g})")
    assert err <= MAIN_ATOL
    return launches, path_err, gpu


# ------------------------------------------------------------ phases 4 and 6
def phase_trace(dev, cfg, arena, tag, groups):
    """The path's rounds twice more from a fresh start in this process:
    once untouched, once with rounds 1.. under ``torch.profiler``. Prints
    the host time of each ``stocfl.*`` phase of the round, the device's
    busy share, the device time of the kernels in ``groups`` ({label:
    (counter getter, kernel-name substrings)}) and the kernels that take
    the most device time. Returns the untouched pass's per-round records
    (merges, objective, parent array where the backend has one)."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import engine

    clients, _, params, loss, _cfg = main_setting()

    def steady_walls(record=None):
        seg = segments()
        state = engine.init("stocfl", loss, params, clients, cfg, device=dev, arena=arena)
        state, rec = engine.run_round(state)
        torch.cuda.synchronize()
        walls, recs = [], [_round_record(state, rec)]
        before = {k: get() for k, (get, _names) in groups.items()}
        with record or contextlib.nullcontext():
            for _ in range(1, ROUNDS):
                t0 = time.perf_counter()
                state, rec = engine.run_round(state)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                recs.append(_round_record(state, rec))
        launched = {k: get() - before[k] for k, (get, _names) in groups.items()}
        return walls, segments() - seg, launched, recs

    fmt = lambda ws, seg: (", ".join(f"{w:.1f}" for w in ws) + f" ms ({sum(ws):.1f} ms "
                           f"in all; {seg} new device-memory segments in the {ROUNDS} rounds)")
    walls, seg, _, untouched = steady_walls()
    print(f"[{tag}] rounds 1..{ROUNDS - 1} again, untouched: {fmt(walls, seg)}")
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    walls, seg, launched, _ = steady_walls(prof)
    wall = sum(walls)
    print(f"[{tag}] rounds 1..{ROUNDS - 1} under the profiler: {fmt(walls, seg)}")
    # a range appears twice: on the host, and as its span on the device
    phases, kernels = collections.defaultdict(float), collections.defaultdict(float)
    for ev in prof.events():
        if ev.name.startswith("stocfl."):
            if ev.device_type == DeviceType.CPU:
                phases[ev.name] += ev.cpu_time_total / 1e3
        elif ev.device_type == DeviceType.CUDA:
            kernels[ev.name] += ev.device_time_total / 1e3
    assert phases, "the profiler recorded no stocfl.* range"
    for name, ms in sorted(phases.items(), key=lambda kv: -kv[1]):
        print(f"[{tag}] host {name:22s} {ms:9.1f} ms ({100 * ms / wall:5.1f}%)")
    other = wall - sum(phases.values())
    print(f"[{tag}] host {'other':22s} {other:9.1f} ms ({100 * other / wall:5.1f}%)")
    busy = sum(kernels.values())
    assert busy > 0, "the profiler recorded no device time"
    own = ", ".join(
        f"{label} {sum(ms for n, ms in kernels.items() if any(k in n for k in names)):.3f} "
        f"ms in {launched[label]} launches" for label, (_get, names) in groups.items())
    print(f"[{tag}] device busy {busy:.2f} ms of {wall:.1f} ms ({100 * busy / wall:.1f}%, "
          f"idle {100 - 100 * busy / wall:.1f}%); {own}")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[{tag}] device {ms:8.3f} ms  {name[:90]}")
    return untouched


def _round_record(state, rec):
    """What two passes of the same rounds must share, and the objective."""
    dc = getattr(state.clusters, "state", None)
    return dict(merges=list(rec["merges"]), objective=rec["objective"],
                partition=state.clusters.assignment(),
                parent=None if dc is None else dc.parent.cpu())


# ------------------------------------------------------------------ phase 5
def merge_closure(merges):
    """{root: component min} over the roots a merge list touches: two lists
    with equal closures make the same partition and the same bank merge."""
    parent = {}

    def find(r):
        while parent.get(r, r) != r:
            r = parent[r]
        return r

    for keep, absorb in merges:
        ra, rb = find(keep), find(absorb)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    return {r: find(r) for pair in merges for r in pair}


def max_model_diff(a, b) -> float:
    """Largest |difference| of ω and of the bank rows of two states with
    the same bank roots."""
    import numpy as np
    from repro_torch import convert
    assert tuple(a.models.roots) == tuple(b.models.roots), "bank roots differ"
    err = max(float(np.abs(x - y).max()) for x, y in zip(
        convert.to_numpy(a.omega).values(), convert.to_numpy(b.omega).values()))
    for r in a.models.roots:
        am, bm = convert.to_numpy(a.models[r]), convert.to_numpy(b.models[r])
        err = max([err] + [float(np.abs(am[k] - bm[k]).max()) for k in am])
    return err


@contextlib.contextmanager
def recording_merge_inputs():
    """Within the block, every ``ops.merge_pairs`` call (the device
    backend's merge pass) also records a copy of the (means, live, τ) it
    received; yields the list of records. The call itself goes through
    unchanged, so its launch is counted once as before."""
    from repro_torch.kernels import ops
    real, records = ops.merge_pairs, []

    def record(means, live, tau, backend="auto"):
        records.append((means.clone(), live.clone(), float(tau)))
        return real(means, live, tau, backend=backend)

    ops.merge_pairs = record
    try:
        yield records
    finally:
        ops.merge_pairs = real


def check_candidates_on_path(records, tag):
    """Hold K3 against its plain version on the inputs the path's merge
    passes gave it, at the path's τ (printing the smallest |cos − τ| among
    live pairs) and at 8 thresholds between neighbouring cosines."""
    for t, (x, live, tau) in enumerate(records):
        taus = taus_between(*live_cosines(x, live), 8)
        margins, pairs = hold_candidates(x, live, [tau] + taus)
        print(f"[{tag}] merge_candidates on round {t}'s merge-pass input {tuple(x.shape)} "
              f"({int(live.sum())} live clusters): exact at tau {tau} ({pairs[0]} pairs over "
              f"tau, closest |cos - tau| {margins[0]:.3e}) and at {len(taus)} tau between "
              f"neighbouring cosines (closest {min(margins[1:], default=float('inf')):.3e})")
        assert min(margins[1:], default=1.0) >= 1e-5


def path2_config(cfg, **kw):
    import dataclasses
    return dataclasses.replace(cfg, cluster_backend="device", **kw)


def phase_device_path(dev, path1):
    """Five rounds of the main setting on the device clustering backend
    over a ClientArena; returns (launches, per-round records)."""
    import torch
    from repro_torch.kernels import cosine_sim, prox_update, resolve_roots

    clients, _, params, loss, cfg = main_setting()
    cfg = path2_config(cfg)
    print("[path2] the same setting with cluster_backend='device', arena=True")
    seg = segments()
    prox_update.launches = cosine_sim.launches = 0
    cosine_sim.candidate_launches = resolve_roots.launches = 0
    with recording_merge_inputs() as merge_inputs:
        start, gpu = _run_rounds(dev, ROUNDS, clients, params, loss, cfg,
                                 torch.cuda.synchronize, arena=True)
    launches = {"prox_update": prox_update.launches, "cosine_sim": cosine_sim.launches,
                "merge_candidates": cosine_sim.candidate_launches,
                "resolve_roots": resolve_roots.launches}
    seg = segments() - seg
    for t, r in enumerate(gpu):
        print(f"[path2] cuda round {t}: wall {r['wall'] * 1e3:.1f} ms, sampled "
              f"{len(r['cohort'])}, n_clusters {r['n_clusters']}, merges "
              f"{len(r['merges'])}, objective {r['objective']:.6f}")
    steady = [r["wall"] * 1e3 for r in gpu[1:]]
    print(f"[path2] round wall, rounds 1..{ROUNDS - 1}: "
          + ", ".join(f"{w:.1f}" for w in steady)
          + f" ms; {seg} new device-memory segments in the {ROUNDS} rounds")
    print(f"[path2] launches on path 2: {launches}")
    # K1 once a local step; K3 once a round (the merge pass); K4 twice a
    # round (the merge pass's and the objective's cluster means); no K2
    assert launches == {"prox_update": ROUNDS * cfg.local_steps, "cosine_sim": 0,
                        "merge_candidates": ROUNDS,
                        "resolve_roots": 2 * ROUNDS}, launches
    arena = start.ctx.arena
    print(f"[path2] arena {arena!r}; Psi bank {tuple(gpu[-1]['state'].clusters.state.rep.shape)} "
          f"fp32 = {gpu[-1]['state'].clusters.state.rep.numel() * 4 / 1e6:.1f} MB")

    for t, (a, b) in enumerate(zip(path1, gpu)):
        for key in ("cohort", "n_clusters", "partition"):
            assert a[key] == b[key], f"round {t}: {key} differs from path 1"
        assert merge_closure(a["merges"]) == merge_closure(b["merges"]), \
            f"round {t}: merge closures differ from path 1"
    err = max_model_diff(path1[-1]["state"], gpu[-1]["state"])
    print(f"[path2] rounds 0..{ROUNDS - 1}: cohorts, partitions, n_clusters equal path 1's "
          f"and merge lists have its transitive closure; omega and "
          f"{len(gpu[-1]['state'].models.roots)} bank rows after round {ROUNDS - 1}: "
          f"max |path 2 - path 1| = {err:.3e} (tol {MAIN_ATOL:g})")
    assert err <= MAIN_ATOL
    assert len(merge_inputs) == ROUNDS
    check_candidates_on_path(merge_inputs, "path2")
    del merge_inputs

    final = gpu[-1]["state"].clusters
    r1, m1 = final.cluster_means()
    r2, m2 = final.cluster_means()
    same = r1 == r2 and bool(torch.equal(m1, m2))
    print(f"[path2] cluster means of the final state computed twice: bitwise equal={same}")
    assert same, "cluster means differ between two computations"

    _, cpu = _run_rounds("cpu", CPU_ROUNDS, clients, params, loss, cfg, lambda: None,
                         arena=True)
    for t in range(CPU_ROUNDS):
        g, c = gpu[t], cpu[t]
        for key in ("cohort", "n_clusters", "partition", "merges"):
            assert g[key] == c[key], f"round {t}: {key} differs from the CPU run"
        print(f"[path2] round {t}: cohort, n_clusters, partition, merges equal the "
              f"CPU run's (CPU wall {c['wall'] * 1e3:.1f} ms)")
    err = max_model_diff(gpu[CPU_ROUNDS - 1]["state"], cpu[CPU_ROUNDS - 1]["state"])
    print(f"[path2] omega and bank rows after round {CPU_ROUNDS - 1}: max |cuda - cpu| = "
          f"{err:.3e} (tol {MAIN_ATOL:g})")
    assert err <= MAIN_ATOL
    return launches, gpu


def check_second_pass(first, second):
    """Phase 6's untouched pass against phase 5's rounds: identical parent
    arrays, partitions and merge lists; objectives compared bit for bit."""
    import torch
    worst = 0.0
    for t, (a, b) in enumerate(zip(first, second)):
        assert torch.equal(a["state"].clusters.state.parent.cpu(), b["parent"]), \
            f"round {t}: parent differs between two passes"
        assert a["merges"] == b["merges"] and a["partition"] == b["partition"], \
            f"round {t}: merges differ between two passes"
        worst = max(worst, abs(a["objective"] - b["objective"]))
    bitwise = all(a["objective"] == b["objective"] for a, b in zip(first, second))
    print(f"[trace2] second pass of rounds 0..{ROUNDS - 1}: parent arrays and merge "
          f"lists identical to path 2's; objectives bitwise equal={bitwise}"
          + ("" if bitwise else f" (largest difference {worst:.3e})"))


# ------------------------------------------------------------------ phase 7
def phase_scale(dev):
    """Two rounds at 4,000 clients on each clustering backend (same seed,
    hence the same cohorts): partitions and n_clusters must be identical.
    Round 0 observes 400 singletons, so K3 runs at (512, 153610) and K4 at
    N = 4096."""
    import dataclasses

    import torch
    from repro_torch.data.synthetic import pathological
    from repro_torch.kernels import cosine_sim, resolve_roots

    _, _, params, loss, cfg = main_setting()
    clients, _, _ = pathological(n_clients=SCALE_CLIENTS, n_per=128, seed=0)
    # per round: the device backend runs K3 once (merge pass) and K4 twice
    # (the merge pass's and the objective's cluster means); the host
    # backend runs K2 twice (merge pass and objective) and neither of those
    expect = {"device": (SCALE_ROUNDS, 2 * SCALE_ROUNDS, 0),
              "numpy": (0, 0, 2 * SCALE_ROUNDS)}
    runs = {}
    for backend in ("device", "numpy"):
        bcfg = dataclasses.replace(cfg, cluster_backend=backend, cohort_chunk=SCALE_CHUNK)
        cosine_sim.candidate_launches = resolve_roots.launches = cosine_sim.launches = 0
        with recording_merge_inputs() as merge_inputs:
            start, trace = _run_rounds(dev, SCALE_ROUNDS, clients, params, loss, bcfg,
                                       torch.cuda.synchronize, arena=True)
        counts = (cosine_sim.candidate_launches, resolve_roots.launches, cosine_sim.launches)
        runs[backend] = (start, trace, merge_inputs)
        for t, r in enumerate(trace):
            print(f"[scale] {backend} backend, {SCALE_CLIENTS} clients, round {t}: wall "
                  f"{r['wall'] * 1e3:.1f} ms, sampled {len(r['cohort'])}, n_clusters "
                  f"{r['n_clusters']}, merges {len(r['merges'])}")
        print(f"[scale] {backend} backend launches: merge_candidates {counts[0]}, "
              f"resolve_roots {counts[1]}, cosine_sim {counts[2]}")
        assert counts == expect[backend], (backend, counts, expect[backend])
    (dstart, dev_t, dev_inputs), (_, host_t, host_inputs) = runs["device"], runs["numpy"]
    assert len(dev_inputs) == SCALE_ROUNDS and not host_inputs
    for t, (a, b) in enumerate(zip(dev_t, host_t)):
        for key in ("cohort", "n_clusters", "partition"):
            assert a[key] == b[key], f"4000 clients, round {t}: {key} differs"
        assert merge_closure(a["merges"]) == merge_closure(b["merges"])
    err = max_model_diff(dev_t[-1]["state"], host_t[-1]["state"])
    st = dev_t[-1]["state"].clusters.state
    print(f"[scale] cohorts, partitions, n_clusters equal across backends; merge "
          f"closures equal; omega and bank rows max |device - numpy| = {err:.3e} "
          f"(tol {MAIN_ATOL:g}); capacity {st.capacity}, Psi bank "
          f"{st.rep.numel() * 4 / 1e9:.2f} GB, arena {dstart.ctx.arena.nbytes / 1e6:.1f} MB")
    assert err <= MAIN_ATOL
    check_candidates_on_path(dev_inputs, "scale")
    del dev_inputs
    final = dev_t[-1]["state"].clusters
    r1, m1 = final.cluster_means()
    r2, m2 = final.cluster_means()
    same = r1 == r2 and bool(torch.equal(m1, m2))
    print(f"[scale] cluster means at capacity {st.capacity} computed twice: "
          f"bitwise equal={same}")
    assert same


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (raises outside a checkout of the repo)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from repro_torch.kernels import cosine_sim, prox_update, resolve_roots

    phase_build()
    kernels = phase_kernels(dev, card_peaks(name))
    launches, path_err, path1 = phase_main_path(dev)
    for k in ("prox_update", "cosine_sim"):
        kernels[k]["launches"] = launches[k]
    kernels["cosine_sim"]["max_abs_err"] = max(kernels["cosine_sim"]["max_abs_err"],
                                               path_err)
    _, _, _, _, cfg = main_setting()
    phase_trace(dev, cfg, False, "trace", {
        "prox_update": (lambda: prox_update.launches, ("prox_update",)),
        "cosine_sim": (lambda: cosine_sim.launches, ("cosine_",))})
    launches2, path2 = phase_device_path(dev, path1)
    for k in ("merge_candidates", "resolve_roots"):
        kernels[k]["launches"] = launches2[k]
    del path1
    second = phase_trace(dev, path2_config(cfg), True, "trace2", {
        "prox_update": (lambda: prox_update.launches, ("prox_update",)),
        "merge_candidates": (lambda: cosine_sim.candidate_launches,
                             ("cosine_partial", "cosine_inv_norm", "candidates_finish")),
        "resolve_roots": (lambda: resolve_roots.launches, ("halving_",))})
    check_second_pass(path2, second)
    del path2
    phase_scale(dev)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kernels[n][k] for k in keys} for n in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
