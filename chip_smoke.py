#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Four phases, each printing its lines; any failure exits non-zero and
prints no result.

1. Build: compile the CUDA kernels of ``kernels/csrc`` with nvcc.
2. Kernel checks: hold each kernel against its plain PyTorch version on
   the card (TF32 off), then time the kernel, the plain version and, where
   one exists, a single PyTorch call computing the same function.
3. Main path: five eager StoCFL rounds at the paper's cross-device setting
   (400 clients × 128 samples × 64 features, the 2048-hidden MLP with
   153,610 parameters, sample rate 0.1, E=5, fused_step=True) through
   ``repro_torch.engine.init`` / ``run_round`` on ``cuda``, with every
   kernel launch counted. Their host walls are the round time. Then the
   cosine kernel is held against its plain version on each round's real
   merge-pass input, and the first rounds are run on the CPU, whose
   cohorts, partition and merges must be identical and whose ω and bank
   rows must agree within 1e-4.
4. Trace: the same rounds twice more from a fresh start, once untouched
   and once with rounds 1.. under ``torch.profiler``: the host time of
   each phase of the round and the device's busy share.

The line before the last is one JSON object describing every kernel of the
path; the last line is ``{"ok": true, "device": {...}}``.
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
    return results


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
def _run_rounds(device, rounds, clients, params, loss, cfg, sync):
    """(initial state, one record per round: cohort, host wall ending in
    ``sync``, metrics, partition and the state after the round)."""
    from repro_torch import engine
    state = start = engine.init("stocfl", loss, params, clients, cfg, device=device)
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
    return launches, path_err


# ------------------------------------------------------------------ phase 4
def phase_trace(dev):
    """The main path's rounds twice more from a fresh start in this
    process: once untouched, once with rounds 1.. under ``torch.profiler``.
    Prints the host time of each ``stocfl.*`` phase of the round, the
    device's busy share and the kernels that take the most device time."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import engine
    from repro_torch.kernels import cosine_sim, prox_update

    clients, _, params, loss, cfg = main_setting()

    def steady_walls(record=None):
        seg = segments()
        state = engine.init("stocfl", loss, params, clients, cfg, device=dev)
        state, _ = engine.run_round(state)
        torch.cuda.synchronize()
        walls = []
        before = (prox_update.launches, cosine_sim.launches)
        with record or contextlib.nullcontext():
            for _ in range(1, ROUNDS):
                t0 = time.perf_counter()
                state, _ = engine.run_round(state)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
        launched = (prox_update.launches - before[0], cosine_sim.launches - before[1])
        return walls, segments() - seg, launched

    fmt = lambda ws, seg: (", ".join(f"{w:.1f}" for w in ws) + f" ms ({sum(ws):.1f} ms "
                           f"in all; {seg} new device-memory segments in the {ROUNDS} rounds)")
    print(f"[trace] rounds 1..{ROUNDS - 1} again, untouched: {fmt(*steady_walls()[:2])}")
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    walls, seg, launched = steady_walls(prof)
    wall = sum(walls)
    print(f"[trace] rounds 1..{ROUNDS - 1} under the profiler: {fmt(walls, seg)}")
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
        print(f"[trace] host {name:22s} {ms:9.1f} ms ({100 * ms / wall:5.1f}%)")
    other = wall - sum(phases.values())
    print(f"[trace] host {'other':22s} {other:9.1f} ms ({100 * other / wall:5.1f}%)")
    busy = sum(kernels.values())
    assert busy > 0, "the profiler recorded no device time"
    own = [sum(ms for n, ms in kernels.items() if k in n)
           for k in ("prox_update", "cosine_")]
    print(f"[trace] device busy {busy:.2f} ms of {wall:.1f} ms ({100 * busy / wall:.1f}%, "
          f"idle {100 - 100 * busy / wall:.1f}%); prox_update {own[0]:.3f} ms in "
          f"{launched[0]} launches, cosine_sim {own[1]:.3f} ms in {launched[1]}")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[trace] device {ms:8.3f} ms  {name[:90]}")


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

    phase_build()
    kernels = phase_kernels(dev, card_peaks(name))
    launches, path_err = phase_main_path(dev)
    for k, n in launches.items():
        kernels[k]["launches"] = n
    kernels["cosine_sim"]["max_abs_err"] = max(kernels["cosine_sim"]["max_abs_err"],
                                               path_err)
    phase_trace(dev)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kernels[n][k] for k in keys} for n in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
