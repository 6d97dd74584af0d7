#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Fifteen phases, each printing its lines; any failure exits non-zero and
prints no result.

1. Build: compile the CUDA kernels of ``kernels/csrc`` with nvcc.
2. Kernel checks: hold each kernel (K1 prox_update and its local-SGD form
   prox_theta, K2 cosine_sim, K3 merge_candidates, K4 resolve_roots, the
   merge pass's component_labels, K5 ssm_scan forward and backward) against
   its plain PyTorch version on the card (TF32 off), then time the kernel,
   the plain version and, where one exists, a single PyTorch call computing
   the same function. prox_theta must equal its plain version bitwise with
   the anchor θ itself (λ = 0), a broadcast (P,) anchor and a full one, on
   ragged and misaligned lengths, in fp32 and bf16, the anchor unchanged;
   it is timed at the baselines' cohorts (40 and 400 clients × 153,610)
   beside ``add_``, with the L2 warm and cold (a 256 MB buffer written
   before each call, its own time taken off). K1's bf16 entry runs on path
   3's (2, 743,305,216) buffers, within 1 bf16 ulp of its plain version,
   and is timed there. K4 is
   timed on the fully compressed arrays the path gives it and on chains,
   beside the launch floor (``torch.cuda._sleep(1)``); component_labels
   against its plain loop, which syncs once a pass, by a host clock around
   a synchronised call. K3's inputs spread their cosines over
   (-1, 1) and it is held at thresholds placed between neighbouring
   float64 cosines. K2 and K3 (3xTF32 on the tensor cores) are timed on
   rows laid out as the paths lay them: K2 at (64, 153610) and (64, 8192),
   K3 at (64, 153610), (512, 153610) and (2048, 153610); their bound is the
   larger of bytes and 3xTF32 operations, the FFMA bound printed beside.
   K5 runs at path 3's shape (4, 256, 8192, 16) and a ragged one; its
   backward must be bitwise repeatable. On paths 1, 2, 4,000 clients and 3
   no K2 or K3 input may be copied into the kernels' row layout
   (``cosine_sim.padded_copies`` stays 0).
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
   is held against its plain version on each round's real merge-pass input,
   component_labels on the adjacency K3 returned there;
   the first rounds are repeated on the CPU with the same comparison.
6. Trace of path 2, as phase 4. Its untouched pass is a second run of the
   same rounds: parent arrays and merge lists must be identical to phase
   5's, and the cluster means of one state computed twice bitwise equal.
7. Path 2 at 4,000 clients (capacity 4,096): two rounds on each clustering
   backend, launches asserted, whose cohorts, partitions and n_clusters
   must be identical; K3 and component_labels held against their plain
   versions on each merge-pass input the device backend received.
8. Path 3: StoCFL's federated LLM round (the reference's ``run_llm``) on
   falcon-mamba-7b at full width (d_model 4096, d_inner 8192, vocab 65024,
   bf16 compute, fp32 params) cut to 2 layers, ``use_pallas=True``: 3
   rounds over 4 clients in 2 domains (2 sequences of 256 tokens each),
   Ψ on the vocab matrices sketched to 8192, each round followed by ω's
   loss on client 0. Launches of K5 (both ways; with the config's remat
   every scan under a gradient runs its forward twice), K1 and K2
   asserted; peak device memory printed; Ψ bitwise repeatable. K5 is held against its
   plain versions on the first cohort step's operands, K2 on every matrix
   the path gave it, K1 bitwise on buffers of the path's (2, 743,305,216)
   size; then the rounds again with rounds 1.. under ``torch.profiler``
   (``[trace3]``). Then, in a child process of its own (a fresh caching
   allocator with expandable segments: the reruns peak near 62 GB), the
   kernel rounds once more, equal to the counted run; the same rounds with
   the plain chunked scan (``use_pallas=False``): cohorts, partitions and
   n_clusters equal, ω's update after round 0 within 5% (bf16 compute);
   the plain rounds again from ω₀ moved by one fp32 ulp (the spread of two
   sound bf16 runs, reported); one loss and gradient at ω₀ in bf16 and
   fp32; the 3 rounds in fp32 compute, kernel against plain scan, ω's
   update within 1e-4 after round 0 and, after the later rounds, no
   farther apart than two plain runs an ulp apart.
9. The smoke falcon-mamba in fp32 through the same rounds on the card and
   on the CPU: cohorts, partitions, merges, n_clusters equal, ω and bank
   rows within 1e-4.
10. The paper's baselines at phase 3's setting through ``engine.init`` /
   ``run_round`` on ``cuda``: FedAvg, FedProx (μ 0.05), Ditto (μ 0.05) and
   IFCA (4 hypotheses) 5 rounds each at sample rate 0.1, CFL 3 rounds over
   all 400 clients (eps_rel 0.5, eps2 0.01), their local SGD on
   prox_theta. Per round the host wall, ``sampled`` and CFL's n_clusters;
   launches asserted (prox_theta 5 a round, 10 for Ditto; prox_update
   none); prox_theta held bitwise against its plain version on each
   strategy's first local step; CFL's split statistics printed and a split
   asserted; then 3 rounds of each on the CPU, whose cohorts, records,
   IFCA choices and CFL members must be identical and whose ω, bank rows
   and Ditto's personal rows of the sampled clients agree within 1e-4.
11. The device sampler, the bf16 policy and the captured loop.
   (a) The threefry draws (``engine.sampler``) at 400 and 4,000 clients on
   the card, bitwise equal to the CPU's. (b) Path 3 with
   ``EngineConfig(dtype="bfloat16")``: the round walls, ω's losses beside
   phase 8's, the peak memory (gate 63.21 GB), K1's launches (all of its
   bf16 entry), ω, θ and the bank in bf16 and Ψ, the means and the
   objective in fp32; then traced (``[trace_bf16]``). (c) Path 2 at 400
   clients (5 rounds) and 4,000 (2 rounds) under ``rng_backend="device"``
   through ``run_round`` and through ``run_rounds`` from the same
   ``init``, and (d) each baseline at phase 10's setting (5 rounds, CFL 3)
   the same way: the eager walls, the first ``run_rounds`` call (its round
   0 runs eagerly on the capture stream, then one round is captured in a
   CUDA graph and replayed), the capture's time, a call of replays only
   (its wall over its rounds) and one under the profiler (the device's busy
   share). Gates: cohorts (the span's draws from its start key), records,
   parent / live, members and bank roots equal the eager loop's; ω, bank
   and personal rows within 1e-4. A kernel's launch counter counts at
   capture, so the graph's owner takes the capture's counts back off and
   adds them once per replay: the first call's launches must equal the
   captured round's counts × the rounds.

12. The varying federation at paths 1 and 2's model and knobs (device rng)
   over ``rotated(n_clusters=4, n_clients=400, n_per=128, seed=0)``, whose
   latent clusters ``rotated_factory`` draws newcomers from. The
   timelines follow ``benchmarks/churn_sweep.py``'s churn model over 30
   rounds (Poisson joins and leaves from round 0, drift every 10 rounds),
   with an availability window and the §5 burst of 80 joins at round 10.
   (a) Its 5% point (1/3 joins and 1/3 leaves a round) through
   ``sim.simulate`` on the device backend over an arena, eagerly and with
   ``scan_spans`` (event-free spans replayed from captured graphs), eval
   every 5 rounds: records, joined, departed, partitions and bank roots
   equal, rows within 1e-4; per-round walls, CUDA graphs captured,
   ``memory_reserved`` before and after, the joined-versus-incumbent
   accuracy curve and the final gap; K3 and component_labels held against
   their plain versions on the churned path's merge-pass inputs. (b) Five
   rounds of ``run_round_async`` at zero delay against ``run_round`` (StoCFL
   on the host backend, FedAvg): cohorts, records, partitions equal, rows
   within 1e-5 (``index_add_`` sums in no fixed order on the card); then
   the 20% point (4/3 and 4/3) with a third of the ids 0-2 rounds late
   each round, ``async_mode=True``, ``AsyncConfig(staleness_decay=0.8,
   staleness_cap=3)``, cohorts quantised to 20, for StoCFL and FedAvg;
   merged / dropped / in flight per round; K2 held against its plain
   version on every matrix the StoCFL run gave it. (c) At round 15 of (b)
   the state is saved with ``block=False`` (deltas in flight), loaded into
   a fresh card engine over the world as it stood and finished: records,
   buffer entries and partitions equal the uninterrupted run's, rows
   within 1e-5; the save call's and the write's times; the same checkpoint
   loaded with ``device="cpu"`` runs one round with the card's cohort,
   record and partition. K1's launches equal 5 × the trained rounds in
   every run; the phase's launches are added to the kernels line.
13. Cluster-routed serving (``repro_torch.serve``) through the serve CLI's
   entry points (``launch.serve.build_server_state`` / ``make_requests``,
   ``ServeEngine``) at the reference CLI's defaults: 2 clusters, 4
   slots a cluster, prompts of 32 tokens, 16 generated, τ 0.3, fp32
   compute with TF32 off. (a) qwen2-1.5b at its full config (28 layers,
   d_model 1536, 12/2 heads, d_ff 8960, vocab 151,936, QKV bias): a first
   wave of 8 requests (it pays the CUDA graph capture of the decode step),
   ``reset``, then a warm wave of 16 new clients with every decode burst
   under sync-debug mode "error" and no new capture, then its requests
   again with their routes cached under the profiler: first_compile_s,
   wall_s, tok_per_s, the routing Ψ's share, the device's busy share while
   serving, the decode step eager and as a graph replay and a prefill
   group (CUDA events), the peak memory. (b) path 3's falcon-mamba (full
   width, 2 layers, ``use_pallas=True``), 2 waves of 4 requests: K5's
   launches while routing (backward once a layer per Ψ, forward twice:
   the remat recompute; none while serving) and K5 against its plain
   versions on the first input the router's Ψ gave it; its launches are
   added to the kernels line.
   Gates of (a) and (b): every route is ``engine.infer``'s, and every
   request's tokens equal ``SequentialLoop``'s under the near-tie rule
   (``serve.near_tie_compare``, ε 1e-3 on the card). (c) The smoke
   configs of qwen2 and falcon-mamba on the card against the same values
   on the CPU: routes equal, tokens under the near-tie rule with the CPU's
   sequential stream the reference.
14. The MoE, MLA and hybrid families and the training driver; every cut
   is one card's memory and is printed. (a) ``zamba2-1.2b`` at full width
   cut 38 -> 6 layers (one group and one application of the shared block)
   trained through ``launch.train.run_llm`` with path 3's traffic as the
   driver's own flags (``TRAIN14``: bf16 compute, fp32 parameters, the
   engine's fp32 policy, ``--fused-step``): round walls, the peak, the
   device's busy share on round 2 (profiled); K1 and K2 launches equal to
   the counts reckoned from rounds, local steps and merge passes, K1
   bitwise against its plain version on the path's first local step's
   operands, K2 on every matrix the path gave it; rows finite, Ψ bitwise
   repeatable. (b) zamba2 at (a)'s cut and (c) ``phi3.5-moe-42b-a6.6b``
   cut 32 -> 2 layers served as in 13a (fp32, TF32 off, waves of 8 and
   16, 13's gates; the MoE prefill groups' requests routed in groups of
   their own, multi-request groups formed, their capacity drops printed).
   (d) ``deepseek-v2-236b`` cut 60 -> 2 layers (a dense layer and an MoE
   layer) at the model level: prefill of 4 x 32 tokens, 16 decode steps
   with one position per row (the absorbed MLA decode) held against
   ``forward_train`` over each row's prefix at ``moe_group_size=1``
   within 1e-3 of the largest |logit|. (e) The three families' smoke
   configs on the card against the CPU, as 13c. The phase's K1 and K2
   launches are added to the kernels line.
15. The encoder-decoder and VLM families, with remat on (every full
   config's default: each layer of a pass under a gradient is
   checkpointed); every cut is one card's memory and is printed. (a)
   ``whisper-medium`` uncut (24 + 24 layers, d_model 1024, 1500 frames,
   811,358,208 parameters) trained through ``launch.train.run_llm`` with
   path 3's traffic as the driver's flags (``TRAIN15``: bf16 compute, the
   engine's bf16 policy, ``--fused-step``): round walls, the peak, the
   busy share on round 2; K1's bf16 entry and K2 launched as reckoned, K1
   bitwise and K2 within 1e-5 of their plain versions on the path's
   inputs; rows finite, Ψ bitwise repeatable. (b) whisper at the model
   level: one loss and gradient on one client's batch with remat on and
   off (the peak lower with it, the gradients within 1e-3 of the largest
   |g|); then in fp32 (TF32 off) prefill of 4 x 32 tokens over 1500
   frames and 16 decode steps with a position per row, each step's logits
   within 1e-3 of ``forward_train``'s, relative to the largest |logit|.
   (c) ``internvl2-26b`` at full width cut 48 -> 2 layers: a loss and
   gradient on 2 x (1024 patches + 256 tokens) in bf16 with remat, then
   (b)'s decode gate over 4 x (1024 + 32). (d) Both smoke configs
   through ``run_llm`` on the card and on the CPU from the same
   parameters: cohorts, n_clusters and ARI equal, ω's update after round
   0 within 5e-2. The phase's K1 and K2 launches are added to the kernels
   line.
16. The engine over a client-axis mesh (``engine.init(..., mesh=)``),
   its ranks subprocesses of this script. (a) One NCCL rank: paths 1 and
   2 for 3 eager rounds and path 2's captured ``run_rounds(5)``, each
   without and with the mesh, bitwise equal (under
   ``torch.use_deterministic_algorithms(True)``, so that the no-mesh
   runs' atomics repeat; there the fixed-order segment add and
   ``index_add_`` must give the same bits). (b) Two ``gloo`` ranks on the
   one card, in the engine's own setting (the fixed-order add repeats bit
   for bit): paths 1 and 2 for 3 eager rounds, both ranks
   bitwise equal after every round, integers exact and floats within rtol
   2e-5, atol 1e-6 of (a)'s no-mesh rounds, each K1 launch on the rank's
   20 of the 40 cohort rows; ``run_rounds`` refused. (c) Beside (b),
   ``torchrun --nproc_per_node 1 chip_smoke.py --train16``: ``launch.train.main``
   with ``--mesh`` on the rotated setting (4 clusters, ARI 1) and on
   falcon-mamba smoke with ``use_pallas``. Every rank's launches are
   added to the kernels line.

The line before the last is one JSON object describing every kernel of the
paths; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import functools
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
LLM_ROUNDS = 3            # path 3: StoCFL rounds on falcon-mamba at full width
LLM_CLIENTS, LLM_DOMAINS, LLM_SEQ, LLM_PER_CLIENT = 4, 2, 256, 2
LLM_SCAN_SHAPE = (4, 256, 8192, 16)   # K5's operands on path 3: 2 clients x 2 sequences
LLM_PARAMS = 743_305_216  # falcon-mamba-7b's widths at 2 layers
LLM_UPDATE_RTOL = 5e-2    # path 3's ω update after round 0, kernel scan against plain
LLM_FP32_RTOL = 1e-4      # the same rounds in fp32 compute: ω's update after round 0
LLM_FP32_SPREAD = 1.0     # ... and after later rounds, against two plain runs an ulp apart
PARITY_FLAG = "--path3-parity"        # runs llm_parity_main, phase_llm_parity's child
PARITY_TIMEOUT_S = 600
LLM_GRAD_RTOL = {"bfloat16": 2e-2, "float32": 1e-4}   # one gradient at ω₀, same
# phase 10's CFL split thresholds: at 0.5 the card's 3 rounds split the
# root cluster (round 0, |mean|/max 0.320) and both halves (round 2, 0.427
# and 0.417) but not round 1 (0.582, 0.573); the statistics are printed
CFL_EPS_REL, CFL_EPS2 = 0.5, 0.01
BASELINES = (             # phase 10: (strategy, EngineConfig knobs, rounds on the card)
    ("fedavg", {}, 5),
    ("fedprox", {"mu": 0.05}, 5),
    ("ditto", {"mu": 0.05}, 5),
    ("ifca", {"n_models": 4}, 5),
    ("cfl", {"eps_rel": CFL_EPS_REL, "eps2": CFL_EPS2}, 3),
)


def card_peaks(name: str):
    """(bytes/s, fp32 FLOP/s outside the tensor cores, dense TF32 FLOP/s on
    the tensor cores) of the card, from NVIDIA's data sheets: H100 SXM
    3.35 TB/s, 67 and 495 TFLOP/s; H100 PCIe 2.0 TB/s, 51 and 378 TFLOP/s."""
    if "PCIe" in name:
        return 2.0e12, 51.2e12, 378e12
    return 3.35e12, 67.0e12, 495e12


def gram_bounds(n, d, out_bytes, peaks):
    """(bound ms, bound_by, FFMA bound ms) of an fp32-accurate X·Xᵀ over
    (n, d) that writes ``out_bytes``: the larger of the bytes (X read once,
    the output written once) and the 3xTF32 operations (3 · n(n+1) · d on
    the tensor cores, the symmetric product's distinct dot products); the
    same operations in FFMA beside it."""
    bw, flops, tf32 = peaks
    t_bytes = (n * d * 4 + out_bytes) / bw
    t_ops = 3 * n * (n + 1) * d / tf32
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            n * (n + 1) * d / flops * 1e3)


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

    bw, flops, _tf32 = peaks
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
    results["prox_update_bf16"] = check_prox_bf16_at_llm_size(dev, bw, flops)
    results["prox_theta"] = check_prox_theta(dev, bw, flops, rand)

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

    # timed on rows laid out as the paths build them (row stride D rounded
    # up to 32 floats): path 1's (64, 153610), path 3's (64, 8192)
    for N, D in ((64, 153610), (64, 8192)):
        x = cosine_sim.row_padded(N, D, dev)
        x.copy_(rand(N, D))
        x[N * 11 // 16:] = 0.0
        norms = torch.linalg.vector_norm(x, dim=1, keepdim=True)
        xn = torch.where(norms > 0, x / norms, torch.zeros_like(x))
        copies = cosine_sim.padded_copies
        k_ms = time_ms(lambda: cosine_sim.cosine_sim(x))
        p_ms = time_ms(lambda: ref.cosine_sim_ref(x))
        l_ms = time_ms(lambda: torch.mm(xn, xn.T))
        assert cosine_sim.padded_copies == copies, "a row-padded input was copied"
        bound, by, ffma = gram_bounds(N, D, N * N * 4, peaks)
        print(f"[time] cosine_sim fp32 ({N}, {D}): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"torch.mm on normalised rows {l_ms:.4f} ms, bound {bound:.4f} ms by {by} "
              f"({(N * D + N * N) * 4 / 1e6:.1f} MB, 3 x {N * (N + 1) * D / 1e9:.3f} GFLOP "
              f"3xTF32; FFMA bound {ffma:.4f} ms), {100 * bound / k_ms:.1f}% of bound")
        if D == 153610:
            results["cosine_sim"] = dict(
                name="cosine_sim", route="cuda",
                source="src/repro_torch/kernels/csrc/cosine_sim.cu",
                replaces="src/repro/kernels/cosine_sim.py:30",
                max_abs_err=main_err, ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=by,
                library_ms=l_ms)

    results["merge_candidates"] = check_merge_candidates(dev, peaks)
    results["resolve_roots"] = check_resolve_roots(dev, bw)
    results["component_labels"] = check_component_labels(dev, bw)
    results.update(check_ssm_scan(dev, bw, flops))
    return results


def check_prox_bf16_at_llm_size(dev, bw, flops):
    """K1's bf16 entry (``prox_update_bf16``, the one the bf16 policy's
    path 3 runs) on (2, 743,305,216) bf16 buffers, path 3's flat θ, ω and
    gradients: within 1 bf16 ulp of its plain version, in place; then
    timed beside the plain version and its bound, 12 bytes an element
    (four bf16 reads, two writes) over the card's memory rate."""
    import torch
    from repro_torch.kernels import prox_update, ref

    n = 2 * LLM_PARAMS
    eta, lam = 0.05, 0.05
    gen = torch.Generator(device=dev).manual_seed(13)
    ops = [torch.randn(n, generator=gen, device=dev).to(torch.bfloat16) for _ in range(4)]
    th, om = ops[0].clone(), ops[1].clone()
    ptrs = (th.data_ptr(), om.data_ptr())
    prox_update.prox_update_flat(th, om, ops[2], ops[3], eta, lam)
    want_t, want_o = ref.prox_update_ref(*ops, eta, lam)
    torch.cuda.synchronize()
    ulps = max(bf16_ulps(th, want_t), bf16_ulps(om, want_o))
    err = max(float((th.float() - want_t.float()).abs().max()),
              float((om.float() - want_o.float()).abs().max()))
    print(f"[check] prox_update bf16 n={n} (path 3's (2, {LLM_PARAMS}) buffers): "
          f"max_abs_err={err:.3e}, {ulps} ulp (tol 1 ulp), in place="
          f"{(th.data_ptr(), om.data_ptr()) == ptrs}")
    assert ulps <= 1 and (th.data_ptr(), om.data_ptr()) == ptrs
    del th, om, want_t, want_o
    k_ms = time_ms(lambda: prox_update.prox_update_flat(*ops, eta, lam))
    p_ms = time_ms(lambda: ref.prox_update_ref_(*ops, eta, lam))
    t_bytes, t_ops = 12 * n / bw, 7 * n / flops
    bound = max(t_bytes, t_ops) * 1e3
    print(f"[time] prox_update bf16 n={n}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
          f"{bound:.3f} ms ({12 * n / 1e9:.2f} GB), {100 * bound / k_ms:.1f}% of bound")
    del ops
    torch.cuda.empty_cache()
    return dict(name="prox_update_bf16", route="cuda",
                source="src/repro_torch/kernels/csrc/prox_update.cu",
                replaces="src/repro/kernels/prox_update.py:29",
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=None)


def time_cold_ms(fn, flush) -> float:
    """``fn``'s device time with a cold L2: ``time_ms`` of ``flush.zero_()``
    (a buffer larger than the card's 50 MB L2) then ``fn``, less that of
    ``flush.zero_()`` alone."""
    both = time_ms(lambda: (flush.zero_(), fn()))
    return both - time_ms(lambda: flush.zero_())


def prox_theta_bound(n, period, bw, flops):
    """(bound ms, bound_by) of K1's local-SGD step on n elements: θ and g
    read and θ written (12 bytes an fp32 element), plus a broadcast anchor
    of ``period`` elements read once (none when the anchor is θ itself);
    5 fp32 operations an element."""
    t_bytes = (12 * n + (4 * period if period else 0)) / bw
    t_ops = 5 * n / flops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_prox_theta(dev, bw, flops, rand):
    """K1's local-SGD form (θ only, the anchor read only) bitwise against
    its plain version: λ = 0 with the anchor θ itself, λ = μ with a (P,)
    anchor broadcast over the rows or a full-length one, ragged and
    misaligned lengths, fp32 and bf16; the anchor's bytes unchanged. Then
    timed at the baselines' cohort sizes (phase 10): FedAvg's 40 clients
    and CFL's 400 at 153,610 parameters, beside its bound and, for λ = 0,
    ``add_`` (one PyTorch call of the same function; it may contract to an
    FMA, so it is a yardstick, not a reference)."""
    import torch
    from repro_torch.kernels import prox_update, ref

    eta, mu, p = 0.1, 0.05, 153610
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    for dtype in (torch.float32, torch.bfloat16):
        for rows, period, offset, kind in ((1, 1000, 0, "theta"), (1, 65537, 1, "theta"),
                                           (40, p, 0, "theta"), (40, p, 0, "broadcast"),
                                           (7, 65537, 1, "broadcast"), (3, 1001, 1, "full")):
            n = rows * period
            th, g = (rand(n + offset).to(dtype).to(dev)[offset:] for _ in range(2))
            a = {"theta": th, "broadcast": rand(period), "full": rand(n)}[kind].to(dtype).to(dev)
            lam = 0.0 if kind == "theta" else mu
            want = ref.prox_theta_ref(th, a, g, eta, lam)
            keep = a.clone()
            ptr = th.data_ptr()
            prox_update.prox_theta_flat(th, a, g, eta, lam)
            torch.cuda.synchronize()
            exact = bool(torch.equal(th.view(bits[dtype]), want.view(bits[dtype])))
            untouched = kind == "theta" or bool(torch.equal(a.view(bits[dtype]),
                                                            keep.view(bits[dtype])))
            tag = f" offset={offset}" if offset else ""
            print(f"[check] prox_theta {str(dtype)[6:]} n={n} ({rows} x {period}){tag} anchor "
                  f"{kind} lam={lam}: bitwise equal to plain={exact}, anchor unchanged="
                  f"{untouched}, in place={th.data_ptr() == ptr}")
            assert exact and untouched and th.data_ptr() == ptr, \
                f"prox_theta {dtype} n={n} {kind} disagrees with plain"

    out = None
    for rows in (40, 400):
        n = rows * p
        th, g, a = rand(n).to(dev), rand(n).to(dev), rand(p).to(dev)
        k_ms = time_ms(lambda: prox_update.prox_theta_flat(th, th, g, eta, 0.0))
        p_ms = time_ms(lambda: ref.prox_theta_ref(th, th, g, eta, 0.0))
        l_ms = time_ms(lambda: th.add_(g, alpha=-eta))
        kb_ms = time_ms(lambda: prox_update.prox_theta_flat(th, a, g, eta, mu))
        pb_ms = time_ms(lambda: ref.prox_theta_ref(th, a, g, eta, mu))
        bound, by = prox_theta_bound(n, 0, bw, flops)
        bound_b, _ = prox_theta_bound(n, p, bw, flops)
        print(f"[time] prox_theta fp32 n={n} ({rows} x {p}): lam=0, anchor theta: kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, add_ {l_ms:.4f} ms, bound {bound:.4f} ms "
              f"by {by} ({12 * n / 1e6:.1f} MB), {100 * bound / k_ms:.1f}% of bound; "
              f"lam={mu}, broadcast ({p},) anchor: kernel {kb_ms:.4f} ms, plain {pb_ms:.4f} ms, "
              f"bound {bound_b:.4f} ms, {100 * bound_b / kb_ms:.1f}% (no single PyTorch call)")
        flush = torch.empty((64 << 20,), dtype=torch.float32, device=dev)   # 256 MB
        kc_ms = time_cold_ms(lambda: prox_update.prox_theta_flat(th, th, g, eta, 0.0), flush)
        lc_ms = time_cold_ms(lambda: th.add_(g, alpha=-eta), flush)
        del flush
        print(f"[time] prox_theta fp32 n={n}, lam=0, cold L2 (a 256 MB buffer written "
              f"before each call, its time taken off): kernel {kc_ms:.4f} ms, add_ "
              f"{lc_ms:.4f} ms (warm: {k_ms:.4f}, {l_ms:.4f}), bound {bound:.4f} ms")
        if rows == 40:
            out = dict(name="prox_theta", route="cuda",
                       source="src/repro_torch/kernels/csrc/prox_update.cu",
                       replaces="src/repro/kernels/prox_update.py:29",
                       max_abs_err=0.0, ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=by,
                       library_ms=l_ms)
    return out


def spread_means(n, d, n_dead, seed, dev):
    """(x, live): n rows mixing three shared directions with per-row
    weights, plus a little noise, so their cosines spread evenly over
    (-1, 1); the last ``n_dead`` rows dead and every fifth of those zero."""
    import torch
    from repro_torch.kernels import cosine_sim
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(n, 3, generator=gen) @ torch.randn(3, d, generator=gen)
         + 0.05 * torch.randn(n, d, generator=gen))
    live = torch.ones(n, dtype=torch.bool)
    live[n - n_dead:] = False
    x[n - n_dead::5] = 0.0
    xp = cosine_sim.row_padded(n, d, dev)      # the paths' layout
    xp.copy_(x)
    return xp, live.to(dev)


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


def check_merge_candidates(dev, peaks):
    """K3 against its plain version, exact as 0/1 matrices, at the two
    path-2 shapes, on rows whose cosines spread over (-1, 1): at 16
    thresholds between neighbouring float64 cosines, each at least 1e-5
    from every pair, and at τ = -1.5 (every live off-diagonal pair). Then
    timed at both shapes and at (2048, 153610), a merge pass at larger K̃
    (timed only), at τ = 0.5. Returns the kernel's JSON entry at the
    4,000-client path's shape, (512, 153610), where its work is largest on
    the paths."""
    import torch
    from repro_torch.kernels import cosine_sim, ref

    tau = 0.5
    entry = None
    for (N, D, n_dead) in ((5, 7, 1), (64, 153610, 20), (512, 153610, 0), (2048, 153610, 0)):
        if N < 2048:
            x, live = spread_means(N, D, n_dead, N + D, dev)
            taus = taus_between(*live_cosines(x, live), 16)
            margins, pairs = hold_candidates(x, live, taus + [-1.5])
            print(f"[check] merge_candidates ({N}, {D}) dead rows {N - n_dead}..{N - 1}: exact "
                  f"at {len(taus)} tau in [{taus[0]:.4f}, {taus[-1]:.4f}] between neighbouring "
                  f"cosines (closest |cos - tau| {min(margins[:-1]):.3e}, must be >= 1e-5; "
                  f"{min(pairs[:-1])}..{max(pairs[:-1])} pairs) and at tau -1.5 "
                  f"({pairs[-1]} pairs)")
            assert min(margins[:-1]) >= 1e-5
        else:
            x = cosine_sim.row_padded(N, D, dev)
            x.normal_(generator=torch.Generator(device=dev).manual_seed(N + D))
            live = torch.ones(N, dtype=torch.bool, device=dev)
        if N < 64:
            continue
        torch.cuda.synchronize()
        norms = torch.linalg.vector_norm(x, dim=1, keepdim=True)
        xn = torch.where(norms > 0, x / norms, torch.zeros_like(x))
        copies = cosine_sim.padded_copies
        k_ms = time_ms(lambda: cosine_sim.merge_candidates(x, live, tau))
        p_ms = time_ms(lambda: ref.merge_candidates_ref(x, live, tau))
        l_ms = time_ms(lambda: torch.mm(xn, xn.T) >= tau)
        assert cosine_sim.padded_copies == copies, "a row-padded input was copied"
        # reads X and the mask once, writes the (N, N) fp32 0/1 matrix
        bound, by, ffma = gram_bounds(N, D, N + N * N * 4, peaks)
        print(f"[time] merge_candidates fp32 ({N}, {D}): kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, torch.mm on normalised rows + threshold {l_ms:.4f} ms, "
              f"bound {bound:.4f} ms by {by} ({(N * D * 4 + N + N * N * 4) / 1e6:.1f} MB, "
              f"3 x {N * (N + 1) * D / 1e9:.3f} GFLOP 3xTF32; FFMA bound {ffma:.4f} ms), "
              f"{100 * bound / k_ms:.1f}% of bound, {l_ms / k_ms:.2f}x faster than torch.mm")
        if N == 512:
            entry = dict(name="merge_candidates", route="cuda",
                         source="src/repro_torch/kernels/csrc/cosine_sim.cu",
                         replaces="src/repro/kernels/cosine_sim.py:79",
                         max_abs_err=0.0, ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                         bound_by=by, library_ms=l_ms)
        del x, xn, norms
        torch.cuda.empty_cache()
    return entry


def forests(n, gen):
    """A random forest (parents at smaller ids), a chain through a random
    permutation of the ids (the deepest tree), a fully compressed array (what
    the path hands K4) and a permutation cycle through all the ids (never a
    fixed point, so K4 runs every step)."""
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
    permutation = torch.empty(n, dtype=torch.int32)
    permutation[order.long()] = torch.roll(order, -1)
    return {"forest": forest, "chain": chain, "compressed": compressed,
            "permutation": permutation}


def halving_steps(parent) -> int:
    """Steps K4's resident loop runs on ``parent``: synchronous ``p <- p[p]``
    until a step changes nothing, at most ``steps_for(N)``."""
    import torch
    from repro_torch.kernels import resolve_roots
    cap = resolve_roots.steps_for(len(parent))
    for step in range(1, cap + 1):
        nxt = parent[parent.long()]
        if torch.equal(nxt, parent):
            return step
        parent = nxt
    return cap


def launch_floor_ms() -> float:
    """Device time of the smallest launch, ``torch.cuda._sleep(1)``, timed as
    the kernels are."""
    import torch
    return time_ms(lambda: torch.cuda._sleep(1))


def check_resolve_roots(dev, bw):
    """K4 against its plain version, exactly, on random forests, chains,
    fully compressed arrays and permutation cycles at N in {1, 512, 4096,
    65536} (the last one the multi-launch route); timed on the compressed
    arrays the path gives it and on chains at 512 and 4096, beside the
    launch floor. Returns the JSON entry at the 400-client path's capacity,
    512, on the compressed input."""
    import torch
    from repro_torch.kernels import ref, resolve_roots

    gen = torch.Generator().manual_seed(4)
    for n in (1, 512, 4096, 65536):
        for kind, parent in forests(n, gen).items():
            parent = parent.to(dev)
            before = resolve_roots.launches
            got = resolve_roots.resolve_roots(parent)
            want = ref.resolve_roots_ref(parent)
            torch.cuda.synchronize()
            same = bool(torch.equal(got, want)) and resolve_roots.launches == before + 1
            route = (f"one block, {halving_steps(parent)} of {resolve_roots.steps_for(n)} steps"
                     if n <= resolve_roots.RESIDENT_MAX else
                     f"one launch a step, {resolve_roots.steps_for(n)} steps")
            print(f"[check] resolve_roots int32 N={n} {kind}: exact={same}, {route}")
            assert same, f"resolve_roots N={n} {kind} disagrees with plain"
    floor = launch_floor_ms()
    print(f"[time] launch floor (torch.cuda._sleep(1), CUDA events as below): {floor:.4f} ms")
    entry = None
    for n in (512, 4096):
        bound = 8 * n / bw * 1e3
        for kind in ("compressed", "chain"):
            parent = forests(n, gen)[kind].to(dev)
            k_ms = time_ms(lambda: resolve_roots.resolve_roots(parent))
            p_ms = time_ms(lambda: ref.resolve_roots_ref(parent))
            print(f"[time] resolve_roots int32 N={n} {kind}: kernel {k_ms:.4f} ms "
                  f"({halving_steps(parent)} steps; launch floor {floor:.4f} ms), plain "
                  f"{p_ms:.4f} ms ({resolve_roots.steps_for(n)} gathers), bound "
                  f"{bound:.6f} ms by bytes ({8 * n} B); no single PyTorch call computes it")
            if (n, kind) == (512, "compressed"):
                entry = dict(name="resolve_roots", route="cuda",
                             source="src/repro_torch/kernels/csrc/resolve_roots.cu",
                             replaces="src/repro/kernels/ops.py:46",
                             max_abs_err=0.0, ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                             bound_by="bytes", library_ms=None)
    return entry


def graphs(k, gen):
    """Symmetric (k, k) fp32 0/1 adjacencies with a zero diagonal, as K3
    writes them: sparse random (about 2 neighbours a node), dense random, a
    chain through a random order of the ids (the most passes) and 4
    disjoint cliques over a random split of the ids (a merge pass that
    collapses singletons into their clusters)."""
    import torch
    order = torch.randperm(k, generator=gen)
    group = torch.randint(0, 4, (k,), generator=gen)
    out = {"sparse": torch.rand(k, k, generator=gen) < 2.0 / k,
           "dense": torch.rand(k, k, generator=gen) < 0.5,
           "chain": torch.zeros(k, k, dtype=torch.bool),
           "cliques": group[:, None] == group[None, :]}
    out["chain"][order[:-1], order[1:]] = True
    for kind, a in out.items():
        a = a | a.T
        a.fill_diagonal_(False)
        out[kind] = a.to(torch.float32)
    return out


def label_passes(adj) -> int:
    """Passes the labelling loop makes on ``adj`` (the last changes
    nothing), counted on the CPU."""
    import torch
    adj = adj.cpu()
    k = adj.shape[0]
    label = torch.arange(k)
    fill = torch.full((k, k), k)
    passes = 0
    while True:
        passes += 1
        m = torch.minimum(label, torch.where(adj > 0, label[None, :], fill).amin(1))
        nxt = m[m]
        if torch.equal(nxt, label):
            return passes
        label = nxt


def host_ms(fn) -> float:
    """Mean host-clock time of ``fn`` followed by ``torch.cuda.synchronize()``
    over TIMED_CALLS calls, after 3 warm-up calls: the only fair clock for a
    function that syncs inside, as the plain labelling loop does a pass."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_CALLS):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / TIMED_CALLS


def check_component_labels(dev, bw):
    """The labelling kernel against its plain loop, exactly, on sparse,
    dense, chained and clique graphs at k in {64, 512, 4096} (4096: the
    bit matrix in a global scratch); one launch a call. Timed at 64 and 512
    on cliques and chains. Returns the JSON entry at 512 on cliques."""
    import torch
    from repro_torch.kernels import ref, resolve_roots

    gen = torch.Generator().manual_seed(5)
    for k in (64, 512, 4096):
        for kind, adj in graphs(k, gen).items():
            adj = adj.to(dev)
            before = resolve_roots.label_launches
            got = resolve_roots.component_labels(adj)
            want = ref.component_labels_ref(adj)
            torch.cuda.synchronize()
            same = bool(torch.equal(got, want)) and resolve_roots.label_launches == before + 1
            where = "shared" if k <= resolve_roots.BITS_SHARED_MAX else "global"
            print(f"[check] component_labels fp32 k={k} {kind}: exact={same}, one launch, "
                  f"{len(torch.unique(want))} components, bit matrix in {where} memory")
            assert same, f"component_labels k={k} {kind} disagrees with plain"
    entry = None
    for k in (64, 512):
        bound = (k * k * 4 + 4 * k) / bw * 1e3
        for kind in ("cliques", "chain"):
            adj = graphs(k, gen)[kind].to(dev)
            k_ms = time_ms(lambda: resolve_roots.component_labels(adj))
            k_host = host_ms(lambda: resolve_roots.component_labels(adj))
            p_host = host_ms(lambda: ref.component_labels_ref(adj))
            print(f"[time] component_labels fp32 k={k} {kind} ({label_passes(adj)} passes): "
                  f"kernel {k_ms:.4f} ms by CUDA events; host clock around a synchronised "
                  f"call: kernel {k_host:.4f} ms, plain loop {p_host:.4f} ms (it syncs once "
                  f"a pass); bound {bound:.6f} ms by bytes ({k * k * 4 + 4 * k} B); no single "
                  f"PyTorch call computes it")
            if (k, kind) == (512, "cliques"):
                entry = dict(name="component_labels", route="cuda",
                             source="src/repro_torch/kernels/csrc/resolve_roots.cu",
                             replaces="src/repro/core/device_clustering.py:116",
                             max_abs_err=0.0, ms=k_ms, plain_ms=p_host, bound_ms=bound,
                             bound_by="bytes", library_ms=None)
    return entry


def scan_inputs(shape, seed, dev):
    """dA in (0.5, 1) (a decaying state, as exp(δ·A) gives), dBx, C and an
    output gradient g_y, fp32 on the card."""
    import torch
    B, S, D, N = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    dA = torch.rand(shape, generator=gen, device=dev) * 0.5 + 0.5
    dBx = torch.randn(shape, generator=gen, device=dev)
    C = torch.randn((B, S, N), generator=gen, device=dev)
    g_y = torch.randn((B, S, D), generator=gen, device=dev)
    return dA, dBx, C, g_y


def check_ssm_scan(dev, bw, flops):
    """K5 forward and backward against their plain versions at path 3's
    shape (4, 256, 8192, 16) and at a ragged one: saved states and the
    gradients of dA and dBx exactly equal (the same roundings), y and the
    gradient of C within 1e-5 of their largest magnitude plus 1e-5 (sums
    over n and d in another order); two backward runs bitwise equal. Timed at path 3's
    shape. Returns the two kernels' JSON entries."""
    import torch
    from repro_torch.kernels import ref, ssm_scan

    entries = {}
    for shape in ((3, 77, 1000, 16), LLM_SCAN_SHAPE):
        dA, dBx, C, g_y = scan_inputs(shape, sum(shape), dev)
        y, hs = ssm_scan.scan_fwd(dA, dBx, C)
        grads = ssm_scan.scan_bwd(dA, dBx, C, hs, g_y)
        again = ssm_scan.scan_bwd(dA, dBx, C, hs, g_y)
        want_y, want_hs = ref.ssm_scan_states_ref(dA, dBx, C, ssm_scan.CHUNK)
        want = ref.ssm_scan_bwd_ref(dA, dBx, C, want_hs, g_y, ssm_scan.CHUNK)
        torch.cuda.synchronize()
        # a sum over D = 8192 in another order: its error scales with the
        # summed magnitudes, not with the (possibly cancelled) result
        close = lambda a, b: float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()) + 1e-5
        exact = (torch.equal(hs, want_hs) and torch.equal(grads[0], want[0])
                 and torch.equal(grads[1], want[1]))
        repeat = all(torch.equal(a, b) for a, b in zip(grads, again))
        err_f = float((y - want_y).abs().max())
        err_b = max(float((a - b).abs().max()) for a, b in zip(grads, want))
        print(f"[check] ssm_scan {shape}: forward max_abs_err={err_f:.3e} (y), backward "
              f"max_abs_err={err_b:.3e} (over g_dA, g_dBx, g_C; tol for y and g_C 1e-5 "
              f"of the largest |value| + 1e-5), states and g_dA, g_dBx exactly "
              f"equal={exact}, backward bitwise repeatable={repeat}")
        assert close(y, want_y) and close(grads[2], want[2]), f"ssm_scan {shape} disagrees"
        assert exact and repeat, f"ssm_scan {shape}: not exact or not repeatable"
        del want, again, want_hs
        if shape != LLM_SCAN_SHAPE:
            continue
        B, S, D, N = shape
        n_hs = hs.numel()
        f_ms = time_ms(lambda: ssm_scan.scan_fwd(dA, dBx, C))
        fp_ms = time_ms(lambda: ref.ssm_scan_states_ref(dA, dBx, C, ssm_scan.CHUNK))
        b_ms = time_ms(lambda: ssm_scan.scan_bwd(dA, dBx, C, hs, g_y))
        bp_ms = time_ms(lambda: ref.ssm_scan_bwd_ref(dA, dBx, C, hs, g_y, ssm_scan.CHUNK))
        # forward: reads dA, dBx, C, writes y and the chunk states; 4 flops
        # per (b, t, d, n). backward: reads dA, dBx, C, hs, g_y, writes
        # g_dA, g_dBx, g_C; 8 flops per (b, t, d, n) with the recompute
        el = B * S * D * N
        f_bytes = (2 * el + B * S * N + B * S * D + n_hs) * 4
        b_bytes = (4 * el + 2 * B * S * N + B * S * D + n_hs) * 4
        for name, ms, p_ms, nbytes, ops in (("ssm_scan_fwd", f_ms, fp_ms, f_bytes, 4 * el),
                                            ("ssm_scan_bwd", b_ms, bp_ms, b_bytes, 8 * el)):
            t_bytes, t_ops = nbytes / bw, ops / flops
            entries[name] = dict(
                name=name, route="cuda", source="src/repro_torch/kernels/csrc/ssm_scan.cu",
                replaces="src/repro/kernels/ssm_scan.py:23",
                max_abs_err=err_f if name == "ssm_scan_fwd" else err_b, ms=ms,
                plain_ms=p_ms, bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=None)
            print(f"[time] {name} fp32 {shape}: kernel {ms:.4f} ms, plain {p_ms:.4f} ms, "
                  f"bound {max(t_bytes, t_ops) * 1e3:.4f} ms by "
                  f"{'bytes' if t_bytes >= t_ops else 'operations'} ({nbytes / 1e9:.3f} GB, "
                  f"{ops / 1e9:.3f} GFLOP); no single PyTorch call computes a selective scan")
    return entries


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
    cosine_sim.launches = cosine_sim.padded_copies = 0
    start, gpu = _run_rounds(dev, ROUNDS, clients, params, loss, cfg,
                             torch.cuda.synchronize)
    launches = {"prox_update": prox_update.launches, "cosine_sim": cosine_sim.launches}
    # the host backend builds its merge-pass matrices in the kernel's layout
    assert cosine_sim.padded_copies == 0, "path 1 copied a K2 input"
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
    the same bank roots (trees of any depth)."""
    from repro_torch.utils import trees
    assert tuple(a.models.roots) == tuple(b.models.roots), "bank roots differ"
    pairs = [(a.omega, b.omega)] + [(a.models[r], b.models[r]) for r in a.models.roots]
    return max(float((x.float().cpu() - y.float().cpu()).abs().max())
               for ta, tb in pairs for x, y in zip(trees.leaves(ta), trees.leaves(tb)))


def same_layout_copy(x):
    """A copy of the (N, D) matrix ``x`` with its rows as far apart as the
    paths lay them (D rounded up to 32 floats), so the checks that replay a
    path's inputs give the kernels the layout the path gave them."""
    from repro_torch.kernels import cosine_sim
    y = cosine_sim.row_padded(*x.shape, x.device, x.dtype)
    return y.copy_(x)


@contextlib.contextmanager
def recording_merge_inputs():
    """Within the block, every ``ops.merge_pairs`` call (the device
    backend's merge pass) also records a copy of the (means, live, τ) it
    received and of the adjacency it returned, which the pass hands to
    ``ops.component_labels``; yields the list of records. The call itself
    goes through unchanged, so its launch is counted once as before."""
    from repro_torch.kernels import ops
    real, records = ops.merge_pairs, []

    def record(means, live, tau, backend="auto"):
        adj = real(means, live, tau, backend=backend)
        records.append((same_layout_copy(means), live.clone(), float(tau), adj.clone()))
        return adj

    ops.merge_pairs = record
    try:
        yield records
    finally:
        ops.merge_pairs = real


def check_candidates_on_path(records, tag):
    """Hold K3 against its plain version on the inputs the path's merge
    passes gave it, at the path's τ (printing the smallest |cos − τ| among
    live pairs) and at 8 thresholds between neighbouring cosines."""
    for t, (x, live, tau, _adj) in enumerate(records):
        taus = taus_between(*live_cosines(x, live), 8)
        margins, pairs = hold_candidates(x, live, [tau] + taus)
        print(f"[{tag}] merge_candidates on round {t}'s merge-pass input {tuple(x.shape)} "
              f"({int(live.sum())} live clusters): exact at tau {tau} ({pairs[0]} pairs over "
              f"tau, closest |cos - tau| {margins[0]:.3e}) and at {len(taus)} tau between "
              f"neighbouring cosines (closest {min(margins[1:], default=float('inf')):.3e})")
        assert min(margins[1:], default=1.0) >= 1e-5


def check_labels_on_path(records, tag):
    """Hold the labelling kernel against its plain loop on the adjacency
    each of the path's merge passes handed it."""
    import torch
    from repro_torch.kernels import ref, resolve_roots
    for t, (_x, _live, _tau, adj) in enumerate(records):
        got = resolve_roots.component_labels(adj)
        want = ref.component_labels_ref(adj)
        same = bool(torch.equal(got, want))
        print(f"[{tag}] component_labels on round {t}'s merge-pass adjacency "
              f"{tuple(adj.shape)} ({int((adj > 0).sum()) // 2} candidate pairs, "
              f"{label_passes(adj)} passes): exact={same}")
        assert same, f"component_labels disagrees with plain on round {t}'s adjacency"


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
    cosine_sim.candidate_launches = resolve_roots.launches = cosine_sim.padded_copies = 0
    resolve_roots.label_launches = 0
    with recording_merge_inputs() as merge_inputs:
        start, gpu = _run_rounds(dev, ROUNDS, clients, params, loss, cfg,
                                 torch.cuda.synchronize, arena=True)
    assert cosine_sim.padded_copies == 0, "path 2 copied a K3 input"
    launches = {"prox_update": prox_update.launches, "cosine_sim": cosine_sim.launches,
                "merge_candidates": cosine_sim.candidate_launches,
                "resolve_roots": resolve_roots.launches,
                "component_labels": resolve_roots.label_launches}
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
    # round (the merge pass's and the objective's cluster means); the
    # labelling kernel once a merge pass (DeviceClusters.merge_round runs
    # merge_round_impl once a round, every round seeing >= 2 clients); no K2
    assert launches == {"prox_update": ROUNDS * cfg.local_steps, "cosine_sim": 0,
                        "merge_candidates": ROUNDS,
                        "resolve_roots": 2 * ROUNDS,
                        "component_labels": ROUNDS}, launches
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
    check_labels_on_path(merge_inputs, "path2")
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
    # per round: the device backend runs K3 and the labelling kernel once
    # (merge pass) and K4 twice (the merge pass's and the objective's
    # cluster means); the host backend runs K2 twice (merge pass and
    # objective) and none of those
    expect = {"device": (SCALE_ROUNDS, 2 * SCALE_ROUNDS, 0, SCALE_ROUNDS),
              "numpy": (0, 0, 2 * SCALE_ROUNDS, 0)}
    runs = {}
    for backend in ("device", "numpy"):
        bcfg = dataclasses.replace(cfg, cluster_backend=backend, cohort_chunk=SCALE_CHUNK)
        cosine_sim.candidate_launches = resolve_roots.launches = cosine_sim.launches = 0
        cosine_sim.padded_copies = resolve_roots.label_launches = 0
        with recording_merge_inputs() as merge_inputs:
            start, trace = _run_rounds(dev, SCALE_ROUNDS, clients, params, loss, bcfg,
                                       torch.cuda.synchronize, arena=True)
        assert cosine_sim.padded_copies == 0, f"{backend} backend copied a K2/K3 input"
        counts = (cosine_sim.candidate_launches, resolve_roots.launches, cosine_sim.launches,
                  resolve_roots.label_launches)
        runs[backend] = (start, trace, merge_inputs)
        for t, r in enumerate(trace):
            print(f"[scale] {backend} backend, {SCALE_CLIENTS} clients, round {t}: wall "
                  f"{r['wall'] * 1e3:.1f} ms, sampled {len(r['cohort'])}, n_clusters "
                  f"{r['n_clusters']}, merges {len(r['merges'])}")
        print(f"[scale] {backend} backend launches: merge_candidates {counts[0]}, "
              f"resolve_roots {counts[1]}, cosine_sim {counts[2]}, component_labels "
              f"{counts[3]}")
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
    check_labels_on_path(dev_inputs, "scale")
    del dev_inputs
    final = dev_t[-1]["state"].clusters
    r1, m1 = final.cluster_means()
    r2, m2 = final.cluster_means()
    same = r1 == r2 and bool(torch.equal(m1, m2))
    print(f"[scale] cluster means at capacity {st.capacity} computed twice: "
          f"bitwise equal={same}")
    assert same


# ------------------------------------------------------------------ phase 8
def llm_setting(smoke=False, **cfg_kw):
    """(model, clients, engine config) of path 3: falcon-mamba-7b at full
    width cut to 2 layers, bf16 compute, ``use_pallas=True``; 4 clients in
    2 domains with 2 sequences of 256 tokens each; the reference's
    ``examples/federated_llm.py`` engine settings with Ψ on the vocab
    matrices sketched to 8192. ``smoke`` takes the smoke config instead
    (d_model 128, vocab 512, 64-token sequences, Ψ sketched to 64)."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_lm_batch
    from repro_torch.engine import EngineConfig
    from repro_torch.models.registry import build

    cfg = get_config("falcon-mamba-7b", smoke=smoke)
    cfg = cfg.with_(**{"use_pallas": True, **({} if smoke else {"n_layers": 2}), **cfg_kw})
    seq = 64 if smoke else LLM_SEQ
    clients = [synthetic_lm_batch(cfg, seq, LLM_PER_CLIENT, seed=i, domain=i % LLM_DOMAINS)
               for i in range(LLM_CLIENTS)]
    ecfg = EngineConfig(tau=0.12, lam=0.05, lr=0.05, local_steps=5, sample_rate=0.5,
                        seed=0, project_dim=64 if smoke else 8192, fused_step=True)
    return build(cfg), clients, ecfg


def _llm_rounds(device, model, params, clients, ecfg, sync, profiler=None,
                snapshots=False):
    """LLM_ROUNDS StoCFL rounds through ``engine.init`` / ``run_round``,
    each followed by ω's loss on client 0 (as the reference's ``run_llm``
    prints it). With ``profiler``, rounds 1.. run under it; with
    ``snapshots``, each record keeps ω flattened on the host. Returns
    (final state, one record per round)."""
    import torch
    from repro_torch import engine
    from repro_torch.core.extractor import llm_leaf_filter

    state = engine.init("stocfl", model.loss_fn, params, clients, ecfg, device=device,
                        leaf_filter=llm_leaf_filter)
    out = []
    with contextlib.ExitStack() as stack:
        for t in range(LLM_ROUNDS):
            if profiler is not None and t == 1:
                stack.enter_context(profiler)
            _, cohort = engine.sample_clients(state)
            t0 = time.perf_counter()
            state, rec = engine.run_round(state)
            sync()
            wall = time.perf_counter() - t0
            with torch.no_grad():
                loss0 = float(model.loss_fn(state.omega, state.ctx.clients[0]))
            out.append(dict(cohort=[int(c) for c in cohort], wall=wall, loss0=loss0,
                            n_clusters=rec["n_clusters"], merges=list(rec["merges"]),
                            objective=rec["objective"],
                            partition=state.clusters.assignment(),
                            omega=_flat_cpu(state.omega) if snapshots else None))
    return state, out


def _flat_cpu(tree):
    """A tree's leaves, flattened and joined into one fp32 host vector."""
    import torch
    from repro_torch.utils import trees
    return torch.cat([x.detach().reshape(-1).float().cpu() for x in trees.leaves(tree)])


def phase_llm_path(dev):
    """Path 3: StoCFL's federated LLM round on falcon-mamba at full width
    (d_model 4096, d_inner 8192, vocab 65024; 2 layers), launches counted;
    K5, K2 and K1 held against their plain versions at the path's shapes;
    then the rounds again under the profiler. Returns the launch counts
    and, per round, the cohort, n_clusters and ω's loss on client 0."""
    import torch
    from repro_torch.kernels import cosine_sim, prox_update, ssm_scan
    from repro_torch.utils import trees

    model, clients, ecfg = llm_setting()
    cfg = model.cfg
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    n_params = sum(p.numel() for p in trees.leaves(params))
    print(f"[path3] {cfg.name} at full width, {cfg.n_layers} layers: d_model {cfg.d_model}, "
          f"d_inner {cfg.d_inner}, ssm_state {cfg.ssm_state}, dt_rank {cfg.resolved_dt_rank}, "
          f"vocab {cfg.vocab_size}, compute {cfg.dtype}, params {cfg.param_dtype}; "
          f"{n_params} parameters ({n_params * 4 / 1e9:.2f} GB); {LLM_CLIENTS} clients in "
          f"{LLM_DOMAINS} domains x {LLM_PER_CLIENT} sequences of {LLM_SEQ} tokens, sample "
          f"rate {ecfg.sample_rate}, E={ecfg.local_steps}, project_dim {ecfg.project_dim}")
    assert n_params == LLM_PARAMS, n_params

    prox_update.launches = cosine_sim.launches = cosine_sim.padded_copies = 0
    ssm_scan.fwd_launches = ssm_scan.bwd_launches = 0
    with recording_first_scan(LLM_SCAN_SHAPE) as first_scan, \
            recording_cosine_inputs() as cosine_inputs:
        state, recs = _llm_rounds(dev, model, params, clients, ecfg, torch.cuda.synchronize)
    assert cosine_sim.padded_copies == 0, "path 3 copied a K2 input"
    launches = {"prox_update": prox_update.launches, "cosine_sim": cosine_sim.launches,
                "ssm_scan_fwd": ssm_scan.fwd_launches, "ssm_scan_bwd": ssm_scan.bwd_launches}
    peak = torch.cuda.max_memory_allocated() - base
    for t, r in enumerate(recs):
        print(f"[path3] cuda round {t}: wall {r['wall'] * 1e3:.1f} ms, cohort {r['cohort']}, "
              f"n_clusters {r['n_clusters']}, merges {r['merges']}, objective "
              f"{r['objective']:.6f}, omega_loss on client 0 {r['loss0']:.4f}")
    print(f"[path3] peak device memory {peak / 1e9:.2f} GB "
          f"(torch.cuda.max_memory_allocated, from {base / 1e9:.2f} GB before the path)")
    print(f"[path3] launches on path 3: {launches}")
    expect = llm_launches(cfg, ecfg, recs)
    assert launches == expect, (launches, expect)
    for leaf in trees.leaves(state.omega) + trees.leaves(state.models.stacked):
        assert bool(torch.isfinite(leaf).all()), "non-finite model values"
    assert all(r["loss0"] == r["loss0"] for r in recs)
    psi = state.ctx.extractor
    a, b = psi(state.ctx.clients[0]), psi(state.ctx.clients[0])
    same = bool(torch.equal(a, b))
    print(f"[path3] Psi of client 0 computed twice ({tuple(a.shape)}, norm "
          f"{float(a.norm()):.6f}): bitwise equal={same}")
    assert same and a.shape == (ecfg.project_dim,)

    del state, psi, a, b
    check_scan_on_path(first_scan[0])
    del first_scan
    check_cosine_on_records(cosine_inputs, ecfg.tau, "path3", 1e-5)
    del cosine_inputs
    torch.cuda.empty_cache()
    check_prox_at_llm_size(dev)
    torch.cuda.empty_cache()
    trace_llm(dev, model, params, clients, ecfg)
    return launches, [dict(cohort=r["cohort"], n_clusters=r["n_clusters"], loss0=r["loss0"])
                      for r in recs]


def llm_launches(cfg, ecfg, recs):
    """Path 3's launches reckoned from its rounds ``recs``. Per local step
    the cohort loss runs twice (θ and ω), each layer's scan once under
    vmap, forward and backward; Ψ runs forward and backward once per newly
    seen client; with ``cfg.remat`` each of those backwards first runs its
    layer's forward again (the checkpoint's recompute), so the scans taken
    under a gradient launch their forward twice. ω's loss after each round
    runs forward only, under ``no_grad``, where nothing is checkpointed.
    K1 once a local step; K2 in each merge pass (from 2 observed clients
    on) and in the objective when there are 2 clusters or more."""
    L, E, R = cfg.n_layers, ecfg.local_steps, len(recs)
    new = len({c for r in recs for c in r["cohort"]})
    grad_passes = R * E * 2 + new
    return {"prox_update": R * E, "cosine_sim": R + sum(r["n_clusters"] >= 2 for r in recs),
            "ssm_scan_fwd": grad_passes * L * (2 if cfg.remat else 1) + R * L,
            "ssm_scan_bwd": grad_passes * L}


def phase_llm_parity(expect):
    """Path 3's reruns against the plain scan, in a process of its own
    (``llm_parity_main``), whose caching allocator starts empty and maps
    its memory in place (``expandable_segments``): the reruns peak near
    62 GB, and this process's allocator, split by the earlier phases,
    could not promise that many contiguous gigabytes of the card's 80.
    ``expect`` holds this process's per-round records, which the child's
    kernel rerun must repeat exactly. Raises if the child fails."""
    import torch
    torch.cuda.empty_cache()
    sys.stdout.flush()
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    subprocess.run([sys.executable, os.path.abspath(__file__), PARITY_FLAG,
                    json.dumps(expect)], env=env, check=True, timeout=PARITY_TIMEOUT_S)


def llm_parity_main(expect) -> int:
    """The child of ``phase_llm_parity``: path 3's kernel rounds again (the
    cohorts, n_clusters and ω's losses of ``expect``, exactly), then the
    same rounds with the plain chunked scan (``use_pallas=False``) and
    from ω₀ moved by one fp32 ulp, one loss and gradient at ω₀, and the
    rounds in fp32 compute."""
    import torch
    from repro_torch.kernels import ssm_scan
    from repro_torch.utils import trees

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    model, clients, ecfg = llm_setting()
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    n_params = sum(p.numel() for p in trees.leaves(params))
    recs = _llm_rounds(dev, model, params, clients, ecfg, torch.cuda.synchronize,
                       snapshots=True)[1]
    for t, (r, e) in enumerate(zip(recs, expect)):
        for key in ("cohort", "n_clusters", "loss0"):
            assert r[key] == e[key], f"path 3 round {t}: {key} differs from the counted run"
    print(f"[path3] kernel rounds again in a fresh process: cohorts, n_clusters and "
          f"omega_loss equal the counted run's exactly; round walls "
          + ", ".join(f"{r['wall'] * 1e3:.1f}" for r in recs) + " ms", flush=True)

    omega0 = _flat_cpu(params)
    plain = llm_setting(use_pallas=False)[0]
    launched = (ssm_scan.fwd_launches, ssm_scan.bwd_launches)
    precs = _llm_rounds(dev, plain, params, clients, ecfg, torch.cuda.synchronize,
                        snapshots=True)[1]
    assert (ssm_scan.fwd_launches, ssm_scan.bwd_launches) == launched
    same_bookkeeping(recs, precs, "the plain scan's")
    # ω's update from ω₀, kernel scan against plain scan; the two round
    # differently in fp32, which flips some bf16 roundings downstream, and
    # the 15 steps at lr 0.05 (ω's loss falls from 11.9 to 2.5) let those
    # differences grow, so in bf16 the gate is on round 0 (5 steps) and the
    # later rounds are reported beside the spread of two plain runs; the
    # fp32 rounds below gate all three
    rels = update_rels(recs, precs, omega0)
    print(f"[path3] use_pallas=False (plain chunked scan): round walls "
          + ", ".join(f"{p['wall'] * 1e3:.1f}" for p in precs)
          + " ms, omega_loss " + ", ".join(f"{p['loss0']:.4f}" for p in precs)
          + "; cohorts, partitions, n_clusters equal; omega update "
          "|du_kernel - du_plain| / |du_plain| after rounds 0..2: "
          + ", ".join(f"{x:.3e}" for x in rels)
          + f" (round 0 tol {LLM_UPDATE_RTOL:g}, bf16 compute)", flush=True)
    assert rels[0] <= LLM_UPDATE_RTOL
    del recs
    # how far two sound bf16 trajectories part: the plain scan again from
    # ω₀ moved up by one fp32 ulp, which flips some of its bf16 casts
    bumped = bump_ulp(params)
    flips = sum(int((x.to(torch.bfloat16) != y.to(torch.bfloat16)).sum())
                for x, y in zip(trees.leaves(params), trees.leaves(bumped)))
    brecs = _llm_rounds(dev, plain, bumped, clients, ecfg, torch.cuda.synchronize,
                        snapshots=True)[1]
    del bumped
    same_bookkeeping(brecs, precs, "the plain scan's")
    print(f"[path3] plain scan from omega_0 + 1 fp32 ulp ({flips} of {n_params} bf16 casts "
          f"change) against the plain scan: omega update |du_bumped - du_plain| / |du_plain| "
          f"after rounds 0..2: " + ", ".join(f"{x:.3e}" for x in update_rels(brecs, precs, omega0))
          + " (reported: the spread of sound bf16 trajectories)", flush=True)
    del brecs, precs, omega0
    check_llm_gradient(dev, params, clients)
    check_llm_fp32_rounds(dev, params, clients, ecfg)
    return 0


def same_bookkeeping(recs, other, what):
    """Cohorts, partitions and n_clusters of two runs of path 3's rounds
    must be equal."""
    for t, (r, p) in enumerate(zip(recs, other)):
        for key in ("cohort", "n_clusters", "partition"):
            assert r[key] == p[key], f"path 3 round {t}: {key} differs from {what}"


def update_rels(recs, other, omega0):
    """Per round, |du - du_other| / |du_other| of ω's update from ω₀."""
    out = []
    for r, p in zip(recs, other):
        du = p["omega"] - omega0
        out.append(float((r["omega"] - omega0 - du).norm() / du.norm()))
    return out


def bump_ulp(params):
    """``params`` with every entry moved up by one fp32 ulp."""
    import torch
    from repro_torch.utils import trees
    return trees.tree_map(lambda x: torch.nextafter(x, torch.full_like(x, float("inf"))),
                          params)


def check_llm_fp32_rounds(dev, params, clients, ecfg):
    """Path 3's 3 rounds at full width in fp32 compute, kernel scan against
    plain scan, and the plain scan again from ω₀ moved up by one fp32 ulp:
    cohorts, partitions and n_clusters equal. ω's update after round 0 (5
    cohort steps) within LLM_FP32_RTOL; after later rounds within
    LLM_FP32_SPREAD times the two plain runs' difference, the spread that
    these rounds give any two fp32 runs a rounding apart."""
    import torch
    from repro_torch.kernels import ssm_scan

    omega0 = _flat_cpu(params)
    runs = []
    for use_pallas, bumped in ((True, False), (False, False), (False, True)):
        start = bump_ulp(params) if bumped else params
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        launched = ssm_scan.fwd_launches
        model = llm_setting(use_pallas=use_pallas, dtype="float32")[0]
        runs.append(_llm_rounds(dev, model, start, clients, ecfg, torch.cuda.synchronize,
                                snapshots=True)[1])
        assert (ssm_scan.fwd_launches > launched) == use_pallas
        del start
        print(f"[path3] fp32 compute, use_pallas={use_pallas}"
              + (", from omega_0 + 1 fp32 ulp" if bumped else "") + ": round walls "
              + ", ".join(f"{r['wall'] * 1e3:.1f}" for r in runs[-1]) + " ms, omega_loss "
              + ", ".join(f"{r['loss0']:.6f}" for r in runs[-1])
              + f"; peak device memory {(torch.cuda.max_memory_allocated() - base) / 1e9:.2f} GB")
    kernel, plain, bumped = runs
    same_bookkeeping(kernel, plain, "the fp32 plain scan's")
    same_bookkeeping(bumped, plain, "the fp32 plain scan's")
    rels, spread = update_rels(kernel, plain, omega0), update_rels(bumped, plain, omega0)
    print(f"[path3] fp32 compute: cohorts, partitions, n_clusters equal; omega update "
          f"|du_kernel - du_plain| / |du_plain| after rounds 0..2: "
          + ", ".join(f"{x:.3e}" for x in rels) + "; plain from omega_0 + 1 ulp against "
          f"plain: " + ", ".join(f"{x:.3e}" for x in spread)
          + f" (tol: round 0 {LLM_FP32_RTOL:g}, later rounds {LLM_FP32_SPREAD:g} x the "
          f"plain runs' spread)")
    assert rels[0] <= LLM_FP32_RTOL
    assert all(r <= LLM_FP32_SPREAD * d for r, d in zip(rels[1:], spread[1:]))


@contextlib.contextmanager
def recording_cosine_inputs():
    """Within the block, every ``ops.pairwise_cosine`` call (the host
    backend's merge pass and objective) also records a copy of the matrix
    it received; yields the list of copies. The call itself goes through
    unchanged, so its launch is counted once."""
    from repro_torch.kernels import ops
    real, records = ops.pairwise_cosine, []

    def record(x, backend="auto"):
        records.append(same_layout_copy(x.detach()))
        return real(x, backend=backend)

    ops.pairwise_cosine = record
    try:
        yield records
    finally:
        ops.pairwise_cosine = real


def check_cosine_on_records(records, tau, tag, atol=1e-4):
    """Hold K2 against its plain version on every matrix a path gave it
    (recorded by ``recording_cosine_inputs``): within ``atol``, the zero
    rows' cosines exactly 0, the same merge decisions (cosine ≥ τ) among
    the live rows. Returns the largest error."""
    import torch
    from repro_torch.kernels import cosine_sim, ref

    assert records, f"{tag} gave K2 no input"
    worst = 0.0
    for t, x in enumerate(records):
        got, want = cosine_sim.cosine_sim(x), ref.cosine_sim_ref(x)
        torch.cuda.synchronize()
        live = torch.linalg.vector_norm(x, dim=1) > 0
        both = live[:, None] & live[None, :] & ~torch.eye(len(x), dtype=torch.bool,
                                                          device=x.device)
        err = float((got - want).abs().max())
        pad_zero = bool((got[~live] == 0).all() and (got[:, ~live] == 0).all())
        same = bool(torch.equal((got >= tau) & both, (want >= tau) & both))
        margin = float((want[both] - tau).abs().min()) if bool(both.any()) else float("inf")
        print(f"[{tag}] cosine_sim on the path's call {t}, {tuple(x.shape)} ({int(live.sum())} "
              f"live rows): max_abs_err={err:.3e} tol {atol:g} pad_exactly_0={pad_zero} merge "
              f"decisions equal={same} (closest |cos - tau| {margin:.3e})")
        assert err <= atol and pad_zero and same, f"cosine_sim disagrees on {tag}'s call {t}"
        worst = max(worst, err)
    return worst


def check_prox_at_llm_size(dev):
    """K1 on path 3's flat (2, 743,305,216) fp32 θ, ω and gradient buffers
    (the kernel's grid-stride loop and its tail run at this size, not at
    phase 2's), against ``ref.prox_update_ref_``, bitwise, in place; then
    timed with its plain version."""
    import torch
    from repro_torch.kernels import prox_update, ref

    n = 2 * LLM_PARAMS
    eta, lam = 0.05, 0.05
    gen = torch.Generator(device=dev).manual_seed(11)
    th, om, gt, go = (torch.randn(n, generator=gen, device=dev) for _ in range(4))
    kt, ko = th.clone(), om.clone()
    ptrs = (kt.data_ptr(), ko.data_ptr())
    prox_update.prox_update_flat(kt, ko, gt, go, eta, lam)
    ref.prox_update_ref_(th, om, gt, go, eta, lam)
    torch.cuda.synchronize()
    exact = bool(torch.equal(kt, th) and torch.equal(ko, om))
    print(f"[path3] prox_update fp32 n={n} (path 3's (2, {LLM_PARAMS}) buffers): bitwise "
          f"equal to ref.prox_update_ref_={exact}, in place="
          f"{(kt.data_ptr(), ko.data_ptr()) == ptrs}")
    assert exact and (kt.data_ptr(), ko.data_ptr()) == ptrs
    del kt, ko
    k_ms = time_ms(lambda: prox_update.prox_update_flat(th, om, gt, go, eta, lam))
    p_ms = time_ms(lambda: ref.prox_update_ref_(th, om, gt, go, eta, lam))
    print(f"[path3] prox_update fp32 n={n}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")


@contextlib.contextmanager
def recording_first_scan(shape):
    """Within the block, the first ``ssm_scan.scan_fwd`` call on operands
    of ``shape`` (on path 3, the first layer's scan in the first cohort
    step) also keeps a copy of the (dA, dBx, C) it received; yields the
    list that receives it. The call itself goes through unchanged, so its
    launch is counted once."""
    from repro_torch.kernels import ssm_scan
    real, records = ssm_scan.scan_fwd, []

    def record(dA, dBx, C):
        if not records and tuple(dA.shape) == tuple(shape):
            records.append(tuple(t.detach().clone() for t in (dA, dBx, C)))
        return real(dA, dBx, C)

    ssm_scan.scan_fwd = record
    try:
        yield records
    finally:
        ssm_scan.scan_fwd = real


def check_scan_on_path(record, tag="path3", what="the path's first cohort-step input"):
    """K5 both ways against the plain versions on the operands the path's
    first scan received (a random output gradient): states, g_dA and g_dBx
    exactly equal, y and g_C within 1e-5 of their largest magnitude.
    Returns the errors of y and of g_C."""
    import torch
    from repro_torch.kernels import ref, ssm_scan
    dA, dBx, C = record
    gen = torch.Generator(device=dA.device).manual_seed(5)
    g_y = torch.randn(dA.shape[:3], generator=gen, device=dA.device)
    y, hs = ssm_scan.scan_fwd(dA, dBx, C)
    grads = ssm_scan.scan_bwd(dA, dBx, C, hs, g_y)
    want_y, want_hs = ref.ssm_scan_states_ref(dA, dBx, C, ssm_scan.CHUNK)
    want = ref.ssm_scan_bwd_ref(dA, dBx, C, want_hs, g_y, ssm_scan.CHUNK)
    torch.cuda.synchronize()
    exact = (torch.equal(hs, want_hs) and torch.equal(grads[0], want[0])
             and torch.equal(grads[1], want[1]))
    errs = [float((a - b).abs().max()) for a, b in ((y, want_y), (grads[2], want[2]))]
    ok = all(e <= 1e-5 * float(b.abs().max()) + 1e-5
             for e, b in zip(errs, (want_y, want[2])))
    print(f"[{tag}] ssm_scan on {what} {tuple(dA.shape)} (dA in "
          f"[{float(dA.min()):.3e}, {float(dA.max()):.3e}]): y max_abs_err {errs[0]:.3e}, "
          f"g_C max_abs_err {errs[1]:.3e}; states, g_dA, g_dBx exactly equal={exact}")
    assert ok and exact, "ssm_scan disagrees with its plain version on the path's input"
    return errs


def check_llm_gradient(dev, params, clients):
    """Loss and gradient of client 0's batch at ω₀ through the full-width
    model, kernel scan (``use_pallas=True``) against the plain chunked
    scan, in bf16 compute (the path's) and in fp32: the kernels inside the
    model, apart from training dynamics. Relative L2 error of the gradient
    within LLM_GRAD_RTOL."""
    import torch
    from repro_torch.utils import trees

    tokens = torch.as_tensor(clients[0]["tokens"], device=dev)
    for dtype in ("bfloat16", "float32"):
        out = []
        for use_pallas in (True, False):
            model = llm_setting(use_pallas=use_pallas, dtype=dtype)[0]
            p = trees.tree_map(lambda x: x.detach().requires_grad_(True), params)
            loss = model.loss_fn(p, {"tokens": tokens})
            grads = torch.autograd.grad(loss, trees.leaves(p))
            out.append((float(loss.detach()), torch.cat([g.reshape(-1) for g in grads])))
            del p, grads, loss
        (lk, gk), (lp, gp) = out
        rel = float((gk - gp).norm() / gp.norm())
        print(f"[path3] loss and gradient at omega_0 on client 0, {dtype} compute: loss "
              f"{lk:.6f} (kernel) / {lp:.6f} (plain), gradient |g_kernel - g_plain| / "
              f"|g_plain| = {rel:.3e} (tol {LLM_GRAD_RTOL[dtype]:g})")
        assert rel <= LLM_GRAD_RTOL[dtype] and abs(lk - lp) <= LLM_GRAD_RTOL[dtype] * abs(lp)
        del out, gk, gp
        torch.cuda.empty_cache()


def trace_llm(dev, model, params, clients, ecfg, tag="trace3"):
    """Path 3 again from a fresh start with rounds 1.. under the profiler:
    host time of each ``stocfl.*`` phase, the device's busy share and the
    kernels that take the most device time."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    _, recs = _llm_rounds(dev, model, params, clients, ecfg, torch.cuda.synchronize,
                          profiler=prof)
    wall = sum(r["wall"] for r in recs[1:]) * 1e3
    phases, kernels = collections.defaultdict(float), collections.defaultdict(float)
    for ev in prof.events():
        if ev.name.startswith("stocfl."):
            if ev.device_type == DeviceType.CPU:
                phases[ev.name] += ev.cpu_time_total / 1e3
        elif ev.device_type == DeviceType.CUDA:
            kernels[ev.name] += ev.device_time_total / 1e3
    print(f"[{tag}] rounds 1..{LLM_ROUNDS - 1} under the profiler: "
          + ", ".join(f"{r['wall'] * 1e3:.1f}" for r in recs[1:]) + " ms")
    for name, ms in sorted(phases.items(), key=lambda kv: -kv[1]):
        print(f"[{tag}] host {name:22s} {ms:9.1f} ms ({100 * ms / wall:5.1f}%)")
    busy = sum(kernels.values())
    assert busy > 0, "the profiler recorded no device time"
    scan = sum(ms for n, ms in kernels.items() if "ssm_scan" in n)
    k1 = sum(ms for n, ms in kernels.items() if "prox_update" in n)
    print(f"[{tag}] device busy {busy:.1f} ms of {wall:.1f} ms ({100 * busy / wall:.1f}%, "
          f"idle {100 - 100 * busy / wall:.1f}%); K5 kernels {scan:.2f} ms, K1 {k1:.2f} ms")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:10]:
        print(f"[{tag}] device {ms:9.2f} ms  {name[:90]}")


def phase_llm_smoke(dev):
    """The smoke falcon-mamba (d_model 128, vocab 512) in fp32 through the
    same 3 rounds on the card (K5 both ways) and on the CPU (plain
    versions): cohorts, partitions, merges, n_clusters equal; ω and the
    bank rows within MAIN_ATOL."""
    import torch

    model, clients, ecfg = llm_setting(smoke=True, dtype="float32")
    params = model.init(torch.Generator().manual_seed(0))
    gs, gpu = _llm_rounds(dev, model, params, clients, ecfg, torch.cuda.synchronize)
    cs, cpu = _llm_rounds("cpu", model, params, clients, ecfg, lambda: None)
    for t, (g, c) in enumerate(zip(gpu, cpu)):
        for key in ("cohort", "n_clusters", "partition", "merges"):
            assert g[key] == c[key], f"smoke LLM round {t}: {key} differs from the CPU run"
    err = max_model_diff(gs, cs)
    print(f"[smoke3] fp32 smoke falcon-mamba, {LLM_ROUNDS} rounds: cohorts, partitions, "
          f"merges, n_clusters equal the CPU run's (n_clusters "
          f"{[g['n_clusters'] for g in gpu]}, merges {[g['merges'] for g in gpu]}); omega "
          f"and {len(gs.models.roots)} bank rows max |cuda - cpu| = {err:.3e} "
          f"(tol {MAIN_ATOL:g}); omega_loss {gpu[-1]['loss0']:.6f} / {cpu[-1]['loss0']:.6f}")
    assert err <= MAIN_ATOL


# ----------------------------------------------------------------- phase 10
def _baseline_rounds(name, device, rounds, cfg, sync):
    """(initial state, one record per round) of strategy ``name`` at the
    main setting; a record holds the cohort (None under full
    participation), the host wall ending in ``sync``, the round's metrics
    and the state after it."""
    from repro_torch import engine
    clients, _, params, loss, _cfg = main_setting()
    state = start = engine.init(name, loss, params, clients, cfg, device=device)
    full = engine.get_strategy(name).full_participation
    trace = []
    for _ in range(rounds):
        cohort = None if full else [int(c) for c in engine.sample_clients(state)[1]]
        t0 = time.perf_counter()
        state, rec = engine.run_round(state)
        sync()
        trace.append(dict(cohort=cohort, wall=time.perf_counter() - t0, rec=dict(rec),
                          state=state))
    return start, trace


@contextlib.contextmanager
def recording_first_theta_step():
    """Within the block, the first ``ops.prox_theta_flat`` call (the first
    local step of the first cohort) also keeps a copy of the (θ, anchor,
    gradient, η, λ) it received, the anchor None when it was θ itself;
    yields the list that receives it. The call itself goes through
    unchanged, so its launch is counted once."""
    from repro_torch.kernels import ops
    real, records = ops.prox_theta_flat, []

    def record(theta, anchor, grad, eta, lam, backend="auto"):
        if not records:
            records.append((theta.clone(), None if anchor is theta else anchor.clone(),
                            grad.clone(), float(eta), float(lam)))
        return real(theta, anchor, grad, eta, lam, backend=backend)

    ops.prox_theta_flat = record
    try:
        yield records
    finally:
        ops.prox_theta_flat = real


@contextlib.contextmanager
def recording_ifca_choices():
    """Within the block, every IFCA round's hypothesis choices are also
    appended to the yielded list."""
    from repro_torch.engine import strategies
    real, records = strategies.IFCAStrategy.choices, []

    def record(self, ctx, state, client_ids, batches=None):
        out = real(self, ctx, state, client_ids, batches)
        records.append([int(c) for c in out])
        return out

    strategies.IFCAStrategy.choices = record
    try:
        yield records
    finally:
        strategies.IFCAStrategy.choices = real


def check_theta_on_path(record, name):
    """K1's local-SGD form against its plain version, bitwise, on the
    operands of the path's first local step."""
    import torch
    from repro_torch.kernels import prox_update, ref
    th, a, g, eta, lam = record
    got = th.clone()
    anchor = got if a is None else a
    keep = None if a is None else a.clone()
    prox_update.prox_theta_flat(got, anchor, g, eta, lam)
    want = ref.prox_theta_ref(th, th if a is None else a, g, eta, lam)
    torch.cuda.synchronize()
    exact = bool(torch.equal(got, want))
    untouched = a is None or bool(torch.equal(a, keep))
    print(f"[base] {name}: prox_theta on the first local step's operands (n={th.numel()}, "
          f"anchor {'theta' if a is None else f'broadcast {tuple(a.shape)}'}, lam={lam}): "
          f"bitwise equal to plain={exact}, anchor unchanged={untouched}")
    assert exact and untouched, f"prox_theta disagrees with plain on {name}'s first step"


def cfl_split_stats(state):
    """The split statistics of the CFL round that starts from ``state``,
    for each cluster of more than 2 members: (cluster, members, |mean
    update| / max |update|, max |update|, the least and the next least
    cosine between two members' updates). CFL splits a cluster when the
    ratio is under ``eps_rel`` and the max over ``eps2``, seeding the
    halves with the least similar pair; the margins show how far the
    decisions lie from a tie. Recomputes the round's local SGD in the
    plain tree form (the same floats as the fused form in fp32)."""
    import torch
    from repro_torch import engine
    from repro_torch.core import bilevel
    from repro_torch.engine import strategies
    from repro_torch.utils import trees
    ctx, cfg = state.ctx, state.ctx.cfg
    live, assign, k, rows = engine.get_strategy("cfl")._matrix(ctx, state)
    a = torch.as_tensor(assign, device=ctx.device)
    thetas = trees.tree_map(lambda r: r.index_select(0, a), rows)
    outs = bilevel.make_cohort_sgd(ctx.loss_fn, cfg.lr, cfg.local_steps)(
        thetas, strategies._batches(ctx, live))
    flat = bilevel.flatten_tree(trees.tree_map(torch.sub, outs, thetas), batch_dims=1)
    norms = torch.linalg.vector_norm(flat, dim=1)
    out = []
    for j in range(k):
        m = a == j
        cnt = int(m.sum())
        if cnt <= 2:
            continue
        max_norm = float(norms[m].max())
        ratio = float(torch.linalg.vector_norm(flat[m].mean(0))) / max_norm
        sims = flat[m] / (norms[m][:, None] + 1e-12)
        cos = (sims @ sims.T)[tuple(torch.triu_indices(cnt, cnt, 1, device=a.device))]
        low = torch.topk(cos, 2, largest=False).values.tolist()
        out.append(f"({j}, {cnt}, {ratio:.6f}, {max_norm:.6f}, {low[0]:.6f}, {low[1]:.6f})")
    return " ".join(out)


def baseline_model_diff(a, b, ids):
    """Largest |difference| of ω, the bank rows and the personal rows of
    clients ``ids`` between two states."""
    from repro_torch.utils import trees
    assert tuple(a.models.roots) == tuple(b.models.roots), "bank roots differ"
    pairs = ([(a.omega, b.omega)] + [(a.models[r], b.models[r]) for r in a.models.roots]
             + [(a.personal[c], b.personal[c]) for c in ids if c in a.personal])
    return max(float((x.float().cpu() - y.float().cpu()).abs().max())
               for ta, tb in pairs for x, y in zip(trees.leaves(ta), trees.leaves(tb)))


def phase_baselines(dev):
    """Phase 10: the paper's baselines at the main setting on the card
    through ``engine.init`` / ``run_round``, their local SGD on K1's
    local-SGD form; launches counted, the kernel held against its plain
    version on each strategy's first step, the first rounds repeated on
    the CPU. Returns the local-SGD launches of all the card's rounds."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.kernels import prox_update

    t_phase = time.perf_counter()
    _, _, params, _, cfg = main_setting()
    n_params = sum(p.numel() for p in params.values())
    print(f"[base] pathological 400 clients x 128 x 64, MLP 2048 hidden ({n_params} params), "
          f"lr {cfg.lr}, E={cfg.local_steps}, seed {cfg.seed}, fused_step=True; CFL eps_rel "
          f"{CFL_EPS_REL}, eps2 {CFL_EPS2} (full participation, cohort_chunk 0)")
    total = 0
    for name, knobs, rounds in BASELINES:
        bcfg = dataclasses.replace(cfg, **knobs)
        steps = (2 if name == "ditto" else 1) * cfg.local_steps
        with recording_first_theta_step() as first, recording_ifca_choices() as gpu_choices:
            prox_update.launches = prox_update.theta_launches = 0
            start, gpu = _baseline_rounds(name, dev, rounds, bcfg, torch.cuda.synchronize)
            launched = (prox_update.theta_launches, prox_update.launches)
        for t, r in enumerate(gpu):
            extra = f", n_clusters {r['rec']['n_clusters']}" if "n_clusters" in r["rec"] else ""
            print(f"[base] {name} cuda round {t}: wall {r['wall'] * 1e3:.1f} ms, sampled "
                  f"{r['rec']['sampled']}{extra}")
        print(f"[base] {name}: prox_theta launches {launched[0]} ({steps} a round), "
              f"prox_update launches {launched[1]}")
        assert launched == (rounds * steps, 0), launched
        total += launched[0]
        check_theta_on_path(first[0], name)
        final = gpu[-1]["state"]
        for tree in ([final.omega] + [final.models[r] for r in final.models.roots]
                     + list(final.personal.values())):
            for leaf in tree.values():
                assert bool(torch.isfinite(leaf).all()), f"{name}: non-finite model values"
        if name == "cfl":
            for t, r in enumerate(gpu):
                stats = cfl_split_stats(gpu[t - 1]["state"] if t else start)
                print(f"[base] cfl round {t}: cluster sizes after it "
                      f"{[len(m) for m in r['state'].members]}; split statistics (cluster, "
                      f"members, |mean|/max, max, least cos, next cos) at its start {stats}")
            assert gpu[-1]["rec"]["n_clusters"] > 1, "CFL made no split on the card"

        with recording_ifca_choices() as cpu_choices:
            _, cpu = _baseline_rounds(name, "cpu", CPU_ROUNDS, bcfg, lambda: None)
        for t in range(CPU_ROUNDS):
            g, c = gpu[t], cpu[t]
            assert g["cohort"] == c["cohort"], f"{name} round {t}: cohort differs"
            assert g["rec"] == c["rec"], f"{name} round {t}: {g['rec']} != {c['rec']}"
            assert g["state"].members == c["state"].members, f"{name} round {t}: members"
        assert gpu_choices[:CPU_ROUNDS] == cpu_choices, f"{name}: IFCA choices differ"
        ids = sorted({i for r in gpu[:CPU_ROUNDS] for i in (r["cohort"] or ())})
        err = baseline_model_diff(gpu[CPU_ROUNDS - 1]["state"], cpu[-1]["state"], ids)
        what = "cohorts, records" + (", choices" if name == "ifca" else "") + \
            (", members" if name == "cfl" else "")
        walls = ", ".join(f"{r['wall'] * 1e3:.1f}" for r in cpu)
        n_personal = len(ids) if name == "ditto" else 0
        print(f"[base] {name}: {what} of rounds 0..{CPU_ROUNDS - 1} equal the CPU run's "
              f"(CPU walls {walls} ms); omega, {len(cpu[-1]['state'].models)} bank rows and "
              f"{n_personal} personal rows: max |cuda - cpu| = {err:.3e} (tol {MAIN_ATOL:g})")
        assert err <= MAIN_ATOL
        del start, gpu, cpu
    print(f"[base] phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return total


# ----------------------------------------------------------------- phase 11
LLM_BF16_PEAK_GB = 63.21   # path 3's peak with fp32 params (PRs 13-16): the bf16 policy's ceiling
# ω's loss after each round of path 3 under dtype="bfloat16", against the
# fp32-param path 3's: bf16 params round every update to 8 significant
# bits, and path 3's rounds already part by 27% of the update between two
# sound bf16-compute runs an fp32 ulp apart (phase 8), so the gate is
# half the fp32 run's loss, with the loss falling round over round
LLM_BF16_LOSS_RTOL = 0.5
SCAN_SEEDS = (0, 1, 7, 123)


def phase_sampler(dev):
    """11a: the threefry draws on the card bitwise equal to the CPU's, at
    400 and 4,000 clients (pools padded to 512 and 4,096, a few departed
    and unavailable ids), five chained draws from each of four seeds."""
    import torch
    from repro_torch.engine import fresh_rng_key, sampler

    for n in (400, SCALE_CLIENTS):
        cap = sampler.pool_capacity(n)
        pool = sampler.cohort_pool(n, {3, 17, n - 1}, {5, 200}, capacity=cap)
        m = sampler.cohort_size(0.1, n - 3, int(pool.sum()))
        same = True
        for seed in SCAN_SEEDS:
            kc, kg = fresh_rng_key(seed), fresh_rng_key(seed, dev)
            for _ in range(5):
                u_same = torch.equal(sampler.uniform(kc, cap).view(torch.int32),
                                     sampler.uniform(kg, cap).cpu().view(torch.int32))
                kc, ic = sampler.draw_cohort(kc, pool, m)
                kg, ig = sampler.draw_cohort(kg, pool, m)
                same &= u_same and torch.equal(ic, ig.cpu()) and torch.equal(kc, kg.cpu())
        print(f"[sampler] {n} clients (pool {cap}, cohort {m}): uniforms, cohorts and "
              f"advanced keys of 5 chained draws from seeds {SCAN_SEEDS} on the card "
              f"bitwise equal to the CPU's={same}")
        assert same, f"the card's draws differ from the CPU's at {n} clients"


@contextlib.contextmanager
def recording_prox_dtypes():
    """Within the block, the dtypes of θ and ω of every ``ops.prox_update_flat``
    call are appended to the yielded list; the call goes through unchanged."""
    from repro_torch.kernels import ops
    real, records = ops.prox_update_flat, []

    def record(theta, omega, *args, **kw):
        records.append((theta.dtype, omega.dtype))
        return real(theta, omega, *args, **kw)

    ops.prox_update_flat = record
    try:
        yield records
    finally:
        ops.prox_update_flat = real


def phase_llm_bf16(dev, fp32_recs):
    """11b: path 3 with ``EngineConfig(dtype="bfloat16")``: params, θ, ω,
    gradients and the bank in bf16 (K1's bf16 entry), Ψ, the cluster means
    and the objective in fp32. Walls, losses beside the fp32-param run's
    (``fp32_recs``, phase 8), peak memory under LLM_BF16_PEAK_GB, launches;
    then traced as phase 8 is. Returns K1's launches."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.kernels import cosine_sim, prox_update, ssm_scan
    from repro_torch.utils import trees

    model, clients, ecfg = llm_setting()
    ecfg = dataclasses.replace(ecfg, dtype="bfloat16")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    prox_update.launches = cosine_sim.launches = 0
    ssm_scan.fwd_launches = ssm_scan.bwd_launches = 0
    with recording_prox_dtypes() as dtypes:
        state, recs = _llm_rounds(dev, model, params, clients, ecfg, torch.cuda.synchronize)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    launches = {"prox_update": prox_update.launches, "cosine_sim": cosine_sim.launches,
                "ssm_scan_fwd": ssm_scan.fwd_launches, "ssm_scan_bwd": ssm_scan.bwd_launches}
    for t, (r, f) in enumerate(zip(recs, fp32_recs)):
        print(f"[bf16] path 3, dtype=bfloat16, round {t}: wall {r['wall'] * 1e3:.1f} ms, cohort "
              f"{r['cohort']}, n_clusters {r['n_clusters']}, objective {r['objective']:.6f}, "
              f"omega_loss on client 0 {r['loss0']:.4f} (fp32 params: {f['loss0']:.4f})")
    print(f"[bf16] peak device memory {peak:.2f} GB (torch.cuda.max_memory_allocated, from "
          f"{base / 1e9:.2f} GB before the path; gate {LLM_BF16_PEAK_GB} GB); launches {launches}")
    R = LLM_ROUNDS
    expect = llm_launches(model.cfg, ecfg, recs)
    assert launches == expect, (launches, expect)
    assert peak <= LLM_BF16_PEAK_GB, f"path 3 in bf16 peaked at {peak:.2f} GB"
    bf16 = torch.bfloat16
    assert dtypes and all(d == (bf16, bf16) for d in dtypes), set(dtypes)
    leaves = trees.leaves(state.omega) + trees.leaves(state.models.stacked)
    assert all(x.dtype == bf16 and bool(torch.isfinite(x).all()) for x in leaves)
    roots, means = state.clusters.cluster_means()
    psi = state.ctx.extractor(state.ctx.clients[0])
    assert state.clusters.reps[roots[0]].dtype == torch.float32
    assert means.dtype == torch.float32 and psi.dtype == torch.float32
    assert all(isinstance(r["objective"], float) and np.isfinite(r["objective"]) for r in recs)
    losses = [r["loss0"] for r in recs]
    rel = [abs(r["loss0"] - f["loss0"]) / f["loss0"] for r, f in zip(recs, fp32_recs)]
    print(f"[bf16] K1 ran its bf16 entry in all {len(dtypes)} calls (theta and omega bf16); "
          f"omega and {len(state.models.roots)} bank rows bf16; Psi {tuple(psi.shape)}, the "
          f"cluster means and the objective fp32; omega_loss relative to the fp32-param run's "
          f"after rounds 0..{R - 1}: " + ", ".join(f"{x:.3e}" for x in rel)
          + f" (gate {LLM_BF16_LOSS_RTOL}, falling round over round)")
    assert all(np.isfinite(losses)) and max(rel) <= LLM_BF16_LOSS_RTOL
    assert all(a > b for a, b in zip(losses, losses[1:])), losses
    del state, psi, means
    torch.cuda.empty_cache()
    trace_llm(dev, model, params, clients, ecfg, tag="trace_bf16")
    return launches["prox_update"]


def _device_kernels(prof) -> dict:
    """{kernel name: device ms} of every CUDA event a profiler recorded."""
    import collections

    from torch.autograd import DeviceType
    out = collections.defaultdict(float)
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            out[ev.name] += ev.device_time_total / 1e3
    return out


def _zero_counts():
    from repro_torch.kernels import _build
    _build.add_launches(_build.launch_counts(), -1)


def _scan_cohorts(start, rounds, dev):
    """The cohorts a span from ``start`` draws: ``sampler.draw``, the
    step's own draw, chained from the span's start key on the card."""
    import torch
    from repro_torch.engine import sampler
    n = start.n_clients
    pool = torch.as_tensor(sampler.cohort_pool(n, start.left, capacity=sampler.pool_capacity(n)),
                           device=dev)
    m = sampler.cohort_size(start.ctx.cfg.sample_rate, n - len(start.left), int(pool.sum()))
    key, out = start.rng_key, []
    for _ in range(rounds):
        key, ids = sampler.draw(key, pool, m)
        out.append(ids.tolist())
    return out


def _state_diff(a, b) -> float:
    """Largest |difference| of ω, the bank rows (same roots) and the
    personal rows of two states."""
    from repro_torch.utils import trees
    assert sorted(a.models.roots) == sorted(b.models.roots), "bank roots differ"
    pairs = ([(a.omega, b.omega)] + [(a.models[r], b.models[r]) for r in a.models.roots]
             + [(a.personal[c], b.personal[c]) for c in sorted(a.personal)])
    return max(float((x.float() - y.float()).abs().max())
               for ta, tb in pairs for x, y in zip(trees.leaves(ta), trees.leaves(tb)))


def masked_cost(dev, state, tag):
    """What the captured StoCFL step does every round that the reference's
    ``lax.cond`` skips on a round with no new client and no merge, timed
    on ``state``'s partition: the merge pass at the span's bound, the
    row-keyed bank merge over every row and the objective (CUDA events,
    ``time_ms``), and Ψ of all the cohort's members (device time under the
    profiler: one autograd call each, which the host issues slower than
    the card runs them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import engine
    from repro_torch.core import device_clustering as devclust
    from repro_torch.engine import sampler, strategies
    from repro_torch.utils import trees

    ctx = state.ctx
    dcs, rows, has = engine.get_strategy("stocfl")._cold_carry(ctx, state, state.clusters)
    cap = dcs.capacity
    k_bound = strategies.merge_bound(state, cap)
    ids = torch.arange(cap, dtype=torch.int32, device=dev)
    merge = lambda: devclust.merge_round_impl(dcs, ctx.cfg.tau, k_bound)
    _, live_rows, new_roots, counts = merge()
    settled = bool((live_rows == new_roots).all())
    t_merge = time_ms(merge)
    t_bank = time_ms(lambda: strategies.row_bank_merge(rows, has, ctx.init_params, ids,
                                                       live_rows, new_roots, counts))
    t_obj = time_ms(lambda: devclust.objective_closed_impl(dcs))
    n = state.n_clients
    pool = sampler.cohort_pool(n, state.left, capacity=sampler.pool_capacity(n))
    m = sampler.cohort_size(ctx.cfg.sample_rate, n - len(state.left), int(pool.sum()))
    _, cohort = sampler.draw_cohort(state.rng_key, pool, m)
    batches = ctx.arena.take(cohort)
    psi_all = lambda: [ctx.extractor(trees.tree_map(lambda x, i=i: x[i], batches))
                       for i in range(m)]
    psi_all()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        psi_all()
        torch.cuda.synchronize()
    t_psi = sum(_device_kernels(prof).values())
    print(f"[{tag}] masked work a round on the final partition ({state.clusters.n_clusters()} "
          f"clusters, capacity {cap}, merge bound {k_bound}, settled={settled}): merge pass "
          f"{t_merge:.4f} ms, bank "
          f"merge over {cap} rows {t_bank:.4f} ms, objective {t_obj:.4f} ms (CUDA events); "
          f"Psi of all {m} cohort members {t_psi:.3f} ms of device time (profiler)")
    del dcs, rows, has


def compare_captured(dev, name, clients, params, loss, cfg, rounds, tag, expect_per_round):
    """``rounds`` eager rounds against ``engine.run_rounds`` from the same
    ``init`` (arena, device rng): the first call (round 0 eager on the
    capture stream, the capture, then replays), a second call (replays
    only), a third under the profiler. Gates: cohorts, records (n_clusters,
    sampled), parent / live, members and bank roots equal; ω, bank and
    personal rows within MAIN_ATOL; the first call's launches equal
    ``expect_per_round`` × rounds, the captured round's own counts. Prints
    the eager walls, each call's wall over its rounds, the capture's time
    and the captured span's device busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import engine
    from repro_torch.engine.api import RoundProgram
    from repro_torch.kernels import _build

    start = engine.init(name, loss, params, clients, cfg, device=dev, arena=True)
    full = engine.get_strategy(name).full_participation
    eager, walls, cohorts = start, [], []
    for _ in range(rounds):
        if not full:
            cohorts.append(engine.sample_clients(eager)[1].tolist())
        t0 = time.perf_counter()
        eager, _ = engine.run_round(eager)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    _zero_counts()
    t0 = time.perf_counter()
    first = engine.run_rounds(start, rounds)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launched = {k: v for k, v in _build.launch_counts().items() if v}
    program = next(v for v in start.ctx.cache.values() if isinstance(v, RoundProgram))
    t0 = time.perf_counter()
    second = engine.run_rounds(start, rounds)
    torch.cuda.synchronize()
    second_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run_rounds(start, rounds)
        torch.cuda.synchronize()
        third_ms = (time.perf_counter() - t0) * 1e3
    kernels = _device_kernels(prof)
    busy = sum(kernels.values())
    busy_txt = (f"device busy {busy:.2f} ms of {third_ms:.1f} ms ({100 * busy / third_ms:.1f}%, "
                f"profiler)" if busy > 0 else "device busy not measured (the profiler "
                f"recorded no device time in the replays)")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
    print(f"[{tag}] {name}: eager walls " + ", ".join(f"{w:.1f}" for w in walls)
          + f" ms; run_rounds({rounds}): first call {first_ms:.1f} ms (round 0 eager on the "
          f"capture stream, capture {program.capture_s * 1e3:.1f} ms, {rounds - 1} replays), "
          f"replays only {second_ms:.1f} ms = {second_ms / rounds:.2f} ms a round; under the "
          f"profiler {third_ms:.1f} ms, {busy_txt}")
    for kname, ms in top:
        print(f"[{tag}] {name}: device {ms:8.3f} ms in {rounds} replays  {kname[:80]}")
    per_round = dict(program.per_round)
    print(f"[{tag}] {name}: launches in the first call {launched} = the captured round's "
          f"{per_round} x {rounds} (round 0 launched eagerly, the rest counted a replay each)")
    assert per_round == expect_per_round, (per_round, expect_per_round)
    assert launched == {k: v * rounds for k, v in per_round.items()}, launched
    strip = lambda h: [{k: v for k, v in r.items() if k in ("n_clusters", "sampled")} for r in h]
    worst = 0.0
    for got in (first, second):
        assert strip(got.history) == strip(eager.history), (got.history, eager.history)
        assert got.members == eager.members
        if not full:
            assert torch.equal(got.rng_key, eager.rng_key)
        if name == "stocfl":
            a, b = got.clusters.state, eager.clusters.state
            assert torch.equal(a.parent, b.parent) and torch.equal(a.live, b.live)
        worst = max(worst, _state_diff(got, eager))
    if not full:
        assert _scan_cohorts(start, rounds, dev) == cohorts
    obj = ""
    if name == "stocfl":
        od = max(abs(a["objective"] - b["objective"])
                 for a, b in zip(first.history, eager.history))
        obj = f", objectives within {od:.3e}"
    print(f"[{tag}] {name}: both calls' cohorts (the span's draws from its start key), "
          f"records, {'parent/live, ' if name == 'stocfl' else ''}members and bank roots "
          f"equal the eager loop's; omega, bank and personal rows max |captured - eager| = "
          f"{worst:.3e} (tol {MAIN_ATOL:g}){obj}")
    assert worst <= MAIN_ATOL
    if name == "stocfl":
        masked_cost(dev, first, tag)
    del start, eager, first, second, program
    torch.cuda.empty_cache()


def phase_captured(dev):
    """11c and 11d: the captured loop against the eager loop, path 2 at 400
    clients (5 rounds) and 4,000 (2), then each baseline at phase 10's
    setting (5 rounds, CFL 3), all with rng_backend="device" over an
    arena."""
    import dataclasses

    from repro_torch.data.synthetic import pathological

    t_phase = time.perf_counter()
    clients, _, params, loss, cfg = main_setting()
    dcfg = path2_config(cfg, rng_backend="device")
    stocfl = {"prox_update.launches": cfg.local_steps, "cosine_sim.candidate_launches": 1,
              "resolve_roots.launches": 2, "resolve_roots.label_launches": 1}
    compare_captured(dev, "stocfl", clients, params, loss, dcfg, ROUNDS, "scan", stocfl)
    big, _, _ = pathological(n_clients=SCALE_CLIENTS, n_per=128, seed=0)
    # 400-client cohorts run in chunks of SCALE_CHUNK: K1 once a step a chunk
    chunks = -(-SCALE_CLIENTS // 10 // SCALE_CHUNK)
    compare_captured(dev, "stocfl", big, params, loss,
                     dataclasses.replace(dcfg, cohort_chunk=SCALE_CHUNK), SCALE_ROUNDS,
                     "scan4k", dict(stocfl, **{"prox_update.launches": chunks * cfg.local_steps}))
    del big
    for name, knobs, rounds in BASELINES:
        steps = (2 if name == "ditto" else 1) * cfg.local_steps
        compare_captured(dev, name, clients, params, loss,
                         dataclasses.replace(cfg, rng_backend="device", **knobs), rounds,
                         "scanbase", {"prox_update.theta_launches": steps})
    print(f"[scan] phases 11c-d took {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------- phase 12
CHURN_ROUNDS = 30         # benchmarks/churn_sweep.py's horizon
CHURN_BURST = 80          # §5's newly-joined-client burst: 20% of 400, at round 10
CHURN_BURST_AT = 10
CHURN_SPLIT = 15          # (c): the checkpoint's round
CHURN_ATOL = 1e-4         # (a): omega and bank rows, captured spans against eager
ASYNC_ATOL = 1e-5         # (b), (c): rows, async against sync and resumed against uninterrupted
ASYNC_CFG = dict(staleness_decay=0.8, staleness_cap=3)
CHURN_QUANTUM = 20        # churn_sweep.py:181: min(32, max(int(0.1 * 400 / 2), 2))
OBJECTIVE_RTOL = 1e-5     # (b): the round's objective, async against sync on the card


def churn_setting():
    """Phase 12's federation: paths 1 and 2's model and knobs
    (``main_setting``, the 153,610-parameter MLP, fused_step) with device
    rng over ``rotated(n_clusters=4, n_clients=400, n_per=128, seed=0)``,
    whose latent clusters ``rotated_factory`` draws newcomers from.
    Returns (clients, true_cluster, test_sets, params, loss, accuracy,
    cfg, factory)."""
    import dataclasses

    from repro_torch.data.synthetic import rotated, rotated_factory
    from repro_torch.models import simple

    _, _, params, loss, cfg = main_setting()
    clients, true_cluster, tests = rotated(n_clusters=4, n_clients=400, n_per=128, seed=0)
    task = dataclasses.replace(simple.MNIST_MLP, input_shape=(64,), name="mlp2048")
    acc = lambda p, b: simple.accuracy(p, b, task)
    return (clients, true_cluster, tests, params, loss, acc,
            dataclasses.replace(cfg, rng_backend="device"),
            rotated_factory(n_clusters=4, n_per=128, seed=0))


def churn_timeline(rate, n_clients, delays=False):
    """``benchmarks/churn_sweep.py``'s churn model (joins and leaves each
    Poisson(``rate``) a round from round 0, 30 rounds, drift every 10),
    one availability window (client 7 offline in the first and last 2
    rounds), the §5 burst of 80 joins at round 10 and, with ``delays``,
    each round a third of the ids reporting 0-2 rounds late."""
    import numpy as np
    from repro_torch.sim import Availability, Delay, Join, Timeline

    base = Timeline.from_poisson(rounds=CHURN_ROUNDS, join_rate=rate, leave_rate=rate,
                                 n_clusters=4, drift_every=10, seed=0, start=0)
    rng = np.random.default_rng(1)
    events = base.events() + [Join(t=CHURN_BURST_AT, cluster=int(rng.integers(4)))
                              for _ in range(CHURN_BURST)]
    if delays:
        ids = n_clients + CHURN_BURST + len(base.events())
        events += [Delay(t=t, rounds=int(rng.integers(0, 3)),
                         cids=tuple(int(c) for c in rng.choice(ids, ids // 3, replace=False)))
                   for t in range(CHURN_ROUNDS)]
    return Timeline(events, windows=[Availability(cid=7, start=2, end=CHURN_ROUNDS - 2)])


def shifted(timeline, k):
    """``timeline``'s rounds from ``k`` on, renumbered from 0."""
    import dataclasses

    from repro_torch.sim import Availability, Timeline
    return Timeline([dataclasses.replace(ev, t=ev.t - k) for ev in timeline.events() if ev.t >= k],
                    windows=[Availability(w.cid, w.start - k, w.end - k) for w in timeline.windows])


def _log_ints(log):
    """What two runs of one timeline must share: each record's events,
    cohort, population, skip flag, n_clusters and flush bookkeeping."""
    keys = ("t", "events", "cohort", "skipped", "n_registered", "n_live", "n_clusters",
            "merged", "dropped_stale", "dropped_left", "in_flight", "max_staleness")
    return [{k: r.get(k) for k in keys} for r in log.records]


def _launched():
    from repro_torch.kernels import _build
    return {k: v for k, v in _build.launch_counts().items() if v}


def churn_run(dev, setting, timeline, cfg, scan, records):
    """One ``simulate`` over ``timeline`` from a fresh card engine:
    returns (state, log, launches, wall s, CUDA graphs captured,
    reserved bytes before and after)."""
    import torch
    from repro_torch import engine
    from repro_torch.engine.api import RoundProgram
    from repro_torch.sim import simulate

    clients, tc, tests, params, loss, acc, _cfg, factory = setting
    start = engine.init("stocfl", loss, params, clients, cfg, eval_fn=acc, device=dev,
                        arena=True)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_reserved(dev)
    _zero_counts()
    with (recording_merge_inputs() if records is not None else contextlib.nullcontext()) as recs:
        t0 = time.perf_counter()
        state, log = simulate(start, timeline, rounds=CHURN_ROUNDS, client_factory=factory,
                              seed=0, eval_every=5, test_sets=tests, true_cluster=tc,
                              scan_spans=scan)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = _launched()
    graphs = sum(isinstance(v, RoundProgram) and v.graph is not None
                 for v in state.ctx.cache.values())
    mem1 = torch.cuda.memory_reserved(dev)
    if records is not None:
        records.extend(recs)
    return state, log, launched, wall, graphs, (mem0, mem1)


def phase_churn(dev):
    """12a: ``simulate`` over timeline (a) on the device backend with an
    arena, eagerly and with ``scan_spans``; returns the launches of both
    runs."""
    import torch

    t_phase = time.perf_counter()
    setting = churn_setting()
    clients, _, _, params, _, _, cfg, _ = setting
    dcfg = path2_config(cfg)
    tl = churn_timeline(1 / 3, len(clients))
    print(f"[churn] rotated 4 clusters, 400 clients x 128 x 64, MLP 2048 hidden "
          f"({sum(p.numel() for p in params.values())} params), tau {cfg.tau}, lam {cfg.lam}, "
          f"lr {cfg.lr}, E={cfg.local_steps}, sample rate {cfg.sample_rate}, fused_step, device "
          f"rng, device backend, arena; timeline (a) {tl} (Poisson 1/3 joins and 1/3 leaves a "
          f"round, the 5% point of churn_sweep.py, plus {CHURN_BURST} joins at round "
          f"{CHURN_BURST_AT}); eval every 5 rounds")
    records, out, total = [], {}, {}
    for scan in (False, True):
        tag = "scan" if scan else "eager"
        state, log, launched, wall, graphs, (m0, m1) = churn_run(
            dev, setting, tl, dcfg, scan, records if not scan else None)
        trained = sum(not r["skipped"] for r in log.records)
        n_scanned = sum(bool(r.get("scanned")) for r in log.records)
        walls = ", ".join(f"{r['sec_train'] * 1e3:.1f}/{r['sec_round'] * 1e3:.1f}"
                          for r in log.records if "sec_train" in r)
        print(f"[churn] {tag}: {wall:.2f} s for {CHURN_ROUNDS} rounds ({trained} trained, "
              f"{n_scanned} in captured spans), {len(log.joined)} joined, {len(log.departed)} "
              f"departed, {state.n_clients - len(state.left)} live, "
              f"{state.clusters.n_clusters()} clusters; CUDA graphs captured {graphs}; "
              f"memory_reserved {m0 / 2**20:.0f} -> {m1 / 2**20:.0f} MiB")
        print(f"[churn] {tag} per-round sec_train/sec_round (ms; the round call alone / with "
              f"its events; spans at their average): {walls}")
        ts, joined = log.curve("joined_acc")
        _, incumbent = log.curve("incumbent_acc")
        gaps = [r["gap"] for r in log.records if "gap" in r]
        print(f"[churn] {tag} §5 routed accuracy at rounds {log.curve('incumbent_acc')[0]}: "
              f"incumbents {[round(a, 4) for a in incumbent]}; joined (rounds {ts}) "
              f"{[round(a, 4) for a in joined]}; final gap {gaps[-1] if gaps else None}")
        print(f"[churn] {tag} launches {launched}")
        assert launched.get("prox_update.launches", 0) == cfg.local_steps * trained, launched
        for k in ("cosine_sim.candidate_launches", "resolve_roots.launches",
                  "resolve_roots.label_launches"):
            assert launched.get(k, 0) > 0, (k, launched)
        assert launched.get("cosine_sim.launches", 0) == 0, launched
        assert launched.get("cosine_sim.padded_copies", 0) == 0, launched
        for k, v in launched.items():
            total[k] = total.get(k, 0) + v
        for leaf in list(state.omega.values()) + list(state.models.stacked.values()):
            assert bool(torch.isfinite(leaf).all()), "non-finite model values"
        out[scan] = (state, log)
    (a, alog), (b, blog) = out[False], out[True]
    assert sum(bool(r.get("scanned")) for r in blog.records) > 0, "no span was captured"
    assert _log_ints(alog) == _log_ints(blog), "the captured run's records differ"
    assert alog.joined == blog.joined and alog.departed == blog.departed
    assert a.clusters.assignment() == b.clusters.assignment()
    assert torch.equal(a.rng_key, b.rng_key)
    err = _state_diff(a, b)
    print(f"[churn] eager and scan_spans runs: records (events, cohorts, skipped, "
          f"n_clusters), joined, departed, partitions and bank roots equal; omega and "
          f"{len(a.models)} bank rows max |scan - eager| = {err:.3e} (tol {CHURN_ATOL:g})")
    assert err <= CHURN_ATOL
    del a, b, out
    check_candidates_on_path(records, "churn")
    check_labels_on_path(records, "churn")
    del records
    torch.cuda.empty_cache()
    print(f"[churn] phase 12a took {time.perf_counter() - t_phase:.1f} s")
    return total


def check_zero_delay(dev, setting, cfg):
    """12b's gate: five rounds of ``run_round_async`` at zero delay equal
    ``run_round`` from the same ``init``, for StoCFL (host backend) and
    FedAvg: cohorts, records and partitions exact, rows within 1e-5
    (``aggregate_segments``' ``index_add_`` sums in no fixed order on
    the card)."""
    import dataclasses

    import torch
    from repro_torch import engine

    clients, _, _, params, loss, _, _, _ = setting
    acfg = dataclasses.replace(cfg, async_cfg=engine.AsyncConfig(**ASYNC_CFG))
    for name in ("stocfl", "fedavg"):
        sync = engine.init(name, loss, params, clients, cfg, device=dev, arena=True)
        asy = engine.init(name, loss, params, clients, acfg, device=dev, arena=True)
        for t in range(ROUNDS):
            cohort = engine.sample_clients(sync)[1].tolist()
            assert engine.sample_clients(asy)[1].tolist() == cohort
            sync, srec = engine.run_round(sync)
            asy, arec = engine.run_round_async(asy)
            # the objective sums cosines of cluster means that ClusterState
            # builds with index_add_, whose float order the card does not fix
            assert all(arec[k] == v for k, v in srec.items()
                       if k not in ("merges", "objective")), (srec, arec)
            if "objective" in srec:
                assert abs(arec["objective"] - srec["objective"]) <= \
                    OBJECTIVE_RTOL * max(1.0, abs(srec["objective"])), (srec, arec)
            assert arec["merged"] == len(cohort) and arec["in_flight"] == 0
            if name == "stocfl":
                assert sync.clusters.assignment() == asy.clusters.assignment()
        torch.cuda.synchronize()
        err = _state_diff(sync, asy)
        assert err <= ASYNC_ATOL, err
        print(f"[async] {name}: {ROUNDS} rounds of run_round_async at zero delay against "
              f"run_round: cohorts, records (the objective within {OBJECTIVE_RTOL:g} "
              f"relative){', partitions' if name == 'stocfl' else ''} equal; omega and bank "
              f"rows max |async - sync| = {err:.3e} (tol {ASYNC_ATOL:g})")


def async_half(state, timeline, setting, seed):
    """``simulate`` in async mode over ``timeline``'s first rounds (all
    that it holds), cohorts quantised to ``CHURN_QUANTUM``; returns
    (state, log, wall s)."""
    import torch
    from repro_torch.sim import simulate

    rounds = min(CHURN_SPLIT, CHURN_ROUNDS)
    t0 = time.perf_counter()
    state, log = simulate(state, timeline, rounds=rounds, client_factory=setting[7], seed=seed,
                          cohort_quantum=CHURN_QUANTUM, async_mode=True)
    torch.cuda.synchronize()
    return state, log, time.perf_counter() - t0


def phase_async_churn(dev):
    """12b and 12c: the zero-delay gate; then StoCFL (host backend) and
    FedAvg through timeline (b) in async mode, checkpointed at round 15
    with deltas in flight, the uninterrupted run against the one resumed
    in a fresh card engine, and the checkpoint loaded on the CPU for one
    round. Returns the launches of the card runs."""
    import dataclasses
    import tempfile

    from repro_torch import engine

    t_phase = time.perf_counter()
    setting = churn_setting()
    clients, _, _, _, _, _, cfg, _ = setting
    check_zero_delay(dev, setting, cfg)
    tl = churn_timeline(4 / 3, len(clients), delays=True)
    second = shifted(tl, CHURN_SPLIT)
    acfg = dataclasses.replace(cfg, async_cfg=engine.AsyncConfig(**ASYNC_CFG))
    print(f"[async] timeline (b) {tl} (Poisson 4/3 joins and 4/3 leaves a round, the 20% "
          f"point of churn_sweep.py, plus {CHURN_BURST} joins at round {CHURN_BURST_AT}, a "
          f"third of the ids 0-2 rounds late each round); AsyncConfig({ASYNC_CFG}), "
          f"cohort_quantum {CHURN_QUANTUM}, host backend, arena")
    total, k2 = {}, 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt") as root:
        for name in ("stocfl", "fedavg"):
            t, err = async_checkpointed_run(dev, name, setting, tl, second, acfg, root)
            for k, v in t.items():
                total[k] = total.get(k, 0) + v
            k2 = max(k2, err)
    print(f"[async] phases 12b-c took {time.perf_counter() - t_phase:.1f} s")
    return total, k2


def async_checkpointed_run(dev, name, setting, tl, second, acfg, root):
    """12b-c for one strategy: timeline (b)'s first 15 rounds, the
    checkpoint (``block=False``), the uninterrupted last 15, then the
    resume in a fresh card engine (and for StoCFL the CPU load). Returns
    (launches of the card run, K2's largest error on its inputs)."""
    import torch
    from repro_torch import checkpoint, convert, engine

    clients, _, _, params, loss, _, cfg, _ = setting
    k2 = 0.0
    start = engine.init(name, loss, params, clients, acfg, device=dev, arena=True)
    _zero_counts()
    with recording_cosine_inputs() as mats:
        first, log1, w1 = async_half(start, tl, setting, seed=0)
        path = os.path.join(root, name)
        t0 = time.perf_counter()
        checkpoint.save_server_state(path, first, block=False)
        t_call = time.perf_counter() - t0
        checkpoint.wait_pending()
        t_write = time.perf_counter() - t0
        world = [convert.to_numpy(c) for c in first.ctx.clients]
        entries = first.buffer.entries
        full, log2, w2 = async_half(first, second, setting, seed=1)
    launched = _launched()
    trained = sum(not r["skipped"] for r in log1.records + log2.records)
    records = log1.records + log2.records
    print(f"[async] {name}: {CHURN_ROUNDS} rounds in {w1 + w2:.2f} s, {trained} trained, "
          f"{len(log1.joined) + len(log2.joined)} joined, "
          f"{len(log1.departed) + len(log2.departed)} departed; per round (merged, "
          f"dropped_stale, dropped_left, in_flight, sec_train/sec_round ms): "
          + " ".join(f"{r['t'] + (CHURN_SPLIT if i >= len(log1.records) else 0)}:"
                     f"({r.get('merged')},{r.get('dropped_stale')},{r.get('dropped_left')},"
                     f"{r.get('in_flight')},{r.get('sec_train', 0) * 1e3:.1f}/"
                     f"{r['sec_round'] * 1e3:.1f})" for i, r in enumerate(records)))
    print(f"[async] {name}: launches {launched}")
    kname = "prox_update.launches" if name == "stocfl" else "prox_update.theta_launches"
    assert launched.get(kname, 0) == cfg.local_steps * trained, launched
    other = "prox_update.theta_launches" if name == "stocfl" else "prox_update.launches"
    assert launched.get(other, 0) == 0, launched
    assert launched.get("cosine_sim.candidate_launches", 0) == 0, launched
    if name == "stocfl":
        assert launched.get("cosine_sim.launches", 0) > 0, launched
        k2 = check_cosine_on_records(mats, cfg.tau, "async")
    del mats
    assert len(entries) > 0, "no delta was in flight at the checkpoint"
    print(f"[ckpt] {name}: save_server_state(block=False) at round {CHURN_SPLIT} with "
          f"{len(entries)} deltas in flight returned in {t_call * 1e3:.1f} ms, "
          f"the write landed at {t_write * 1e3:.1f} ms (wait_pending)")

    fresh = engine.init(name, loss, params, world, acfg, device=dev, arena=True)
    loaded = checkpoint.load_server_state(path, fresh)
    assert loaded.buffer.entries == entries and loaded.round == CHURN_SPLIT
    if name == "stocfl":
        # before the resumed run grows this engine's world
        check_cpu_resume(dev, path, setting, world, acfg, loaded)
    resumed, log3, _ = async_half(loaded, second, setting, seed=1)
    assert _log_ints(log3) == _log_ints(log2), "the resumed run's records differ"
    assert log3.joined == log2.joined and log3.departed == log2.departed
    assert resumed.buffer.entries == full.buffer.entries
    if name == "stocfl":
        assert resumed.clusters.assignment() == full.clusters.assignment()
    err = _state_diff(full, resumed)
    assert err <= ASYNC_ATOL, err
    print(f"[ckpt] {name}: resumed in a fresh card engine and finished: records, joined, "
          f"departed, buffer entries{', partition' if name == 'stocfl' else ''} equal the "
          f"uninterrupted run's; omega and bank rows max |resumed - uninterrupted| = "
          f"{err:.3e} (tol {ASYNC_ATOL:g})")
    del start, first, full, fresh, loaded, resumed
    torch.cuda.empty_cache()
    return launched, k2


def check_cpu_resume(dev, path, setting, world, acfg, card):
    """12c: the checkpoint loaded with ``device="cpu"``; one round there
    and one on the card from the loaded state: cohort, record and
    partition equal."""
    import torch
    from repro_torch import checkpoint, engine

    _, _, _, params, loss, _, _, _ = setting
    cpu = checkpoint.load_server_state(path, engine.init("stocfl", loss, params, world, acfg,
                                                         device="cpu", arena=True))
    assert cpu.clusters.device.type == "cpu" and card.clusters.device == torch.device(dev)
    cohort = engine.sample_clients(card)[1].tolist()
    assert engine.sample_clients(cpu)[1].tolist() == cohort
    t0 = time.perf_counter()
    cpu_next, crec = engine.run_round_async(cpu)
    t_cpu = time.perf_counter() - t0
    card_next, grec = engine.run_round_async(card)
    assert crec.keys() == grec.keys()
    assert all(crec[k] == grec[k] for k in grec if k != "objective"), (crec, grec)
    assert abs(crec["objective"] - grec["objective"]) <= \
        OBJECTIVE_RTOL * max(1.0, abs(grec["objective"])), (crec, grec)
    assert cpu_next.clusters.assignment() == card_next.clusters.assignment()
    print(f"[ckpt] stocfl: the same checkpoint loaded with device='cpu' (its partition on "
          f"the CPU): one round there ({t_cpu:.2f} s) and on the card give the same cohort "
          f"({len(cohort)} clients), record {grec} (the objective within "
          f"{OBJECTIVE_RTOL:g} relative: K2 on the card, the plain product on the CPU) and "
          f"partition")


# ----------------------------------------------------------------- phase 13
# the reference CLI's defaults (src/repro/launch/serve.py): 2 clusters,
# 4 slots a cluster, prompts of 32 tokens, 16 generated, tau 0.3, seed 0
SERVE_CLUSTERS, SERVE_SLOTS, SERVE_PROMPT, SERVE_GEN, SERVE_TAU = 2, 4, 32, 16, 0.3
SERVE_FIRST, SERVE_WARM = 8, 16     # qwen2: the first wave, then a warm wave
SERVE_MAMBA = 4                     # falcon-mamba: requests a wave
SERVE_SMOKE = 6                     # 13c: requests on 2 x 2 lanes (two admission waves)
SERVE_MAX_STOPS = 1                 # near-tie stops a wave may make (13a, 13b, 13c)


def bound_stops(tag, reqs, stops):
    """The bound on one wave's near-tie stops (rid, step): at most
    ``SERVE_MAX_STOPS``, so a fault that shows only where top-2 gaps are
    small cannot pass as a run of stops. Returns the share of the wave's
    tokens that were compared."""
    gen = {r.rid: r.gen for r in reqs}
    total = sum(gen.values())
    compared = total - sum(gen[rid] - step for rid, step in stops)
    assert len(stops) <= SERVE_MAX_STOPS, (tag, stops)
    return compared / total


def serve_setting(arch, smoke=False, **kw):
    """(config, model) of a served architecture in fp32 compute: greedy
    argmax ties flip under bf16, and the card is held to its own
    sequential loop and to the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build
    cfg = get_config(arch, smoke=smoke).with_(dtype="float32", **kw)
    return cfg, build(cfg)


@contextlib.contextmanager
def sync_free_bursts(eng):
    """Within the block every decode burst of ``eng`` runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a host sync there raises."""
    from repro_torch.engine.api import _sync_errors
    real = eng._decode_burst

    def guarded(n):
        with _sync_errors():
            real(n)

    eng._decode_burst = guarded
    try:
        yield
    finally:
        del eng._decode_burst


def serve_wave(eng, reqs):
    """One admission wave through the engine, as the serve CLI times it:
    returns (results, routes, routing s, wall s), walls ending in a
    synchronise."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    routes = eng.submit_many(reqs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = eng.run()
    torch.cuda.synchronize()
    return res, routes, t1 - t0, time.perf_counter() - t0


def hold_wave(tag, eng, state, reqs, routes, res):
    """13's gates on one wave: each route's cluster is ``engine.infer``'s
    (the accepted cluster, else the nearest), and each request's tokens
    equal ``SequentialLoop``'s on the card under the near-tie rule (ε =
    ``NEAR_TIE_EPS["cuda"]``); the loop takes the engine's router, whose
    routes were just held to ``infer``, so it runs no Ψ of its own.
    The wave's near-tie stops are bounded by ``bound_stops``."""
    from repro_torch import engine, serve
    loop = serve.SequentialLoop(eng.model, state, max_len=eng.cfg.max_len,
                                max_gen=eng.cfg.max_gen)
    loop.router = eng.router
    eps, stops, gaps = serve.NEAR_TIE_EPS["cuda"], [], []
    for r, rt in zip(reqs, routes):
        inf = engine.infer(state, r.history)
        want = inf["cluster"] if inf["cluster"] is not None else inf["seed_from"]
        assert rt.root == want, (tag, r.rid, rt, want)
        sr = loop.serve(r)
        assert sr.cluster == rt.root and len(res[r.rid].tokens) == r.gen
        stop = serve.near_tie_compare(sr.tokens, res[r.rid].tokens, sr.gaps, eps)
        if stop is not None:
            stops.append((r.rid, stop))
        gaps.append(float(sr.gaps.min()))
    share = bound_stops(tag, reqs, stops)
    print(f"[{tag}] {len(reqs)} routes equal engine.infer's; tokens equal SequentialLoop's "
          f"on the card under the near-tie rule (eps {eps:g}): {len(stops)} near-tie stops "
          f"{stops} (at most {SERVE_MAX_STOPS}), {100 * share:.1f}% of the tokens compared; "
          f"smallest top-2 gap of a reference stream {min(gaps):.3e}")


def phase_serve_qwen(dev, peaks):
    """13a: qwen2-1.5b at its full config served through the port's
    engine: the serve CLI's state, a first wave of 8 requests (the capture),
    a warm wave of 16 new clients with every burst under sync-debug mode
    "error", the same requests again (routes cached) under the profiler;
    timings, the peak memory, the gates."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import serve
    from repro_torch.launch import serve as launch_serve
    from repro_torch.utils import trees

    t_phase = time.perf_counter()
    cfg, model = serve_setting("qwen2-1.5b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    st = launch_serve.build_server_state(cfg, model, SERVE_CLUSTERS, SERVE_TAU, 0, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in trees.leaves(st.ctx.init_params))
    max_len = SERVE_PROMPT + SERVE_GEN
    eng = serve.ServeEngine(model, st, serve.ServeConfig(slots=SERVE_SLOTS, max_len=max_len,
                                                         max_gen=SERVE_GEN))
    print(f"[serve] {cfg.name} full config ({cfg.source}): {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, qkv_bias {cfg.qkv_bias}; {n_params} parameters "
          f"({n_params * 4 / 1e9:.2f} GB fp32 a model), fp32 compute, TF32 off; "
          f"build_server_state ({SERVE_CLUSTERS} clusters, Psi on the vocab matrices "
          f"sketched to 8192) {setup_s:.2f} s; {SERVE_SLOTS} slots a cluster, prompt "
          f"{SERVE_PROMPT}, gen {SERVE_GEN}; cluster models stacked as views of the bank "
          f"{eng._stacked['embed'].data_ptr() == st.models.stacked['embed'].data_ptr()}")

    first = launch_serve.make_requests(cfg, SERVE_FIRST, SERVE_PROMPT, SERVE_GEN, SERVE_CLUSTERS)
    res1, routes1, route1_s, first_s = serve_wave(eng, first)
    assert eng.captures == 1, eng.captures
    graph = eng._graph().graph
    capture_s = eng._graph().capture_s
    eng.reset()
    warm = launch_serve.make_requests(cfg, SERVE_WARM, SERVE_PROMPT, SERVE_GEN, SERVE_CLUSTERS,
                                seed_base=SERVE_FIRST)
    with sync_free_bursts(eng):
        res2, routes2, route2_s, wall = serve_wave(eng, warm)
    assert eng.captures == 1 and eng._graph().graph is graph, "the warm wave captured a graph"
    stats = eng.stats()
    n_tok = sum(len(r.tokens) for r in res2.values())
    print(f"[serve] first wave ({SERVE_FIRST} requests, capture included): first_compile_s "
          f"{first_s:.3f} (routing {route1_s:.3f} s, the capture {capture_s:.3f} s); warm wave "
          f"({SERVE_WARM} new clients, every burst under sync-debug mode 'error', no new "
          f"graph): wall_s {wall:.4f}, tokens {n_tok}, tok_per_s {n_tok / wall:.2f}; Psi "
          f"routing {route2_s * 1e3:.1f} ms for the wave ({route2_s * 1e3 / SERVE_WARM:.1f} ms "
          f"a client, one infer_batch), serving after routing {(wall - route2_s) * 1e3:.1f} ms "
          f"({n_tok / (wall - route2_s):.2f} tok/s); stats {stats}")

    # the warm wave's requests again, their routes cached: serving alone
    # under the profiler (with the routing's Psi passes in the trace too,
    # the phase took about a minute longer)
    eng.reset()
    again = [serve.Request(rid=-1 - r.rid, client_id=r.client_id, prompt=r.prompt, gen=r.gen)
             for r in warm]
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    t0 = time.perf_counter()
    with prof:
        res_again, _, _, pwall = serve_wave(eng, again)
    kernels = _device_kernels(prof)
    busy = sum(kernels.values())
    assert busy > 0, "the profiler recorded no device time"
    assert all(list(res_again[-1 - r.rid].tokens) == list(res2[r.rid].tokens) for r in warm)
    print(f"[serve] the warm wave again, routes cached, under the profiler (trace and its "
          f"parse {time.perf_counter() - t0:.1f} s): wall {pwall * 1e3:.1f} ms, device busy "
          f"{busy:.1f} ms ({100 * busy / (pwall * 1e3):.1f}%, idle "
          f"{100 - 100 * busy / (pwall * 1e3):.1f}%); tokens equal the warm wave's")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:6]:
        print(f"[serve] device {ms:9.3f} ms  {name[:90]}")
    del prof, kernels

    # device times by CUDA events, on the engine's own buffers
    params0 = eng._params_list[0]
    batch = {"tokens": torch.as_tensor(np.stack([r.prompt for r in first[:SERVE_SLOTS]]),
                                       device=dev)}
    prefill_ms = time_ms(lambda: eng._prefill(params0, batch))
    eager_ms = time_ms(lambda: eng._step(eng._stacked, eng.sl))
    replay_ms = time_ms(eng._graph().graph.replay)
    step_bytes = sum(p.numel() * p.element_size() for p in trees.leaves(eng._stacked))
    print(f"[serve] decode step over {SERVE_CLUSTERS} clusters x {SERVE_SLOTS} slots: eager "
          f"{eager_ms:.3f} ms, graph replay {replay_ms:.3f} ms (CUDA events, "
          f"{TIMED_CALLS} calls); its bytes floor {step_bytes / peaks[0] * 1e3:.3f} ms (the "
          f"{step_bytes / 1e9:.2f} GB of stacked cluster weights read once at "
          f"{peaks[0] / 1e12:.2f} TB/s); prefill of a group of {SERVE_SLOTS} x {SERVE_PROMPT} "
          f"tokens {prefill_ms:.3f} ms")

    peak = torch.cuda.max_memory_allocated() - base
    print(f"[serve] peak device memory {peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated, "
          f"from {base / 1e9:.2f} GB before the phase)")
    t0 = time.perf_counter()
    for tag, reqs, routes, res in (("first", first, routes1, res1), ("warm", warm, routes2, res2)):
        hold_wave(f"serve {tag}", eng, st, reqs, routes, res)
    print(f"[serve] the gates took {time.perf_counter() - t0:.1f} s")
    del eng, st
    torch.cuda.empty_cache()
    print(f"[serve] phase 13a took {time.perf_counter() - t_phase:.1f} s")


def phase_serve_mamba(dev):
    """13b: path 3's falcon-mamba (full width, 2 layers, ``use_pallas=True``)
    in fp32 served with 2 clusters: K5 launched forward and backward while
    routing (the router's Ψ) and held against its plain version on the
    first input Ψ gave it; none while serving (prefill and decode take the
    plain scan, which returns the state); then the gates of 13a on two
    waves. Returns (K5's launches while routing, K5's errors on y and g_C)."""
    import torch
    from repro_torch import serve
    from repro_torch.launch import serve as launch_serve

    t_phase = time.perf_counter()
    cfg, model = serve_setting("falcon-mamba-7b", n_layers=2, use_pallas=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    st = launch_serve.build_server_state(cfg, model, SERVE_CLUSTERS, SERVE_TAU, 0, device=dev)
    max_len = SERVE_PROMPT + SERVE_GEN
    eng = serve.ServeEngine(model, st, serve.ServeConfig(slots=SERVE_SLOTS, max_len=max_len,
                                                         max_gen=SERVE_GEN))
    first = launch_serve.make_requests(cfg, SERVE_MAMBA, SERVE_PROMPT, SERVE_GEN, SERVE_CLUSTERS)
    shape = (8, 256, cfg.d_inner, cfg.ssm_state)      # Psi's history batch: 8 x 256 tokens
    _zero_counts()
    with recording_first_scan(shape) as rec:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        routes1 = eng.submit_many(first)
        torch.cuda.synchronize()
        route_s = time.perf_counter() - t0
    routing = _launched()
    # Ψ takes a gradient: K5 once a layer each way, and with cfg.remat its
    # forward once more in the checkpoint's recompute
    want = SERVE_MAMBA * cfg.n_layers
    want_fwd = want * (2 if cfg.remat else 1)
    print(f"[serve3] {cfg.name} at full width, {cfg.n_layers} layers, use_pallas, fp32, "
          f"remat {cfg.remat}: routing {SERVE_MAMBA} new clients took {route_s * 1e3:.1f} ms; "
          f"launches while routing {routing} (K5 per Psi: forward {want_fwd // SERVE_MAMBA}, "
          f"backward {want // SERVE_MAMBA})")
    assert routing.get("ssm_scan.fwd_launches", 0) == want_fwd, routing
    assert routing.get("ssm_scan.bwd_launches", 0) == want, routing
    t0 = time.perf_counter()
    res1 = eng.run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    assert _launched() == routing, "serving launched a counted kernel"
    assert eng.captures == 1, eng.captures
    graph = eng._graph().graph
    eng.reset()
    warm = launch_serve.make_requests(cfg, SERVE_MAMBA, SERVE_PROMPT, SERVE_GEN, SERVE_CLUSTERS,
                                seed_base=SERVE_MAMBA)
    with sync_free_bursts(eng):
        res2, routes2, route2_s, wall = serve_wave(eng, warm)
    assert eng.captures == 1 and eng._graph().graph is graph, "the warm wave captured a graph"
    n_tok = sum(len(r.tokens) for r in res2.values())
    launches = {k: v for k, v in _launched().items() if k.startswith("ssm_scan.")}
    print(f"[serve3] first wave served in {first_s:.3f} s (the capture "
          f"{eng._graph().capture_s:.3f} s); warm wave ({SERVE_MAMBA} new clients, bursts "
          f"under sync-debug mode 'error', no new graph): wall_s {wall:.4f} (routing "
          f"{route2_s:.3f} s), tokens {n_tok}, tok_per_s {n_tok / wall:.2f}; peak device "
          f"memory {(torch.cuda.max_memory_allocated() - base) / 1e9:.2f} GB; K5 launches "
          f"in both waves' routing {launches}")
    errs = check_scan_on_path(rec[0], "serve3", "the router's first Psi input")
    del rec
    for tag, reqs, routes, res in (("first", first, routes1, res1), ("warm", warm, routes2, res2)):
        hold_wave(f"serve3 {tag}", eng, st, reqs, routes, res)
    del eng, st
    torch.cuda.empty_cache()
    print(f"[serve3] phase 13b took {time.perf_counter() - t_phase:.1f} s")
    return launches, errs


def state_on(cpu_state, model, dev):
    """The serve CLI's serving state built anew on ``dev`` from a CPU state's
    parameters (ω₀, the joined reference batches, the cluster models), so
    the two hold equal values."""
    from repro_torch import engine
    from repro_torch.core.extractor import llm_leaf_filter
    from repro_torch.engine.bank import ClusterBank
    from repro_torch.utils import trees
    st = engine.init("stocfl", model.loss_fn, cpu_state.ctx.init_params, [],
                     cpu_state.ctx.cfg, device=dev, leaf_filter=llm_leaf_filter)
    for batch in cpu_state.ctx.clients:
        st, _ = engine.join(st, batch)
    assert st.clusters.assignment() == cpu_state.clusters.assignment()
    models = {r: trees.tree_map(lambda x: x.to(dev), cpu_state.models[r])
              for r in cpu_state.models}
    return st.replace(models=ClusterBank.from_dict(models))


SMOKE13 = (("qwen2-1.5b", {}), ("falcon-mamba-7b", {"use_pallas": True}))


def phase_serve_smoke(dev, archs=SMOKE13):
    """13c (and 14e): the smoke configs of qwen2 (d_model 192, vocab 512)
    and falcon-mamba (``use_pallas=True``) in fp32 (14e: zamba2, phi3.5-moe
    and deepseek-v2), one state on the CPU and the same values on the
    card: the card's engine against the CPU's sequential loop, routes
    equal, tokens under the near-tie rule (ε = ``NEAR_TIE_EPS["cuda"]``,
    the CPU stream the reference)."""
    from repro_torch import serve
    from repro_torch.launch import serve as launch_serve

    for arch, kw in archs:
        cfg, model = serve_setting(arch, smoke=True, **kw)
        cpu = launch_serve.build_server_state(cfg, model, SERVE_CLUSTERS, SERVE_TAU, 0, device="cpu")
        card = state_on(cpu, model, dev)
        max_len = SERVE_PROMPT + SERVE_GEN
        reqs = launch_serve.make_requests(cfg, SERVE_SMOKE, SERVE_PROMPT, SERVE_GEN, SERVE_CLUSTERS)
        eng = serve.ServeEngine(model, card, serve.ServeConfig(slots=2, max_len=max_len,
                                                               max_gen=SERVE_GEN))
        res, routes, _, wall = serve_wave(eng, reqs)
        loop = serve.SequentialLoop(model, cpu, max_len=max_len, max_gen=SERVE_GEN)
        eps, stops, sims = serve.NEAR_TIE_EPS["cuda"], [], 0.0
        for r, rt in zip(reqs, routes):
            sr = loop.serve(r)
            assert sr.cluster == rt.root, (arch, r.rid)
            sims = max(sims, abs(sr.similarity - rt.similarity))
            stop = serve.near_tie_compare(sr.tokens, res[r.rid].tokens, sr.gaps, eps)
            if stop is not None:
                stops.append((r.rid, stop))
        share = bound_stops(f"serve-smoke {arch}", reqs, stops)
        print(f"[serve-smoke] {cfg.name} smoke fp32{' use_pallas' if kw else ''}: "
              f"{SERVE_SMOKE} requests on {SERVE_CLUSTERS} x 2 lanes of the card's engine "
              f"({wall:.2f} s) against the CPU's SequentialLoop: routes equal (similarity "
              f"max |cuda - cpu| {sims:.2e}), tokens equal under the near-tie rule (eps "
              f"{eps:g}): {len(stops)} near-tie stops {stops} (at most {SERVE_MAX_STOPS}), "
              f"{100 * share:.1f}% of the tokens compared")


# ----------------------------------------------------------------- phase 14
# (a) path 3's traffic through the training driver's own flags
TRAIN14 = ["--arch", "zamba2-1.2b", "--clients", "4", "--domains", "2", "--batch", "2",
           "--seq-len", "256", "--rounds", "3", "--local-steps", "5", "--sample-rate", "0.5",
           "--tau", "0.12", "--lr", "0.05", "--fused-step", "--device", "cuda"]
ZAMBA_LAYERS = 6          # 38 -> 6: one full group of 6 and one shared-block application
PHI_LAYERS = 2            # 32 -> 2
DEEPSEEK_LAYERS = 2       # 60 -> 2, moe_layer_start 1 kept (a dense layer, an MoE layer)
DEEPSEEK_ROWS, DEEPSEEK_STEPS = 4, 16
DEEPSEEK_RTOL = 1e-3      # decode logits against forward_train, of the largest |logit|


@contextlib.contextmanager
def patched(module, name, value):
    """``module.name`` is ``value`` within the block."""
    real = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def recording_first_prox_update():
    """Within the block, the first ``ops.prox_update_flat`` call (the first
    local step of the first cohort) also keeps a host copy of the (θ, ω,
    g_θ, g_ω, η, λ) it received (2 × 0.36 G fp32 each on 14a: on the card
    they would crowd the round's peak) and the seconds the copy took;
    yields the list that receives them.
    The call itself goes through unchanged, so its launch is counted once."""
    from repro_torch.kernels import ops
    real, records = ops.prox_update_flat, []

    def record(theta, omega, g_theta, g_omega, eta, lam, backend="auto"):
        if not records:
            t0 = time.perf_counter()
            ops_ = tuple(x.detach().to("cpu", copy=True) for x in (theta, omega, g_theta, g_omega))
            records.append({"ops": ops_ + (float(eta), float(lam)),
                            "copy_s": time.perf_counter() - t0})
        return real(theta, omega, g_theta, g_omega, eta, lam, backend=backend)

    with patched(ops, "prox_update_flat", record):
        yield records


@contextlib.contextmanager
def recording_rounds(profile_round=None, snapshots=False):
    """Within the block every ``engine.run_round`` is timed (ending in a
    synchronise) and recorded: cohort, wall, record, and the state after
    it; round ``profile_round`` runs under ``torch.profiler``. With
    ``snapshots`` each record also keeps ω after the round flattened on
    the host (``omega``) and the first the initial parameters (``init``).
    Yields (records, the profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import engine
    real, records = engine.run_round, []
    # device activity only: recording every host op of a round of ~10^5
    # small launches would slow it and take minutes to parse
    prof = profile(activities=[ProfilerActivity.CUDA])

    def run_round(state, client_ids=None):
        _, cohort = engine.sample_clients(state)
        traced = len(records) == profile_round
        with (prof if traced else contextlib.nullcontext()):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, rec = real(state, client_ids)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        records.append(dict(cohort=[int(c) for c in cohort], wall=wall, traced=traced,
                            n_clusters=rec["n_clusters"], merges=list(rec["merges"]),
                            state=state, omega=_flat_cpu(state.omega) if snapshots else None,
                            init=state.ctx.init_params))
        return state, rec

    with patched(engine, "run_round", run_round):
        yield records, prof


def check_prox_on_path(record, tag):
    """K1 on the operands the path's first fused step gave it, against
    ``ref.prox_update_ref_``: bitwise in fp32, in place. Returns 0.0 (the
    largest error)."""
    import torch
    from repro_torch.kernels import prox_update, ref

    th, om, gt, go, eta, lam = record
    n = th.numel()
    dev = torch.device("cuda")
    gt, go = gt.to(dev), go.to(dev)
    kt, ko = th.to(dev), om.to(dev)
    ptrs = (kt.data_ptr(), ko.data_ptr())
    before = prox_update.launches
    prox_update.prox_update_flat(kt, ko, gt, go, eta, lam)
    prox_update.launches = before             # a check, not a launch of the path
    pt, po = ref.prox_update_ref_(th.to(dev), om.to(dev), gt, go, eta, lam)
    torch.cuda.synchronize()
    exact = bool(torch.equal(kt, pt) and torch.equal(ko, po))
    print(f"[{tag}] prox_update ({th.dtype}) on the path's first local step's operands "
          f"(n={n}, eta {eta}, lam {lam}): bitwise equal to ref.prox_update_ref_={exact}, "
          f"in place={(kt.data_ptr(), ko.data_ptr()) == ptrs}")
    assert exact and (kt.data_ptr(), ko.data_ptr()) == ptrs
    return 0.0


def phase_train_zamba2(dev):
    """14a: zamba2-1.2b at full width cut to 6 layers through
    ``launch.train.run_llm``, the training driver, at path 3's traffic
    given as the driver's flags (bf16 compute, fp32 parameters, the
    engine's fp32 policy, ``--fused-step``): round walls, the peak, the
    device's busy share on round 2; K1 and K2 launches equal the counts
    reckoned from rounds, local steps and merge passes and are held
    against their plain versions on the inputs the path gave them; the
    model rows finite; Ψ bitwise repeatable. Returns (the launches, K2's
    largest error)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import cosine_sim, prox_update
    from repro_torch.launch import train
    from repro_torch.utils import trees

    t_phase = time.perf_counter()
    args = train.build_parser().parse_args(TRAIN14)
    cut = lambda arch, smoke=False: get_config(arch, smoke=smoke).with_(n_layers=ZAMBA_LAYERS)
    cfg = cut(args.arch)
    print(f"[train14] {cfg.name} at full width ({cfg.source}): d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, ssm_state "
          f"{cfg.ssm_state}, ssm_head_dim {cfg.ssm_head_dim}, d_inner {cfg.d_inner}, window "
          f"{cfg.sliding_window}; depth cut {get_config(args.arch).n_layers} -> "
          f"{cfg.n_layers} (one group of {cfg.attn_every} and one shared-block application: "
          f"one card's memory); compute {cfg.dtype}, params {cfg.param_dtype}; "
          f"python -m repro_torch.launch.train {' '.join(TRAIN14)}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _zero_counts()
    cosine_sim.padded_copies = 0
    with patched(train, "get_config", cut), recording_first_prox_update() as k1_in, \
            recording_cosine_inputs() as k2_in, recording_rounds(profile_round=2) as (recs, prof):
        out = train.run_llm(args)
    launches = _launched()
    peak = torch.cuda.max_memory_allocated() - base
    state = recs[-1]["state"]
    n_params = sum(p.numel() for p in trees.leaves(state.ctx.init_params))
    copy_s = k1_in[0]["copy_s"]
    for t, r in enumerate(recs):
        note = (f" (under the profiler)" if r["traced"] else
                f" ({(r['wall'] - copy_s) * 1e3:.1f} ms without the {copy_s:.1f} s host copy "
                f"of K1's first operands)" if t == 0 else "")
        print(f"[train14] round {t}: wall {r['wall'] * 1e3:.1f} ms{note}, cohort "
              f"{r['cohort']}, n_clusters {r['n_clusters']}, merges {r['merges']}")
    kernels = {k: ms for k, ms in _device_kernels(prof).items() if not k.startswith("stocfl.")}
    busy = sum(kernels.values())
    wall = recs[2]["wall"] * 1e3
    assert busy > 0, "the profiler recorded no device time"
    print(f"[train14] {n_params} parameters ({n_params * 4 / 1e9:.2f} GB fp32); driver JSON "
          f"{out}; peak device memory {peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated, "
          f"from {base / 1e9:.2f} GB); round 2 under the profiler: device busy {busy:.1f} ms "
          f"of {wall:.1f} ms ({100 * busy / wall:.1f}%, idle {100 - 100 * busy / wall:.1f}%)")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:6]:
        print(f"[train14] device {ms:9.2f} ms  {name[:90]}")
    del prof, kernels
    E, R = args.local_steps, args.rounds
    expect = {"prox_update.launches": R * E,
              "cosine_sim.launches": R + sum(r["n_clusters"] >= 2 for r in recs)}
    print(f"[train14] launches {launches}; reckoned K1 {R} rounds x {E} local steps, K2 one a "
          f"merge pass and one an objective with >= 2 clusters: {expect}")
    assert launches == expect, (launches, expect)
    assert cosine_sim.padded_copies == 0, "14a copied a K2 input"
    assert state.ctx.init_params["embed"].dtype == torch.float32 and len(k1_in) == 1
    assert k1_in[0]["ops"][0].dtype == torch.float32, "K1 did not take its f32 entry"
    for leaf in trees.leaves(state.omega) + trees.leaves(state.models.stacked):
        assert bool(torch.isfinite(leaf).all()), "non-finite model values"
    psi = state.ctx.extractor
    a, b = psi(state.ctx.clients[0]), psi(state.ctx.clients[0])
    same = bool(torch.equal(a, b))
    print(f"[train14] model rows finite; Psi of client 0 computed twice ({tuple(a.shape)}, "
          f"norm {float(a.norm()):.6f}): bitwise equal={same}")
    assert same and a.shape == (8192,)
    del state, psi, a, b, recs
    torch.cuda.empty_cache()
    err = check_cosine_on_records(k2_in, args.tau, "train14", 1e-5)
    check_prox_on_path(k1_in[0]["ops"], "train14")
    del k1_in, k2_in
    torch.cuda.empty_cache()
    print(f"[train14] phase 14a took {time.perf_counter() - t_phase:.1f} s")
    return {"prox_update": launches["prox_update.launches"],
            "cosine_sim": launches["cosine_sim.launches"]}, err


@contextlib.contextmanager
def recording_moe_prefills(prompt_len):
    """Within the block every MoE layer call on ``prompt_len`` positions
    (a prefill; the decode runs under vmap on 1) records (batch rows,
    routing group size, assignments dropped); yields the list."""
    from repro_torch.models import moe
    real, calls = moe.moe_ffn, []

    def record(params, x, cfg, group_size=0):
        if x.shape[1] == prompt_len:
            g = moe.group_tokens(x.shape[0] * prompt_len, group_size or cfg.moe_group_size)
            calls.append((x.shape[0], g, moe.dropped(params, x, cfg, group_size)))
        return real(params, x, cfg, group_size)

    with patched(moe, "moe_ffn", record):
        yield calls


def phase_serve_family(dev, tag, arch, n_layers, first_n, warm_n, peaks):
    """14b / 14c: a family at full width cut to ``n_layers`` served as in
    13a (the serve CLI's state with 2 clusters, 4 slots a cluster, prompt
    32, gen 16, fp32, TF32 off): a first wave (the capture), ``reset``, a
    warm wave of new clients with every burst under sync-debug mode
    "error" and the same graph; 13's gates on both waves. MoE: each
    prefill group's requests routed in groups of their own (the calls'
    group sizes asserted), multi-request prefill groups formed
    (asserted), the assignments capacity dropped there printed."""
    import numpy as np
    import torch
    from repro_torch import serve
    from repro_torch.launch import serve as launch_serve
    from repro_torch.utils import trees

    t_phase = time.perf_counter()
    cfg, model = serve_setting(arch, n_layers=n_layers)
    full = serve_setting(arch)[0]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    st = launch_serve.build_server_state(cfg, model, SERVE_CLUSTERS, SERVE_TAU, 0, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in trees.leaves(st.ctx.init_params))
    max_len = SERVE_PROMPT + SERVE_GEN
    eng = serve.ServeEngine(model, st, serve.ServeConfig(slots=SERVE_SLOTS, max_len=max_len,
                                                         max_gen=SERVE_GEN))
    print(f"[{tag}] {cfg.name} at full width ({cfg.source}), depth cut {full.n_layers} -> "
          f"{cfg.n_layers} (one card's memory: 3 models, the omega_0 anchor and 2 cluster "
          f"models): {n_params} parameters ({n_params * 4 / 1e9:.2f} GB fp32 a model), fp32 "
          f"compute, TF32 off; build_server_state {setup_s:.2f} s; {SERVE_SLOTS} slots a "
          f"cluster, prompt {SERVE_PROMPT}, gen {SERVE_GEN}")
    first = launch_serve.make_requests(cfg, first_n, SERVE_PROMPT, SERVE_GEN, SERVE_CLUSTERS)
    moe_ctx = recording_moe_prefills(SERVE_PROMPT) if cfg.n_experts else \
        contextlib.nullcontext([])
    with moe_ctx as calls:
        res1, routes1, route1_s, first_s = serve_wave(eng, first)
    assert eng.captures == 1, eng.captures
    graph = eng._graph().graph
    stats1 = eng.stats()
    if cfg.n_experts:
        multi = [c for c in calls if c[0] >= 2]
        print(f"[{tag}] first wave: {stats1['prefill_groups']} prefill groups for "
              f"{stats1['admitted']} requests; MoE prefill calls (rows, routing group, "
              f"assignments dropped at capacity factor {cfg.capacity_factor}): {calls}")
        assert multi, "no multi-request prefill group formed"
        assert all(g == SERVE_PROMPT for _, g, _ in calls), calls
    eng.reset()
    warm = launch_serve.make_requests(cfg, warm_n, SERVE_PROMPT, SERVE_GEN, SERVE_CLUSTERS,
                                      seed_base=first_n)
    with sync_free_bursts(eng):
        res2, routes2, route2_s, wall = serve_wave(eng, warm)
    assert eng.captures == 1 and eng._graph().graph is graph, "the warm wave captured a graph"
    n_tok = sum(len(r.tokens) for r in res2.values())
    print(f"[{tag}] first wave ({first_n} requests): first_compile_s {first_s:.3f} (routing "
          f"{route1_s:.3f} s, the capture {eng._graph().capture_s:.3f} s); warm wave "
          f"({warm_n} new clients, bursts under sync-debug mode 'error', no new graph): "
          f"wall_s {wall:.4f}, tokens {n_tok}, tok_per_s {n_tok / wall:.2f}; Psi routing "
          f"{route2_s * 1e3:.1f} ms ({route2_s * 1e3 / warm_n:.1f} ms a client), serving "
          f"after routing {(wall - route2_s) * 1e3:.1f} ms ({n_tok / (wall - route2_s):.2f} "
          f"tok/s); stats {eng.stats()}")
    params0 = eng._params_list[0]
    batch = {"tokens": torch.as_tensor(np.stack([r.prompt for r in first[:SERVE_SLOTS]]),
                                       device=dev)}
    prefill_ms = time_ms(lambda: eng._prefill(params0, batch))
    eager_ms = time_ms(lambda: eng._step(eng._stacked, eng.sl))
    replay_ms = time_ms(eng._graph().graph.replay)
    step_bytes = sum(p.numel() * p.element_size() for p in trees.leaves(eng._stacked))
    peak = torch.cuda.max_memory_allocated() - base
    print(f"[{tag}] decode step over {SERVE_CLUSTERS} clusters x {SERVE_SLOTS} slots: eager "
          f"{eager_ms:.3f} ms, graph replay {replay_ms:.3f} ms (CUDA events, {TIMED_CALLS} "
          f"calls); its bytes floor {step_bytes / peaks[0] * 1e3:.3f} ms ({step_bytes / 1e9:.2f}"
          f" GB of stacked cluster weights at {peaks[0] / 1e12:.2f} TB/s); prefill of a group "
          f"of {SERVE_SLOTS} x {SERVE_PROMPT} tokens {prefill_ms:.3f} ms; peak device memory "
          f"{peak / 1e9:.2f} GB (from {base / 1e9:.2f} GB)")
    for wave, reqs, routes, res in (("first", first, routes1, res1), ("warm", warm, routes2, res2)):
        hold_wave(f"{tag} {wave}", eng, st, reqs, routes, res)
    del eng, st
    torch.cuda.empty_cache()
    print(f"[{tag}] phase took {time.perf_counter() - t_phase:.1f} s")


def phase_deepseek_model(dev):
    """14d: deepseek-v2-236b at full width cut to 2 layers (a dense layer
    0, an MoE layer), fp32, TF32 off, at the model level: ``prefill`` of
    4 prompts x 32 tokens, then 16 greedy ``decode_step``s with one
    position per row (the absorbed MLA decode, each row its own MoE
    group). Gates: prefill's last logits equal ``forward_train``'s last
    position (the same routing groups); each step's logits equal
    ``forward_train`` over each row's prefix under
    ``cfg.with_(moe_group_size=1)`` (each token its own group, as the
    per-row decode routes it) within 1e-3 of the largest |logit|; the
    tokens follow the near-tie rule against those forward passes."""
    import numpy as np
    import torch
    from repro_torch import serve
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_lm_batch
    from repro_torch.models.registry import build
    from repro_torch.utils import trees

    t_phase = time.perf_counter()
    full = get_config("deepseek-v2-236b")
    cfg = full.with_(dtype="float32", n_layers=DEEPSEEK_LAYERS)
    model, single = build(cfg), build(cfg.with_(moe_group_size=1))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(p.numel() for p in trees.leaves(params))
    print(f"[mla14] {cfg.name} at full width ({cfg.source}): d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}, MLA r {cfg.kv_lora_rank} rope {cfg.qk_rope_dim} nope "
          f"{cfg.qk_nope_dim} v {cfg.v_head_dim}, dense d_ff {cfg.d_ff}, {cfg.n_experts} "
          f"routed top-{cfg.moe_top_k} + {cfg.n_shared_experts} shared, expert d_ff "
          f"{cfg.moe_d_ff}, vocab {cfg.vocab_size}; depth cut {full.n_layers} -> "
          f"{cfg.n_layers} (moe_layer_start {cfg.moe_layer_start} kept; one card's memory: "
          f"one model); {n_params} parameters ({n_params * 4 / 1e9:.2f} GB fp32)")
    tokens = torch.as_tensor(synthetic_lm_batch(cfg, SERVE_PROMPT, DEEPSEEK_ROWS, seed=7,
                                                domain=0)["tokens"], device=dev)
    total = SERVE_PROMPT + DEEPSEEK_STEPS
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        full_logits, _ = model.forward_train(params, {"tokens": tokens})
        scale = float(full_logits[:, -1].abs().max())
        pre_err = float((logits - full_logits[:, -1]).abs().max())
        print(f"[mla14] prefill of {DEEPSEEK_ROWS} x {SERVE_PROMPT} tokens {prefill_s * 1e3:.1f} "
              f"ms (first call); last logits against forward_train's: max |diff| "
              f"{pre_err:.3e} of max |logit| {scale:.3f}")
        assert pre_err <= DEEPSEEK_RTOL * scale
        from repro_torch.models.registry import grow_cache
        cache = grow_cache(model, cache, DEEPSEEK_ROWS, total)
        pos = torch.full((DEEPSEEK_ROWS,), SERVE_PROMPT, dtype=torch.int32, device=dev)
        tok = torch.argmax(logits, -1).to(torch.int32)
        seq, walls, worst = [tokens, tok[:, None]], [], 0.0
        ref_tokens, got_tokens, gaps = [], [], []
        for t in range(DEEPSEEK_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = model.decode(params, tok, cache, pos)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            prefix = torch.cat(seq, 1)
            want = single.forward_train(params, {"tokens": prefix})[0][:, -1]
            err = float((logits - want).abs().max()) / float(want.abs().max())
            worst = max(worst, err)
            assert err <= DEEPSEEK_RTOL, (t, err)
            tok = torch.argmax(logits, -1).to(torch.int32)
            got_tokens.append(tok.cpu().numpy())
            ref_tokens.append(torch.argmax(want, -1).cpu().numpy())
            gaps.append(serve.top2_gap(want).cpu().numpy())
            seq.append(tok[:, None])
            pos = pos + 1
    stops = []
    for b in range(DEEPSEEK_ROWS):
        stop = serve.near_tie_compare([r[b] for r in ref_tokens], [g[b] for g in got_tokens],
                                      [g[b] for g in gaps], serve.NEAR_TIE_EPS["cuda"])
        if stop is not None:
            stops.append((b, stop))
    peak = torch.cuda.max_memory_allocated() - base
    print(f"[mla14] {DEEPSEEK_STEPS} decode steps (per-row positions, absorbed MLA): "
          f"{np.mean(walls[1:]) * 1e3:.2f} ms a step after the first ({walls[0] * 1e3:.1f} "
          f"ms); logits against forward_train over each row's prefix at moe_group_size=1: "
          f"largest |diff| / max |logit| {worst:.3e} (gate {DEEPSEEK_RTOL:g}); tokens equal "
          f"under the near-tie rule (eps {serve.NEAR_TIE_EPS['cuda']:g}): {len(stops)} stops "
          f"{stops}; peak device memory {peak / 1e9:.2f} GB")
    assert len(stops) <= SERVE_MAX_STOPS, stops
    del params, cache
    torch.cuda.empty_cache()
    print(f"[mla14] phase 14d took {time.perf_counter() - t_phase:.1f} s")


def phase_14(dev, peaks):
    """Phase 14: the MoE, MLA and hybrid families and the training
    driver. Returns (K1 and K2 launches of 14a, K2's largest error)."""
    t0 = time.perf_counter()
    launches, err = phase_train_zamba2(dev)
    phase_serve_family(dev, "serve14z", "zamba2-1.2b", ZAMBA_LAYERS, 8, 16, peaks)
    phase_serve_family(dev, "serve14m", "phi3.5-moe-42b-a6.6b", PHI_LAYERS, 8, 16, peaks)
    phase_deepseek_model(dev)
    phase_serve_smoke(dev, (("zamba2-1.2b", {}), ("phi3.5-moe-42b-a6.6b", {}),
                            ("deepseek-v2-236b", {})))
    print(f"[phase14] took {time.perf_counter() - t0:.1f} s")
    return launches, err


# ----------------------------------------------------------------- phase 15
# (a) path 3's traffic through the training driver's own flags, whisper uncut
TRAIN15 = ["--arch", "whisper-medium", "--clients", "4", "--domains", "2", "--batch", "2",
           "--seq-len", "256", "--rounds", "3", "--local-steps", "5", "--sample-rate", "0.5",
           "--tau", "0.12", "--lr", "0.05", "--fused-step", "--dtype", "bfloat16",
           "--device", "cuda"]
WHISPER_PARAMS = 811_358_208      # whisper-medium's full config
INTERNVL_LAYERS = 2               # 48 -> 2
INTERNVL_PARAMS = 1_955_211_264   # internvl2-26b's widths at 2 layers
ENCDEC_ROWS, ENCDEC_PROMPT, ENCDEC_STEPS = 4, 32, 16
DECODE_RTOL = 1e-3                # decode logits against forward_train, of the largest |logit|
REMAT_GRAD_RTOL = 1e-3            # 15b: gradients with remat on against off, of the largest |g|
# (d) the smoke configs through the driver, on the card and on the CPU
SMOKE15 = ["--smoke", "--clients", "4", "--domains", "2", "--batch", "2", "--seq-len", "64",
           "--rounds", "3", "--local-steps", "5", "--sample-rate", "0.5", "--tau", "0.12",
           "--lr", "0.05", "--fused-step"]


def reckoned_rounds(recs, local_steps, k1="prox_update.launches"):
    """K1 once a local step; K2 once a merge pass and once an objective
    with 2 clusters or more."""
    return {k1: len(recs) * local_steps,
            "cosine_sim.launches": len(recs) + sum(r["n_clusters"] >= 2 for r in recs)}


def phase_train_whisper(dev):
    """15a: whisper-medium uncut (24 + 24 layers, 1500 frames) through
    ``launch.train.run_llm`` with path 3's traffic as the driver's flags
    (``TRAIN15``: the config's bf16 compute and fp32 parameters, the
    engine's bf16 policy, ``--fused-step``), remat on: round walls, the
    peak, the device's busy share on round 2; K1's bf16 entry and K2
    launched as reckoned, held against their plain versions on the inputs
    the path gave them (K1 bitwise); the model rows finite; Ψ bitwise
    repeatable. Returns (the launches, K2's largest error)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import cosine_sim
    from repro_torch.launch import train
    from repro_torch.utils import trees

    t_phase = time.perf_counter()
    args = train.build_parser().parse_args(TRAIN15)
    cfg = get_config(args.arch)
    print(f"[train15] {cfg.name} uncut ({cfg.source}): {cfg.n_enc_layers} encoder + "
          f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, heads {cfg.n_heads}/"
          f"{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.enc_seq} frames, "
          f"remat {cfg.remat}; compute {cfg.dtype}, params {cfg.param_dtype}, engine dtype "
          f"{args.dtype}; no cut (the bf16 policy's model state fits one card); "
          f"python -m repro_torch.launch.train {' '.join(TRAIN15)}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _zero_counts()
    cosine_sim.padded_copies = 0
    with recording_first_prox_update() as k1_in, recording_cosine_inputs() as k2_in, \
            recording_rounds(profile_round=2) as (recs, prof):
        out = train.run_llm(args)
    launches = _launched()
    peak = torch.cuda.max_memory_allocated() - base
    state = recs[-1]["state"]
    n_params = sum(p.numel() for p in trees.leaves(state.ctx.init_params))
    copy_s = k1_in[0]["copy_s"]
    for t, r in enumerate(recs):
        note = (" (under the profiler)" if r["traced"] else
                f" ({(r['wall'] - copy_s) * 1e3:.1f} ms without the {copy_s:.1f} s host copy "
                f"of K1's first operands)" if t == 0 else "")
        print(f"[train15] round {t}: wall {r['wall'] * 1e3:.1f} ms{note}, cohort "
              f"{r['cohort']}, n_clusters {r['n_clusters']}, merges {r['merges']}")
    kernels = _device_kernels(prof)
    busy = sum(kernels.values())
    wall = recs[2]["wall"] * 1e3
    assert busy > 0, "the profiler recorded no device time"
    print(f"[train15] {n_params} parameters; driver JSON {out}; peak device memory "
          f"{peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated, from {base / 1e9:.2f} GB); "
          f"round 2 under the profiler: device busy {busy:.1f} ms of {wall:.1f} ms "
          f"({100 * busy / wall:.1f}%, idle {100 - 100 * busy / wall:.1f}%)")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:6]:
        print(f"[train15] device {ms:9.2f} ms  {name[:90]}")
    del prof, kernels
    assert n_params == WHISPER_PARAMS, n_params
    expect = reckoned_rounds(recs, args.local_steps)
    print(f"[train15] launches {launches}; reckoned: K1 {args.rounds} rounds x "
          f"{args.local_steps} local steps, K2 one a merge pass and one an objective with >= 2 "
          f"clusters: {expect}")
    assert launches == expect, (launches, expect)
    assert cosine_sim.padded_copies == 0, "15a copied a K2 input"
    assert len(k1_in) == 1 and k1_in[0]["ops"][0].dtype == torch.bfloat16, \
        "K1 did not take its bf16 entry"
    for leaf in trees.leaves(state.omega) + trees.leaves(state.models.stacked):
        assert bool(torch.isfinite(leaf).all()), "non-finite model values"
    psi = state.ctx.extractor
    a, b = psi(state.ctx.clients[0]), psi(state.ctx.clients[0])
    same = bool(torch.equal(a, b))
    print(f"[train15] model rows finite; Psi of client 0 computed twice ({tuple(a.shape)}, "
          f"norm {float(a.norm()):.6f}): bitwise equal={same}")
    assert same and a.shape == (8192,)
    del state, psi, a, b, recs
    torch.cuda.empty_cache()
    err = check_cosine_on_records(k2_in, args.tau, "train15", 1e-5)
    check_prox_on_path(k1_in[0]["ops"], "train15")
    del k1_in, k2_in
    torch.cuda.empty_cache()
    print(f"[train15] phase 15a took {time.perf_counter() - t_phase:.1f} s")
    return {"prox_update_bf16": launches["prox_update.launches"],
            "cosine_sim": launches["cosine_sim.launches"]}, err


def loss_and_grad_peak(model, params, batch):
    """One loss and gradient: (loss, gradients, peak bytes above the start,
    wall s)."""
    import torch
    from repro_torch.utils import trees
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    p = trees.tree_map(lambda x: x.detach().requires_grad_(True), params)
    loss = model.loss_fn(p, batch)
    grads = torch.autograd.grad(loss, trees.leaves(p))
    torch.cuda.synchronize()
    return float(loss), grads, torch.cuda.max_memory_allocated() - base, time.perf_counter() - t0


def check_decode(tag, model, params, extra, tokens, offset=0):
    """``prefill`` of ``tokens`` (with the batch's non-token inputs
    ``extra``), then ENCDEC_STEPS greedy ``decode_step``s with one position
    per row, each step's logits held against ``forward_train``'s at the
    same position within DECODE_RTOL of its largest |logit|. ``offset``:
    the positions before the tokens (a VLM's patches). Returns the worst
    relative error and the decode ms a step."""
    import numpy as np
    import torch
    from repro_torch.models.registry import grow_cache

    rows, prompt = tokens.shape
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {**extra, "tokens": tokens})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        want = model.forward_train(params, {**extra, "tokens": tokens})[0][:, -1]
        worst = float((logits - want).abs().max()) / float(want.abs().max())
        assert worst <= DECODE_RTOL, ("prefill", worst)
        cache = grow_cache(model, cache, rows, offset + prompt + ENCDEC_STEPS)
        pos = torch.full((rows,), offset + prompt, dtype=torch.int32, device=tokens.device)
        tok = torch.argmax(logits, -1).to(tokens.dtype)
        seq, walls = [tokens, tok[:, None]], []
        for t in range(ENCDEC_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = model.decode(params, tok, cache, pos)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            want = model.forward_train(params, {**extra, "tokens": torch.cat(seq, 1)})[0][:, -1]
            err = float((logits - want).abs().max()) / float(want.abs().max())
            assert err <= DECODE_RTOL, (t, err)
            worst = max(worst, err)
            tok = torch.argmax(logits, -1).to(tokens.dtype)
            seq.append(tok[:, None])
            pos = pos + 1
    step_ms = float(np.mean(walls[1:])) * 1e3
    print(f"[{tag}] fp32 compute, TF32 off: prefill of {rows} x {prompt} tokens "
          f"{prefill_s * 1e3:.1f} ms (first call), {ENCDEC_STEPS} decode steps with a position "
          f"per row, {step_ms:.2f} ms a step after the first ({walls[0] * 1e3:.1f} ms); logits "
          f"against forward_train at the same position: largest |diff| / max |logit| "
          f"{worst:.3e} (gate {DECODE_RTOL:g})")
    del cache
    return worst, step_ms


def phase_whisper_model(dev):
    """15b: whisper-medium's full config at the model level: one loss and
    gradient on one client's batch of 15a (2 x 1500 frames, 2 x 256
    tokens) in the config's bf16 compute with remat on and then off (the
    peak with remat below the peak without; the gradients within
    REMAT_GRAD_RTOL of the largest |g|); then in fp32 compute ``prefill``
    of 4 x 32 tokens over 1500 frames and 16 decode steps against
    ``forward_train``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_lm_batch
    from repro_torch.models.registry import build

    t_phase = time.perf_counter()
    cfg = get_config("whisper-medium")
    params = build(cfg).init(torch.Generator(device=dev).manual_seed(0), dev)
    data = synthetic_lm_batch(cfg, 256, 2, seed=0, domain=0)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in data.items()}
    runs = {}
    for remat in (True, False):
        runs[remat] = loss_and_grad_peak(build(cfg.with_(remat=remat)), params, batch)
    (l_on, g_on, p_on, w_on), (l_off, g_off, p_off, w_off) = runs[True], runs[False]
    err = max(float((a - b).abs().max()) for a, b in zip(g_on, g_off))
    scale = max(float(b.abs().max()) for b in g_off)
    print(f"[whisper15] {cfg.name} full config, {cfg.dtype} compute, one loss and gradient on "
          f"2 x {cfg.enc_seq} frames + 2 x 256 tokens: remat on peak {p_on / 1e9:.2f} GB, "
          f"{w_on * 1e3:.1f} ms, loss {l_on:.6f}; remat off peak {p_off / 1e9:.2f} GB, "
          f"{w_off * 1e3:.1f} ms, loss {l_off:.6f}; gradients largest |on - off| {err:.3e} of "
          f"max |g| {scale:.3e} (gate {REMAT_GRAD_RTOL:g})")
    assert p_on < p_off, (p_on, p_off)
    assert err <= REMAT_GRAD_RTOL * scale
    del runs, g_on, g_off, batch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model = build(cfg.with_(dtype="float32"))
    data = synthetic_lm_batch(cfg, ENCDEC_PROMPT, ENCDEC_ROWS, seed=7, domain=0)
    frames = torch.as_tensor(data["frames"], device=dev)
    check_decode("whisper15", model, params, {"frames": frames},
                 torch.as_tensor(data["tokens"], device=dev))
    print(f"[whisper15] decode check peak {(torch.cuda.max_memory_allocated() - base) / 1e9:.2f}"
          f" GB; phase 15b took {time.perf_counter() - t_phase:.1f} s")
    del params
    torch.cuda.empty_cache()


def phase_internvl_model(dev):
    """15c: internvl2-26b at full width cut to 2 layers at the model level:
    one loss and gradient on 2 x (1024 patches + 256 text tokens) in the
    config's bf16 compute with remat; then in fp32 compute ``prefill`` of
    4 x (1024 + 32) and 16 decode steps against ``forward_train``. No
    training round: the vocabulary leaves alone are 1.137 G parameters,
    about 54 GB at path 3's 48 B a parameter in the bf16 policy, and each
    layer adds about 19 GB."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_lm_batch
    from repro_torch.models.registry import build
    from repro_torch.utils import trees

    t_phase = time.perf_counter()
    full = get_config("internvl2-26b")
    cfg = full.with_(n_layers=INTERNVL_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = build(cfg).init(torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(p.numel() for p in trees.leaves(params))
    print(f"[vlm15] {cfg.name} at full width ({cfg.source}): d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.n_patches} patches; depth cut {full.n_layers} -> {cfg.n_layers} (one card's "
          f"memory; no training round: the vocab leaves alone would take ~54 GB in the bf16 "
          f"policy); {n_params} parameters ({n_params * 4 / 1e9:.2f} GB fp32)")
    assert n_params == INTERNVL_PARAMS, n_params
    data = synthetic_lm_batch(cfg, cfg.n_patches + 256, 2, seed=0, domain=0)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in data.items()}
    loss, grads, peak, wall = loss_and_grad_peak(build(cfg), params, batch)
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    print(f"[vlm15] {cfg.dtype} compute, remat {cfg.remat}: one loss and gradient on 2 x "
          f"({cfg.n_patches} patches + {batch['tokens'].shape[1]} text tokens): loss "
          f"{loss:.6f}, {wall * 1e3:.1f} ms, gradients finite={finite}; peak "
          f"{peak / 1e9:.2f} GB above the parameters")
    assert finite and loss == loss
    del grads, batch
    torch.cuda.empty_cache()
    model = build(cfg.with_(dtype="float32"))
    data = synthetic_lm_batch(cfg, cfg.n_patches + ENCDEC_PROMPT, ENCDEC_ROWS, seed=7, domain=0)
    check_decode("vlm15", model, params, {"patches": torch.as_tensor(data["patches"], device=dev)},
                 torch.as_tensor(data["tokens"], device=dev), offset=cfg.n_patches)
    print(f"[vlm15] peak device memory {(torch.cuda.max_memory_allocated() - base) / 1e9:.2f} "
          f"GB; phase 15c took {time.perf_counter() - t_phase:.1f} s")
    del params
    torch.cuda.empty_cache()


def phase_train_smoke15(dev):
    """15d: the two families' smoke configs (the full configs' bf16
    compute) through ``run_llm`` with ``SMOKE15``, on the card and on the
    CPU from the same parameters (drawn on the CPU): cohorts, n_clusters
    and ARI equal, ω's update after round 0 within LLM_UPDATE_RTOL; K1
    and K2 launched on the card as reckoned. Returns the card's
    launches."""
    import torch
    from repro_torch.launch import train

    total = {}
    cpu_generator = lambda _dev, seed: torch.Generator().manual_seed(seed)
    for arch in ("whisper-medium", "internvl2-26b"):
        runs = {}
        for device in ("cuda", "cpu"):
            args = train.build_parser().parse_args(SMOKE15 + ["--arch", arch, "--device", device])
            _zero_counts()
            with patched(train, "_generator", cpu_generator), \
                    recording_rounds(snapshots=True) as (recs, _):
                out = train.run_llm(args)
            runs[device] = (out, recs, _launched())
        (out, recs, launches), (cout, crecs, _) = runs["cuda"], runs["cpu"]
        omega0 = _flat_cpu(recs[0]["init"])
        rel = update_rels([{"omega": r["omega"]} for r in recs[:1]],
                          [{"omega": r["omega"]} for r in crecs[:1]], omega0)[0]
        expect = reckoned_rounds(recs, args.local_steps)
        print(f"[smoke15] {arch} smoke through run_llm, card against CPU: cohorts "
              f"{[r['cohort'] for r in recs]}, n_clusters {[r['n_clusters'] for r in recs]}, "
              f"ari {out['ari']:.4f} / {cout['ari']:.4f}; omega update after round 0 "
              f"|du_cuda - du_cpu| / |du_cpu| {rel:.3e} (tol {LLM_UPDATE_RTOL:g}, bf16 compute); "
              f"launches on the card {launches} (reckoned {expect})")
        for key in ("cohort", "n_clusters"):
            assert [r[key] for r in recs] == [r[key] for r in crecs], (arch, key)
        assert out["ari"] == cout["ari"] and out["n_clusters"] == cout["n_clusters"]
        assert rel <= LLM_UPDATE_RTOL
        assert launches == expect, (launches, expect)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    return total


def phase_15(dev):
    """Phase 15: the encoder-decoder and VLM families. Returns (launches
    by kernels-line name, K2's largest error)."""
    t0 = time.perf_counter()
    launches, err = phase_train_whisper(dev)
    phase_whisper_model(dev)
    phase_internvl_model(dev)
    smoke = phase_train_smoke15(dev)
    launches["prox_update"] = smoke["prox_update.launches"]
    launches["cosine_sim"] += smoke["cosine_sim.launches"]
    print(f"[phase15] took {time.perf_counter() - t0:.1f} s")
    return launches, err


# ----------------------------------------------------------------- phase 16
MESH_FLAG = "--mesh-rank"       # runs mesh_rank_main, one rank of phase 16
TRAIN16_FLAG = "--train16"      # runs train16_main, 16c's torchrun worker
MESH_ROUNDS = 3                 # 16a / 16b: eager rounds of each path
MESH_SPAN = 5                   # 16a: the captured run_rounds span
MESH_RTOL, MESH_ATOL = 2e-5, 1e-6   # 16b against 16a: the reference's mesh tolerance
MESH_TIMEOUT_S = 240            # one world of phase 16
TRAIN16 = ["--rounds", "8", "--clients", "24", "--sample-rate", "0.5", "--algo", "stocfl"]
TRAIN16_SSM = ["--arch", "falcon-mamba-7b", "--smoke", "--rounds", "3",
               "--clients", "4", "--domains", "2", "--seq-len", "64", "--batch", "2",
               "--sample-rate", "0.5"]


def mesh_snapshot(state) -> dict:
    """A state on the host: ω, bank and personal rows, the partition (and
    Ψ reps), members, records, rng position."""
    import numpy as np
    from repro_torch import convert
    out = {"round": state.round, "left": sorted(state.left), "members": state.members,
           "history": [{k: v for k, v in r.items() if k != "merges"} for r in state.history],
           "omega": convert.to_numpy(state.omega),
           "models": {int(r): convert.to_numpy(state.models[r]) for r in state.models.roots},
           "rng_key": None if state.rng_key is None else state.rng_key.cpu().numpy(),
           "rng_state": json.dumps(state.rng_state, sort_keys=True, default=str)}
    clusters = state.clusters
    out["assignment"] = clusters.assignment()
    if hasattr(clusters, "arrays"):
        a = clusters.arrays()
        out["parent"], out["live"] = a["parent"], a["live"]
        out["reps"] = {int(c): np.asarray(a["rep"])[c] for c in clusters.seen}
    else:
        out["reps"] = {int(c): clusters.reps[c].cpu().numpy() for c in clusters.seen}
    return out


def mesh_match(ref, got, exact):
    """``got`` against ``ref``: bitwise when ``exact``; otherwise integers
    (keys, partition, Ψ reps, members, rounds, records' integers) exact
    and floats within MESH_RTOL / MESH_ATOL. Returns the largest float
    difference."""
    import numpy as np
    for key in ("round", "left", "members", "assignment", "rng_state"):
        assert ref[key] == got[key], key
    for key in ("parent", "live"):
        if key in ref:
            assert np.array_equal(ref[key], got[key]), key
    if ref["rng_key"] is not None:
        assert np.array_equal(ref["rng_key"], got["rng_key"]), "PRNG key"
    assert set(ref["reps"]) == set(got["reps"])
    for c in ref["reps"]:
        assert np.array_equal(ref["reps"][c], got["reps"][c]), f"Psi rep of client {c}"
    worst = 0.0
    for hr, hg in zip(ref["history"], got["history"], strict=True):
        assert set(hr) == set(hg)
        for k, v in hr.items():
            if isinstance(v, float) and not exact:
                assert np.isclose(hg[k], v, rtol=MESH_RTOL, atol=MESH_ATOL), k
                worst = max(worst, abs(hg[k] - v))
            else:
                assert v == hg[k], k
    assert set(ref["models"]) == set(got["models"]), "bank roots"
    pairs = [(ref["omega"], got["omega"])] + [(ref["models"][r], got["models"][r])
                                              for r in ref["models"]]
    for a, b in pairs:
        for k in a:
            if exact:
                assert np.array_equal(a[k], b[k]), k
            else:
                np.testing.assert_allclose(b[k], a[k], rtol=MESH_RTOL, atol=MESH_ATOL,
                                           err_msg=k)
                worst = max(worst, float(np.abs(a[k] - b[k]).max()))
    return worst


@contextlib.contextmanager
def recording_k1_sizes():
    """Within the block, the element count of every
    ``ops.prox_update_flat`` call's θ (the cohort rows × P, flattened) is
    appended to the yielded list."""
    from repro_torch.kernels import ops
    real, rows = ops.prox_update_flat, []

    def record(theta, omega, g_theta, g_omega, eta, lam, backend="auto"):
        rows.append(int(theta.numel()))
        return real(theta, omega, g_theta, g_omega, eta, lam, backend=backend)

    with patched(ops, "prox_update_flat", record):
        yield rows


def _mesh_eager(mesh, cfg, rounds):
    """``rounds`` eager rounds of the main setting under ``cfg`` on
    ``mesh`` (None: no mesh): (snapshots, round walls in ms, launches)."""
    import torch
    from repro_torch import engine
    from repro_torch.kernels import _build
    clients, _, params, loss, _cfg = main_setting()
    dev = torch.device("cuda", torch.cuda.current_device())
    state = engine.init("stocfl", loss, params, clients, cfg, device=dev, arena=True,
                        mesh=mesh)
    _zero_counts()
    snaps, walls = [], []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = engine.run_round(state)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        snaps.append(mesh_snapshot(state))
    return snaps, walls, {k: v for k, v in _build.launch_counts().items() if v}


def _mesh_span(mesh, cfg):
    """16a's captured span: ``run_rounds(MESH_SPAN)`` twice from one
    ``init`` (the first call captures, the second only replays): (final
    snapshot, first and second call's ms, the captured round's launches,
    the first call's launches)."""
    import torch
    from repro_torch import engine
    from repro_torch.engine.api import RoundProgram
    from repro_torch.kernels import _build
    clients, _, params, loss, _cfg = main_setting()
    dev = torch.device("cuda", torch.cuda.current_device())
    start = engine.init("stocfl", loss, params, clients, cfg, device=dev, arena=True,
                        mesh=mesh)
    _zero_counts()
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final = engine.run_rounds(start, MESH_SPAN)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if len(walls) == 1:
            launched = {k: v for k, v in _build.launch_counts().items() if v}
    program = next(v for v in start.ctx.cache.values() if isinstance(v, RoundProgram))
    return mesh_snapshot(final), walls, dict(program.per_round), launched


def ordered_add_check(dev, deterministic):
    """The fixed-order segment add (``sharding.ordered_index_add_``)
    against ``index_add_`` at the cohort aggregate's shape (40 rows of
    153,610 into 4 segments): with deterministic algorithms on, the two
    must be the same bits (16a holds mesh runs, which take the ordered
    add, bitwise against no-mesh runs, which take ``index_add_``); with
    them off, the ordered add must repeat bit for bit, while the atomics
    may not. Returns the counts and each op's ms a call (10 calls after
    one warm-up, host clock around a synchronise)."""
    import torch
    from repro_torch.sharding import specs
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((40, 153610), device=dev, generator=g)
    idx = torch.randint(0, 4, (40,), device=dev, generator=g)
    ordered = lambda: specs.ordered_index_add_(torch.zeros((4, 153610), device=dev), idx, x)
    atomic = lambda: torch.zeros((4, 153610), device=dev).index_add_(0, idx, x)
    first_o, first_a = ordered(), atomic()
    out = {"ordered_repeats": sum(torch.equal(first_o, ordered()) for _ in range(10)),
           "atomic_repeats": sum(torch.equal(first_a, atomic()) for _ in range(10)),
           "same_bits": bool(torch.equal(first_o, first_a))}
    for name, fn in (("ordered_ms", ordered), ("atomic_ms", atomic)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e2
    assert out["ordered_repeats"] == 10, out
    if deterministic:
        assert out["same_bits"], out
    return out


def mesh_rank_main(spec) -> int:
    """One rank of phase 16 (``chip_smoke.py --mesh-rank SPEC``): joins the
    world of ``spec`` through a FileStore, builds ``make_client_mesh()``
    and runs its part; writes its results to ``spec["out"]``.

    16a (one rank, NCCL): paths 1 and 2 eagerly without and with the mesh,
    then path 2's captured span without and with it, under deterministic
    algorithms.
    16b (two ranks on the one card, gloo, the engine's own setting):
    paths 1 and 2 eagerly with the mesh, the size of each K1 launch's θ
    recorded; then ``run_rounds``, which must refuse."""
    import datetime
    import pickle

    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_client_mesh
    from repro_torch.sharding import specs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if spec["deterministic"]:
        # without a mesh the card's index_add_ sums in no fixed order
        # (atomics), so two runs of one round differ in the last bits;
        # deterministic algorithms (and CUBLAS_WORKSPACE_CONFIG, set by
        # the parent) make 16a's bitwise gate a statement about the mesh,
        # not about the atomics. 16b runs without them: the engine itself
        # keeps its ranks equal.
        t_det = time.perf_counter()
        torch.use_deterministic_algorithms(True)
        det_switch_ms = (time.perf_counter() - t_det) * 1e3
    rank, world = spec["rank"], spec["world"]
    os.environ["LOCAL_RANK"] = str(rank)
    torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(spec["backend"], store=dist.FileStore(spec["store"], world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    mesh = make_client_mesh()
    assert specs.mesh_backend(mesh) == spec["backend"]
    _, _, _, _, cfg = main_setting()
    paths = {"path1": cfg, "path2": path2_config(cfg, rng_backend="device")}
    out = {"backend": specs.mesh_backend(mesh), "device": str(specs.mesh_device(mesh)),
           "order": ordered_add_check(specs.mesh_device(mesh), spec["deterministic"])}
    if spec["deterministic"]:
        out["det_switch_ms"] = det_switch_ms
    if spec["part"] == "a":
        for name, run, pcfg in (("path1", _mesh_eager, paths["path1"]),
                                ("path2", _mesh_eager, paths["path2"]),
                                ("span", _mesh_span, paths["path2"])):
            args = (pcfg, MESH_ROUNDS) if run is _mesh_eager else (pcfg,)
            out[name] = [{"nomesh": run(None, *args), "mesh": run(mesh, *args)}]
    else:
        for name, pcfg in paths.items():
            with recording_k1_sizes() as sizes:
                out[name] = _mesh_eager(mesh, pcfg, MESH_ROUNDS)
            out[name + "_k1_sizes"] = sizes
        from repro_torch import engine
        clients, _, params, loss, _cfg = main_setting()
        state = engine.init("stocfl", loss, params, clients, paths["path2"],
                            device=specs.mesh_device(mesh), arena=True, mesh=mesh)
        out["blocker"] = engine.scan_blockers(state)
        try:
            engine.run_rounds(state, 1)
            out["refused"] = None
        except ValueError as err:
            out["refused"] = str(err)
    with open(spec["out"], "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()
    return 0


def run_mesh_world(part, world, backend, root):
    """Start ``world`` ranks of ``mesh_rank_main`` and wait for them; a
    rank that fails or outlasts MESH_TIMEOUT_S fails the phase. Returns
    each rank's results."""
    import pickle
    sys.stdout.flush()
    store = os.path.join(root, f"store_{part}")
    procs, outs = [], []
    for rank in range(world):
        out = os.path.join(root, f"{part}_rank{rank}.pkl")
        spec = dict(rank=rank, world=world, backend=backend, store=store, out=out, part=part,
                    deterministic=part == "a")
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), MESH_FLAG,
                                       json.dumps(spec)], env=env))
        outs.append(out)
    try:
        for p in procs:
            p.wait(timeout=MESH_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    codes = [p.returncode for p in procs]
    assert codes == [0] * world, f"phase 16{part}: ranks exited with {codes}"
    results = []
    for out in outs:
        with open(out, "rb") as f:
            results.append(pickle.load(f))
    return results


def _add(total, launches, names):
    for counter, n in launches.items():
        if counter in names:
            total[names[counter]] = total.get(names[counter], 0) + n


def train16_main(spec) -> int:
    """16c's torchrun worker (``chip_smoke.py --train16 SPEC``): the
    training driver's ``main`` with ``--mesh`` and ``spec["argv"]``, LLM
    configs with ``use_pallas=True`` (the Mamba-1 scan through K5); then
    this rank's kernel launches as JSON, to ``spec["counts"].rank<r>.json``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import train
    pallas = lambda arch, smoke=False: get_config(arch, smoke=smoke).with_(use_pallas=True)
    with patched(train, "get_config", pallas):
        train.main(spec["argv"] + ["--mesh"])
    with open(f"{spec['counts']}.rank{os.environ['RANK']}.json", "w") as f:
        json.dump(_build.launch_counts(), f)
    return 0


def start_train16(argv, tag, root):
    """Start ``torchrun --standalone --nproc_per_node 1 chip_smoke.py
    --train16`` with ``argv``; ``finish_train16`` waits for it."""
    counts = os.path.join(root, f"counts_{tag}")
    spec = {"argv": argv, "counts": counts}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", os.path.abspath(__file__), TRAIN16_FLAG,
           json.dumps(spec)]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    sys.stdout.flush()
    with open(counts + ".out", "w") as out, open(counts + ".err", "w") as err:
        # a session of its own, so that a kill takes torchrun's worker too
        proc = subprocess.Popen(cmd, env=env, stdout=out, stderr=err, start_new_session=True)
    return proc, counts, tag, time.perf_counter()


def stop_train16(run):
    """Kill a ``start_train16`` run's process group if it still runs."""
    import signal
    if run[0].poll() is None:
        os.killpg(run[0].pid, signal.SIGKILL)
        run[0].wait()


def finish_train16(run):
    """(the JSON the driver printed, once, its rank's launches, wall s)."""
    proc, counts, tag, t0 = run
    try:
        proc.wait(timeout=MESH_TIMEOUT_S)
    finally:
        stop_train16(run)
    wall = time.perf_counter() - t0
    with open(counts + ".out") as out, open(counts + ".err") as err:
        stdout, stderr = out.read(), err.read()
    assert proc.returncode == 0, f"[{tag}] torchrun failed:\n{stderr[-3000:]}"
    assert stdout.count("{\n") == 1, f"[{tag}] expected one JSON:\n{stdout[-2000:]}"
    out = json.loads(stdout[stdout.index("{\n"):])
    with open(counts + ".rank0.json") as f:
        launches = json.load(f)
    return out, launches, wall


def phase_mesh(smi):
    """Phase 16: the engine over a client-axis mesh, its ranks subprocesses
    of this script. Returns the launches of every rank's mesh runs by
    kernels-line name."""
    import shutil
    import tempfile

    import numpy as np
    t_phase = time.perf_counter()
    names = {"prox_update.launches": "prox_update", "cosine_sim.launches": "cosine_sim",
             "cosine_sim.candidate_launches": "merge_candidates",
             "resolve_roots.launches": "resolve_roots",
             "resolve_roots.label_launches": "component_labels",
             "ssm_scan.fwd_launches": "ssm_scan_fwd", "ssm_scan.bwd_launches": "ssm_scan_bwd"}
    total = {}
    root = tempfile.mkdtemp(prefix="mesh16_")
    print(f"[mesh16] card: {smi}; main setting (400 clients, MLP 2048 hidden, cohort 40, "
          f"fused_step), path 1 host backend + numpy rng, path 2 device backend + device "
          f"rng, arena; {MESH_ROUNDS} eager rounds each; 16a's rank runs with "
          f"torch.use_deterministic_algorithms(True), 16b's ranks without")

    # --- 16a: one rank under NCCL, against no mesh in the same process
    (a,) = run_mesh_world("a", 1, "nccl", root)
    print(f"[mesh16a] one rank, backend {a['backend']}, device {a['device']}; the first "
          f"torch.use_deterministic_algorithms(True) in the process took "
          f"{a['det_switch_ms']:.1f} ms of host time; under it the fixed-order segment add "
          f"(index_put_ with accumulate) and index_add_ give the same bits at (40, 153610) "
          f"into 4 segments: {a['order']}")
    fmt = lambda walls: ", ".join(f"{w:.1f}" for w in walls)
    for name in ("path1", "path2"):
        ref = a[name][0]["nomesh"][0]
        for turn, runs in enumerate(a[name]):
            for tag in ("nomesh", "mesh"):
                for x, y in zip(ref, runs[tag][0], strict=True):
                    mesh_match(x, y, exact=True)
            launched = runs["mesh"][2]
            assert launched["prox_update.launches"] == MESH_ROUNDS * 5, launched
            if name == "path1":
                assert launched["cosine_sim.launches"] == 2 * MESH_ROUNDS, launched
            else:
                assert launched["cosine_sim.candidate_launches"] == MESH_ROUNDS, launched
                assert launched["resolve_roots.launches"] == 2 * MESH_ROUNDS, launched
                assert launched["resolve_roots.label_launches"] == MESH_ROUNDS, launched
            _add(total, launched, names)
        (f,) = a[name]
        print(f"[mesh16a] {name}: {MESH_ROUNDS} eager rounds without and with the mesh, "
              f"bitwise equal; round walls ms: no mesh {fmt(f['nomesh'][1])}, mesh "
              f"{fmt(f['mesh'][1])} ({smi}); launches a mesh run {launched}")
    ref = a["span"][0]["nomesh"][0]
    for runs in a["span"]:
        for tag in ("nomesh", "mesh"):
            mesh_match(ref, runs[tag][0], exact=True)
        _, _, per_round, launched = runs["mesh"]
        assert per_round == runs["nomesh"][2], (per_round, runs["nomesh"][2])
        assert launched == {k: v * MESH_SPAN for k, v in per_round.items()}, launched
        _add(total, launched, names)
    (f,) = a["span"]
    span = lambda run: f"{run[1][0]:.1f} / {run[1][1]:.1f} ({run[1][1] / MESH_SPAN:.2f} a round)"
    print(f"[mesh16a] path 2 run_rounds({MESH_SPAN}) captured with the mesh (NCCL all-reduces "
          f"in the graph) and without, bitwise equal; first call (capture) / replays-only "
          f"call ms: no mesh {span(f['nomesh'])}, mesh {span(f['mesh'])} ({smi}); launches a "
          f"mesh call {launched}")

    # --- 16b: two ranks on the one card under gloo, while 16c's two
    # torchrun runs (the training driver) start up and run beside them
    runs = [start_train16(TRAIN16, "train16", root),
            start_train16(TRAIN16_SSM, "train16_ssm", root)]
    try:
        ranks = run_mesh_world("b", 2, "gloo", root)
    except BaseException:
        for run in runs:
            stop_train16(run)
        raise
    for name in ("path1", "path2"):
        ref = a[name][0]["nomesh"][0]
        worst = 0.0
        for r, res in enumerate(ranks):
            snaps, walls, launched = res[name]
            for x, y in zip(ref, snaps, strict=True):
                worst = max(worst, mesh_match(x, y, exact=False))
            for x, y in zip(ranks[0][name][0], snaps, strict=True):
                mesh_match(x, y, exact=True)
            sizes = res[name + "_k1_sizes"]
            assert sizes == [20 * 153610] * (MESH_ROUNDS * 5), sizes
            assert launched["prox_update.launches"] == MESH_ROUNDS * 5, launched
            _add(total, launched, names)
            print(f"[mesh16b] {name} rank {r}: round walls "
                  + ", ".join(f"{w:.1f}" for w in walls) + f" ms (16c beside; {smi}); launches "
                  f"{launched}; every K1 launch on this rank's 20 rows of the cohort of 40")
        print(f"[mesh16b] {name}: both ranks' states bitwise equal after every round, without "
              f"deterministic algorithms; against "
              f"16a's no-mesh rounds integers exact, floats max |diff| {worst:.3e} "
              f"(rtol {MESH_RTOL:g}, atol {MESH_ATOL:g})")
    for r, res in enumerate(ranks):
        assert res["backend"] == "gloo" and res["refused"] and res["refused"] == res["blocker"]
    print(f"[mesh16b] run_rounds on the gloo group refused: {ranks[0]['refused']!r}")
    for r, res in enumerate(ranks):
        print(f"[mesh16b] rank {r}, no deterministic mode: fixed-order segment add against "
              f"index_add_ at (40, 153610) into 4 segments, 10 repeats each (ms a call, host "
              f"clock; {smi}): {res['order']}")

    # --- 16c: the training driver under torchrun, both runs at once
    try:
        results = [finish_train16(run) for run in runs]
    finally:
        for run in runs:
            stop_train16(run)
    out, launched, wall = results[0]
    print(f"[mesh16c] torchrun --standalone --nproc_per_node 1 chip_smoke.py --train16: "
          f"repro_torch.launch.train --mesh {' '.join(TRAIN16)}: {wall:.1f} s (beside the next run and 16b), n_clusters {out['n_clusters']}, ARI "
          f"{out['ari']:.4f}, cluster_avg_acc {out['cluster_avg_acc']:.4f}; launches "
          f"{ {k: v for k, v in launched.items() if v} }")
    assert out["n_clusters"] == 4 and out["ari"] >= 0.99, out
    assert launched["cosine_sim.launches"] > 0, launched
    _add(total, launched, names)
    out, launched, wall = results[1]
    print(f"[mesh16c] ... --mesh {' '.join(TRAIN16_SSM)} (use_pallas): {wall:.1f} s, n_clusters "
          f"{out['n_clusters']}, ARI {out['ari']:.4f}; launches "
          f"{ {k: v for k, v in launched.items() if v} }")
    assert launched["ssm_scan.fwd_launches"] > 0 and launched["ssm_scan.bwd_launches"] > 0
    assert np.isfinite(out["ari"])
    _add(total, launched, names)
    print(f"[mesh16] launches of every rank's mesh runs: {total}")
    shutil.rmtree(root, ignore_errors=True)
    print(f"[mesh16] phase 16 took {time.perf_counter() - t_phase:.1f} s")
    return total


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (raises outside a checkout of the repo)
    from repro_torch.core import extractor
    # the sketch's draws are a pure function of (length, dim, seed): path 3's
    # reruns and the served and trained models' Ψ would otherwise draw up to
    # 532 M host random numbers again each time (~7.5 s for path 3's vocab
    # leaves), so round 0's wall holds them only in a length's first run
    extractor.jl_draws = functools.lru_cache(maxsize=None)(extractor.jl_draws)
    if sys.argv[1:2] == [PARITY_FLAG]:
        return llm_parity_main(json.loads(sys.argv[2]))
    if sys.argv[1:2] == [MESH_FLAG]:
        return mesh_rank_main(json.loads(sys.argv[2]))
    if sys.argv[1:2] == [TRAIN16_FLAG]:
        return train16_main(json.loads(sys.argv[2]))
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
        "cosine_sim": (lambda: cosine_sim.launches, ("cosine_kernel",))})
    launches2, path2 = phase_device_path(dev, path1)
    for k in ("merge_candidates", "resolve_roots", "component_labels"):
        kernels[k]["launches"] = launches2[k]
    del path1
    second = phase_trace(dev, path2_config(cfg), True, "trace2", {
        "prox_update": (lambda: prox_update.launches, ("prox_update",)),
        "merge_candidates": (lambda: cosine_sim.candidate_launches, ("candidates_kernel",)),
        "resolve_roots": (lambda: resolve_roots.launches, ("halving_",)),
        "component_labels": (lambda: resolve_roots.label_launches,
                             ("component_labels_kernel",))})
    check_second_pass(path2, second)
    del path2
    phase_scale(dev)
    launches3, expect = phase_llm_path(dev)
    for k in ("ssm_scan_fwd", "ssm_scan_bwd"):
        kernels[k]["launches"] = launches3[k]
    phase_llm_parity(expect)
    phase_llm_smoke(dev)
    kernels["prox_theta"]["launches"] = phase_baselines(dev)
    phase_sampler(dev)
    kernels["prox_update_bf16"]["launches"] = phase_llm_bf16(dev, expect)
    phase_captured(dev)
    churn = phase_churn(dev)
    async_launches, k2_err = phase_async_churn(dev)
    names = {"prox_update.launches": "prox_update", "prox_update.theta_launches": "prox_theta",
             "cosine_sim.launches": "cosine_sim", "cosine_sim.candidate_launches":
             "merge_candidates", "resolve_roots.launches": "resolve_roots",
             "resolve_roots.label_launches": "component_labels"}
    for counts in (churn, async_launches):
        for counter, n in counts.items():
            if counter in names:
                kernels[names[counter]]["launches"] += n
    kernels["cosine_sim"]["max_abs_err"] = max(kernels["cosine_sim"]["max_abs_err"], k2_err)
    phase_serve_qwen(dev, card_peaks(name))
    serve_launches, k5_errs = phase_serve_mamba(dev)
    for k, err in zip(("fwd", "bwd"), k5_errs):
        entry = kernels[f"ssm_scan_{k}"]
        entry["launches"] += serve_launches[f"ssm_scan.{k}_launches"]
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
    phase_serve_smoke(dev)
    launches14, k2_err14 = phase_14(dev, card_peaks(name))
    for k, n in launches14.items():
        kernels[k]["launches"] += n
    kernels["cosine_sim"]["max_abs_err"] = max(kernels["cosine_sim"]["max_abs_err"], k2_err14)
    launches15, k2_err15 = phase_15(dev)
    for k, n in launches15.items():
        kernels[k]["launches"] += n
    kernels["cosine_sim"]["max_abs_err"] = max(kernels["cosine_sim"]["max_abs_err"], k2_err15)
    for k, n in phase_mesh(smi).items():
        kernels[k]["launches"] += n
    print(f"[total] chip_smoke.py took {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kernels[n][k] for k in keys} for n in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
