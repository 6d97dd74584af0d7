#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Twenty phases, each printing its lines; any failure exits non-zero and
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
   bf16 compute, fp32 params) cut to 2 layers, ``use_pallas=True``: 2
   rounds (cut from 3 for the script's time) over 4 clients in 2 domains
   (2 sequences of 256 tokens each), Ψ on the vocab matrices sketched to
   8192, each round followed by ω's loss on client 0. Launches of K5
   (both ways; with the config's remat every scan under a gradient runs
   its forward twice), K1 and K2
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
   fp32; the 2 rounds in fp32 compute, kernel against plain scan, ω's
   update within 1e-4 after round 0 and, after round 1, no farther apart
   than two plain runs an ulp apart.
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
   ``reset``, then a warm wave of 8 new clients (16 before the script's
   time was cut) with every decode burst
   under ``sanitize.no_transfer()`` and no new program
   (``compile_budget(0)``), then its requests
   again with their routes cached under the profiler: first_compile_s,
   wall_s, tok_per_s, the routing Ψ's share, the device's busy share while
   serving, the decode step eager and as a graph replay and a prefill
   group (CUDA events), the peak memory. Every wave is routed through
   the batched Ψ (``engine.infer_batch``: one vmapped Ψ call for each
   ``launch.serve.ROUTE_CHUNK`` new clients). (b) path 3's falcon-mamba
   (full width, 2 layers, ``use_pallas=True``), 2 waves of 4 requests:
   K5's launches while routing (one chunk a wave: the 4 clients folded
   into K5's B, backward once a layer, forward twice: the remat
   recompute; none while serving) and K5 against its plain versions on
   the first folded input the router's Ψ gave it; its launches are added
   to the kernels line.
   Gates of (a) and (b), and of 14b and 14c (``hold_wave``): every route
   is ``engine.infer``'s (the per-client Ψ) with its similarity within
   1e-4 of ``infer``'s; in (a) the wave's batched Ψ rows within 1e-4 of
   the largest |value| of the per-client rows; the wave's routing ms a
   client beside the batched Ψ's and ``infer``'s, with the chunk and both
   peaks; every request's tokens equal ``SequentialLoop``'s under the
   near-tie rule (``serve.near_tie_compare``, ε 1e-3 on the card). (c) The smoke
   configs of qwen2 and falcon-mamba on the card against the same values
   on the CPU: routes equal, tokens under the near-tie rule with the CPU's
   sequential stream the reference.
14. The MoE, MLA and hybrid families and the training driver; every cut
   is one card's memory and is printed. (a) ``zamba2-1.2b`` at full width
   cut 38 -> 6 layers (one group and one application of the shared block)
   trained through ``launch.train.run_llm`` with path 3's traffic as the
   driver's own flags (``TRAIN14``: bf16 compute, fp32 parameters, the
   engine's fp32 policy, ``--fused-step``): round walls, the peak, the
   device's busy share on round 1 (profiled; 2 rounds, cut from 3 for
   the script's time); K1 and K2 launches equal to
   the counts reckoned from rounds, local steps and merge passes, K1
   bitwise against its plain version on the path's first local step's
   operands, K2 on every matrix the path gave it; rows finite, Ψ bitwise
   repeatable. (b) zamba2 at (a)'s cut and (c) ``phi3.5-moe-42b-a6.6b``
   cut 32 -> 2 layers served as in 13a (fp32, TF32 off, two waves of
   8, 13's gates; the MoE prefill groups' requests routed in groups of
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
   busy share on round 1 (2 rounds, cut from 3 for the script's time);
   K1's bf16 entry and K2 launched as reckoned, K1
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
   2 for 2 eager rounds and path 2's captured ``run_rounds(5)``, each
   without and with the mesh, bitwise equal (under
   ``torch.use_deterministic_algorithms(True)``, so that the no-mesh
   runs' atomics repeat; there the fixed-order segment add and
   ``index_add_`` must give the same bits). (b) Two ``gloo`` ranks on the
   one card, in the engine's own setting (the fixed-order add repeats bit
   for bit): paths 1 and 2 for 2 eager rounds, both ranks
   bitwise equal after every round, integers exact and floats within rtol
   2e-5, atol 1e-6 of (a)'s no-mesh rounds, each K1 launch on the rank's
   20 of the 40 cohort rows; ``run_rounds`` refused. (a) and (b) also run
   4 ``run_round_async`` rounds of path 1 over a buffer of 64 rows that
   round 1 doubles, with late reports and a flush every 2nd round: on (a)'s
   rank bitwise equal to no mesh; on (b)'s each rank holds half the rows
   and bytes (``AsyncBuffer.place``: slot s on rank s mod 2), both ranks'
   states and gathered buffers bitwise equal, each write's rows bit for bit
   at their slots, against (a)'s no-mesh rounds within the tolerance
   above; their K1 launches are counted. (c) Beside (b),
   ``torchrun --nproc_per_node 1 chip_smoke.py --train16``: ``launch.train.main``
   with ``--mesh`` on the rotated setting (4 clusters, ARI 1) and on
   falcon-mamba smoke with ``use_pallas``. Every rank's launches are
   added to the kernels line.
17. The model axis and serving over a mesh, ranks again subprocesses.
   (a) One NCCL rank on ``make_host_mesh()`` (1 x 1): qwen2-1.5b at full
   width in fp32 (TF32 off) through ``launch.steps.lower_step``'s train
   step (StoCFL's bi-level step, K1 on each rank's local shards) at
   global batch 2 x 256 tokens, prefill, 4 decode steps and the Psi
   step, each bitwise equal to the same step without a mesh in the same
   process; K1's launches counted and its first launch held bitwise
   against ``ref.prox_update_ref_`` on the step's own operands; the peak
   memory. (b) ``ServeEngine(mesh=make_client_mesh())`` over qwen2-1.5b
   at full width, 2 cluster groups, 8 requests, on one NCCL rank and on
   two ``gloo`` ranks on the card: every rank's tokens, routes and stats
   equal; tokens equal the engine without a mesh (on the same routes)
   under the near-tie rule; each rank holds K / ranks groups; each
   rank's peak.
18. The model axis for the families beyond qwen2, and the flash decode,
   ranks subprocesses. On each gloo rank, before its functional
   collectives are routed through gloo's own, ``make_host_mesh`` and
   ``param_shardings`` must refuse the group with their error, not crash.
   (a) One NCCL rank on ``make_host_mesh()`` (1 x 1): falcon-mamba-7b at
   full width cut 64 -> 2 layers as path 3 is, fp32, ``use_pallas``, 2 x
   256 tokens: the four ``lower_step`` steps bitwise equal to no mesh;
   each mesh step's K1 and K5 launches as reckoned (K5 forward 2 a layer
   and gradient with remat's recompute, backward 1); K1 bitwise and K5
   both ways on the mesh train step's first operands, which are tensors
   with storage. (b) The train step on two ``gloo`` ranks on the card (1 x
   2): each rank's K5 on 4096 of d_inner's 8192 channels, its shards
   within 1e-4 of its own no-mesh step, the leaves both ranks hold whole
   and the losses bitwise equal across ranks. (c) whisper-medium uncut on
   (a)'s mesh, bitwise, K1 counted. (d) qwen2-1.5b at full width with
   ``flash_decode``: 8 decode steps from a 2 x 256 prefill on the 1 x 1
   mesh (logits within 1e-5 of the plain decode without a mesh) and on two
   gloo ranks each holding half the cache (within 1e-4); the entries a
   step does not write bitwise, the written ones within the same gate; 3
   flash all-reduces a layer; each step's ms with and without flash on the
   mesh and the bytes its collectives send. The launches are added to the
   kernels line.
19. The optimisers, the Byzantine screen and the kernel library's cache.
   (a) Two ``chip_smoke.py --warm-start`` children, started with phase 18
   (whose host mostly waits on its ranks), the second once the first has
   written its results, each run one classification round through
   ``launch.train.main --fused-step`` on the card with ``--compile-cache``
   on one directory, empty at first: the first builds the library there
   (``_build.builds`` 1), the second builds nothing and launches K1 and K2
   from it; each library load's seconds. Then here: (b)
   ``clip_by_global_norm`` with ``sgd_momentum`` (Nesterov) and with
   ``adam`` (weight decay), 3 steps over path 1's MLP on the card under
   ``sanitize.no_transfer()``, within 1e-6 of the largest magnitude of the
   same steps on the CPU; (c) one ``adam`` step plus ``apply_updates`` over
   qwen2-1.5b's full-width fp32 tree: its ms (a first step under
   ``no_transfer()`` and a second), the peak, the bytes bound; (d)
   ``byzantine_distance_screen`` over path 1's 400 Ψ rows against its last
   round's cluster means on the card, its masks equal to the CPU's; (e)
   ``sanitize.nan_guard``: K1 fed a NaN gradient raises naming
   ``prox_update``, one clean path-1 round raises nothing. The children's
   launches are added to the kernels line.
20. The dry run for H100 meshes (``repro_torch.launch.dryrun``), in a
   ``chip_smoke.py --dryrun20`` child started after phase 8's child and
   run beside phases 9-16 (phase 17 waits for it: its ranks fill the
   card): on fake CUDA tensors over a fake process group of 512
   ranks, qwen2-1.5b on the (32, 8) mesh at all four shapes and
   falcon-mamba-7b train_4k on the (2, 32, 8) mesh with ``use_pallas``,
   probes extrapolated; one line per record (a model of a 256- or 512-GPU
   cluster, not a measurement), each ``ok``; K1 and K5 seen as one op each
   on a 2-layer falcon-mamba trace; 17a's configuration on a 1 x 1 fake
   mesh, its predicted peak (arguments + temp) beside the measured peak of
   17a's first mesh train step alone, and its predicted temp beside that
   of 17a's step on arguments placed beforehand; and qwen2-1.5b's and
   falcon-mamba's smoke configs, a train step without a mesh traced and
   then run on the card in the child, predicted peak beside measured.

``[sanitize]`` lines (``repro_torch.analysis.sanitize``, no phase of their
own): 11c-d's replays-only ``run_rounds`` span under ``no_transfer()`` and
``compile_budget(0)`` (count 0, captures 0); 12a's runs under
``compile_budget()`` (the scanned run's programs and captures equal the
round programs cached and the graphs captured, each program named); the
warm waves of 13a, 13b, 14b and 14c under ``compile_budget(0)`` with their
bursts under ``no_transfer()``; 19a's children under ``compile_budget()``
(cold: count 1, the library build; warm: count 0, cache_hits 1); 19e.

The line before the last is one JSON object describing every kernel of the
paths; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
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
LLM_ROUNDS = 2            # path 3: StoCFL rounds on falcon-mamba at full width (3 -> 2:
                          # the script's time)
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
    for name, device, ms in _raw_events(prof):
        if name.startswith("stocfl."):
            if device == DeviceType.CPU:
                phases[name] += ms
        elif device == DeviceType.CUDA:
            kernels[name] += ms
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
    """A tree's leaves, flattened and joined into one fp32 host vector
    (joined on the tree's device, then copied once)."""
    import torch
    from repro_torch.utils import trees
    return torch.cat([x.detach().reshape(-1).float() for x in trees.leaves(tree)]).cpu()


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
          "|du_kernel - du_plain| / |du_plain| after each round: "
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
          f"after each round: " + ", ".join(f"{x:.3e}" for x in update_rels(brecs, precs, omega0))
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
    """Path 3's rounds at full width in fp32 compute, kernel scan against
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
          f"|du_kernel - du_plain| / |du_plain| after each round: "
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
    for name, device, ms in _raw_events(prof):
        if name.startswith("stocfl."):
            if device == DeviceType.CPU:
                phases[name] += ms
        elif device == DeviceType.CUDA:
            kernels[name] += ms
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


def _raw_events(prof):
    """(name, device type, ms) of every event a profiler recorded, read
    from its raw results: ``prof.events()`` first builds the profiler's
    event tree in Python, tens of seconds of host time for the half a
    million events of a round with a Python-loop scan."""
    for ev in prof.profiler.kineto_results.events():
        yield ev.name(), ev.device_type(), (ev.end_ns() - ev.start_ns()) / 1e6


def _device_kernels(prof) -> dict:
    """{kernel name: device ms} of every CUDA event a profiler recorded."""
    import collections

    from torch.autograd import DeviceType
    out = collections.defaultdict(float)
    for name, device, ms in _raw_events(prof):
        if device == DeviceType.CUDA:
            out[name] += ms
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
    from repro_torch.analysis import sanitize
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
    # the replays-only call as run_rounds makes it, its span under the guards
    # (finalize, the host hand-off, outside them)
    with sanitize.compile_budget(0) as budget:
        fn, carry0, consts, finalize = engine.scan_program(start, rounds)
        with sanitize.no_transfer():
            carry, ys = fn(carry0, consts)
            torch.cuda.synchronize()
    second = finalize(start, carry, ys, rounds)
    torch.cuda.synchronize()
    second_ms = (time.perf_counter() - t0) * 1e3
    print(f"[sanitize] {tag} {name}: the replays-only call under no_transfer() and "
          f"compile_budget(0): count {budget.count}, captures {budget.captures}")
    assert (budget.count, budget.captures) == (0, 0), budget.describe()
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
          f"replays only {second_ms:.1f} ms = {second_ms / rounds:.2f} ms a round (its span under the sanitizers); under the "
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
    reserved bytes before and after). The run is made under
    ``sanitize.compile_budget``, whose programs and captures it prints."""
    import torch
    from repro_torch import engine
    from repro_torch.analysis import sanitize
    from repro_torch.engine.api import RoundProgram
    from repro_torch.sim import simulate

    clients, tc, tests, params, loss, acc, _cfg, factory = setting
    start = engine.init("stocfl", loss, params, clients, cfg, eval_fn=acc, device=dev,
                        arena=True)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_reserved(dev)
    _zero_counts()
    with (recording_merge_inputs() if records is not None else contextlib.nullcontext()) as recs, \
            sanitize.compile_budget(log_names=True) as budget:
        t0 = time.perf_counter()
        state, log = simulate(start, timeline, rounds=CHURN_ROUNDS, client_factory=factory,
                              seed=0, eval_every=5, test_sets=tests, true_cluster=tc,
                              scan_spans=scan)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = _launched()
    programs = [v for v in state.ctx.cache.values() if isinstance(v, RoundProgram)]
    graphs = sum(v.graph is not None for v in programs)
    tag = "scan" if scan else "eager"
    print(f"[sanitize] 12a {tag}: compile_budget() count {budget.count} (round programs "
          f"in the cache {len(programs)}), captures {budget.captures} (CUDA graphs "
          f"captured {graphs})")
    for pname in budget.names:
        print(f"[sanitize] 12a {tag}: program {pname}")
    assert budget.count == len(programs) and budget.captures == graphs, budget.describe()
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
SERVE_FIRST, SERVE_WARM = 8, 8      # qwen2: the first wave, then a warm wave (16 -> 8: the
                                    # script's time)
SERVE_MAMBA = 4                     # falcon-mamba: requests a wave
SERVE_SMOKE = 6                     # 13c: requests on 2 x 2 lanes (two admission waves)
SERVE_MAX_STOPS = 1                 # near-tie stops a wave may make (13a, 13b, 13c)
ROUTE_SIM_ATOL = 1e-4               # a route's similarity, batched Psi against engine.infer
ROUTE_ROWS_RTOL = 1e-4              # 13a: batched Psi rows against the per-client rows, of
                                    # their largest |value|


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
    ``sanitize.no_transfer()`` (sync-debug mode "error" on the card): a
    host read there raises."""
    from repro_torch.analysis import sanitize
    real = eng._decode_burst

    def guarded(n):
        with sanitize.no_transfer():
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


def hold_wave(tag, eng, state, reqs, routes, res, route_s, rows_gate=False):
    """13's gates on one wave. Its routes came from the batched Ψ (the
    router's ``engine.infer_batch``, ``route_s`` seconds for the wave);
    ``engine.infer`` (the per-client Ψ) then runs for each request, timed,
    and the batched Ψ once more on the wave's histories, timed, each from
    a fresh peak (the phase's own peak is read before). Each route's
    cluster is ``infer``'s (the accepted cluster, else the nearest) and
    its similarity within ``ROUTE_SIM_ATOL`` of ``infer``'s; with
    ``rows_gate`` the batched rows are within ``ROUTE_ROWS_RTOL`` of the
    per-client rows' largest |value|. Each request's tokens equal
    ``SequentialLoop``'s on the card under the near-tie rule (ε =
    ``NEAR_TIE_EPS["cuda"]``); the loop takes the engine's router, whose
    routes were just held to ``infer``, so it runs no Ψ of its own. The
    wave's near-tie stops are bounded by ``bound_stops``."""
    import torch
    from repro_torch import engine, serve
    from repro_torch.engine.state import on_device
    from repro_torch.engine.strategies import stack_batches
    ctx, n = state.ctx, len(reqs)
    real, one = ctx.extractor, []

    def recorded(batch):
        one.append(real(batch))
        return one[-1]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ctx.extractor = recorded
    try:
        infs = [engine.infer(state, r.history) for r in reqs]
    finally:
        ctx.extractor = real
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t0
    infer_peak = torch.cuda.max_memory_allocated() - held
    stacked = stack_batches([on_device(r.history, ctx.device) for r in reqs])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    rows = ctx.batched_extractor(stacked)
    torch.cuda.synchronize()
    batched_s = time.perf_counter() - t0
    batched_peak = torch.cuda.max_memory_allocated() - held
    one = torch.stack(one)
    rows_err = float((rows - one).abs().max())
    rows_scale = float(one.abs().max())
    del stacked, rows, one
    sim_err = 0.0
    for r, rt, inf in zip(reqs, routes, infs):
        want = inf["cluster"] if inf["cluster"] is not None else inf["seed_from"]
        assert rt.root == want, (tag, r.rid, rt, want)
        sim_err = max(sim_err, abs(rt.similarity - inf["similarity"]))
    assert sim_err <= ROUTE_SIM_ATOL, (tag, sim_err)
    if rows_gate:
        assert rows_err <= ROUTE_ROWS_RTOL * rows_scale, (tag, rows_err, rows_scale)
    chunk = ctx.cfg.cohort_chunk or n
    print(f"[{tag}] routing Psi: the wave's {n} new clients in {-(-n // chunk)} batched "
          f"call(s) of at most {chunk} (cohort_chunk {ctx.cfg.cohort_chunk}): the wave's "
          f"routing {route_s * 1e3 / n:.1f} ms a client, the batched Psi again "
          f"{batched_s * 1e3 / n:.1f} ms a client (peak {batched_peak / 1e9:.2f} GB over the "
          f"{held / 1e9:.2f} GB held), engine.infer {infer_s * 1e3 / n:.1f} ms a client (peak "
          f"{infer_peak / 1e9:.2f} GB); similarities max |batched - infer| {sim_err:.3e} (at "
          f"most {ROUTE_SIM_ATOL:g}); rows max |batched - per-client| {rows_err:.3e} of the "
          f"largest {rows_scale:.3e}" + (f" (at most {ROUTE_ROWS_RTOL:g} of it)" if rows_gate
                                         else ""))
    loop = serve.SequentialLoop(eng.model, state, max_len=eng.cfg.max_len,
                                max_gen=eng.cfg.max_gen)
    loop.router = eng.router
    eps, stops, gaps = serve.NEAR_TIE_EPS["cuda"], [], []
    for r, rt in zip(reqs, routes):
        sr = loop.serve(r)
        assert sr.cluster == rt.root and len(res[r.rid].tokens) == r.gen
        stop = serve.near_tie_compare(sr.tokens, res[r.rid].tokens, sr.gaps, eps)
        if stop is not None:
            stops.append((r.rid, stop))
        gaps.append(float(sr.gaps.min()))
    share = bound_stops(tag, reqs, stops)
    print(f"[{tag}] {n} routes equal engine.infer's; tokens equal SequentialLoop's "
          f"on the card under the near-tie rule (eps {eps:g}): {len(stops)} near-tie stops "
          f"{stops} (at most {SERVE_MAX_STOPS}), {100 * share:.1f}% of the tokens compared; "
          f"smallest top-2 gap of a reference stream {min(gaps):.3e}")


def phase_serve_qwen(dev, peaks):
    """13a: qwen2-1.5b at its full config served through the port's
    engine: the serve CLI's state, a first wave of 8 requests (the capture),
    a warm wave of ``SERVE_WARM`` new clients with every burst under
    ``sanitize.no_transfer()`` and no new program, the same requests again
    (routes cached) under
    the profiler;
    timings, the peak memory, the gates."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.analysis import sanitize
    from repro_torch import serve
    from repro_torch.launch import serve as launch_serve
    from repro_torch.utils import trees

    t_phase = time.perf_counter()
    cfg, model = serve_setting("qwen2-1.5b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    st = launch_serve.build_server_state(cfg, model, SERVE_CLUSTERS, SERVE_TAU, 0, device=dev,
                                         cohort_chunk=launch_serve.ROUTE_CHUNK)
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
    with sanitize.compile_budget(0) as budget, sync_free_bursts(eng):
        res2, routes2, route2_s, wall = serve_wave(eng, warm)
    print(f"[sanitize] 13a warm wave under compile_budget(0), bursts under no_transfer(): "
          f"count {budget.count}, captures {budget.captures}")
    assert (budget.count, budget.captures) == (0, 0), budget.describe()
    assert eng.captures == 1 and eng._graph().graph is graph, "the warm wave captured a graph"
    stats = eng.stats()
    n_tok = sum(len(r.tokens) for r in res2.values())
    print(f"[serve] first wave ({SERVE_FIRST} requests, capture included): first_compile_s "
          f"{first_s:.3f} (routing {route1_s:.3f} s, the capture {capture_s:.3f} s); warm wave "
          f"({SERVE_WARM} new clients, every burst under no_transfer(), no new "
          f"graph): wall_s {wall:.4f}, tokens {n_tok}, tok_per_s {n_tok / wall:.2f}; Psi "
          f"routing {route2_s * 1e3:.1f} ms for the wave ({route2_s * 1e3 / SERVE_WARM:.1f} ms "
          f"a client, one infer_batch: {-(-SERVE_WARM // launch_serve.ROUTE_CHUNK)} batched Psi "
          f"call(s)), serving after routing {(wall - route2_s) * 1e3:.1f} ms "
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
    for tag, reqs, routes, res, rs in (("first", first, routes1, res1, route1_s),
                                       ("warm", warm, routes2, res2, route2_s)):
        hold_wave(f"serve {tag}", eng, st, reqs, routes, res, rs, rows_gate=True)
    print(f"[serve] the gates took {time.perf_counter() - t0:.1f} s")
    del eng, st
    torch.cuda.empty_cache()
    print(f"[serve] phase 13a took {time.perf_counter() - t_phase:.1f} s")


def phase_serve_mamba(dev):
    """13b: path 3's falcon-mamba (full width, 2 layers, ``use_pallas=True``)
    in fp32 served with 2 clusters: K5 launched forward and backward while
    routing (the router's batched Ψ: a chunk of clients folded into K5's
    B, one launch a layer each way a chunk) and held against its plain
    version on the first folded input Ψ gave it; none while serving
    (prefill and decode take the plain scan, which returns the state);
    then the gates of 13a on two waves. Returns (K5's launches while
    routing, K5's errors on y and g_C)."""
    import torch
    from repro_torch.analysis import sanitize
    from repro_torch import serve
    from repro_torch.launch import serve as launch_serve

    t_phase = time.perf_counter()
    cfg, model = serve_setting("falcon-mamba-7b", n_layers=2, use_pallas=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    st = launch_serve.build_server_state(cfg, model, SERVE_CLUSTERS, SERVE_TAU, 0, device=dev,
                                         cohort_chunk=launch_serve.ROUTE_CHUNK)
    max_len = SERVE_PROMPT + SERVE_GEN
    eng = serve.ServeEngine(model, st, serve.ServeConfig(slots=SERVE_SLOTS, max_len=max_len,
                                                         max_gen=SERVE_GEN))
    first = launch_serve.make_requests(cfg, SERVE_MAMBA, SERVE_PROMPT, SERVE_GEN, SERVE_CLUSTERS)
    # Psi's history batch is 8 x 256 tokens a client; a chunk of clients is
    # folded into K5's B
    folded = min(launch_serve.ROUTE_CHUNK, SERVE_MAMBA)
    chunks = -(-SERVE_MAMBA // folded)
    shape = (8 * folded, 256, cfg.d_inner, cfg.ssm_state)
    _zero_counts()
    with recording_first_scan(shape) as rec:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        routes1 = eng.submit_many(first)
        torch.cuda.synchronize()
        route_s = time.perf_counter() - t0
    routing = _launched()
    # the batched Ψ takes a gradient: K5 once a layer each way a chunk, and
    # with cfg.remat its forward once more in the checkpoint's recompute
    want = chunks * cfg.n_layers
    want_fwd = want * (2 if cfg.remat else 1)
    print(f"[serve3] {cfg.name} at full width, {cfg.n_layers} layers, use_pallas, fp32, "
          f"remat {cfg.remat}: routing {SERVE_MAMBA} new clients took {route_s * 1e3:.1f} ms "
          f"in {chunks} batched Psi call(s) of {folded} clients (K5 at B = {8 * folded}); "
          f"launches while routing {routing} (K5 per call: forward {want_fwd // chunks}, "
          f"backward {want // chunks})")
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
    with sanitize.compile_budget(0) as budget, sync_free_bursts(eng):
        res2, routes2, route2_s, wall = serve_wave(eng, warm)
    print(f"[sanitize] 13b warm wave under compile_budget(0), bursts under no_transfer(): "
          f"count {budget.count}, captures {budget.captures}")
    assert (budget.count, budget.captures) == (0, 0), budget.describe()
    assert eng.captures == 1 and eng._graph().graph is graph, "the warm wave captured a graph"
    n_tok = sum(len(r.tokens) for r in res2.values())
    launches = {k: v for k, v in _launched().items() if k.startswith("ssm_scan.")}
    print(f"[serve3] first wave served in {first_s:.3f} s (the capture "
          f"{eng._graph().capture_s:.3f} s); warm wave ({SERVE_MAMBA} new clients, bursts "
          f"under no_transfer(), no new graph): wall_s {wall:.4f} (routing "
          f"{route2_s:.3f} s), tokens {n_tok}, tok_per_s {n_tok / wall:.2f}; peak device "
          f"memory {(torch.cuda.max_memory_allocated() - base) / 1e9:.2f} GB; K5 launches "
          f"in both waves' routing {launches}")
    errs = check_scan_on_path(rec[0], "serve3", "the router's first folded Psi input")
    del rec
    for tag, reqs, routes, res, rs in (("first", first, routes1, res1, route_s),
                                       ("warm", warm, routes2, res2, route2_s)):
        hold_wave(f"serve3 {tag}", eng, st, reqs, routes, res, rs)
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
# (a) path 3's traffic through the training driver's own flags, 3 -> 2 rounds
# (the script's time: phase 18's budget)
TRAIN14 = ["--arch", "zamba2-1.2b", "--clients", "4", "--domains", "2", "--batch", "2",
           "--seq-len", "256", "--rounds", "2", "--local-steps", "5", "--sample-rate", "0.5",
           "--tau", "0.12", "--lr", "0.05", "--fused-step", "--device", "cuda"]
ZAMBA_LAYERS = 6          # 38 -> 6: one full group of 6 and one shared-block application
PHI_LAYERS = 2            # 32 -> 2
PHI_ROUTE_CHUNK = 2       # 14c's clients a batched Psi call: its 3 models hold 34.4 GB and a
                          # call ~10 GB a client; 4 (the serve CLI's) ran out of memory
                          # beside the decode graph's pool
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
    local step of the first cohort) also keeps a copy on the card of the
    (θ, ω, g_θ, g_ω, η, λ) it received; yields the list that receives it.
    The copy (4 × 2 × 0.36 G fp32 on 14a) stays out of the path's peak:
    ``peak_without_copy`` reads it. The call itself goes through
    unchanged, so its launch is counted once."""
    import torch
    from repro_torch.kernels import ops
    real, records = ops.prox_update_flat, []

    def record(theta, omega, g_theta, g_omega, eta, lam, backend="auto"):
        if not records:
            before = torch.cuda.max_memory_allocated()
            ops_ = tuple(x.detach().clone() for x in (theta, omega, g_theta, g_omega))
            torch.cuda.reset_peak_memory_stats()
            records.append({"ops": ops_ + (float(eta), float(lam)), "peak_before": before,
                            "bytes": sum(x.numel() * x.element_size() for x in ops_)})
        return real(theta, omega, g_theta, g_omega, eta, lam, backend=backend)

    with patched(ops, "prox_update_flat", record):
        yield records


def peak_without_copy(record) -> int:
    """The peak allocated bytes of a block run under
    ``recording_first_prox_update``, without its copy: the peak before
    the copy, or the peak since it less the copy's bytes (held since)."""
    import torch
    return max(record["peak_before"], torch.cuda.max_memory_allocated() - record["bytes"])


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
    """K1 on the operands the path's first fused step gave it (the
    record's copies on the card, which it updates), against
    ``ref.prox_update_ref_``: bitwise in fp32, in place. Returns 0.0 (the
    largest error)."""
    import torch
    from repro_torch.kernels import prox_update, ref

    th, om, gt, go, eta, lam = record
    n = th.numel()
    pt, po = ref.prox_update_ref_(th.clone(), om.clone(), gt, go, eta, lam)
    kt, ko = th, om                           # the record's copies, updated in place
    ptrs = (kt.data_ptr(), ko.data_ptr())
    before = prox_update.launches
    prox_update.prox_update_flat(kt, ko, gt, go, eta, lam)
    prox_update.launches = before             # a check, not a launch of the path
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
    device's busy share on round 1; K1 and K2 launches equal the counts
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
            recording_cosine_inputs() as k2_in, recording_rounds(profile_round=1) as (recs, prof):
        out = train.run_llm(args)
    launches = _launched()
    peak = peak_without_copy(k1_in[0]) - base
    state = recs[-1]["state"]
    n_params = sum(p.numel() for p in trees.leaves(state.ctx.init_params))
    for t, r in enumerate(recs):
        note = " (under the profiler)" if r["traced"] else ""
        print(f"[train14] round {t}: wall {r['wall'] * 1e3:.1f} ms{note}, cohort "
              f"{r['cohort']}, n_clusters {r['n_clusters']}, merges {r['merges']}")
    kernels = {k: ms for k, ms in _device_kernels(prof).items() if not k.startswith("stocfl.")}
    busy = sum(kernels.values())
    wall = recs[1]["wall"] * 1e3
    assert busy > 0, "the profiler recorded no device time"
    print(f"[train14] {n_params} parameters ({n_params * 4 / 1e9:.2f} GB fp32); driver JSON "
          f"{out}; peak device memory {peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated, "
          f"from {base / 1e9:.2f} GB); round 1 under the profiler: device busy {busy:.1f} ms "
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


def phase_serve_family(dev, tag, arch, n_layers, first_n, warm_n, peaks, chunk=None):
    """14b / 14c: a family at full width cut to ``n_layers`` served as in
    13a (the serve CLI's state with 2 clusters, 4 slots a cluster, prompt
    32, gen 16, fp32, TF32 off): a first wave (the capture), ``reset``, a
    warm wave of new clients with every burst under ``no_transfer()`` and
    the same graph, no new program; 13's gates on both waves. MoE: each
    prefill group's requests routed in groups of their own (the calls'
    group sizes asserted), multi-request prefill groups formed
    (asserted), the assignments capacity dropped there printed. The
    router's batched Ψ takes ``chunk`` clients a call (the serve CLI's
    ``ROUTE_CHUNK`` unless given)."""
    import numpy as np
    import torch
    from repro_torch.analysis import sanitize
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
    st = launch_serve.build_server_state(cfg, model, SERVE_CLUSTERS, SERVE_TAU, 0, device=dev,
                                         cohort_chunk=chunk or launch_serve.ROUTE_CHUNK)
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
    with sanitize.compile_budget(0) as budget, sync_free_bursts(eng):
        res2, routes2, route2_s, wall = serve_wave(eng, warm)
    print(f"[sanitize] {tag} warm wave under compile_budget(0), bursts under no_transfer(): "
          f"count {budget.count}, captures {budget.captures}")
    assert (budget.count, budget.captures) == (0, 0), budget.describe()
    assert eng.captures == 1 and eng._graph().graph is graph, "the warm wave captured a graph"
    n_tok = sum(len(r.tokens) for r in res2.values())
    print(f"[{tag}] first wave ({first_n} requests): first_compile_s {first_s:.3f} (routing "
          f"{route1_s:.3f} s, the capture {eng._graph().capture_s:.3f} s); warm wave "
          f"({warm_n} new clients, bursts under no_transfer(), no new graph): "
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
    for wave, reqs, routes, res, rs in (("first", first, routes1, res1, route1_s),
                                        ("warm", warm, routes2, res2, route2_s)):
        hold_wave(f"{tag} {wave}", eng, st, reqs, routes, res, rs)
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
    phase_serve_family(dev, "serve14z", "zamba2-1.2b", ZAMBA_LAYERS, SERVE_FIRST, SERVE_WARM,
                       peaks)
    phase_serve_family(dev, "serve14m", "phi3.5-moe-42b-a6.6b", PHI_LAYERS, SERVE_FIRST,
                       SERVE_WARM, peaks, chunk=PHI_ROUTE_CHUNK)
    phase_deepseek_model(dev)
    phase_serve_smoke(dev, (("zamba2-1.2b", {}), ("phi3.5-moe-42b-a6.6b", {}),
                            ("deepseek-v2-236b", {})))
    print(f"[phase14] took {time.perf_counter() - t0:.1f} s")
    return launches, err


# ----------------------------------------------------------------- phase 15
# (a) path 3's traffic through the training driver's own flags, whisper uncut,
# 3 -> 2 rounds (the script's time: phase 18's budget)
TRAIN15 = ["--arch", "whisper-medium", "--clients", "4", "--domains", "2", "--batch", "2",
           "--seq-len", "256", "--rounds", "2", "--local-steps", "5", "--sample-rate", "0.5",
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
    peak, the device's busy share on round 1; K1's bf16 entry and K2
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
            recording_rounds(profile_round=1) as (recs, prof):
        out = train.run_llm(args)
    launches = _launched()
    peak = peak_without_copy(k1_in[0]) - base
    state = recs[-1]["state"]
    n_params = sum(p.numel() for p in trees.leaves(state.ctx.init_params))
    for t, r in enumerate(recs):
        note = " (under the profiler)" if r["traced"] else ""
        print(f"[train15] round {t}: wall {r['wall'] * 1e3:.1f} ms{note}, cohort "
              f"{r['cohort']}, n_clusters {r['n_clusters']}, merges {r['merges']}")
    kernels = _device_kernels(prof)
    busy = sum(kernels.values())
    wall = recs[1]["wall"] * 1e3
    assert busy > 0, "the profiler recorded no device time"
    print(f"[train15] {n_params} parameters; driver JSON {out}; peak device memory "
          f"{peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated, from {base / 1e9:.2f} GB); "
          f"round 1 under the profiler: device busy {busy:.1f} ms of {wall:.1f} ms "
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
MESH_ROUNDS = 2                 # 16a / 16b: eager rounds of each path (3 -> 2: the script's
                                # time)
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


def arena_info(state) -> dict:
    """What a rank holds of the engine's world: its arena rows and bytes
    (``ClientArena.held`` / ``nbytes``) against the capacity, and the
    devices of the client list's leaves."""
    from repro_torch.utils import trees
    ar = state.ctx.arena
    return {"held": ar.held, "capacity": ar.capacity, "nbytes": ar.nbytes,
            "clients_on": sorted({x.device.type for c in state.ctx.clients
                                  for x in trees.leaves(c)})}


def counting_psi(state):
    """The context's Ψ counting its calls: returns the counter list."""
    calls, real = [0], state.ctx.extractor

    def psi(batch):
        calls[0] += 1
        return real(batch)

    state.ctx.extractor = psi
    return calls


def _mesh_eager(mesh, cfg, rounds):
    """``rounds`` eager rounds of the main setting under ``cfg`` on
    ``mesh`` (None: no mesh): (snapshots, round walls in ms, launches,
    ``arena_info`` with the Ψ calls of each round)."""
    import torch
    from repro_torch import engine
    from repro_torch.kernels import _build
    clients, _, params, loss, _cfg = main_setting()
    dev = torch.device("cuda", torch.cuda.current_device())
    state = engine.init("stocfl", loss, params, clients, cfg, device=dev, arena=True,
                        mesh=mesh)
    info, calls, psi = arena_info(state), counting_psi(state), []
    _zero_counts()
    snaps, walls = [], []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        before = calls[0]
        state, _ = engine.run_round(state)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        psi.append(calls[0] - before)
        snaps.append(mesh_snapshot(state))
    info["psi_calls"] = psi
    return snaps, walls, {k: v for k, v in _build.launch_counts().items() if v}, info


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


MESH_ASYNC_CFG = dict(buffer_capacity=64, flush_every=2, staleness_cap=3)
MESH_ASYNC_ROUNDS = 4           # 16a / 16b: async rounds; round 1 doubles the 64 rows


def _async_delays(t: int, m: int):
    """Round ``t``'s report-back delays for a cohort of ``m``: late
    reports in rounds 0, 1 and 3, none in round 2."""
    import numpy as np
    return (np.arange(m) % (3, 2, 1, 3)[t % 4]).astype(np.int64)


def _buffer_digest(buf) -> str:
    """sha256 of the buffer's row banks gathered whole (a collective: every
    rank calls it), leaves in sorted order."""
    import hashlib

    from repro_torch.utils import trees
    whole, h = buf.gathered(), hashlib.sha256()
    for c in ("payload", "aux", "psi"):
        for x in ([] if getattr(whole, c) is None else trees.leaves(getattr(whole, c))):
            h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def recording_buffer_writes():
    """Within the block, each ``AsyncBuffer.write`` / ``write_psi`` call's
    slots and its rows gathered whole from every rank's slice (a
    collective) are appended to the yielded list, as (slots, {component:
    tree})."""
    from repro_torch.engine.async_agg import AsyncBuffer
    real_write, real_psi, writes = AsyncBuffer.write, AsyncBuffer.write_psi, []

    def write(self, slots, payload, aux=None, split=None):
        whole = lambda t: t if split is None or not split.sharded else split.gather(t)
        rows = {"payload": whole(payload)}
        if aux is not None:
            rows["aux"] = whole(aux)
        writes.append((list(map(int, slots)), rows))
        return real_write(self, slots, payload, aux, split)

    def write_psi(self, slots, rows):
        import torch
        writes.append((list(map(int, slots)), {"psi": rows.to(torch.float32)}))
        return real_psi(self, slots, rows)

    AsyncBuffer.write, AsyncBuffer.write_psi = write, write_psi
    try:
        yield writes
    finally:
        AsyncBuffer.write, AsyncBuffer.write_psi = real_write, real_psi


def _mesh_async(mesh, cfg):
    """16a / 16b's async run: MESH_ASYNC_ROUNDS ``run_round_async`` rounds of
    the main setting on ``mesh`` (None: no mesh) over a buffer of 64 rows
    that round 1 doubles, flushes every 2nd round. After each round: the
    snapshot, the buffer rows and bytes this rank holds, the entries, the
    whole buffer's digest, and whether the whole buffer holds, at each of
    the round's writes' slots, the row written there bit for bit. Returns
    (rounds, launches)."""
    import dataclasses

    import torch
    from repro_torch import engine
    from repro_torch.kernels import _build
    from repro_torch.utils import trees
    clients, _, params, loss, _cfg = main_setting()
    dev = torch.device("cuda", torch.cuda.current_device())
    acfg = engine.AsyncConfig(**MESH_ASYNC_CFG)
    state = engine.init("stocfl", loss, params, clients, dataclasses.replace(cfg, async_cfg=acfg),
                        device=dev, arena=True, mesh=mesh)
    _zero_counts()
    rounds = []
    for t in range(MESH_ASYNC_ROUNDS):
        with recording_buffer_writes() as writes:
            state, rec = engine.run_round_async(state, delays=_async_delays(t, 40))
        buf, whole = state.buffer, state.buffer.gathered()
        moved = all(torch.equal(torch.index_select(w, 0, torch.as_tensor(slots, device=dev)),
                                r.to(w.dtype))
                    for slots, rows in writes for c, tree in rows.items()
                    for w, r in zip(trees.leaves(getattr(whole, c)), trees.leaves(tree)))
        del whole, writes
        rounds.append({"snap": mesh_snapshot(state), "held": buf.held,
                       "capacity": buf.capacity, "nbytes": buf.nbytes,
                       "entries": [tuple(e) for e in buf.entries],
                       "digest": _buffer_digest(buf), "moved_bitwise": moved,
                       "merged": rec.get("merged")})
    return rounds, {k: v for k, v in _build.launch_counts().items() if v}


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
        out["async"] = {"nomesh": _mesh_async(None, paths["path1"]),
                        "mesh": _mesh_async(mesh, paths["path1"])}
    else:
        out["async"] = _mesh_async(mesh, paths["path1"])
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


def run_mesh_world(part, world, backend, root, flag=MESH_FLAG):
    """Start ``world`` ranks of ``mesh_rank_main`` (``steps_rank_main``
    with ``flag=STEPS_FLAG``) and wait for them; a rank that fails or
    outlasts MESH_TIMEOUT_S fails the phase. Returns each rank's
    results."""
    return wait_mesh_world(*start_mesh_world(part, world, backend, root, flag))


def start_mesh_world(part, world, backend, root, flag=MESH_FLAG, go=None):
    """Start ``world`` ranks as ``run_mesh_world`` does; returns (their
    processes, their output files). With ``go``, a rank that reads it
    waits for that file to exist before it touches the card."""
    sys.stdout.flush()
    store = os.path.join(root, f"store_{part}")
    procs, outs = [], []
    for rank in range(world):
        out = os.path.join(root, f"{part}_rank{rank}.pkl")
        spec = dict(rank=rank, world=world, backend=backend, store=store, out=out, part=part,
                    deterministic=flag == MESH_FLAG and part == "a", go=go)
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), flag,
                                       json.dumps(spec)], env=env))
        outs.append(out)
    return procs, outs


def wait_mesh_world(procs, outs):
    """Wait for ``start_mesh_world``'s ranks and read their results."""
    import pickle
    world = len(procs)
    try:
        for p in procs:
            p.wait(timeout=MESH_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    codes = [p.returncode for p in procs]
    assert codes == [0] * world, f"the ranks writing {outs} exited with {codes}"
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
    from repro_torch.engine import api
    pallas = lambda arch, smoke=False: get_config(arch, smoke=smoke).with_(use_pallas=True)
    calls, real = [0], api.make_extractors

    def counted(*args, **kw):
        psi, many = real(*args, **kw)

        def one(batch):
            calls[0] += 1
            return psi(batch)

        return one, many

    with patched(train, "get_config", pallas), patched(api, "make_extractors", counted):
        train.main(spec["argv"] + ["--mesh"])
    with open(f"{spec['counts']}.rank{os.environ['RANK']}.json", "w") as f:
        json.dump(dict(_build.launch_counts(), psi_calls=calls[0]), f)
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
    out["psi_calls"] = launches.pop("psi_calls")
    return out, launches, wall


def hand_over_card(tag):
    """Before a phase whose ranks are subprocesses sharing the card: this
    process's cached blocks go back to the card (the ranks of 17b build
    their states within a few GB of its 80), and what it still holds is
    printed."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{tag}] this process holds {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"allocated, {torch.cuda.memory_reserved() / 1e9:.2f} GB reserved on the card "
          f"while its ranks run")


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
        whole, one = f["nomesh"][3], f["mesh"][3]
        assert one["held"] == one["capacity"] == whole["held"], (one, whole)
        assert one["nbytes"] == whole["nbytes"] and one["clients_on"] == ["cpu"], one
        assert whole["clients_on"] == ["cuda"] and one["psi_calls"] == whole["psi_calls"]
        print(f"[mesh16a] {name}: {MESH_ROUNDS} eager rounds without and with the mesh, "
              f"bitwise equal; round walls ms: no mesh {fmt(f['nomesh'][1])}, mesh "
              f"{fmt(f['mesh'][1])} ({smi}); launches a mesh run {launched}")
        print(f"[mesh16a] {name}: the rank's arena {one['held']} of {one['capacity']} rows, "
              f"{one['nbytes'] / 1e6:.2f} MB (no mesh {whole['held']} rows, "
              f"{whole['nbytes'] / 1e6:.2f} MB); client list's leaves on {one['clients_on']} "
              f"(no mesh {whole['clients_on']}); Psi calls a round {one['psi_calls']} (no mesh "
              f"{whole['psi_calls']})")
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

    # --- 16a's async rounds: the buffer on one rank's mesh against no mesh
    an, (am, launched) = a["async"]["nomesh"][0], a["async"]["mesh"]
    for x, y in zip(an, am, strict=True):
        mesh_match(x["snap"], y["snap"], exact=True)
        assert (x["digest"], x["entries"]) == (y["digest"], y["entries"])
        assert y["held"] == y["capacity"] == x["capacity"] and y["nbytes"] == x["nbytes"], y
        assert x["moved_bitwise"] and y["moved_bitwise"]
    caps = [x["capacity"] for x in an]
    assert caps[:2] == [64, 128] and sum(x["merged"] or 0 for x in an) > 0, an
    assert launched["prox_update.launches"] == MESH_ASYNC_ROUNDS * 5, launched
    _add(total, launched, names)
    print(f"[mesh16a] async: {MESH_ASYNC_ROUNDS} run_round_async rounds of path 1 "
          f"({MESH_ASYNC_CFG}, late reports in rounds 0, 1, 3), without and with the mesh, "
          f"bitwise equal (states, entries, the buffer's rows); capacity by round {caps}, "
          f"merged {[x['merged'] for x in an]}; the rank holds {am[-1]['held']} of "
          f"{am[-1]['capacity']} rows, {am[-1]['nbytes'] / 1e6:.2f} MB; launches {launched}")

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
        whole = a[name][0]["nomesh"][3]
        psi = [res[name][3]["psi_calls"] for res in ranks]
        assert [sum(c) for c in zip(*psi)] == whole["psi_calls"], (psi, whole)
        for r, res in enumerate(ranks):
            snaps, walls, launched, info = res[name]
            assert 2 * info["held"] == info["capacity"] == whole["capacity"], (info, whole)
            assert 2 * info["nbytes"] == whole["nbytes"], (info, whole)
            assert info["clients_on"] == ["cpu"], info
            print(f"[mesh16b] {name} rank {r}: arena {info['held']} of {info['capacity']} "
                  f"rows, {info['nbytes'] / 1e6:.2f} MB (16a without a mesh: "
                  f"{whole['held']} rows, {whole['nbytes'] / 1e6:.2f} MB); client list's "
                  f"leaves on {info['clients_on']}; Psi calls a round {info['psi_calls']} "
                  f"(16a without a mesh {whole['psi_calls']}: the two ranks' sum)")
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
    worst = 0.0
    for r, res in enumerate(ranks):
        rounds, launched = res["async"]
        for t, (x, y) in enumerate(zip(an, rounds, strict=True)):
            worst = max(worst, mesh_match(x["snap"], y["snap"], exact=False))
            mesh_match(ranks[0]["async"][0][t]["snap"], y["snap"], exact=True)
            assert y["digest"] == ranks[0]["async"][0][t]["digest"], (r, t)
            assert y["entries"] == x["entries"] and y["capacity"] == x["capacity"], (r, t)
            assert 2 * y["held"] == y["capacity"] and 2 * y["nbytes"] == x["nbytes"], (r, y)
            assert y["moved_bitwise"], (r, t)
        assert launched["prox_update.launches"] == MESH_ASYNC_ROUNDS * 5, launched
        _add(total, launched, names)
        print(f"[mesh16b] async rank {r}: the buffer's rows on their owners, "
              + ", ".join(f"round {t}: {y['held']} of {y['capacity']} rows, "
                          f"{y['nbytes'] / 1e6:.2f} MB (16a {x['nbytes'] / 1e6:.2f} MB)"
                          for t, (x, y) in enumerate(zip(an, rounds)))
              + f"; launches {launched}")
    print(f"[mesh16b] async: both ranks' states and gathered buffers bitwise equal after every "
          f"round; each write's rows at their slots bit for bit; against 16a's no-mesh rounds "
          f"entries and integers exact, floats max |diff| {worst:.3e} (rtol {MESH_RTOL:g}, "
          f"atol {MESH_ATOL:g}: the cohort trains in slices of 20 and a flush sums partial "
          f"sums)")
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
          f"repro_torch.launch.train --mesh {' '.join(TRAIN16)}: {wall:.1f} s (beside the next "
          f"run and 16b), n_clusters {out['n_clusters']}, ARI "
          f"{out['ari']:.4f}, cluster_avg_acc {out['cluster_avg_acc']:.4f}; the rank's Psi "
          f"calls {out['psi_calls']}; launches { {k: v for k, v in launched.items() if v} }")
    assert 0 < out["psi_calls"] <= 24, out
    assert out["n_clusters"] == 4 and out["ari"] >= 0.99, out
    assert launched["cosine_sim.launches"] > 0, launched
    _add(total, launched, names)
    out, launched, wall = results[1]
    print(f"[mesh16c] ... --mesh {' '.join(TRAIN16_SSM)} (use_pallas): {wall:.1f} s, n_clusters "
          f"{out['n_clusters']}, ARI {out['ari']:.4f}; the rank's Psi calls "
          f"{out['psi_calls']}; launches { {k: v for k, v in launched.items() if v} }")
    assert 0 < out["psi_calls"] <= 4, out
    assert launched["ssm_scan.fwd_launches"] > 0 and launched["ssm_scan.bwd_launches"] > 0
    assert np.isfinite(out["ari"])
    _add(total, launched, names)
    print(f"[mesh16] launches of every rank's mesh runs: {total}")
    shutil.rmtree(root, ignore_errors=True)
    print(f"[mesh16] phase 16 took {time.perf_counter() - t_phase:.1f} s")
    return total


# ----------------------------------------------------------------- phase 17
STEPS_FLAG = "--steps-rank"     # runs steps_rank_main, one rank of phase 17
STEPS_BATCH, STEPS_SEQ = 2, 256   # 17a: train_4k's global batch and length, cut
STEPS_DECODE = 4                # 17a: decode steps after the prefill (8 -> 4: the script's
                                # time)
SERVE17_REQUESTS = 8            # 17b: one wave over 2 groups x 4 slots
SERVE17_HISTORY = (64, 2)       # 17b: a client's routing batch (13a's 256 x 8 cut so
                                # that two ranks' states and routing fit one card)
SERVE17_CHUNK = 1               # 17b: clients a batched Psi call: one keeps a rank's routing
                                # memory the one-client Psi's (two ranks share the card, their
                                # states built within a few GB of its 80)


@contextlib.contextmanager
def recording_first_k1():
    """Within the block the first K1 launch ``ops.prox_update_tree`` makes
    also keeps device copies of its operands (θ, ω, g_θ, g_ω, η, λ) and
    the (θ', ω') it wrote; yields the list that receives them."""
    from repro_torch.kernels import ops
    real, records = ops._prox_kernel, []

    def record(theta, omega, g_theta, g_omega, eta, lam):
        first = not records
        if first:
            records.append([x.detach().clone() for x in (theta, omega, g_theta, g_omega)]
                           + [float(eta), float(lam)])
        out = real(theta, omega, g_theta, g_omega, eta, lam)
        if first:
            records[0] += [theta, omega]
        return out

    with patched(ops, "_prox_kernel", record):
        yield records


def _bitwise(a, b) -> bool:
    """Two trees (tuples and dicts of DTensors or tensors) hold the same
    bits, leaf for leaf."""
    from repro_torch.sharding import to_local
    from repro_torch.utils import trees
    flat = lambda t: ([x for part in t for x in flat(part)] if isinstance(t, (tuple, list))
                      else trees.leaves(t))
    la, lb = flat(a), flat(b)
    return len(la) == len(lb) and all(torch_equal(to_local(x), to_local(y)) for x, y in zip(la, lb))


def torch_equal(x, y) -> bool:
    import torch
    return x.shape == y.shape and x.dtype == y.dtype and bool(torch.equal(x, y))


def _timed(fn):
    """(fn(), its host ms ending in a synchronise)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def steps17a():
    """17a on this rank (a world of one under NCCL): every step of
    ``launch.steps`` on ``make_host_mesh()`` against the same step
    without a mesh, bitwise."""
    import torch
    from repro_torch.kernels import _build, ref
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.config import InputShape
    from repro_torch.models.registry import grow_cache
    from repro_torch.utils import trees

    from repro_torch.sharding import specs

    mesh = make_host_mesh()
    dev = specs.mesh_device(mesh)
    cfg, model = serve_setting("qwen2-1.5b")
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev).manual_seed(0)
    theta = model.init(g, dev)
    omega = trees.tree_map(lambda x: x + 0.01 * torch.randn(x.shape, generator=g, device=dev),
                           theta)
    tokens = torch.randint(0, cfg.vocab_size, (STEPS_BATCH, STEPS_SEQ), generator=g, device=dev,
                           dtype=torch.int32)
    batch = {"tokens": tokens}
    bind = lambda kind, s: steps.lower_step(model, InputShape(kind, s, STEPS_BATCH, kind),
                                            mesh, kind)
    out = {"n_params": sum(x.numel() for x in trees.leaves(theta)), "mesh": tuple(mesh.mesh.shape),
           "remat": cfg.remat, "n_leaves": len(trees.leaves(theta))}

    # each step twice, the first result kept on the host (the card holds
    # theta, omega, one step's gradients and outputs, and the K1 record)
    on_host = lambda out: [(x.to_local() if hasattr(x, "to_local") else x).to("cpu")
                           for part in out for x in trees.leaves(part)]
    plain_step = steps.stocfl_train_step(model)
    plain, out["train_ms"] = _timed(lambda: on_host(plain_step(theta, omega, batch)))
    _, out["train_ms2"] = _timed(lambda: plain_step(theta, omega, batch) and None)
    train = bind("train", STEPS_SEQ)
    _zero_counts()
    # the first mesh step's own peak, from what is live before it (its
    # arguments), against which phase 20 holds the dry run's prediction;
    # the K1 record is taken on the second step, after this peak is read
    peak_plain = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out["step_base"] = torch.cuda.memory_allocated()
    got, out["train_mesh_ms"] = _timed(lambda: train.fn(theta, omega, batch))
    out["step_peak"] = torch.cuda.max_memory_allocated()
    out["train_bitwise"] = _bitwise(on_host(got), plain)
    out["losses"] = {k: float(v.full_tensor()) for k, v in got[2].items()}
    del got
    with recording_first_k1() as rec:
        _, out["train_mesh_ms2"] = _timed(lambda: train.fn(theta, omega, batch) and None)
    out["launches"] = {k: v for k, v in _build.launch_counts().items() if v}
    th, om, gt, go, eta, lam, kt, ko = rec[0]
    pt, po = ref.prox_update_ref_(th.clone(), om.clone(), gt, go, eta, lam)
    out["k1"] = {"n": th.numel(), "bitwise": torch_equal(kt, pt) and torch_equal(ko, po),
                 "max_abs_err": float(max((kt - pt).abs().max(), (ko - po).abs().max()))}
    del plain, rec, th, om, gt, go, kt, ko, pt, po
    # a third mesh step, on arguments placed beforehand: the step the dry
    # run models (its arguments already in their shardings, as the
    # reference's compiled step takes them), where the steps above first
    # place whole tensors, a copy of them; its launches are not counted.
    # What the steps above left to the cyclic collector is freed first, so
    # that it is not freed inside the step and taken off its peak
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    gc.collect()
    before = torch.cuda.memory_allocated()
    out["gc_freed"] = held - before
    placed = [steps._put_tree(x, sh) for x, sh in zip((theta, omega, batch),
                                                       train.in_shardings)]
    torch.cuda.synchronize()
    out["placed_bytes"] = torch.cuda.memory_allocated() - before
    torch.cuda.reset_peak_memory_stats()
    out["placed_base"] = torch.cuda.memory_allocated()
    got = train.fn(*placed)
    torch.cuda.synchronize()
    out["placed_peak"] = torch.cuda.max_memory_allocated()
    del got, placed
    out["peak_train"] = max(peak_plain, torch.cuda.max_memory_allocated())

    (logits, cache), out["prefill_ms"] = _timed(lambda: steps.prefill_step(model)(theta, batch))
    (mlogits, mcache), out["prefill_mesh_ms"] = _timed(
        lambda: bind("prefill", STEPS_SEQ).fn(theta, batch))
    out["prefill_bitwise"] = _bitwise((logits, cache), (mlogits, mcache))
    del mlogits, mcache

    s_max = STEPS_SEQ + STEPS_DECODE
    cache = grow_cache(model, cache, STEPS_BATCH, s_max)
    dec, plain_dec = bind("decode", s_max), steps.decode_step(model)
    tok = torch.argmax(logits, -1).to(torch.int32)
    mtok, mcache, bits, toks = tok, cache, [], []
    walls = {"plain": [], "mesh": []}
    for i in range(STEPS_DECODE):
        pos = torch.tensor(STEPS_SEQ + i, dtype=torch.int32, device=dev)
        (lg, cache), ms = _timed(lambda: plain_dec(theta, tok, cache, pos))
        walls["plain"].append(ms)
        (mlg, mcache), ms = _timed(lambda: dec.fn(theta, mtok, mcache, pos))
        walls["mesh"].append(ms)
        bits.append(_bitwise(lg, mlg) and _bitwise(cache, mcache))
        tok = torch.argmax(lg, -1).to(torch.int32)
        mtok = torch.argmax(mlg.full_tensor(), -1).to(torch.int32)
        toks.append(tok.tolist())
    out.update(decode_bitwise=bits, decode_tokens=toks, decode_ms=walls)
    del cache, mcache, lg, mlg

    psi, out["repr_ms"] = _timed(lambda: steps.repr_step(model)(theta, batch))
    mpsi, out["repr_mesh_ms"] = _timed(lambda: bind("repr", STEPS_SEQ).fn(theta, batch))
    out["repr_bitwise"] = _bitwise(psi, mpsi)
    out["repr_finite"] = all(bool(torch.isfinite(x).all()) for x in trees.leaves(psi))
    out["peak"] = max(out["peak_train"], torch.cuda.max_memory_allocated())
    return out


def steps17b(mesh_size):
    """17b on this rank: ``ServeEngine(mesh=make_client_mesh())`` over
    qwen2-1.5b at full width, 2 cluster groups, one wave of 8 requests;
    then the engine without a mesh on the same router (the routes
    cached), its tokens the reference of the near-tie rule, with
    ``SequentialLoop``'s gaps for a request whose tokens differ. Each
    client, and each cluster's reference client, routes on
    ``SERVE17_HISTORY`` tokens."""
    import dataclasses

    import torch
    from repro_torch import serve
    from repro_torch.core import extractor
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch.mesh import make_client_mesh
    from repro_torch.sharding import specs
    from repro_torch.utils import trees

    mesh = make_client_mesh()
    dev = specs.mesh_device(mesh)
    cfg, model = serve_setting("qwen2-1.5b")
    seq, rows = SERVE17_HISTORY
    small = lambda cfg, _seq, _rows, **kw: synthetic_lm_batch(cfg, seq, rows, **kw)
    # the Psi sketch's host draws over the vocab leaves (seconds of host
    # time; build_server_state sketches to 8192 with seed 0, and main()
    # caches the draws) on every rank at once, before the turns below
    extractor.jl_draws(2 * cfg.vocab_size * cfg.d_model, 8192, 0)
    # the ranks build their states in turn, each joining its clusters'
    # reference clients on SERVE17_HISTORY tokens and making its own
    # groups' models alone (the bank placed on the mesh), then returning the
    # allocator's cache (the layer-by-layer inits leave ~2 models of it)
    for turn in range(mesh_size):
        if turn == specs.mesh_rank(mesh):
            with patched(launch_serve, "synthetic_lm_batch", small):
                st = launch_serve.build_server_state(cfg, model, SERVE_CLUSTERS, SERVE_TAU, 0,
                                                     device=dev, cohort_chunk=SERVE17_CHUNK,
                                                     mesh=mesh)
            torch.cuda.empty_cache()
        specs.barrier(mesh, dev)
    nbytes = lambda tree: sum(x.numel() * x.element_size() for x in trees.leaves(tree))
    reqs = [dataclasses.replace(r, history=synthetic_lm_batch(
                cfg, seq, rows, seed=1000 + r.rid, domain=r.rid % SERVE_CLUSTERS))
            for r in launch_serve.make_requests(cfg, SERVE17_REQUESTS, SERVE_PROMPT, SERVE_GEN,
                                                SERVE_CLUSTERS)]
    scfg = serve.ServeConfig(slots=SERVE_SLOTS, max_len=SERVE_PROMPT + SERVE_GEN,
                             max_gen=SERVE_GEN)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _zero_counts()
    eng = serve.ServeEngine(model, st, scfg, mesh=mesh)
    res, routes, route_s, wall = serve_wave(eng, reqs)
    launches = {k: v for k, v in _build.launch_counts().items() if v}
    out = {"backend": specs.mesh_backend(mesh), "ranks": mesh_size, "base": base,
           "peak": torch.cuda.max_memory_allocated(), "route_s": route_s, "wall": wall,
           "held": int(trees.leaves(eng._stacked)[0].shape[0]),
           "bank_bytes": nbytes(st.models.stacked), "model_bytes": nbytes(st.ctx.init_params),
           "stacked_is_bank": all(a.data_ptr() == b.data_ptr() for a, b in zip(
               trees.leaves(eng._stacked), trees.leaves(st.models.stacked))),
           "lane_bytes": sum(nbytes(x) for x in eng.sl),
           "stats": eng.stats(), "launches": launches, "captures": eng.captures,
           "routes": [(rt.root, rt.similarity, rt.accepted) for rt in routes],
           "tokens": {r.rid: [int(t) for t in res[r.rid].tokens] for r in reqs}}
    # the reference below serves every group without a mesh: the other
    # ranks' groups' models are made again from their seeds (in turn, as
    # above), after the placed state's peak was read
    for turn in range(mesh_size):
        if turn == specs.mesh_rank(mesh):
            st = whole_server_state(st, model, dev)
            torch.cuda.empty_cache()
        specs.barrier(mesh, dev)
    ref_eng = serve.ServeEngine(model, st, scfg)
    ref_eng.router = eng.router
    ref_res, _, _, out["wall_nomesh"] = serve_wave(ref_eng, reqs)
    out["stats_nomesh"] = ref_eng.stats()
    loop = serve.SequentialLoop(model, st, max_len=scfg.max_len, max_gen=scfg.max_gen)
    loop.router = eng.router
    eps, stops = serve.NEAR_TIE_EPS["cuda"], []
    for r in reqs:
        want = ref_res[r.rid].tokens
        if list(want) != out["tokens"][r.rid]:
            gaps = loop.serve(r).gaps
            stop = serve.near_tie_compare(want, res[r.rid].tokens, gaps, eps)
            stops.append((r.rid, stop))
    out["stops"] = stops
    out["equal_nomesh"] = not stops
    return out


def whole_server_state(st, model, dev):
    """A placed serving state (``build_server_state(..., mesh=...)``) with
    every group's model: the rank's own rows, and the others' made again
    as ``build_server_state`` makes them (cluster k, joined k-th, from its
    seed)."""
    from repro_torch.engine.bank import ClusterBank
    from repro_torch.launch import serve as launch_serve
    bank = st.models
    models = {}
    for k in range(len(bank.roots)):
        root = st.client_root(k)
        models[root] = (bank[root] if bank.holds(root)
                        else model.init(launch_serve._generator(dev, 0, k), dev))
    return st.replace(models=ClusterBank.from_dict(models))


def steps_rank_main(spec) -> int:
    """One rank of phase 17 (``chip_smoke.py --steps-rank SPEC``): joins
    the world of ``spec`` through a FileStore and runs 17a or 17b; writes
    its results to ``spec["out"]``."""
    import datetime
    import pickle

    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = spec["rank"], spec["world"]
    os.environ["LOCAL_RANK"] = str(rank)
    torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(spec["backend"], store=dist.FileStore(spec["store"], world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    if spec["part"].startswith("a"):
        # 17a, then 17b's world of one in the same process and NCCL group
        out = {"a": steps17a()}
        torch.cuda.empty_cache()
        out["b"] = steps17b(world)
    else:
        out = steps17b(world)
    with open(spec["out"], "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()
    return 0


def phase_steps_mesh(smi):
    """Phase 17: the model axis (``launch.steps`` over DTensor placements)
    and serving over a client-axis mesh, ranks subprocesses of this
    script. Returns K1's launches on 17a's mesh train step."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="steps17_")
    gb = lambda n: f"{n / 1e9:.2f} GB"

    # --- 17a: one NCCL rank on make_host_mesh() (1 x 1), against no mesh;
    # then 17b's world of one in that process
    t0 = time.perf_counter()
    (ab,) = run_mesh_world("a17", 1, "nccl", root, flag=STEPS_FLAG)
    a = ab["a"]
    print(f"[steps17a] the world of one (17a, then 17b's one rank) took "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"[steps17a] qwen2-1.5b full width, {a['n_params']} parameters in {a['n_leaves']} "
          f"leaves, fp32 compute (TF32 off), remat {a['remat']}, mesh {a['mesh']} (data, model) "
          f"of one NCCL rank; global batch {STEPS_BATCH} x {STEPS_SEQ} tokens (train_4k's "
          f"shape cut to one card's step)")
    print(f"[steps17a] train (StoCFL bi-level step, both gradients, K1 on the local shards): "
          f"no mesh {a['train_ms']:.1f} / {a['train_ms2']:.1f} ms, mesh "
          f"{a['train_mesh_ms']:.1f} / {a['train_mesh_ms2']:.1f} ms (host clock, first / "
          f"second call, the second with the K1 record; {smi}); the first call's outputs "
          f"bitwise equal {a['train_bitwise']}; "
          f"losses {a['losses']}; launches on the two mesh steps {a['launches']}")
    k1 = a["k1"]
    print(f"[steps17a] K1 on the mesh step's first launch's operands (n={k1['n']}): bitwise "
          f"equal to ref.prox_update_ref_ {k1['bitwise']} (max |diff| {k1['max_abs_err']:.3e})")
    print(f"[steps17a] prefill {STEPS_BATCH} x {STEPS_SEQ}: no mesh {a['prefill_ms']:.1f} ms, "
          f"mesh {a['prefill_mesh_ms']:.1f} ms; bitwise equal {a['prefill_bitwise']}")
    fmt = lambda ws: ", ".join(f"{w:.1f}" for w in ws)
    print(f"[steps17a] {STEPS_DECODE} decode steps: no mesh ms {fmt(a['decode_ms']['plain'])}; "
          f"mesh ms {fmt(a['decode_ms']['mesh'])}; logits and caches bitwise equal "
          f"{a['decode_bitwise']}; tokens {a['decode_tokens']}")
    print(f"[steps17a] Psi (anchor gradient, one global L2 norm): no mesh {a['repr_ms']:.1f} ms, "
          f"mesh {a['repr_mesh_ms']:.1f} ms; bitwise equal {a['repr_bitwise']}, finite "
          f"{a['repr_finite']}")
    print(f"[steps17a] peak device memory {gb(a['peak'])} (after train {gb(a['peak_train'])}; "
          f"the first mesh train step alone {gb(a['step_peak'])} from {gb(a['step_base'])} "
          f"live before it; a third on arguments placed beforehand ({gb(a['placed_bytes'])}) "
          f"{gb(a['placed_peak'])} from {gb(a['placed_base'])}, after gc.collect() freed "
          f"{gb(a['gc_freed'])}; "
          f"torch.cuda.max_memory_allocated; {smi})")
    assert a["train_bitwise"] and a["prefill_bitwise"] and all(a["decode_bitwise"])
    assert a["repr_bitwise"] and a["repr_finite"] and k1["bitwise"]
    assert a["launches"].get("prox_update.launches") == 2 * a["n_leaves"], a["launches"]
    assert all(map(math.isfinite, a["losses"].values())), a["losses"]

    # --- 17b: ServeEngine(mesh=...) on one NCCL rank (above), then two gloo
    # ranks on the card
    t0 = time.perf_counter()
    ranks = {1: [ab["b"]], 2: run_mesh_world("b17g", 2, "gloo", root, flag=STEPS_FLAG)}
    print(f"[serve17b] the world of two gloo ranks took {time.perf_counter() - t0:.1f} s")
    for n, res in ranks.items():
        for r, x in enumerate(res):
            assert x["tokens"] == res[0]["tokens"] and x["routes"] == res[0]["routes"], (n, r)
            # the engine without a mesh reads the same router: its counters differ
            loop_stats = lambda st: {k: v for k, v in st.items() if not k.startswith("router")}
            assert x["stats"] == res[0]["stats"], (n, r, x["stats"])
            assert loop_stats(x["stats"]) == loop_stats(x["stats_nomesh"]), (n, r, x["stats"])
            assert x["held"] == SERVE_CLUSTERS // n, (n, r, x["held"])
            assert x["bank_bytes"] == x["held"] * x["model_bytes"], (n, r, x["bank_bytes"])
            assert x["stacked_is_bank"], (n, r)
            assert len(x["stops"]) <= SERVE_MAX_STOPS, (n, r, x["stops"])
            assert x["captures"] == 1, x["captures"]
            print(f"[serve17b] {n} rank(s) ({x['backend']}), rank {r}: holds {x['held']} of "
                  f"{SERVE_CLUSTERS} groups; its bank (build_server_state(mesh=...), placed) "
                  f"holds {x['bank_bytes'] / 1e9:.3f} GB = {x['held']} x "
                  f"{x['model_bytes'] / 1e9:.3f} GB models, the engine's weights views of it; "
                  f"lanes {x['lane_bytes'] / 1e6:.1f} MB); wave of "
                  f"{SERVE17_REQUESTS}: routing {x['route_s']:.2f} s, wall {x['wall']:.2f} s "
                  f"(no mesh, routes cached: {x['wall_nomesh']:.2f} s); tokens equal the "
                  f"engine without a mesh {x['equal_nomesh']} (near-tie stops {x['stops']}); "
                  f"peak {gb(x['peak'])} from {gb(x['base'])} before the engine ({smi}); "
                  f"launches {x['launches']}")
        print(f"[serve17b] {n} rank(s): every rank's tokens, routes and stats equal; stats "
              f"{res[0]['stats']}")
    assert ranks[1][0]["tokens"] == ranks[2][0]["tokens"]
    shutil.rmtree(root, ignore_errors=True)
    print(f"[steps17] phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return a["launches"].get("prox_update.launches", 0), a


# ----------------------------------------------------------------- phase 18
STEPS18_FLAG = "--steps18-rank"   # runs steps18_rank_main, one rank of phase 18
STEPS18_DECODE = 1                # 18a, 18c: decode steps after the prefill
FLASH18_STEPS = 8                 # 18d: flash decode steps from the prefilled cache
FLASH18_RTOL = {1: 1e-5, 2: 1e-4}    # 18d's logits and written cache entries, by ranks
MODEL18_RTOL = 1e-4               # 18b's two ranks against no mesh


def _on_host(out):
    """Every leaf of a step's outputs (DTensors as their local shards) on
    the host, in order."""
    from repro_torch.sharding import to_local
    from repro_torch.utils import trees
    parts = out if isinstance(out, tuple) else (out,)
    return [to_local(x).to("cpu") for part in parts for x in trees.leaves(part)]


def route_functional_to_gloo() -> None:
    """Register CUDA kernels for the functional collectives DTensor calls
    (all_reduce, all_gather_into_tensor, reduce_scatter_tensor,
    all_to_all_single) that run the group's own blocking ``dist.*``
    collective and return its result, so ``wait_tensor`` finds no pending
    work. Phase 18's two ranks share the card under gloo, whose
    functional collectives crash in ``wait_tensor`` on CUDA tensors
    (torch 2.11) while its ``dist.*`` ones run there. The registration
    holds for the rest of the rank's process, which makes no other group;
    the port itself keeps DTensor's one collective path."""
    import torch
    import torch.distributed as dist
    group = dist.distributed_c10d._resolve_process_group
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
           "product": dist.ReduceOp.PRODUCT}

    def reduce_(t, op, name):
        g = group(name)
        dist.all_reduce(t, op=ops["sum" if op == "avg" else op], group=g)
        return t.div_(g.size()) if op == "avg" else t

    def all_gather(x, size, name):
        out = x.new_empty((x.shape[0] * size,) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group(name))
        return out

    def reduce_scatter(x, op, size, name):
        g = group(name)
        out = x.new_empty((x.shape[0] // size,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x.contiguous(), op=ops["sum" if op == "avg" else op],
                                   group=g)
        return out.div_(g.size()) if op == "avg" else out

    def all_to_all(x, out_splits, in_splits, name):
        out = x.new_empty((sum(out_splits) if out_splits else x.shape[0],) + tuple(x.shape[1:]))
        dist.all_to_all_single(out, x.contiguous(), list(out_splits) or None,
                               list(in_splits) or None, group=group(name))
        return out

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_reduce", lambda x, op, name: reduce_(x.clone(), op, name), "CUDA")
    lib.impl("all_reduce_", reduce_, "CUDA")
    lib.impl("all_gather_into_tensor", all_gather, "CUDA")
    lib.impl("reduce_scatter_tensor", reduce_scatter, "CUDA")
    lib.impl("all_to_all_single", all_to_all, "CUDA")
    _ROUTED.append(lib)


_ROUTED = []      # keeps route_functional_to_gloo's Library alive in the rank


def refusals18(world):
    """On a gloo rank of the card, before its collectives are routed: the
    package's model-axis entry points (``make_host_mesh``, and
    ``param_shardings`` over a 1 x ``world`` CUDA ``DeviceMesh``) must raise
    their error naming the remedy, not crash in DTensor's collectives.
    Returns the two messages."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import param_shardings
    mesh = lambda: DeviceMesh("cuda", torch.arange(world).reshape(1, world),
                              mesh_dim_names=("data", "model"))
    calls = {"make_host_mesh": lambda: make_host_mesh(world),
             "param_shardings": lambda: param_shardings(
                 {"embed": torch.empty(64, 8, device="meta")}, mesh())}
    said = []
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            assert "'nccl'" in str(e) and "_c10d_functional" in str(e), (name, str(e))
            said.append(f"{name}: {e}")
        else:
            raise AssertionError(f"{name} accepted an unrouted gloo group on the card")
    return said


def falcon18():
    """(config, model) of 18a and 18b: falcon-mamba-7b at full width, cut
    64 -> 2 layers as path 3 is, fp32 compute, ``use_pallas``."""
    return serve_setting("falcon-mamba-7b", n_layers=2, use_pallas=True)


def _seeded(model, cfg, dev, batch_fn):
    """θ (from seed 0 on the device), ω = θ + 0.01·N(0, 1), and a batch."""
    import torch
    from repro_torch.utils import trees
    g = torch.Generator(device=dev).manual_seed(0)
    theta = model.init(g, dev)
    omega = trees.tree_map(lambda x: x + 0.01 * torch.randn(x.shape, generator=g, device=dev),
                           theta)
    return theta, omega, batch_fn(g)


def four_steps18(model, cfg, mesh, theta, omega, batch, seq, scan_shape=None):
    """The four steps of ``launch.steps`` on ``mesh`` against the same
    steps without a mesh, each bitwise, with the launches of each mesh
    step; the first K1 launch of the mesh train step held bitwise against
    its plain version, and (``scan_shape``) K5 both ways on the operands
    of its first scan, which must be tensors with storage."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.launch import steps
    from repro_torch.models.config import InputShape
    from repro_torch.models.registry import grow_cache
    from repro_torch.utils import trees

    B = trees.leaves(batch)[0].shape[0]
    bind = lambda kind, s: steps.lower_step(model, InputShape(kind, s, B, kind), mesh, kind)
    out = {"launches": {}}
    plain, out["train_ms"] = _timed(lambda: _on_host(
        steps.stocfl_train_step(model)(theta, omega, batch)))
    train = bind("train", seq)
    _zero_counts()
    scans = recording_first_scan(scan_shape) if scan_shape else contextlib.nullcontext([])
    with recording_first_k1() as rec, scans as first_scan:
        got, out["train_mesh_ms"] = _timed(lambda: train.fn(theta, omega, batch))
    out["launches"]["train"] = _launched()
    out["train_bitwise"] = _bitwise(_on_host(got), plain)
    out["losses"] = {k: float(v.to_local()) for k, v in got[2].items()}
    del got, plain
    th, om, gt, go, eta, lam, kt, ko = rec[0]
    pt, po = ref.prox_update_ref_(th.clone(), om.clone(), gt, go, eta, lam)
    out["k1"] = {"n": th.numel(), "bitwise": torch_equal(kt, pt) and torch_equal(ko, po),
                 "max_abs_err": float(max((kt - pt).abs().max(), (ko - po).abs().max()))}
    del rec, th, om, gt, go, kt, ko, pt, po
    if scan_shape:
        out["scan_operands"] = [type(t).__name__ for t in first_scan[0]]
        out["k5_errs"] = check_scan_on_path(first_scan[0], tag="steps18a",
                                            what="the mesh train step's first scan")
        del first_scan

    (logits, cache), out["prefill_ms"] = _timed(lambda: steps.prefill_step(model)(theta, batch))
    _zero_counts()
    (mlogits, mcache), out["prefill_mesh_ms"] = _timed(lambda: bind("prefill", seq).fn(
        theta, batch))
    out["launches"]["prefill"] = _launched()
    out["prefill_bitwise"] = _bitwise((logits, cache), (mlogits, mcache))
    del mlogits, mcache

    s_max = seq + STEPS18_DECODE
    cache = grow_cache(model, cache, B, s_max)
    dec, plain_dec = bind("decode", s_max), steps.decode_step(model)
    tok = torch.argmax(logits, -1).to(torch.int32)
    mcache, bits, walls = cache, [], {"plain": [], "mesh": []}
    _zero_counts()
    for i in range(STEPS18_DECODE):
        pos = torch.tensor(seq + i, dtype=torch.int32, device=tok.device)
        (lg, cache), ms = _timed(lambda: plain_dec(theta, tok, cache, pos))
        walls["plain"].append(ms)
        (mlg, mcache), ms = _timed(lambda: dec.fn(theta, tok, mcache, pos))
        walls["mesh"].append(ms)
        bits.append(_bitwise(lg, mlg) and _bitwise(cache, mcache))
        tok = torch.argmax(lg, -1).to(torch.int32)
    out["launches"]["decode"] = _launched()
    out.update(decode_bitwise=bits, decode_ms=walls)
    del cache, mcache, lg, mlg

    psi, out["repr_ms"] = _timed(lambda: steps.repr_step(model)(theta, batch))
    _zero_counts()
    mpsi, out["repr_mesh_ms"] = _timed(lambda: bind("repr", seq).fn(theta, batch))
    out["launches"]["repr"] = _launched()
    out["repr_bitwise"] = _bitwise(psi, mpsi)
    out["repr_finite"] = all(bool(torch.isfinite(x).all()) for x in trees.leaves(psi))
    out["n_leaves"] = len(trees.leaves(theta))
    out["n_params"] = sum(x.numel() for x in trees.leaves(theta))
    return out


def steps18a():
    """18a on this rank (a world of one under NCCL): falcon-mamba's four
    steps on ``make_host_mesh()`` against no mesh."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import specs
    mesh = make_host_mesh()
    dev = specs.mesh_device(mesh)
    cfg, model = falcon18()
    theta, omega, batch = _seeded(model, cfg, dev, lambda g: {"tokens": torch.randint(
        0, cfg.vocab_size, (STEPS_BATCH, STEPS_SEQ), generator=g, device=dev,
        dtype=torch.int32)})
    torch.cuda.reset_peak_memory_stats()
    out = four_steps18(model, cfg, mesh, theta, omega, batch, STEPS_SEQ,
                       scan_shape=(STEPS_BATCH, STEPS_SEQ, cfg.d_inner, cfg.ssm_state))
    out.update(mesh=tuple(mesh.mesh.shape), remat=cfg.remat, layers=cfg.n_layers,
               peak=torch.cuda.max_memory_allocated())
    return out


def steps18c():
    """18c on this rank: whisper-medium uncut, its four steps on the 1 × 1
    mesh against no mesh (2 × 1500 frames and 2 × 256 tokens)."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import specs
    mesh = make_host_mesh()
    dev = specs.mesh_device(mesh)
    cfg, model = serve_setting("whisper-medium")
    theta, omega, batch = _seeded(model, cfg, dev, lambda g: {
        "frames": torch.randn((STEPS_BATCH, cfg.enc_seq, cfg.d_model), generator=g, device=dev),
        "tokens": torch.randint(0, cfg.vocab_size, (STEPS_BATCH, STEPS_SEQ), generator=g,
                                device=dev, dtype=torch.int32)})
    torch.cuda.reset_peak_memory_stats()
    out = four_steps18(model, cfg, mesh, theta, omega, batch, STEPS_SEQ)
    out.update(mesh=tuple(mesh.mesh.shape), remat=cfg.remat,
               peak=torch.cuda.max_memory_allocated())
    return out


def _digest(x) -> tuple:
    """An exact fingerprint of a tensor's bytes: two int64 sums of its
    32-bit words, plain and weighted by position modulo a prime."""
    import torch
    w = x.detach().contiguous().view(torch.int32).reshape(-1).to(torch.int64)
    i = torch.arange(w.numel(), device=w.device) % 65521
    return int(w.sum()), int((w * i).sum())


def steps18b(world):
    """18b on this rank of two gloo ranks on the one card: 18a's train step
    on a 1 × 2 mesh, each rank's K5 on its half of d_inner's channels.
    Returns the rank's launches, its first scan's operands' shape and
    types, each output leaf's local shard against the same slice of the
    step without a mesh (run on this rank), and digests of the leaves the
    ranks hold whole, for the phase to compare across ranks."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.config import InputShape
    from repro_torch.sharding import specs
    from repro_torch.utils import trees
    mesh = make_host_mesh(world)
    dev = specs.mesh_device(mesh)
    cfg, model = falcon18()
    theta, omega, batch = _seeded(model, cfg, dev, lambda g: {"tokens": torch.randint(
        0, cfg.vocab_size, (STEPS_BATCH, STEPS_SEQ), generator=g, device=dev,
        dtype=torch.int32)})
    shape = (STEPS_BATCH, STEPS_SEQ, cfg.d_inner // world, cfg.ssm_state)
    train = steps.lower_step(model, InputShape("train", STEPS_SEQ, STEPS_BATCH, "train"), mesh,
                             "train")
    _zero_counts()
    with recording_first_scan(shape) as first_scan:
        got, ms = _timed(lambda: train.fn(theta, omega, batch))
    out = {"launches": _launched(), "train_mesh_ms": ms, "mesh": tuple(mesh.mesh.shape),
           "scan": [(tuple(t.shape), type(t).__name__) for t in first_scan[0]],
           "k5_errs": check_scan_on_path(first_scan[0], tag=f"steps18b rank {dist.get_rank()}",
                                         what="its mesh train step's first scan")}
    del first_scan
    plain, out["train_ms"] = _timed(lambda: steps.stocfl_train_step(model)(theta, omega, batch))
    worst, whole = 0.0, []
    for x, want in zip([x for part in got for x in trees.leaves(part)],
                       [x for part in plain for x in trees.leaves(part)]):
        lshape, offset = compute_local_shape_and_global_offset(want.shape, mesh, x.placements)
        ref_part = want[tuple(slice(o, o + n) for o, n in zip(offset, lshape))]
        err = float((x.to_local() - ref_part).abs().max()) if ref_part.numel() else 0.0
        worst = max(worst, err / max(float(want.abs().max()), 1e-30))
        if all(p.is_replicate() for p in x.placements):
            whole.append(_digest(x.to_local()))
    out.update(worst_rel=worst, whole=whole, losses={k: float(v.to_local())
                                                     for k, v in got[2].items()})
    return out


def flash18(world):
    """18d on this rank: qwen2-1.5b at full width with ``flash_decode``, a
    prefill of ``STEPS_BATCH`` x ``STEPS_SEQ`` tokens without a mesh, its
    cache grown by ``FLASH18_STEPS`` entries (a length the model axis
    divides), then ``FLASH18_STEPS`` decode steps, each from the plain
    decode's token and cache: the plain decode without a mesh, and the
    decode ``lower_step`` binds on ``make_host_mesh(world)`` with and
    without ``flash_decode``. Each step's logits and this rank's slab of
    the flash cache are held against the plain decode's (entries the step
    did not write bitwise, the written ones within ``FLASH18_RTOL``), with
    each call's host ms and the bytes its collectives send."""
    import torch
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.config import InputShape
    from repro_torch.models.registry import build, grow_cache
    from repro_torch.sharding import CollectiveLog, specs
    from repro_torch.utils import trees
    mesh = make_host_mesh(world)
    dev = specs.mesh_device(mesh)
    cfg, model = serve_setting("qwen2-1.5b")
    g = torch.Generator(device=dev).manual_seed(0)
    params = model.init(g, dev)
    tokens = torch.randint(0, cfg.vocab_size, (STEPS_BATCH, STEPS_SEQ), generator=g,
                           device=dev, dtype=torch.int32)
    s_max = STEPS_SEQ + FLASH18_STEPS
    assert s_max % world == 0, (s_max, world)
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": tokens})
    cache = grow_cache(model, cache, STEPS_BATCH, s_max)
    tok = torch.argmax(logits, -1).to(torch.int32)
    shape = InputShape("decode", s_max, STEPS_BATCH, "decode")
    flash = steps.lower_step(build(cfg.with_(flash_decode=True)), shape, mesh, "decode")
    plain_mesh = steps.lower_step(model, shape, mesh, "decode")
    plain = steps.decode_step(model)
    tol = FLASH18_RTOL[world]
    rows, walls, sent = [], {"plain": [], "flash": [], "mesh": []}, {"flash": [], "mesh": []}
    for i in range(FLASH18_STEPS):
        pos = torch.tensor(STEPS_SEQ + i, dtype=torch.int32, device=dev)
        (lg, nc), ms = _timed(lambda: plain(params, tok, cache, pos))
        walls["plain"].append(ms)
        with CollectiveLog() as flog:
            (flg, fc), ms = _timed(lambda: flash.fn(params, tok, cache, pos))
        walls["flash"].append(ms)
        with CollectiveLog() as mlog:
            _, ms = _timed(lambda: plain_mesh.fn(params, tok, cache, pos))
        walls["mesh"].append(ms)
        sent["flash"].append(sum(b for _, _, b in flog.calls))
        sent["mesh"].append(sum(b for _, _, b in mlog.calls))
        core = [n for op, n, _ in flog.calls if op == "c10d.allreduce_"]
        err = float((flg.to_local() - lg).abs().max()) / float(lg.abs().max())
        bits, werr = True, 0.0
        for x, want in zip(trees.leaves(fc), trees.leaves(nc)):
            lshape, off = compute_local_shape_and_global_offset(want.shape, x.device_mesh,
                                                                x.placements)
            part = want[tuple(slice(o, o + n) for o, n in zip(off, lshape))]
            local = x.to_local()
            slot = STEPS_SEQ + i - off[2]              # (L, B, S, H_kv, hd): the written entry
            keep = torch.ones(local.shape[2], dtype=torch.bool, device=dev)
            if 0 <= slot < local.shape[2]:
                keep[slot] = False
                werr = max(werr, float((local[:, :, slot] - part[:, :, slot]).abs().max())
                           / float(want.abs().max()))
            bits = bits and torch.equal(local[:, :, keep], part[:, :, keep])
        rows.append({"logits_rel": err, "cache_unwritten_bitwise": bits, "written_rel": werr,
                     "core_all_reduces": len(core), "core_elems": sorted(set(core))})
        cache, tok = nc, torch.argmax(lg, -1).to(torch.int32)
    cache_bytes = sum(x.numel() * x.element_size() for x in trees.leaves(cache))
    return {"mesh": tuple(mesh.mesh.shape), "rows": rows, "walls": walls, "sent": sent,
            "tol": tol, "layers": cfg.n_layers, "cache_bytes": cache_bytes,
            "heads": (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)}


def steps18_rank_main(spec) -> int:
    """One rank of phase 18 (``chip_smoke.py --steps18-rank SPEC``): joins
    the world of ``spec`` through a FileStore and runs 18a, 18c and 18d's
    one rank (part a, one NCCL rank) or 18b and 18d's two ranks (part b,
    gloo); writes its results to ``spec["out"]``."""
    import datetime
    import pickle

    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = spec["rank"], spec["world"]
    os.environ["LOCAL_RANK"] = str(rank)
    torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(spec["backend"], store=dist.FileStore(spec["store"], world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    deadline = time.perf_counter() + MESH_TIMEOUT_S
    while spec["go"] and not os.path.exists(spec["go"]):
        assert time.perf_counter() < deadline, "no go from phase 18"
        time.sleep(0.05)
    t0, out = time.perf_counter(), {}
    if spec["backend"] == "gloo":
        out["refused"] = refusals18(world)
        route_functional_to_gloo()
    parts = ((("a", steps18a), ("c", steps18c), ("d", lambda: flash18(world)))
             if spec["part"].startswith("a") else
             (("b", lambda: steps18b(world)), ("d", lambda: flash18(world))))
    for name, fn in parts:
        out[name] = fn()
        out[name]["s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
    with open(spec["out"], "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()
    return 0


def phase_model_axis(smi):
    """Phase 18: the model axis for the families beyond qwen2 and the
    flash decode, ranks subprocesses of this script (one NCCL rank, then
    two gloo ranks on the card). Returns the launches of K1 and K5 on its
    mesh steps and K5's largest errors (y, g_C) on their first operands,
    for the kernels line."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="steps18_")
    gb = lambda n: f"{n / 1e9:.2f} GB"
    fmt = lambda ws: ", ".join(f"{w:.1f}" for w in ws)
    # the gloo ranks start up (interpreter, imports, their group) while the
    # NCCL rank runs, and touch the card only once it has ended
    go = os.path.join(root, "go_b18g")
    started = start_mesh_world("b18g", 2, "gloo", root, flag=STEPS18_FLAG, go=go)
    try:
        (one,) = run_mesh_world("a18", 1, "nccl", root, flag=STEPS18_FLAG)
    except BaseException:
        for p in started[0]:
            p.kill()
        raise
    open(go, "w").close()
    two = wait_mesh_world(*started)
    total = {"prox_update": 0, "ssm_scan_fwd": 0, "ssm_scan_bwd": 0}

    def add(launches):
        total["prox_update"] += launches.get("prox_update.launches", 0)
        total["ssm_scan_fwd"] += launches.get("ssm_scan.fwd_launches", 0)
        total["ssm_scan_bwd"] += launches.get("ssm_scan.bwd_launches", 0)

    # --- 18a: falcon-mamba's four steps, one NCCL rank's 1 x 1 mesh against none
    a = one["a"]
    per_grad = a["layers"] * (2 if a["remat"] else 1)       # K5 forwards of one gradient
    want = {"train": {"prox_update.launches": a["n_leaves"], "ssm_scan.fwd_launches":
                      2 * per_grad, "ssm_scan.bwd_launches": 2 * a["layers"]},
            "prefill": {}, "decode": {},
            "repr": {"ssm_scan.fwd_launches": per_grad, "ssm_scan.bwd_launches": a["layers"]}}
    print(f"[steps18a] falcon-mamba-7b at full width, {a['layers']} layers (path 3's cut), "
          f"{a['n_params']} parameters, fp32 compute (TF32 off), use_pallas, remat "
          f"{a['remat']}, mesh {a['mesh']} of one NCCL rank; {STEPS_BATCH} x {STEPS_SEQ} "
          f"tokens; took {a['s']:.1f} s")
    print(f"[steps18a] train: no mesh {a['train_ms']:.1f} ms, mesh {a['train_mesh_ms']:.1f} ms "
          f"(host clock, first call; {smi}); prefill {a['prefill_ms']:.1f} / "
          f"{a['prefill_mesh_ms']:.1f} ms; {STEPS18_DECODE} decodes no mesh "
          f"{fmt(a['decode_ms']['plain'])} ms, mesh {fmt(a['decode_ms']['mesh'])} ms; Psi "
          f"{a['repr_ms']:.1f} / {a['repr_mesh_ms']:.1f} ms; bitwise equal to no mesh: train "
          f"{a['train_bitwise']}, prefill {a['prefill_bitwise']}, decode {a['decode_bitwise']}, "
          f"Psi {a['repr_bitwise']}; losses {a['losses']}; peak {gb(a['peak'])}")
    print(f"[steps18a] launches by mesh step {a['launches']} (reckoned {want}); the first "
          f"scan's operands {a['scan_operands']}; K1 on the first launch's operands "
          f"(n={a['k1']['n']}) bitwise equal to ref.prox_update_ref_ {a['k1']['bitwise']}")
    assert a["train_bitwise"] and a["prefill_bitwise"] and all(a["decode_bitwise"])
    assert a["repr_bitwise"] and a["repr_finite"] and a["k1"]["bitwise"]
    assert a["scan_operands"] == ["Tensor"] * 3, a["scan_operands"]
    assert a["launches"] == want, (a["launches"], want)
    for launches in a["launches"].values():
        add(launches)

    # --- 18b: the train step on two gloo ranks, each K5 on half the channels
    for r, x in enumerate(two):
        assert len(x["refused"]) == 2, (r, x["refused"])
    print(f"[steps18b] before routing, each gloo rank's model-axis entry points refuse "
          f"the group: {two[0]['refused']}")
    b = [r["b"] for r in two]
    for r, x in enumerate(b):
        print(f"[steps18b] rank {r} of {len(b)} (gloo, one card), mesh {x['mesh']}: train "
              f"{x['train_mesh_ms']:.1f} ms (no mesh on the rank {x['train_ms']:.1f} ms; {smi}); "
              f"first scan's operands {x['scan']}; launches {x['launches']}; its shards' "
              f"largest |diff| / max |value| against no mesh {x['worst_rel']:.3e} (gate "
              f"{MODEL18_RTOL}); losses {x['losses']}")
        assert x["launches"] == want["train"], (r, x["launches"])
        assert x["scan"][0] == ((STEPS_BATCH, STEPS_SEQ, 8192 // len(b), 16), "Tensor"), x["scan"]
        assert all(t == "Tensor" for _, t in x["scan"]) and x["worst_rel"] <= MODEL18_RTOL
        assert x["whole"] == b[0]["whole"] and x["losses"] == b[0]["losses"], r
        add(x["launches"])
    print(f"[steps18b] the ranks' replicated leaves ({len(b[0]['whole'])}) and losses "
          f"bitwise equal; took {two[0]['b']['s']:.1f} s")

    # --- 18c: whisper-medium uncut on the 1 x 1 mesh
    c = one["c"]
    print(f"[steps18c] whisper-medium uncut, {c['n_params']} parameters, fp32, remat "
          f"{c['remat']}, mesh {c['mesh']}; {STEPS_BATCH} x {STEPS_SEQ} tokens over "
          f"{STEPS_BATCH} x 1500 frames; train {c['train_ms']:.1f} / {c['train_mesh_ms']:.1f} "
          f"ms, prefill {c['prefill_ms']:.1f} / {c['prefill_mesh_ms']:.1f}, decodes "
          f"{fmt(c['decode_ms']['plain'])} / {fmt(c['decode_ms']['mesh'])}, Psi "
          f"{c['repr_ms']:.1f} / {c['repr_mesh_ms']:.1f} (no mesh / mesh, host clock; {smi}); "
          f"bitwise: train {c['train_bitwise']}, prefill {c['prefill_bitwise']}, decode "
          f"{c['decode_bitwise']}, Psi {c['repr_bitwise']}; K1 bitwise {c['k1']['bitwise']}; "
          f"launches {c['launches']}; peak {gb(c['peak'])}; took {c['s']:.1f} s")
    assert c["train_bitwise"] and c["prefill_bitwise"] and all(c["decode_bitwise"])
    assert c["repr_bitwise"] and c["repr_finite"] and c["k1"]["bitwise"]
    assert c["launches"] == {"train": {"prox_update.launches": c["n_leaves"]}, "prefill": {},
                             "decode": {}, "repr": {}}, c["launches"]
    add(c["launches"]["train"])

    # --- 18d: qwen2-1.5b's flash decode, one NCCL rank, then two gloo ranks
    for d in [one["d"]] + [r["d"] for r in two]:
        H, Hkv, hd = d["heads"]
        n = d["mesh"][1]
        for i, row in enumerate(d["rows"]):
            assert row["logits_rel"] <= d["tol"] and row["written_rel"] <= d["tol"], (i, row)
            assert row["cache_unwritten_bitwise"], (i, row)
            assert row["core_all_reduces"] == 3 * d["layers"], (i, row)
            assert row["core_elems"] == sorted({STEPS_BATCH * H, STEPS_BATCH * H * hd}), row
        print(f"[flash18d] qwen2-1.5b full width, fp32, mesh {d['mesh']} ({n} rank(s) each "
              f"holding {(STEPS_SEQ + FLASH18_STEPS) // n} of the cache's "
              f"{STEPS_SEQ + FLASH18_STEPS} entries): {FLASH18_STEPS} steps, logits largest "
              f"|diff| / max |logit| against the plain decode without a mesh "
              f"{max(r['logits_rel'] for r in d['rows']):.3e}, written cache entries "
              f"{max(r['written_rel'] for r in d['rows']):.3e} (gate {d['tol']}), every other "
              f"entry bitwise; {3 * d['layers']} flash all-reduces a step of "
              f"{d['rows'][0]['core_elems']} elements")
        print(f"[flash18d] mesh {d['mesh']} ms a step (host clock; {smi}): plain decode no "
              f"mesh {fmt(d['walls']['plain'])}; flash {fmt(d['walls']['flash'])}; plain on the "
              f"mesh {fmt(d['walls']['mesh'])}; bytes the collectives send a step: flash "
              f"{d['sent']['flash'][-1]}, plain on the mesh {d['sent']['mesh'][-1]} (the cache "
              f"holds {d['cache_bytes']} bytes); took {d['s']:.1f} s")
    shutil.rmtree(root, ignore_errors=True)
    print(f"[steps18] phase 18 took {time.perf_counter() - t_phase:.1f} s")
    k5_errs = [a["k5_errs"]] + [x["k5_errs"] for x in b]
    return total, [max(e[i] for e in k5_errs) for i in (0, 1)]


# ----------------------------------------------------------------- phase 19
WARM_FLAG = "--warm-start"        # runs warm_start_main, one process of 19a
# the driver's classification defaults, K1 through --fused-step (the tree step is plain)
WARM_ARGV = ["--rounds", "1", "--fused-step", "--device", "cuda"]
WARM_TIMEOUT_S = 240
OPTIM_STEPS = 3                   # 19b: clipped optimiser steps on path 1's MLP
OPTIM_RTOL = 1e-6                 # 19b: the card against the CPU, of the largest magnitude
SCREEN_GAP = 2e-5                 # 19d: τ at least this far from every row's largest cosine


def screen_inputs(state):
    """Path 1's Ψ rows of all its clients and the cluster means of its last
    round (``ClusterState.cluster_means``), as host copies kept for 19d."""
    import torch
    from repro_torch.engine import strategies
    reps = torch.stack([strategies._psi(state.ctx, c) for c in range(len(state.ctx.clients))])
    _, means = state.clusters.cluster_means()
    return reps.cpu(), means.cpu()


def warm_start_main(spec) -> int:
    """19a's child (``chip_smoke.py --warm-start SPEC``): once ``spec["go"]``
    exists, ``launch.train.main`` runs one classification round on the card
    with ``--compile-cache spec["dir"]``, the kernel library's first load
    timed, under ``sanitize.compile_budget``; writes the builds this
    process ran, that load's seconds, the budget's programs and cache hits,
    the library's path, the launches and ``launch.train``'s JSON to
    ``spec["out"]``."""
    from repro_torch.analysis import sanitize
    from repro_torch.kernels import _build
    from repro_torch.launch import train
    deadline = time.perf_counter() + WARM_TIMEOUT_S
    while spec["go"] and not os.path.exists(spec["go"]):
        assert time.perf_counter() < deadline, "no go from phase 19"
        time.sleep(0.05)
    real, load_s = _build.load, []

    def timed_load():
        if _build._lib is not None:
            return real()
        t0 = time.perf_counter()
        lib = real()
        load_s.append(time.perf_counter() - t0)
        return lib

    _zero_counts()
    with patched(_build, "load", timed_load), sanitize.compile_budget() as budget:
        out = train.main(WARM_ARGV + ["--compile-cache", spec["dir"]])
    with open(spec["out"], "w") as f:
        json.dump({"builds": _build.builds, "load_s": load_s, "lib": str(_build.library_path()),
                   "programs": budget.count, "cache_hits": budget.cache_hits,
                   "captures": budget.captures, "launches": _launched(), "out": out}, f)
    return 0


def start_warm(tag, cache_dir, root, go=None):
    """Start a ``--warm-start`` child (once ``go`` exists, if given);
    ``finish_warm`` waits for it."""
    spec = {"dir": cache_dir, "go": go, "out": os.path.join(root, f"{tag}.json")}
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    sys.stdout.flush()
    with open(os.path.join(root, f"{tag}.log"), "w") as log:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), WARM_FLAG,
                                 json.dumps(spec)], env=env, stdout=log,
                                stderr=subprocess.STDOUT)
    return proc, spec, tag, root


def stop_warm(runs):
    """Kill the ``start_warm`` children that still run."""
    for proc, *_ in runs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def start_warm_pair():
    """19a's two children, started while phase 18's ranks hold the card
    (its host mostly waits on them): the cold child on an empty cache
    directory, the warm one once the cold one has written its results."""
    import tempfile
    root = tempfile.mkdtemp(prefix="warm19_")
    cache_dir = os.path.join(root, "cache")
    cold = start_warm("cold", cache_dir, root)
    return [cold, start_warm("warm", cache_dir, root, go=cold[1]["out"])]


def finish_warm(run):
    """The child's results; fails with its log if it failed."""
    proc, spec, tag, root = run
    try:
        proc.wait(timeout=WARM_TIMEOUT_S)
    finally:
        stop_warm([run])
    with open(os.path.join(root, f"{tag}.log")) as log:
        assert proc.returncode == 0, f"[warm19a] {tag} failed:\n{log.read()[-3000:]}"
    with open(spec["out"]) as f:
        return json.load(f)


def check_optimisers(dev):
    """19b: ``clip_by_global_norm`` then ``sgd_momentum`` (Nesterov) or
    ``adam`` (weight decay) and ``apply_updates``, ``OPTIM_STEPS`` steps
    over path 1's MLP tree on the card (under ``sanitize.no_transfer()``) and on
    the CPU from the same parameters and gradients; returns the largest
    |card - CPU| over parameters, norms and moments, each relative to the
    largest magnitude of the CPU's tensor (the norms, ~392, are sums in
    another order)."""
    import torch
    from repro_torch import optim
    from repro_torch.analysis import sanitize
    from repro_torch.optim.sgd import apply_updates, clip_by_global_norm
    from repro_torch.utils import trees
    params = main_setting()[2]
    g = torch.Generator().manual_seed(19)
    grads = [trees.tree_map(lambda p: torch.randn(p.shape, generator=g), params)
             for _ in range(OPTIM_STEPS)]
    worst = {}
    for name, opt in (("sgd_momentum nesterov", optim.sgd_momentum(0.05, 0.9, nesterov=True)),
                      ("adam weight_decay", optim.adam(1e-3, weight_decay=0.01))):
        runs = {}
        for where in ("cpu", dev):
            p = trees.tree_map(lambda x: x.to(where), params)
            placed = [trees.tree_map(lambda x: x.to(where), gr) for gr in grads]
            state, norms = opt.init(p), []
            with sanitize.no_transfer() if where == dev else contextlib.nullcontext():
                for gr in placed:
                    clipped, norm = clip_by_global_norm(gr, 1.0)
                    updates, state = opt.update(clipped, state, p)
                    p = apply_updates(p, updates)
                    norms.append(norm)
            runs[str(where)] = [x.cpu() for x in trees.leaves(p) + norms + trees.leaves(
                {k: v for k, v in state.items() if k != "count"})]
            assert int(state["count"]) == OPTIM_STEPS
        worst[name] = max(float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)
                          for a, b in zip(runs["cpu"], runs[str(dev)]))
    print(f"[optim19b] {OPTIM_STEPS} steps of clip_by_global_norm(1.0) + optimiser + "
          f"apply_updates over path 1's MLP ({sum(p.numel() for p in params.values())} "
          f"parameters), the card's steps under no_transfer(): largest |card - CPU| / "
          f"max |CPU| over parameters, norms and moments {worst} (gate {OPTIM_RTOL})")
    assert max(worst.values()) <= OPTIM_RTOL, worst
    return worst


def adam_full_width(dev, bw, smi):
    """19c: one ``adam`` step with weight decay plus ``apply_updates`` over
    qwen2-1.5b's full-width fp32 parameter tree: the first step under
    ``sanitize.no_transfer()`` (no host read), a second unguarded (the
    guard's Python dispatch would be timed too); each step's ms (CUDA
    events), the peak, and the bytes
    bound (parameters, gradients, m and v read once; parameters, m and v
    written once: 28 B a value)."""
    import torch
    from repro_torch import optim
    from repro_torch.analysis import sanitize
    from repro_torch.optim.sgd import apply_updates
    from repro_torch.utils import trees
    torch.cuda.empty_cache()
    cfg, model = serve_setting("qwen2-1.5b")
    g = torch.Generator(device=dev).manual_seed(0)
    params = model.init(g, dev)
    grads = trees.tree_map(lambda p: 1e-3 * torch.randn(p.shape, generator=g, device=dev),
                           params)
    n = trees.tree_size(params)
    opt = optim.adam(1e-4, weight_decay=0.01)
    state = opt.init(params)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for guard in (sanitize.no_transfer, contextlib.nullcontext):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with guard():
            start.record()
            updates, state = opt.update(grads, state, params)
            params = apply_updates(params, updates)
            end.record()
        del updates
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()
    bound_ms = 28 * n / bw * 1e3
    finite = bool(torch.stack([torch.isfinite(x).all() for x in trees.leaves(params)]).all())
    print(f"[adam19c] {cfg.name} full width fp32: {n} parameters ({len(trees.leaves(params))} "
          f"leaves); adam(1e-4, weight_decay=0.01) + apply_updates: first step (under "
          f"no_transfer()) {times[0]:.3f} ms, second {times[1]:.3f} ms (CUDA events; {smi}); "
          f"bytes bound {bound_ms:.3f} ms (28 B a value at {bw / 1e12:.2f} TB/s; the plain "
          f"per-leaf chain takes {times[1] / bound_ms:.1f}x it); peak "
          f"{peak / 1e9:.2f} GB (held before the step {base / 1e9:.2f} GB); count "
          f"{int(state['count'])}, parameters finite {finite}")
    assert finite and int(state["count"]) == 2
    del params, grads, state
    torch.cuda.empty_cache()
    return times, bound_ms, peak


def check_screen(dev, reps, means):
    """19d: ``byzantine_distance_screen`` over path 1's Ψ rows against its
    last round's cluster means, on the card and on the CPU, at τ = 0 and
    at τ midway between two neighbouring largest cosines near their
    median, ``SCREEN_GAP`` from every row's: the masks equal."""
    import torch
    from repro_torch.core.aggregators import byzantine_distance_screen
    r64, m64 = reps.double(), means.double()
    best = ((r64 / r64.norm(dim=1, keepdim=True)) @ (m64 / m64.norm(dim=1, keepdim=True)).T)
    best = torch.sort(best.amax(dim=1)).values
    i = len(best) // 2
    while best[i + 1] - best[i] < 2 * SCREEN_GAP:
        i += 1
    taus = [0.0, float((best[i] + best[i + 1]) / 2)]
    rd, md = reps.to(dev), means.to(dev)
    for tau in taus:
        assert float((best - tau).abs().min()) >= SCREEN_GAP
        got = byzantine_distance_screen(rd, tau)(md)
        want = byzantine_distance_screen(reps, tau)(means)
        assert got.device == rd.device and got.dtype == torch.bool
        same = bool(torch.equal(got.cpu(), want))
        print(f"[screen19d] {tuple(reps.shape)} Psi rows against {means.shape[0]} cluster "
              f"means, all on the card, tau {tau:.6f}: keeps {int(got.sum())}; equal to the "
              f"CPU's mask {same}")
        assert same
    del rd, md


def check_nan_guard(dev):
    """19e: ``sanitize.nan_guard`` on the card. K1 fed a NaN gradient raises
    ``FloatingPointError`` naming ``prox_update`` (the wrapper's output
    check: a ctypes launch passes no dispatcher), and one clean path-1
    round (``main_setting``, eager, host backend) raises nothing."""
    import torch
    from repro_torch import engine
    from repro_torch.analysis import sanitize
    from repro_torch.kernels import _build, prox_update

    before = _build.launch_counts()
    n = 153610
    th, om = torch.zeros(n, device=dev), torch.zeros(n, device=dev)
    g = torch.zeros(n, device=dev)
    g[n // 2] = float("nan")
    t0 = time.perf_counter()
    try:
        with sanitize.nan_guard():
            prox_update.prox_update_flat(th, om, g, torch.zeros_like(g), 0.1, 0.05)
        raised = ""
    except FloatingPointError as e:
        raised = str(e)
    assert raised.startswith("prox_update produced a NaN"), raised
    clients, _, params, loss, cfg = main_setting()
    state = engine.init("stocfl", loss, params, clients, cfg, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with sanitize.nan_guard():
        state, rec = engine.run_round(state)
        torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    print(f"[sanitize] 19e nan_guard: K1 fed a NaN gradient raised FloatingPointError "
          f"({raised!r}); one clean path-1 round under the guard raised nothing "
          f"({rec['sampled']} sampled, {rec['n_clusters']} clusters, {secs:.2f} s with every "
          f"op checked; {time.perf_counter() - t0:.2f} s in all)")
    # these launches check the guard, not a path: off the counters again
    after = _build.launch_counts()
    _build.add_launches({k: after[k] - before[k] for k in after}, -1)
    del state
    torch.cuda.empty_cache()


def phase_19(dev, smi, bw, screen, warm_runs):
    """Phase 19: the optimisers, the Byzantine screen and the kernel
    library's warm start. ``warm_runs`` are ``start_warm_pair``'s two
    children, each one classification round through the driver with
    ``--compile-cache`` on one directory, empty at first, the second
    started after the first: the first builds the library there, the
    second builds nothing and launches K1 and K2 from it. The checks
    19b-d run here, then the children's results are read. Returns the
    children's K1 and K2 launches."""
    import shutil
    t_phase = time.perf_counter()
    try:
        check_optimisers(dev)
        adam_full_width(dev, bw, smi)
        check_screen(dev, *screen)
        check_nan_guard(dev)
        first, second = (finish_warm(run) for run in warm_runs)
    finally:
        stop_warm(warm_runs)
    cache_dir = warm_runs[0][1]["dir"]
    for tag, r in (("cold", first), ("warm", second)):
        print(f"[warm19a] {tag} process: builds {r['builds']}, library {r['lib']}, its load "
              f"{', '.join(f'{t:.3f}' for t in r['load_s'])} s (nvcc and dlopen, or dlopen "
              f"only), launches {r['launches']}; driver JSON {r['out']}")
    lib = os.path.join(cache_dir, os.path.basename(first["lib"]))
    assert first["builds"] == 1 and second["builds"] == 0, (first["builds"], second["builds"])
    for tag, r in (("cold", first), ("warm", second)):
        print(f"[sanitize] 19a {tag} child under compile_budget(): count {r['programs']}, "
              f"cache_hits {r['cache_hits']}, captures {r['captures']}")
    assert (first["programs"], first["cache_hits"]) == (1, 0), first
    assert (second["programs"], second["cache_hits"]) == (0, 1), second
    assert len(first["load_s"]) == len(second["load_s"]) == 1
    assert first["lib"] == second["lib"] == lib and os.path.exists(lib)
    for r in (first, second):
        assert r["launches"].get("prox_update.launches", 0) > 0, r["launches"]
        assert r["launches"].get("cosine_sim.launches", 0) > 0, r["launches"]
        assert r["out"]["rounds"] == 1 and math.isfinite(r["out"]["global_avg_acc"])
    shutil.rmtree(warm_runs[0][3], ignore_errors=True)
    print(f"[phase19] took {time.perf_counter() - t_phase:.1f} s (the children ran "
          f"during phase 18)")
    return {k: first["launches"][f"{k}.launches"] + second["launches"][f"{k}.launches"]
            for k in ("prox_update", "cosine_sim")}


# ----------------------------------------------------------------- phase 20
DRY20_FLAG = "--dryrun20"         # runs dryrun20_main, phase 20's child
DRY20_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
DRY20_TIMEOUT_S = 900
DRY20_SMALL = ("qwen2-1.5b", "falcon-mamba-7b")   # smoke configs, traced and run on the card
DRY20_SMALL_BATCH, DRY20_SMALL_SEQ = 4, 64


def dryrun20_main(spec) -> int:
    """Phase 20's child (``chip_smoke.py --dryrun20 SPEC``): the dry run
    (``repro_torch.launch.dryrun``) on fake CUDA tensors over a fake world
    of 512 ranks, probes extrapolated: qwen2-1.5b on the single (32, 8)
    mesh for all four shapes, falcon-mamba-7b train_4k on the multi (2,
    32, 8) mesh with ``use_pallas`` (K1, K5 and the ``pod`` axis); one
    2-layer falcon-mamba trace on that mesh, whose hand-written kernels'
    ops are counted; and 17a's own configuration (qwen2-1.5b full width in
    fp32, 2 x 256 tokens) on a 1 x 1 fake mesh, its predicted peak. Writes
    the results as JSON to ``spec["out"]``."""
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_mesh, make_production_mesh
    from repro_torch.models.config import INPUT_SHAPES, InputShape
    from repro_torch.utils import trees

    t0 = time.perf_counter()
    single = make_production_mesh(device="cuda")
    multi = make_production_mesh(multi_pod=True, device="cuda")
    recs = [dryrun.run_one("qwen2-1.5b", s, False, None, mesh=single) for s in DRY20_SHAPES]
    recs.append(dryrun.run_one("falcon-mamba-7b", "train_4k", True, None, mesh=multi,
                               overrides={"use_pallas": True}))
    cfg = get_config("falcon-mamba-7b").with_(n_layers=2, use_pallas=True)
    kernels = dryrun.trace_step(cfg, INPUT_SHAPES["train_4k"], multi, "train")["kernels"]
    cfg17, _ = serve_setting("qwen2-1.5b")
    one = fake_mesh((1, 1), ("data", "model"), "cuda")
    m17 = dryrun.trace_step(cfg17, InputShape("train", STEPS_SEQ, STEPS_BATCH, "train"), one,
                            "train")
    mem = ("argument_bytes", "temp_bytes", "output_bytes")
    out = {"records": recs, "kernels": kernels, "patched": dryrun.patched_sites(),
           "pred17": {k: m17[k] for k in mem}, "kernels17": m17["kernels"],
           "seconds": time.perf_counter() - t0, "torch": torch.__version__,
           "cuda_allocated": torch.cuda.memory_allocated(), "small": {}}
    # the memory model on real tensors: smoke configs' train steps without a
    # mesh, traced and then run on the card (a few MB beside the phases the
    # parent runs; this process's peak counter is its own)
    for arch in DRY20_SMALL:
        cfg, model = serve_setting(arch, smoke=True)
        shape = InputShape("train", DRY20_SMALL_SEQ, DRY20_SMALL_BATCH, "train")
        pred = dryrun.trace_step(cfg, shape, None, "train", device="cuda")
        g = torch.Generator(device="cuda").manual_seed(0)
        theta = model.init(g, "cuda")
        omega = trees.tree_map(lambda x: x.clone(), theta)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (DRY20_SMALL_BATCH, DRY20_SMALL_SEQ),
                                         generator=g, device="cuda", dtype=torch.int32)}
        step = dryrun._unbound(model, "train", 0.1, 0.05)
        step(theta, omega, batch)                       # the kernels' first launch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        res = step(theta, omega, batch)
        torch.cuda.synchronize()
        out["small"][arch] = {"pred": {k: pred[k] for k in mem}, "base": base,
                              "peak": torch.cuda.max_memory_allocated()}
        del res, theta, omega, batch
    with open(spec["out"], "w") as f:
        json.dump(out, f)
    return 0


def start_dryrun20():
    """Start phase 20's child after phase 8's child, beside phases 9-16
    (it needs the host, a core, and on the card only its context, which
    phase 8's and 17's near-full card should not have to hold);
    returns (process, results path, start time)."""
    import tempfile
    sys.stdout.flush()
    root = tempfile.mkdtemp(prefix="dryrun20_")
    out = os.path.join(root, "dryrun20.json")
    with open(os.path.join(root, "log.txt"), "wb") as log:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), DRY20_FLAG,
                                 json.dumps({"out": out})], stdout=log, stderr=subprocess.STDOUT)
    return proc, out, time.perf_counter()


def stop_child(proc) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def finish_dryrun20(dry_run) -> dict:
    """Wait for phase 20's child (before phase 17, whose ranks fill the
    card) and read its results; the seconds waited are added."""
    proc, path, t_start = dry_run
    t0 = time.perf_counter()
    try:
        proc.wait(timeout=max(DRY20_TIMEOUT_S - (t0 - t_start), 1.0))
    except subprocess.TimeoutExpired:
        stop_child(proc)
        raise AssertionError(f"phase 20's child outlasted {DRY20_TIMEOUT_S} s")
    if proc.returncode != 0:
        with open(os.path.join(os.path.dirname(path), "log.txt"), "rb") as f:
            raise AssertionError(f"phase 20's child exited with {proc.returncode}:\n"
                                 + f.read().decode(errors="replace")[-6000:])
    with open(path) as f:
        return dict(json.load(f), waited=time.perf_counter() - t0)


def phase_dryrun(smi, res, a17):
    """Phase 20: the dry run's records (a model of a cluster of 256 or 512
    H100s, not a measurement), each ``ok``, and 17a's predicted peak beside
    the peak its first mesh train step measured (``a17``, ``steps17a``'s
    results: that step alone, from its arguments and what else was live)."""
    gb = lambda n: f"{n / 1e9:.3f} GB"
    print(f"[dryrun20] child (torch {res['torch']}): {res['seconds']:.1f} s beside phases "
          f"9-16, waited {res['waited']:.1f} s before phase 17; DTensor internals patched "
          f"{res['patched']}; its CUDA allocations {res['cuda_allocated']} bytes (fake "
          f"tensors hold none)")
    for r in res["records"]:
        assert r["status"] == "ok", r
        coll = r["collective_bytes_per_device"]
        print(f"[dryrun20] {r['arch']} {r['shape']} {r['mesh']} ({r['variant']}, "
              f"{r['n_devices']} {r['device']} ranks, {r['cost_source']}, trace "
              f"{r['lower_s']} s + probes {r['probe_s']} s): per device FLOPs "
              f"{r['flops_per_device']:.4e}, bytes {r['bytes_per_device']:.4e} (unfused), "
              f"collective bytes {coll['total']:.4e} {r['collective_bytes_by_axis']}, "
              f"arguments {gb(r['memory']['argument_bytes'])}, temp "
              f"{gb(r['memory']['temp_bytes'])}; terms ms "
              + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in r["terms"].items())
              + f", dominant {r['dominant']}; useful FLOPs ratio {r['useful_flops_ratio']:.4f} "
              f"(a model of a cluster of {r['n_devices']} H100s, not a measurement)")
    k = res["kernels"]
    print(f"[dryrun20] falcon-mamba-7b at 2 layers, train_4k, multi, use_pallas, on fake CUDA "
          f"tensors: the hand-written kernels' ops {k} (each launch one op, its shape-only "
          f"path)")
    assert k.get("prox_update_", 0) > 0 and k.get("ssm_scan_fwd", 0) > 0, k
    assert k.get("ssm_scan_bwd", 0) > 0, k
    p = res["pred17"]
    pred = p["argument_bytes"] + p["temp_bytes"]
    base, peak = a17["step_base"], a17["step_peak"]
    print(f"[dryrun20] 17a's configuration (qwen2-1.5b fp32, {STEPS_BATCH} x {STEPS_SEQ}, 1 x 1 "
          f"mesh): predicted arguments {gb(p['argument_bytes'])} + temp {gb(p['temp_bytes'])} "
          f"= {gb(pred)} against 17a's first mesh train step: {gb(base)} live before it, "
          f"peak {gb(peak)}, temp {gb(peak - base)} (torch.cuda.max_memory_allocated; {smi}): "
          f"predicted / measured peak {pred / peak:.4f}, arguments {p['argument_bytes'] / base:.4f}, "
          f"temp {p['temp_bytes'] / (peak - base):.4f}; against its step on arguments "
          f"placed beforehand (the dry run's model: {gb(a17['placed_bytes'])} placed), temp "
          f"{gb(a17['placed_peak'] - a17['placed_base'])}: predicted / measured temp "
          f"{p['temp_bytes'] / (a17['placed_peak'] - a17['placed_base']):.4f}, arguments "
          f"{p['argument_bytes'] / a17['placed_bytes']:.4f}; K1 ops on the trace "
          f"{res['kernels17']}")
    for arch, x in res["small"].items():
        q, base, peak = x["pred"], x["base"], x["peak"]
        pred = q["argument_bytes"] + q["temp_bytes"]
        print(f"[dryrun20] {arch} smoke, fp32, a train step of {DRY20_SMALL_BATCH} x "
              f"{DRY20_SMALL_SEQ} tokens without a mesh: predicted arguments "
              f"{q['argument_bytes']} + temp {q['temp_bytes']} bytes against {base} live before "
              f"the step on the card and a peak of {peak} (temp {peak - base}; "
              f"torch.cuda.max_memory_allocated): predicted / measured peak "
              f"{pred / peak:.4f}, temp {q['temp_bytes'] / max(peak - base, 1):.4f}")


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
    if sys.argv[1:2] == [STEPS_FLAG]:
        return steps_rank_main(json.loads(sys.argv[2]))
    if sys.argv[1:2] == [STEPS18_FLAG]:
        return steps18_rank_main(json.loads(sys.argv[2]))
    if sys.argv[1:2] == [WARM_FLAG]:
        return warm_start_main(json.loads(sys.argv[2]))
    if sys.argv[1:2] == [DRY20_FLAG]:
        return dryrun20_main(json.loads(sys.argv[2]))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    marks = [("start", time.perf_counter())]
    mark = lambda tag: marks.append((tag, time.perf_counter()))
    dry_run = []
    try:
        return _phases(dev, name, smi, marks, mark, t_start, dry_run)
    finally:
        for run in dry_run:
            stop_child(run[0])


def _phases(dev, name, smi, marks, mark, t_start, dry_run) -> int:
    import torch

    from repro_torch.kernels import cosine_sim, prox_update, resolve_roots
    phase_build()
    mark("1")
    kernels = phase_kernels(dev, card_peaks(name))
    mark("2")
    launches, path_err, path1 = phase_main_path(dev)
    screen = screen_inputs(path1[-1]["state"])
    mark("3")
    for k in ("prox_update", "cosine_sim"):
        kernels[k]["launches"] = launches[k]
    kernels["cosine_sim"]["max_abs_err"] = max(kernels["cosine_sim"]["max_abs_err"],
                                               path_err)
    _, _, _, _, cfg = main_setting()
    phase_trace(dev, cfg, False, "trace", {
        "prox_update": (lambda: prox_update.launches, ("prox_update",)),
        "cosine_sim": (lambda: cosine_sim.launches, ("cosine_kernel",))})
    mark("4")
    launches2, path2 = phase_device_path(dev, path1)
    mark("5")
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
    mark("6")
    del path2
    phase_scale(dev)
    mark("7")
    launches3, expect = phase_llm_path(dev)
    mark("8 path3")
    for k in ("ssm_scan_fwd", "ssm_scan_bwd"):
        kernels[k]["launches"] = launches3[k]
    phase_llm_parity(expect)
    mark("8 parity")
    dry_run.append(start_dryrun20())
    phase_llm_smoke(dev)
    mark("9")
    kernels["prox_theta"]["launches"] = phase_baselines(dev)
    mark("10")
    phase_sampler(dev)
    mark("11a")
    kernels["prox_update_bf16"]["launches"] = phase_llm_bf16(dev, expect)
    mark("11b")
    phase_captured(dev)
    mark("11c-d")
    churn = phase_churn(dev)
    mark("12a")
    async_launches, k2_err = phase_async_churn(dev)
    mark("12b-c")
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
    mark("13a")
    serve_launches, k5_errs = phase_serve_mamba(dev)
    mark("13b")
    for k, err in zip(("fwd", "bwd"), k5_errs):
        entry = kernels[f"ssm_scan_{k}"]
        entry["launches"] += serve_launches[f"ssm_scan.{k}_launches"]
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
    phase_serve_smoke(dev)
    mark("13c")
    launches14, k2_err14 = phase_14(dev, card_peaks(name))
    mark("14")
    for k, n in launches14.items():
        kernels[k]["launches"] += n
    kernels["cosine_sim"]["max_abs_err"] = max(kernels["cosine_sim"]["max_abs_err"], k2_err14)
    launches15, k2_err15 = phase_15(dev)
    mark("15")
    for k, n in launches15.items():
        kernels[k]["launches"] += n
    kernels["cosine_sim"]["max_abs_err"] = max(kernels["cosine_sim"]["max_abs_err"], k2_err15)
    hand_over_card("mesh16")
    for k, n in phase_mesh(smi).items():
        kernels[k]["launches"] += n
    mark("16")
    dry = finish_dryrun20(dry_run[0])
    hand_over_card("steps17")
    k1_17, a17 = phase_steps_mesh(smi)
    kernels["prox_update"]["launches"] += k1_17
    mark("17")
    hand_over_card("steps18")
    warm_runs = start_warm_pair()
    try:
        launches18, k5_errs18 = phase_model_axis(smi)
    except BaseException:
        stop_warm(warm_runs)
        raise
    mark("18")
    for k, n in launches18.items():
        kernels[k]["launches"] += n
    for k, err in zip(("fwd", "bwd"), k5_errs18):
        entry = kernels[f"ssm_scan_{k}"]
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
    for k, n in phase_19(dev, smi, card_peaks(name)[0], screen, warm_runs).items():
        kernels[k]["launches"] += n
    mark("19")
    phase_dryrun(smi, dry, a17)
    mark("20")
    print("[phases] seconds: " + ", ".join(
        f"{tag} {t - marks[i][1]:.1f}" for i, (tag, t) in enumerate(marks[1:])))
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
