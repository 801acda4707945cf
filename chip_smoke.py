#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold it against its plain
versions.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100. It
imports nothing of JAX and nothing of the JAX package ``repro``.

Every aggregation with ``backend=None`` goes through the measured dispatch
table (``src/repro_torch/agg/tables/cuda.json``), which gives each shape
bucket B1's measured lane count; on the card every decision is B1. So
every count of B1 launches below is a count of dispatch decisions, each
one B1 launch (``check_launches``); the holds of the card against the CPU
(phases 5, 10, 14, 20 and 26) run under ``platform_rule()``, B1 at its
planner's lanes as before the table, and phase 17 forces B1
(``use_pallas``).
Phases, each of which ends the run with a nonzero exit code on failure:

1. Device: the card's name and power limit (nvidia-smi) and its torch name.
2. Build: compiles ``src/repro_torch/agg/csrc/ostat.cu`` and
   ``src/repro_torch/kernels/csrc/gqa_decode.cu``, one nvcc each, started
   together, into the gitignored ``_build/`` beside each, and prints the
   build seconds, each kernel's registers, shared memory and spills as
   ptxas reports them (B2's split pass at head dims 64, 112 and 128), and
   B2's plan at the main shape and at zamba2-7b's (head dim 112) (chunk,
   blocks, resident blocks per SM, waves).
3. Kernel against its plain version on the card, all seven ops at every
   shape the main path launches at (Figure 1 trusted and untrusted,
   Figures 3/6, the one-coordinate s1 summaries, the sweep presets'
   replicate batches and the baselines') and at the agg-sweep, mid and
   gradient shapes (n_bisect = 60): ``kth`` and
   ``median`` bit-equal, the rest within 1e-5 * max(1, |ref|) at the
   99.9th percentile of the error; the same gate against the sort-based
   reference. Times the kernel, its plain version and, where one PyTorch
   call computes the same function, that call, each as device time from a
   CUDA graph replay; and the kernel's wrapper called eagerly, which
   includes the host's time per call. Then checks (untimed) every op at
   the lane-group edges of the kernel's plan (m from 1 to 15,000, ragged
   p, B > 1). Then the serving and training paths' shapes (phases 11-20:
   the fleets' (1, m, 10) and their 70% fills, the reduced glm4-9b's
   leaves at fill 45 and at 4 machines, and the full-width leaves at fills
   4 and 3), each for the ops launched there and the median (the training
   shapes for mean, dcq_mad and median, the zoo's full-width and reduced
   leaves of phases 21-28 among them), beside ``torch.median`` (and
   ``torch.mean`` for mean): the same gates, checked over column blocks of
   2^24 coordinates; shapes past 2^24 coordinates are timed eagerly
   (milliseconds per launch) and their plain version once over its column
   blocks. Every leaf is the reference's stacked leaf (``Model.params()``:
   embed and lm_head 620,756,992 coordinates at full width, the stacked
   mlp leaves 112,197,632, w_q and w_o 33,554,432, w_k and w_v 2,097,152,
   norm1 and norm2 8,192, norm_f 4,096).
4. Algorithm 1 on the card at the paper's sizes (§5.1 Figure 1: logistic,
   m = 50, n = 1000, p = 10, eps = 30, delta = 0.05, 20 replicates;
   10% Byzantine under scale -3; Poisson; untrusted center; Figures 3/6:
   m = 80, n = 500) through ``DPQNProtocol.run_monte_carlo`` with draws
   from a CUDA generator. The warm-up run holds every kernel launch
   against the plain version on the same tensors and checks that phase 3
   timed each shape it launched at. Prints MRSE and replicates/s, and
   asserts that every center-side aggregation was decided once and
   launched B1 once; a
   profiler trace of one more run gives the device's busy time and idle
   share.
5. Card against CPU: the Figure 1 setting, trusted and untrusted center,
   with draws made once on the CPU and handed to both sides;
   theta_cq/os/qn agree within atol = rtol = 1e-4.
6. GQA flash-decode (kernel B2) against its plain version and the library
   call (``scaled_dot_product_attention`` with ``enable_gqa`` and a boolean
   mask from ``cache_len``, which the port never calls): the main shape
   (B = 8, Hq = 32, Hkv = 2, Dh = 128, S = 32,768, bf16) at cache_len 16,
   4,096 and 32,768 and one ragged vector, the four shapes of the JAX
   shape sweep in f32 and bf16, and a length-invariance check (garbage of
   100x the scale past cache_len must leave the output bit-equal). f32
   within atol = 2e-5, rtol = 1e-4 of the plain version; bf16 within one
   bf16 rounding (rtol = 2^-7) of the plain version in bf16, and within
   atol = rtol = 0.05 of the plain version on the f32-widened inputs. Times
   as phase 3, with the bound (bytes up to cache_len, or flops), and
   B2's plan for each shape; qwen3-moe's decode shape (Hq 32, Hkv 4, Dh
   128) at cache_len 16, 4,096 and 32,768, and the catalogue's last
   decode shapes, each at cache_len 16, half, full and ragged: zamba2-7b's
   (8, 4,096, 32, 32, 112), also in f32 (with the bound at the bytes the
   bf16 kernel reads: a Dh-112 row is two 64-column TMA boxes, 128/112 of
   its bytes), llava's (8, 32,768, 32, 8, 128), musicgen's (8, 2,048, 24,
   24, 64) and starcoder2's (8, 32,768, 48, 4, 128); the model shapes are
   held by ``gqa_check_model`` (see phase 22), with whether ``gqa_check``
   holds recorded beside; the reduced zoo's (Hq = Hkv = 4, Dh 64, f32)
   and the reduced hybrid at head dim 112 (2, 8, 2, 2, 112) too.
7. The decode slice at full width: glm4-9b (40 layers, d_model 4096, 9.40 B
   parameters, bf16, weights drawn on the card from a seeded generator),
   B = 8 requests, a KV cache of 32,768 slots. Run "ctx-short": a 16-token
   prompt from an empty cache through ``Model.decode_step``, then 48 greedy
   tokens. Run "ctx-32k": the first 32,704 cache slots of every layer
   filled from the generator and ``pos`` set there (a stand-in for a
   prefill, which the JAX package's decode path does not have), then the
   same 16 + 48 steps, ending at a full cache. A warm-up step holds every
   B2 launch against the plain version on the same tensors; the timed
   steps must make 40 B2 launches each and give finite logits. Prints
   tokens/s, the median step, peak device memory and a profiler trace of
   one step (device busy, idle share, busiest device operations).
8. Card against CPU for the decode path: glm4-9b at full width with its
   depth cut to 2 layers so that a CPU copy fits, f32, B = 2, 12 steps from
   an empty cache, the same weights on both sides and the CPU's greedy
   tokens fed to both: logits within atol = rtol = 1e-3 (f32 sums over up
   to 13,696 terms in another order), the same greedy tokens.
9. The scenario sweep (paper §5.1 Figures 1-6, §5.2 Table 1) through
   ``python -m repro_torch.sweep``'s ``main`` on the card, in full: the
   presets ``paper`` (47 scenarios), ``untrusted`` (48),
   ``attack-sensitivity`` (126), ``smoke`` (18) and ``smoke --accountant
   rdp``, each with the kernel's counter set to 0 before and read after.
   The first group's launches of each preset are held against the plain
   version, every launched shape must be one phase 3 timed (phase 3 reads
   the sweep's shapes off the presets), every artifact must validate and
   hold every scenario with finite metrics and the expected launches.
   Prints scenarios, groups, wall seconds, scenarios/s and launches per
   preset, the Figure 1 logistic MRSE-vs-eps rows and the Table 1
   accuracies, and a profiler trace of one fig-eps group.
9b. The Newton and GD baselines at the Figure 1 size, 20 runs each with
   every launch held against the plain version: MRSE beside theta_qn's,
   bytes per machine.
10. Card against CPU: one fig-eps group (logistic, 10% Byzantine, 5
   budgets) through the executor and one run of each baseline, with data
   and draws made once on the CPU and handed to both sides: metrics and
   thetas within atol = rtol = 1e-4 (a row's scale is its largest |theta|,
   so a diverging replicate is compared relatively).
11. The streaming aggregation service at the reference's serve benchmark
   setting (``BENCH_serve.json``): fleets of 64, 1,024 and 16,384
   machines, p = 10, ``dcq_mad``, eps = 1, ingest block min(1024, m), 4
   rounds and one partial round at 70% fill through an explicit flush.
   Prints cold and steady flush ms, ingest-to-update ms, updates/s and B1
   launches per fleet; checks a buffer against its dense prefix byte for
   byte at three fills, and holds every B1 launch of a second service's
   first two rounds against the plain version.
12. The launcher, ``python -m repro_torch.launch.serve``'s ``main`` on the
   card (reduced glm4-9b, 64 machines, 5 rounds, ``dcq_mad``, eps = 1, 25%
   signflip, 30% dropout, ingest block 8): 5 rounds at fill 45, one B1
   launch per leaf and round (12 leaves, 60 launches), a finite theta,
   the ledger and the accountant; a first run holds every launch against
   the plain version.
13. A full-width theta: glm4-9b's parameters at full width cut to 2
   layers (12 stacked leaves, 1,649,430,528 parameters, bf16), capacity
   4, 12 launches per round: a
   capacity flush at fill 4 (median, every launch held against the plain
   version over column blocks), an explicit flush at fill 3 (dcq_mad, eps
   = 1) and a capacity flush at fill 4 with one signflip machine
   (dcq_mad). Prints flush ms and peak device memory (fails above 64 GB).
14. Serve, card against CPU: the same CPU-drawn updates and noise
   (``flush(noise=)``) to a service on each side, m = 1,024, p = 10, 3
   rounds, the last partial: ``dcq_mad`` thetas within atol = rtol =
   1e-5, ``median`` bit-equal.
15. Training at full width: glm4-9b (``hf:THUDM/glm-4-9b``) at full width
   cut to 2 layers (1,649,430,528 bf16 parameters, 12 leaves), 4 machines
   of one sequence of train_4k's 4,096 tokens each, ``Trainer``'s step
   with AdamW (lr 3e-4), dcq_mad, machine 0 signflipped, remat. A warm-up
   step holds every B1 launch against the plain version over column
   blocks; then 5 timed steps (step ms, tokens/s, 12 B1 launches each)
   and one step under the profiler (device busy, idle share, B1's share
   of busy, busiest operations); then 2 steps with per-leaf calibrated DP
   noise (eps 1, each machine's 4,096 tokens its samples: at dp_n = 1 the
   sigmas are 0) and their ledger of 12 records. Fails on a non-finite
   loss, a launch count other than 12 in any step (the profiled step's
   included) or a peak above 64 GB.
16. The training launcher, ``python -m repro_torch.launch.train``'s
   ``main`` on the card (reduced glm4-9b, 12 steps, 4 machines, dcq, 25%
   scale attack): 12 launches per step, the last loss below the first; a
   first run holds every launch against the plain version.
17. Training card against CPU: the reduced glm4-9b in f32, batch 8 x 128,
   4 machines, remat, 3 steps of dcq_mad with eps 1 and machine 0
   signflipped, the same weights, tokens and standard normals (made on
   the CPU) on both sides: before each step the per-machine gradients
   leaf for leaf within 1e-4 of the leaf's largest magnitude (the DP
   noise, sigmas ~1e2-1e3, would hide a wrong backward pass in the
   aggregate), aggregated gradients within atol = rtol = 1e-4 at every
   step, losses within rtol = 1e-4, parameters within 1e-5 on at least
   99.99% of coordinates and within 2 * lr * steps on all.
18. The quasi-Newton protocol as the train step at full width: the same
   glm4-9b cut to 2 layers, 4 machines of two 2,048-token sequences each
   (n = 2 rows, 4,096 tokens a machine), ``TreeProtocolConfig(hist=1)``
   with the other defaults (lr 0.5, local_lr 0.1, dcq_mad, K 10), machine
   0 signflipped, remat: a warm-up step with every B1 launch held against
   the plain version over column blocks, 3 timed steps (step ms,
   tokens/s), one profiled step (idle share, B1's share of busy, busiest
   operations), then 1 step (2 before phases 33-35 came in) at eps 1 with the calibrated per-leaf sigmas
   (checked for running, launches and memory: at n = 2 the sigmas are
   large by design). Fails on a launch count other than 60 (5
   transmissions x 12 leaves) in any step, a non-finite loss or grad norm
   of a noiseless step, a memory count not (4,), or a peak of the steps
   above 72 GB.
19. The quasi-Newton launcher, ``python -m repro_torch.launch.train
   --optimizer qn``'s ``main`` on the card (reduced glm4-9b, 12 steps, 4
   machines, 25% signflip): 60 launches a step, finite losses, and a
   checkpoint under the reference's keys (``params/...``, ``opt/0/...``
   s_hist, ``opt/1/...`` y_hist, ``opt/2`` count) that ``restore`` reads
   back into an ``LBFGSMemory`` equal to the file; a first run holds every
   launch against the plain version.
20. The QN step card against CPU: reduced glm4-9b in f32, batch 8 x 128,
   4 machines, hist 5, machine 0 signflipped, every sigma 1e-3 on
   CPU-drawn normals handed to both sides, 3 steps of each of three runs
   (dcq_mad on two seeds, the median on one), each step from the CPU's
   parameters and memory: R2's per-machine gradients at the CPU's
   theta_cq within 1e-4 of each leaf's largest magnitude; counts equal;
   losses and grad norm within rtol 1e-4. The median: theta_cq, theta_os,
   theta_qn and the memory within atol = rtol = 1e-4 on every coordinate.
   dcq_mad: theta_cq and theta_os on 99.99% of the coordinates, theta_qn
   and the memory on 99.9% (DCQ at m = 4 is discontinuous and the
   two-loop spreads a flipped coordinate into every direction). Prints
   the largest gaps and the coordinates apart at each step of each run.
21. The model zoo's xLSTM family at full width: xlstm-125m
   (``arXiv:2405.04517``) with its depth cut from 12 to 6 layers (the
   sLSTM at layer 1 kept, the one at 7 dropped; 133,959,976 bf16
   parameters in 53 leaves, the layers a list of per-layer trees), the QN
   step at the reference's ``TreeProtocolConfig`` defaults (hist 5: the
   memory is 40 parameter copies) but the step sizes, cut to local_lr
   1e-5 and lr 5e-5 (XLSTM_STEP_SIZES), 4 machines of two 512-token rows,
   dcq_mad, machine 0 signflipped, remat. First a probe of the step
   sizes: machine 0's first round up to theta_os alone, at the defaults
   and at XLSTM_STEP_SIZES (losses, gradient norms, max|theta_os|; the
   latter must be finite). Then a warm-up step with the first launch at each (op, shape)
   held against the plain version over column blocks, 1 timed step with
   the sLSTM loop's share of it (host-clock stamps around every
   ``slstm_forward``: its forward, its recomputation and its backward,
   inside that step), one profiled step (of the device only:
   a million launches; idle share, B1's share of busy), and a decode of B
   = 8 for 64 steps (tokens/s). Fails on a launch count other than 265
   (5 x 53) in any step, a non-finite loss or a peak above 72 GB.
22. The moe family: qwen3-moe-30b-a3b (``hf:Qwen/Qwen3-30B-A3B``) at full
   width cut to 1 layer (1,245,452,288 parameters, 13 leaves), the QN
   step as phase 21 at hist 1 and phase 18's traffic (4 machines x 2 x
   2,048 tokens): 65 launches a step. Then its decode cut to 2 layers, B
   = 8, a 32,768-slot cache, ctx-short and ctx-32k as phase 7 (Hq 32, Hkv
   4, Dh 128), every B2 launch held against the plain version in a pass
   before the timed one (``gqa_check_model``: the bf16 atol scales with
   max|v|, from the kernel's documented precision of P, where phase 6's
   ``gqa_check`` fails on outputs that cancel), and one step profiled (B2's
   share of busy).
23. The hybrid family: zamba2-7b (``arXiv:2411.15242``) at full width cut
   to 6 layers (one shared attention insertion, 902,733,024 parameters,
   20 leaves), the QN step as phase 22: 100 launches a step. Then its
   decode at full width and depth (81 layers, 13 insertions of the shared
   attention block at head dim 112, 6,750,550,224 parameters), B = 8, a
   4,096-slot cache (the model's context length), ctx-short and ctx-4096
   as phase 7: 13 B2 launches a step, every one held against the plain
   version (``gqa_check_model``) in a pass before the timed one.
24. Both launchers at their defaults (xlstm-125m, reduced): the
   reference's documented serve command (``--machines 16 --rounds 3
   --agg median --eps 1.0 --byzantine 0.25 --attack signflip --dropout
   0.3 --ingest-block 8``: fill 12, 51 launches, 51 ledger records) and
   ``train`` at 8 steps (the documented 12 before phases 33-35) under AdamW (136
   launches) and ``--optimizer qn`` (680), finite losses; the first launch
   at each (op, shape) held.
25. ``python -m repro_torch.sweep --preset zoo-smoke`` on the card: 7
   records, 5 x leaves launches a step (1,130 in all), every launch at a
   shape phase 3 timed, the first at each (op, shape) held.
26. Card against CPU for the reduced xLSTM, MoE, hybrid, vlm
   (llava-next-mistral-7b, its patch embeddings prepended) and audio
   (musicgen-medium, 4 codebooks), and a hybrid at head dim 112 (d_model
   224, 2 heads), in f32: the
   loss (rtol 1e-5) and its gradients leaf for leaf (1e-4 of the leaf's
   largest magnitude); two median QN steps, each from the CPU's state:
   the parameters and the memory's s within 1e-4 on every coordinate, its
   y within 1e-4 of its largest magnitude on every coordinate (the hybrid
   at head dim 112: on 99.99%, and within 1e-3 on all), and the
   CPU's y at the card's theta_os and theta_cq equal to the card's at that
   tolerance; 8 greedy decode steps, logits within 1e-4, every B2 launch
   held.
27. The vlm family: llava-next-mistral-7b (``hf:llava-hf/llava-v1.6-
   mistral-7b-hf``) at full width cut to 2 layers (702,566,400
   parameters, 13 leaves), the QN step as phase 22 over 4 machines x 2
   rows of train_4k's 4,096 positions, 576 patch embeddings and 3,520 text
   tokens: 65 launches a step. Then its decode at full width and depth
   (32 layers, 7,245,926,400 parameters), B = 8, a 32,768-slot cache,
   ctx-short and ctx-32768: 32 B2 launches a step, the warm-up step's
   held.
28. The audio family: musicgen-medium (``arXiv:2306.05284``) at full
   width cut from 48 to 12 layers (24 before phases 33-35; 468,751,872
   parameters, 12 leaves),
   the QN step over 4 machines x 2 rows of 1,500 frames of 4 codebooks:
   60 launches a step, the (1, 4, 12,582,912) stacked codebook embedding
   among them. Then its decode at full width and depth (48 layers), B =
   8, a 2,048-slot cache: 48 B2 launches a step, every one held.
29. The multi-device layer at world 1 (NCCL, a process group started in
   this process; ``launch.cli.machine_mesh``): Figure 1's Monte-Carlo run
   (20 replicates, 10% Byzantine under scale -3) through the sharded
   protocol's machine map and one replicate through ``run_sharded``, each
   against the unsharded run on the same draws (atol = rtol = 1e-5); ``python
   -m repro_torch.sweep --preset paper --sharded`` against phase 9's
   artifact (every scenario's thetas relatively, as phase 10; n_devices
   1); both train launchers' phase 16 and 19 commands cut to
   SHARDED_STEPS steps, with ``--sharded`` and without: equal losses; the
   serve launcher's phase 12 command with ``--sharded`` and without: every
   round's aggregate, the fills and the final theta bit-equal.
30. Phase 15's full-width training at world 1 with ``GradAggConfig(
   strategy="sharded")``: one step's per-machine gradients aggregated leaf
   by leaf unsharded (the first launch at each leaf shape held against
   the plain version over column blocks) and through the gather
   (``sharded_aggregate_leaf``), and the whole wire both ways, equal bit
   for bit; the gather's ms per leaf; then a warm-up, SHARDED_TIMED timed
   and one profiled sharded step (step ms, tokens/s, idle share, B1's
   share of busy). Fails above a 64 GB peak.
31. RANKS spawned processes on the one card in a gloo group (NCCL will not
   put two ranks on one device), every tensor on cuda:0: Figure 1's run
   (51 shards, 17 a rank) against phase 29's world-1 result (atol = rtol
   = 1e-5), and RANKS_QN_STEPS QN steps of the reduced glm4-9b at
   RANKS_QN_M machines (2 a rank, hist 5, median, signflip) against the
   same steps at world 1: the parameters and each rank's memory within
   1e-4 on every coordinate; the reduced glm4-9b's parameters served with
   the ring buffer over the ranks (RANKS_SERVE_C slots, 3 rounds, the last
   a partial fill) against the same service at world 1, bit for bit.
   Every rank's B1 launches and dispatch decisions are counted.
32. Dispatch: the committed table's meta beside this card's name and power
   limit; ``autotune`` at FAST_SHAPES into ``build/``, every recorded
   kernel candidate within its gate; phase 11's fleets flushed under the
   table's decision, a forced ``bisect`` and a forced ``sort``; the
   decision log of every phase (phase 31's ranks' from their processes),
   failing on any ``fallback-unmeasured`` decision. It runs last, after
   phases 33-35.
33. The dry run against the card (``repro_torch.launch.roofline``'s
   counting mode): three cells, each traced on the meta device at the mesh
   {data 1, model 1} and run once on the card under ``FlopCounterMode``
   (given the roofline's GQA formulas for the fused attention ops) with
   the device's peak reset just before: phase 15's AdamW step and phase
   18's QN step (run inside those phases on their own models and state)
   and one decode step of phase 7's model at the ctx-32k cache's last
   position. Each prints the predicted and counted FLOPs, the predicted
   and measured peak, the phase's measured step ms, MFU = 6ND (2ND for
   decode) / (step s x 989e12) and the memory term's (traced bytes / 3.35
   TB/s) share of the step; fails unless the FLOPs agree within 0.5% and
   the peak within 15%.
34. The shapes that had not run on the card, at glm4-9b's full width and
   depth on phase 7's model: prefill_32k with B cut from 32 to PREFILL_B
   (tokens/s, MFU, row 0's last-position logits held against its own
   prefill); long_500k, ``adapt_config``'s 4,096-slot ring (B = 1) filled
   from the generator at pos 524,287, LONG_STEPS steps past the wrap with
   every B2 launch held against the plain version at cache_len 4,096,
   then timed; and on phase 23's zamba2-7b (the shared attention
   windowed) LONG_HYBRID_STEPS steps.
35. Payload dims over "model" on the one card: four spawned gloo ranks as
   (data 2, model 2) against the unsharded world-1 run, AdamW (dcq_mad)
   and the QN step (the median) on the reduced glm4-9b in f32; the bytes
   each rank holds.
36. A ``{"kernels": [...]}`` JSON line (``ostat`` and ``gqa_decode``; the
   ``ostat`` launches include phases 29-31's and 35's, the ranks' own
   among them, the ``gqa_decode`` launches phases 33 and 34's), then the
   ``{"ok": true, ...}`` line.

A full report goes to ``build/chip_smoke.json``, the sweep's artifacts and
CLI logs to ``build/sweep_<preset>.json`` and ``.log``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s, and fp32
#: operations/s outside the tensor cores, an FMA counted as two.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
#: dense bf16 tensor-core peak, the operations bound of bf16 attention
PEAK_BF16 = 989e12
#: Instruction issue rates behind PEAK_FP32, from the per-SM throughput
#: table of the CUDA C++ Programming Guide for compute capability 9.0: fp32
#: add, multiply and FMA issue 128 per SM per clock; compare, min/max and
#: 32-bit integer add 64.
FP32_RATE = PEAK_FP32 / 2
CMP_RATE = PEAK_FP32 / 4

SHAPES = ((320, 8, 10),       # BENCH_agg.json sweep bucket
          (20, 51, 10),       # §5.1 Figure 1: 20 replicates, m+1 = 51
          (20, 50, 10),       # untrusted R2b variance: the m = 50 nodes
          (1, 51, 1),         # s1 summary median, m = 50
          (20, 81, 10),       # Figures 3/6: m+1 = 81
          (1, 81, 1),         # s1 summary median, m = 80
          (8, 8, 4096),       # mid bucket
          (1, 8, 262144))     # model-gradient bucket
#: the sweep presets phase 9 runs through the CLI, with extra arguments
SWEEP_RUNS = (("paper", ()), ("untrusted", ()), ("attack-sensitivity", ()),
              ("smoke", ()), ("smoke", ("--accountant", "rdp")))
#: the baselines at Figure 1's size (phase 9b): the s1 summary, the theta
#: and gradient medians, and the p^2 = 100-coordinate Hessian median
BASELINE_SHAPES = ((1, 51, 1), (1, 51, 10), (1, 51, 100))
N_BISECT = 60
TOL = 1e-5
#: the lane-group edges of B1's plan (checked, not timed; the card test
#: tests/test_torch_cuda.py::test_kernel_at_the_group_edges takes the same
#: list): m around the group sizes and register rows, the paper's m, the
#: slab and past it
EDGE_MS = (1, 2, 7, 8, 31, 32, 33, 51, 64, 65, 81, 1000, 2000, 15000)
#: the reference's serve benchmark setting (BENCH_serve.json "setting"):
#: fleet sizes, payload width, rounds; then one round at 70% fill
SERVE_FLEETS = (64, 1024, 16384)
SERVE_P = 10
SERVE_ROUNDS = 4
PARTIAL = 0.7
#: phase 12: the launcher's command; every round arrives at 64 - int(0.3 *
#: 64) = 45 machines, as the reference's launcher computes it
LAUNCH_ARGV = ("--config", "glm4-9b", "--machines", "64", "--rounds", "5",
               "--agg", "dcq_mad", "--eps", "1.0", "--byzantine", "0.25",
               "--attack", "signflip", "--dropout", "0.3", "--ingest-block",
               "8")
LAUNCH_ROUNDS = 5
LAUNCH_FILL = 45
#: phase 13: glm4-9b at full width cut to 2 layers, a ring of 4 machines;
#: per round (rule, fill, eps, signflip machines)
WIDE_LAYERS = 2
#: the leaves of Model.params(), the reference's tree: embed, lm_head,
#: norm_f and nine stacked layer leaves (attn w_q/w_k/w_v/w_o, mlp
#: w_gate/w_up/w_down, norm1, norm2), each on a leading L axis
WIDE_LEAVES = 12
WIDE_PARAMS = 1_649_430_528
WIDE_CAP = 4
WIDE_ROUNDS = (("median", 4, 0.0, 0), ("dcq_mad", 3, 1.0, 0),
               ("dcq_mad", 4, 0.0, 1))
#: phase 14: the fleet served on the card and on the CPU
VS_CPU_M = 1024
#: coordinates per column block where a full-width leaf is checked against
#: the plain version (B1 is coordinate-wise, so blocks compute the same)
BLOCK_COLS = 1 << 24
#: elements past which phase 3 times a serve shape's calls eagerly and
#: once (each takes milliseconds)
HEAVY = 1 << 22
#: the one serve shape where phase 3 also times ``dcq``
DCQ_AT = (1, 64, SERVE_P)
#: phases 15-17, training: machines, the ops phase 3 times at the training
#: shapes (1, TRAIN_M, d_leaf) (the trainer's default mean, the launcher's
#: dcq_mad, the median), AdamW's learning rate
TRAIN_M = 4
TRAIN_OPS = ("mean", "dcq_mad", "median")
TRAIN_LR = 3e-4
#: phase 15: glm4-9b at full width, WIDE_LAYERS layers, one sequence of
#: train_4k's length per machine; timed steps, then steps with per-leaf
#: DP noise (each machine's 4,096 tokens counted as its samples: at
#: dp_n = 1 the sensitivity's log(n) is 0 and so is every sigma)
TRAIN_SEQ = 4096
TRAIN_TIMED = 5
TRAIN_DP_STEPS = 2
TRAIN_DP_N = TRAIN_SEQ
#: phase 16: the training launcher's command (reduced glm4-9b)
TRAIN_ARGV = ("--config", "glm4-9b", "--steps", "12", "--machines", "4",
              "--agg", "dcq", "--byzantine", "0.25", "--attack", "scale")
TRAIN_STEPS = 12
#: phase 17: reduced glm4-9b in f32 on the card and on the CPU
VS_CPU_BATCH, VS_CPU_SEQ, VS_CPU_STEPS = 8, 128, 3
#: phases 18-20, the quasi-Newton train step: five transmissions, each one
#: B1 launch per leaf
QN_LAUNCHES = 5 * WIDE_LEAVES
#: phase 18: glm4-9b at full width, WIDE_LAYERS layers, 4 machines of two
#: 2,048-token sequences each (n = 2 rows a machine, the DP sigmas
#: non-zero), an L-BFGS memory of one pair (2 x 1 x 4 parameter copies);
#: warm-up, timed and profiled steps, then DP steps at eps 1; the peak of
#: the steps may reach 72 GB (the memory alone is 26.4 GB)
QN_BATCH, QN_SEQ, QN_HIST = 8, 2048, 1
#: (QN_DP_STEPS was 2, cut to 1 to make room for phases 33-35)
QN_TIMED, QN_DP_STEPS = 3, 1
QN_PEAK = 72e9
#: phase 19: the launcher's quasi-Newton command (reduced glm4-9b)
QN_ARGV = ("--config", "glm4-9b", "--steps", "12", "--machines", "4",
           "--optimizer", "qn", "--byzantine", "0.25", "--attack",
           "signflip")
#: phase 20: the QN step on the card and on the CPU (reduced glm4-9b, f32):
#: runs of (aggregator, seed), dcq_mad on two seeds and the median on one
QN_VS_CPU_STEPS, QN_VS_CPU_SIGMA, QN_VS_CPU_HIST = 3, 1e-3, 5
QN_VS_CPU_RUNS = (("dcq_mad", 2020), ("dcq_mad", 2121), ("median", 2020))
#: phases 21-28, the model zoo's other families. The full-width QN steps:
#: (arch, layers kept, leaves, parameters, hist, rows x tokens a step,
#: timed steps); B1 launches 5 x leaves a step. A step of the xLSTM at 12
#: layers took ~54 s on the card (the sLSTM loop, host bound), so it has 1
#: timed step (3 until the catalogue's last families came in; the whole
#: run took 1,095 s on one card with 2, against its limit of 1,200 s),
#: and since the multi-device phases 29-31 came in (the whole run 1,102 s
#: with 12 layers) its depth is cut to 6 layers: the sLSTM at layer 1
#: stays and the one at 7 goes, halving the host-bound loop. Since
#: phases 33-35 came in (the whole run 1,136 s on one H100 80GB HBM3 at
#: 700 W with musicgen's QN step at 24 layers) musicgen's QN step is cut to 12 layers (the xLSTM stays at
#: 6: its one sLSTM layer is 0.90 of its step, so fewer mLSTM layers would
#: save little). The
#: catalogue's last families have 1 timed step each. The
#: vlm's rows are train_4k's 4,096 positions split as the reference's
#: configs/shapes.py input_specs splits them, 576 patch embeddings and
#: 3,520 text tokens; the audio's rows are 1,500 frames of 4 codebooks
#: (30 s at EnCodec's 50 Hz, arXiv:2306.05284 section 4)
XLSTM, MOE, HYBRID = "xlstm-125m", "qwen3-moe-30b-a3b", "zamba2-7b"
LLAVA, MUSICGEN = "llava-next-mistral-7b", "musicgen-medium"
ZOO_WIDE = {
    XLSTM: (6, 53, 133_959_976, 5, (8, 512), 1),
    MOE: (1, 13, 1_245_452_288, 1, (8, 2048), 3),
    HYBRID: (6, 20, 902_733_024, 1, (8, 2048), 3),
    LLAVA: (2, 13, 702_566_400, 1, (8, 3520), 1),
    MUSICGEN: (12, 12, 468_751_872, 1, (8, 1500), 1),
}
#: phases 23, 27 and 28: full width and depth decodes, B = DECODE_B,
#: PROMPT + GEN steps from an empty cache and from slots - PROMPT - GEN
#: filled ones: (cache slots, parameters, B2 launches a step, every launch
#: held or the warm-up step's). zamba2-7b's cache is its context_length
#: (hf:Zyphra/Zamba2-7B-Instruct config.json), 4,096
ZOO_DECODE = {
    HYBRID: (4096, 6_750_550_224, 13, True),
    LLAVA: (32768, 7_245_926_400, 32, False),
    MUSICGEN: (2048, 1_827_816_960, 48, True),
}
#: the xLSTM's step sizes (local_lr, lr) in place of the defaults (0.1,
#: 0.5), which the xlstm-125m's gradient at init (norm ~1.3e5 at 512
#: tokens a row) throws off in one step: phase 21's probe runs one
#: machine's first round at both (at the defaults the gradient at
#: theta_cq is NaN), and tests/test_torch_xlstm.py holds the port's
#: full-depth gradient norm against the reference's. The other
#: TreeProtocolConfig fields keep their defaults
XLSTM_STEP_SIZES = (1e-5, 5e-5)
#: phase 21: the xLSTM decode (B requests, steps)
XLSTM_DECODE = (8, 64)
#: phase 22: qwen3-moe decode, depth cut to 2 layers (B = DECODE_B, a
#: DECODE_LEN-slot cache, PROMPT + GEN steps from empty and from
#: DECODE_LEN - PROMPT - GEN filled slots)
MOE_DECODE_LAYERS = 2
#: phase 24: the launchers at their defaults (xlstm-125m, reduced): the
#: reference's documented serve command, every round at 16 - int(0.3 x
#: 16) = 12 machines; the training launcher's steps, AdamW and qn: the
#: documented 12, cut to 8 to make room for phases 33-35 inside the
#: 1,100 s the whole run may take
ZOO_SERVE_ARGV = ("--config", XLSTM, "--machines", "16", "--rounds", "3",
                  "--agg", "median", "--eps", "1.0", "--byzantine", "0.25",
                  "--attack", "signflip", "--dropout", "0.3",
                  "--ingest-block", "8")
ZOO_SERVE_ROUNDS, ZOO_SERVE_FILL = 3, 12
ZOO_TRAIN_STEPS = 8
#: phase 26: the reduced families card against CPU, f32; HYBRID_112 is the
#: reduced hybrid at zamba2-7b's full-width head dim (d_model 224, 2 heads)
HYBRID_112 = "zamba2-7b@dh112"
ZOO_VS_CPU = (XLSTM, MOE, HYBRID, LLAVA, MUSICGEN, HYBRID_112)
#: the share of the QN memory's y held at 1e-4 of its largest magnitude
#: (the rest at 1e-3), where the strict gate does not hold: the hybrid at
#: head dim 112 had 2 of 28,057,360 coordinates of y apart by up to
#: 1.24e-4 at its seed while the same-points witness held every coordinate
#: (the SSD's curvature times theta_os's f32 rounding, as the card test's
#: zamba2 at seed 2600: ROADMAP C)
ZOO_VS_CPU_Y_SHARE = {HYBRID_112: 0.9999}
ZOO_VS_CPU_BATCH, ZOO_VS_CPU_SEQ, ZOO_VS_CPU_DECODE = 8, 32, 8
#: phases 29-31, the multi-device layer: the machine axis over
#: torch.distributed ranks. Phase 29 (world 1, NCCL, in process): the
#: launchers' phase 16 and 19 commands cut to SHARDED_STEPS steps;
#: phase 30: phase 15's model and tokens, one warm-up step, SHARDED_TIMED
#: timed steps and one profiled, the gather adding one (4, leaf) buffer
SHARDED_STEPS = 4
SHARDED_TIMED = 2
#: phase 31: RANKS processes on the one card (gloo: NCCL will not put two
#: ranks on one device), every rank's tensors on cuda:0. Figure 1's 51
#: shards, 17 a rank; the QN step on the reduced glm4-9b (f32) at
#: RANKS_QN_M machines (2 a rank), rows x tokens, hist 5, the median,
#: machine 0 signflipped, every sigma RANKS_QN_SIGMA, 2 steps
RANKS = 3
RANKS_QN_M, RANKS_QN_BATCH, RANKS_QN_SEQ = 6, 12, 64
RANKS_QN_HIST, RANKS_QN_STEPS, RANKS_QN_SIGMA = 5, 2, 1e-3
#: and the service of the reduced glm4-9b on a ring of RANKS_SERVE_C slots
#: (4 a rank), 3 rounds, the last a partial fill (rank 2's slots empty)
RANKS_SERVE_C, RANKS_SERVE_FILLS = 12, (12, 12, 8)
#: the peak device memory of the zoo's full-width QN steps
ZOO_PEAK = 72e9
#: phase 33, the dry run against the card: the traced FLOPs within
#: DRY_FLOPS_TOL of FlopCounterMode around one real step, the traced peak
#: within DRY_PEAK_TOL of max_memory_allocated over it
DRY_FLOPS_TOL, DRY_PEAK_TOL = 0.005, 0.15
#: phase 34, the long shapes at glm4-9b's full width and depth: prefill_32k
#: with its global batch of 32 cut to PREFILL_B rows (the logits of every
#: position are (B, 32,768, 151,552) bf16, 9.9 GB a row), its last logits
#: within a relative L2 error of PREFILL_REL_TOL of a decode step's on the
#: same tokens; long_500k's decode (B = 1) LONG_STEPS steps past the wrap
#: of the 4,096-slot ring, zamba2-7b's LONG_HYBRID_STEPS
PREFILL_B, LONG_STEPS, LONG_HYBRID_STEPS = 2, 32, 16
PREFILL_REL_TOL = 0.05
#: phase 35, payload sharding on one card: PAYLOAD_RANKS gloo ranks as
#: (data 2, model 2), the reduced glm4-9b in f32 at PAYLOAD_M machines of
#: phase 31's rows x tokens, PAYLOAD_STEPS AdamW steps (dcq_mad, lr
#: PAYLOAD_LR, the default eps) and QN steps (the median, hist
#: RANKS_QN_HIST), every sigma RANKS_QN_SIGMA on whole-leaf draws made
#: alike in every process
PAYLOAD_RANKS, PAYLOAD_M, PAYLOAD_STEPS = 4, 4, 2
PAYLOAD_LR = 1e-3


def sweep_shapes():
    """Every (B, m, p) phases 9-10 launch the kernel at, read off the
    presets' scenarios: per scenario the s1 summary (1, m+1, 1), the
    replicate batch (reps, m+1, p) and, with an untrusted center, the R2b
    variance median (reps, m, p); and the baselines' shapes."""
    from repro_torch.sweep import build_preset
    out = set(BASELINE_SHAPES)
    for preset in {name for name, _ in SWEEP_RUNS}:
        for s in build_preset(preset):
            out |= {(1, s.m + 1, 1), (s.reps, s.m + 1, s.p)}
            if s.center_trust == "untrusted":
                out.add((s.reps, s.m, s.p))
    return out


def timed_shapes():
    """Phase 3's shapes: SHAPES, then the sweep's and the baselines'."""
    return SHAPES + tuple(sorted(sweep_shapes() - set(SHAPES)))


def wide_config():
    """glm4-9b at full width, its depth cut to WIDE_LAYERS (bf16)."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(GLM), n_layers=WIDE_LAYERS)


def zoo_config(arch, layers=None):
    """``arch`` at full width (bf16), its depth cut to ``layers`` (the
    ZOO_WIDE cut when None)."""
    from repro_torch.configs import get_config
    return dataclasses.replace(
        get_config(arch), n_layers=ZOO_WIDE[arch][0] if layers is None
        else layers)


def vs_cpu_config(name):
    """Phase 26's reduced config of ``name`` (an arch, or HYBRID_112)."""
    from repro_torch.configs import get_config
    if name == HYBRID_112:
        return dataclasses.replace(get_config(HYBRID, reduced=True),
                                   d_model=224, n_heads=2, n_kv_heads=2)
    return get_config(name, reduced=True)


def _leaf_dims(cfg):
    from repro_torch.models.model import Model
    return {p.numel() for p in Model(cfg, device="meta").parameters()}


def serve_launches():
    """Every ``(op, (1, fill, d))`` phases 11-14 launch B1 at: the fleets'
    and the card-vs-CPU fleet's full and 70% fills, the reduced glm4-9b's
    leaves at the launcher's fill, the full-width leaves per round."""
    from repro_torch.configs import get_config
    out = set()
    for m in SERVE_FLEETS + (VS_CPU_M,):
        out |= {("dcq_mad", (1, f, SERVE_P)) for f in (m, int(PARTIAL * m))}
    out |= {("median", (1, f, SERVE_P))
            for f in (VS_CPU_M, int(PARTIAL * VS_CPU_M))}
    out |= {("dcq_mad", (1, LAUNCH_FILL, d))
            for d in _leaf_dims(get_config(GLM, reduced=True))}
    wide = _leaf_dims(wide_config())
    for rule, fill, _, _ in WIDE_ROUNDS:
        out |= {(rule, (1, fill, d)) for d in wide}
    out |= {("median", (1, ZOO_SERVE_FILL, d))
            for d in _leaf_dims(get_config(XLSTM, reduced=True))}
    return out


def train_launches():
    """Every ``(op, (1, TRAIN_M, d))`` phases 15-28 launch B1 at, and the
    ops phase 3 times there: the full-width and the reduced leaves of
    glm4-9b (the QN phases 18-20 launch dcq_mad at the same shapes, five
    times a step) and the reduced leaves of the zoo's other families
    (phases 24-26: the launchers, zoo-smoke, card against CPU, the
    hybrid at head dim 112 among them) for TRAIN_OPS; the zoo's
    full-width leaves (phases 21-23, 27, 28) for dcq_mad."""
    from repro_torch.configs import get_config
    dims = _leaf_dims(wide_config()) | _leaf_dims(get_config(GLM,
                                                             reduced=True))
    for arch in ZOO_WIDE:
        dims |= _leaf_dims(get_config(arch, reduced=True))
    for name in ZOO_VS_CPU:
        dims |= _leaf_dims(vs_cpu_config(name))
    out = {(op, (1, TRAIN_M, d)) for op in TRAIN_OPS for d in dims}
    # the zoo's full-width QN steps launch dcq_mad only (phase 3 adds the
    # median at every shape)
    for arch in ZOO_WIDE:
        out |= {("dcq_mad", (1, TRAIN_M, d))
                for d in _leaf_dims(zoo_config(arch))}
    return out


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def launch_mark():
    """(B1 launches, dispatch decisions for a kernel backend, all dispatch
    decisions) made so far in this process: the mark
    :func:`check_launches` counts from."""
    from repro_torch.agg import dispatch, kernel
    log = dispatch.decisions()
    return (kernel.launches,
            sum(n for k, n in log.items()
                if k[3] in dispatch.KERNEL_BACKENDS), sum(log.values()))


def check_launches(mark, want: int, where: str) -> int:
    """Since ``mark``: ``want`` dispatch decisions (every aggregation of a
    rule with a kernel form decides, by the table or by the platform rule),
    every one of them for B1 (the card's table chooses only B1's lanes),
    and one B1 launch for each, no more, no fewer. Returns the B1
    launches."""
    launches, kern, decided = (a - b for a, b in zip(launch_mark(), mark))
    check(decided == want, f"{where}: {decided} dispatch decisions, "
          f"expected {want}")
    check(launches == kern == decided, f"{where}: {launches} B1 launches "
          f"for {kern} decisions for the kernel of {decided}")
    return launches


@contextlib.contextmanager
def flushes():
    """The aggregate of every ``AggregationService.flush`` made inside, in
    order: a list of rounds, each a list of cloned leaves."""
    from repro_torch.core.transport import tree_leaves
    from repro_torch.serve.service import AggregationService
    rounds, real = [], AggregationService.flush

    def flush(self, *args, **kw):
        out = real(self, *args, **kw)
        if out is not None:
            rounds.append([t.clone() for t in tree_leaves(out)])
        return out
    AggregationService.flush = flush
    try:
        yield rounds
    finally:
        AggregationService.flush = real


@contextlib.contextmanager
def platform_rule():
    """Dispatch on the card without the table: every decision the platform
    rule's (B1 at its planner's lanes, bisect for a masked rule), as
    before the table. The holds of the card against the CPU run inside,
    so that the card's side is the launch layout those holds were set
    for."""
    from repro_torch.agg import dispatch
    dispatch.set_table(dispatch.NO_TABLE, "cuda")
    try:
        yield
    finally:
        dispatch.set_table(None, "cuda")


# ------------------------------------------------------------ measurement

def eager_ms(fn, iters: int) -> float:
    """Mean time per call of ``fn`` issued eagerly from the host, over
    ``iters`` back-to-back calls (CUDA events, after one warm-up call).
    Where the host issues work more slowly than the card runs it, this is
    the host's time per call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed once to warm up and once under CUDA events, so the
    host's launch overhead is not in the number. The capture is begun and
    ended directly on a side stream: ``torch.cuda.graph`` would also
    synchronise and empty the allocator's cache before each of phase 3's
    ~390 captures."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        fn()
        graph.capture_begin()
        for _ in range(iters):
            fn()
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def select_compares(m: int, k: int) -> int:
    """Fewest comparisons that can find the k-th smallest (0-based) of m
    values, ``m + min(k, m - 1 - k) - 1`` (the lower bound in Knuth, TAOCP
    vol. 3, §5.3.3). Finding both middle values of an even m needs at
    least what finding one does."""
    return m + min(k, m - 1 - k) - 1


def ostat_work(op: str, B: int, m: int, p: int, K: int = 10,
               trim_beta: float = 0.2, kth: int = 0):
    """(bytes, compares, fp32 operations) the op's function needs at this
    shape, whatever algorithm computes it. Bytes: each input read once
    and each output written once. Per coordinate: the comparisons a
    selection needs (not the kernel's bisection, which does far more);
    for the CQ ops, K*m compares of values against knot thresholds and
    K*m integer adds of the counts (counted with the compares: same
    issue rate); fp32 adds and multiplies of the sums and corrections.
    None of it depends on the data."""
    n_out = 3 if op == "median_mad_dcq" else 1
    nbytes = 4 * (B * m * p + (B * p if op == "dcq" else 0) + n_out * B * p)
    med = (select_compares(m, m // 2), 0 if m % 2 else 2)
    cq = (2 * K * m, 3 * K + 3)         # thresholds, count sum, correction
    mad = (med[0] + cq[0], med[1] + m + 2 + cq[1])   # |v - med|, scale
    g = int(trim_beta * m)
    cmp, fp = {"mean": (0, m),
               "kth": (select_compares(m, kth), 0),
               "median": med,
               "trimmed": (select_compares(m, g) if g else 0, m - 2 * g),
               "dcq": (med[0] + cq[0], med[1] + cq[1]),
               "dcq_mad": (med[0] + mad[0], med[1] + mad[1]),
               "median_mad_dcq": (med[0] + mad[0], med[1] + mad[1])}[op]
    return nbytes, cmp * B * p, fp * B * p


def bound(op: str, shape, kth: int):
    """(least ms the card could take, "bytes" or "operations"). Compares
    issue at half the fp32 rate, and all instructions share one issue
    slot per lane and clock."""
    nbytes, cmp, fp = ostat_work(op, *shape, kth=kth)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = max(cmp / CMP_RATE, (cmp + fp) / FP32_RATE) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def err_stats(got, ref):
    """(max |err|, 99.9th percentile of |err| / max(1, |ref|))."""
    import torch
    err = (got.double() - ref.double()).abs().flatten()
    rel = err / ref.double().abs().flatten().clamp_min(1.0)
    k = max(1, int(round(0.999 * rel.numel())))
    p999 = rel.kthvalue(k).values.item()
    return err.max().item(), p999


def device_profile(fn, wall_s: float, kernels=("ostat_kernel",)):
    """Device activity of one call of ``fn`` from a torch.profiler trace of
    the device alone: the busy time (union of device event spans),
    the number of device events, the time of the device kernels whose
    names contain each of ``kernels``, the six busiest kernels, and the
    idle share against ``wall_s``, the call's unprofiled wall time. The
    trace's raw events are read, not the profiler's event tree, which
    takes ~0.2 ms an event to build. None when the trace holds no device
    events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    if not dev:
        return None
    spans = sorted((s, e) for _, s, e in dev)
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy, lo, hi = busy + hi - lo, s, e
        else:
            hi = max(hi, e)
    busy += hi - lo
    by_name = {}
    for name, s, e in dev:
        by_name[name] = by_name.get(name, 0.0) + e - s
    return {"device_busy_us": busy, "device_events": len(dev),
            "kernels_us": {name: sum(t for k, t in by_name.items()
                                     if name in k) for name in kernels},
            "wall_us": wall_s * 1e6,
            "idle_share": 1.0 - busy / (wall_s * 1e6),
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:6]}


# ---------------------------------------------------------------- phases

def phase_device():
    import torch
    card = phase_device_line()
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    print(f"[1] device: {name}, {torch.cuda.device_count()} visible; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"Python {sys.version.split()[0]}", flush=True)
    return card, name


def phase_build():
    """Both kernels, one nvcc each, started together."""
    from repro_torch.agg import kernel
    from repro_torch.kernels import gqa_decode

    def timed(mod):
        t0 = time.perf_counter()
        mod.build()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    mods = (kernel, gqa_decode)
    with ThreadPoolExecutor(len(mods)) as pool:
        secs = list(pool.map(timed, mods))
    total = time.perf_counter() - t0
    print(f"[2] build: {total:.3f} s for both kernels", flush=True)
    resources = {}
    for mod, sec in zip(mods, secs):
        print(f"    {sec:.3f} s -> {mod.library_path()}")
        for fn, use in ptxas_resources(
                mod.library_path().with_suffix(".log")).items():
            resources[fn] = use
            print(f"    {fn}: {use}")
    sms, resident = gqa_decode.card_plan(0, MAIN[2] // MAIN[3], MAIN[4], 1)
    plan = gqa_decode.split_plan(MAIN[0], MAIN[1], MAIN[3], sms, resident)
    for shape in (MAIN, ZAMBA_MAIN):
        sms, resident = gqa_decode.card_plan(0, shape[2] // shape[3],
                                             shape[4], 1)
        plan = gqa_decode.split_plan(shape[0], shape[1], shape[3], sms,
                                     resident)
        print(f"    B2 plan at {shape}: {plan.n_chunks} chunks per "
              f"(sequence, kv head) ({plan.chunk} slots at a full cache), "
              f"{plan.blocks} blocks, {resident} resident per SM x {sms} "
              f"SMs = {plan.slots} slots, {plan.waves} wave(s)", flush=True)
    sms, resident = gqa_decode.card_plan(0, MAIN[2] // MAIN[3], MAIN[4], 1)
    plan = gqa_decode.split_plan(MAIN[0], MAIN[1], MAIN[3], sms, resident)
    return {"total_s": total, "ostat_s": secs[0], "gqa_decode_s": secs[1],
            "ptxas": resources, "gqa_plan": dataclasses.asdict(plan),
            "gqa_resident_per_sm": resident}


def ptxas_resources(log: Path) -> dict:
    """{kernel: "N registers, S bytes smem, spills"} from nvcc's
    ``-Xptxas -v`` output, names demangled where c++filt is present."""
    if not log.exists():
        return {}
    out, name = {}, None
    for ln in log.read_text().splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif "spill" in ln and name:
            out[name] = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            out[name] = ln.split(":", 1)[1].strip() + "; " \
                + out.get(name, "")
            name = None
    try:
        res = subprocess.run(["c++filt"], input="\n".join(out),
                             capture_output=True, text=True, timeout=30,
                             check=True)
        names = res.stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = list(out)
    return dict(zip(names, out.values())) if len(names) == len(out) \
        else out


def _reference(op, v, sc, kth):
    from repro_torch.agg import reference as ref
    if op == "mean":
        return (ref.mean_agg(v, axis=-2),)
    if op == "median":
        return (ref.median_agg(v, axis=-2),)
    if op == "kth":
        return (v.sort(dim=-2).values[..., kth, :],)
    if op == "trimmed":
        return (ref.trimmed_mean_agg(v, beta=0.2, axis=-2),)
    if op == "dcq":
        return (ref.dcq(v, sc, K=10, axis=-2),)
    if op == "dcq_mad":
        return (ref.dcq_mad_reference(v, K=10, axis=-2),)
    return ref.median_mad_dcq_reference(v, K=10, axis=-2)


def _library(op, v, kth):
    """One PyTorch call computing the same function, where there is one:
    at even m, torch.median returns the lower middle value, and
    torch.quantile(0.5) averages the two as the kernel does."""
    import torch
    m = v.shape[-2]
    if op == "mean":
        return lambda: torch.mean(v, dim=-2)
    if op == "kth":
        return lambda: torch.kthvalue(v, kth + 1, dim=-2).values
    if op == "median":
        if m % 2:
            return lambda: torch.median(v, dim=-2).values
        return lambda: torch.quantile(v, 0.5, dim=-2)
    return None


def phase_kernel():
    import torch
    from repro_torch.agg import kernel
    g = torch.Generator(device="cuda")
    g.manual_seed(1234)
    rows = []
    for shape in timed_shapes():
        B, m, p = shape
        v = torch.randn(shape, generator=g, device="cuda")
        sc = torch.rand((B, p), generator=g, device="cuda") + 0.1
        kth = m // 3
        for op in kernel.OPS:
            scale = sc if op == "dcq" else None
            args = dict(kth=kth, n_bisect=N_BISECT)
            got = kernel.ostat(v, op, scale, **args)
            plain = kernel.ostat_plain(v, op, scale, **args)
            ref = _reference(op, v, scale, kth)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            plain = plain if isinstance(plain, tuple) else (plain,)
            max_err, p999, max_ref, p999_ref, neq = 0.0, 0.0, 0.0, 0.0, 0
            for a, b, r in zip(got, plain, ref):
                check(bool(torch.isfinite(a).all()),
                      f"{op} at {shape}: non-finite kernel output")
                e, q = err_stats(a, b)
                er, qr = err_stats(a, r)
                max_err, p999 = max(max_err, e), max(p999, q)
                max_ref, p999_ref = max(max_ref, er), max(p999_ref, qr)
                neq += int((a != b).sum())
            if op in ("kth", "median"):
                check(neq == 0, f"{op} at {shape}: {neq} coordinates differ "
                      f"from the plain version (must be bit-equal)")
            check(p999 <= TOL, f"{op} at {shape}: p99.9 error {p999:.3g} "
                  f"against the plain version exceeds {TOL}")
            check(p999_ref <= TOL, f"{op} at {shape}: p99.9 error "
                  f"{p999_ref:.3g} against the reference exceeds {TOL}")
            def run():
                return kernel.ostat(v, op, scale, **args)
            ms = graph_ms(run, 100)
            call_ms = eager_ms(run, 100)
            plain_ms = graph_ms(lambda: kernel.ostat_plain(v, op, scale,
                                                           **args), 3)
            lib = _library(op, v, kth)
            lib_ms = graph_ms(lib, 100) if lib else None
            lib_err = err_stats(got[0], lib())[0] if lib else None
            b_ms, b_by = bound(op, shape, kth)
            rows.append({"op": op, "shape": list(shape), "ms": ms,
                         "eager_ms": call_ms,
                         "plain_ms": plain_ms, "library_ms": lib_ms,
                         "max_abs_err_vs_library": lib_err,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "max_abs_err": max_err, "p999_rel_err": p999,
                         "max_abs_err_vs_reference": max_ref,
                         "p999_rel_err_vs_reference": p999_ref,
                         "bit_equal": neq == 0})
            plan = kernel.ostat_plan(B, m, p, *kernel._card(0))
            rows[-1]["plan"] = dataclasses.asdict(plan)
            print(f"[3] {op:15s} {str(shape):16s} kernel {ms:.4f} ms "
                  f"(eager call {call_ms:.4f} ms)  "
                  f"plain {plain_ms:.4f} ms  library "
                  f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'} "
                  f"(max|err| {'-' if lib_err is None else f'{lib_err:.3g}'})"
                  f"  bound "
                  f"{b_ms * 1e3:.3f} us ({b_by})  max|err| {max_err:.3g}  "
                  f"p99.9 {p999:.3g}  vs ref max {max_ref:.3g} p99.9 "
                  f"{p999_ref:.3g}  plan {plan}", flush=True)
    return rows, check_edges(g), time_serve_shapes(g)


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def blockwise(fn, values, scale=None):
    """``fn(values, scale)`` over column blocks of BLOCK_COLS coordinates,
    concatenated: the same result for a coordinate-wise function, with one
    block's working memory."""
    import torch
    p = values.shape[-1]
    if p <= BLOCK_COLS:
        return fn(values, scale)
    parts = []
    for c0 in range(0, p, BLOCK_COLS):
        cols = slice(c0, c0 + BLOCK_COLS)
        sc = scale if scale is None or scale.shape[-1] != p \
            else scale[..., cols]
        parts.append(_tuple(fn(values[..., cols], sc)))
    out = tuple(torch.cat(col, dim=-1) for col in zip(*parts))
    return out if len(out) > 1 else out[0]


def _hold(got, plain, where):
    """kth/median bit-equal, the rest at the p99.9 gate, checked over
    column blocks of BLOCK_COLS coordinates (a block's gate implies the
    whole output's). Returns an upper bound of the largest p99.9 error:
    the largest relative error where that is within the gate (then the
    percentile needs no selection), else the percentile."""
    import torch
    worst = 0.0
    for a, b in zip(_tuple(got), _tuple(plain)):
        for c0 in range(0, a.shape[-1], BLOCK_COLS):
            x = a[..., c0:c0 + BLOCK_COLS]
            y = b[..., c0:c0 + BLOCK_COLS]
            check(bool(torch.isfinite(x).all()),
                  f"{where}: non-finite output")
            if where.split()[0] in ("kth", "median"):
                check(bool(torch.equal(x, y)), f"{where}: differs from "
                      f"the plain version (must be bit-equal)")
                continue
            q = ((x.double() - y.double()).abs()
                 / y.double().abs().clamp_min(1.0)).max().item()
            if q > TOL:
                q = err_stats(x, y)[1]
            check(q <= TOL, f"{where}: p99.9 error {q:.3g} exceeds {TOL}")
            worst = max(worst, q)
    return worst


def check_edges(g):
    """Every op at the lane-group edges of the plan, a ragged p and B > 1
    (3 x m x 13), against the plain version; one launch per call."""
    import torch
    from repro_torch.agg import kernel
    worst, n = 0.0, 0
    for m in EDGE_MS:
        v = torch.randn((3, m, 13), generator=g, device="cuda")
        sc = torch.rand((3, 13), generator=g, device="cuda") + 0.1
        for op in kernel.OPS:
            scale = sc if op == "dcq" else None
            before = kernel.launches
            got = kernel.ostat(v, op, scale, kth=m // 3)
            check(kernel.launches == before + 1, f"{op} at m={m}: "
                  f"{kernel.launches - before} launches for one call")
            plain = kernel.ostat_plain(v, op, scale, kth=m // 3)
            worst = max(worst, _hold(got, plain, f"{op} edge (3, {m}, 13)"))
            n += 1
    print(f"[3] edges: {n} calls at m in {EDGE_MS} x (3, m, 13) held against "
          f"the plain version (kth/median bit-equal, the rest p99.9 <= "
          f"{worst:.3g})", flush=True)
    return {"calls": n, "ms": list(EDGE_MS), "p999_rel_err": worst}


def _event_ms(fn):
    """(result, ms) of one call of ``fn`` between two CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def time_serve_shapes(g):
    """Phase 3 for the serving and training paths: every shape phases
    11-17 launch B1 at, for the ops launched there and the median (and
    ``dcq`` at DCQ_AT; the training shapes for TRAIN_OPS), held against
    the plain version and the sort reference, timed beside
    ``torch.median`` and, where it computes the same function (odd m, or
    ``torch.quantile`` at even m up to 2^24 elements), the library call;
    ``mean`` beside ``torch.mean``. Shapes wider than BLOCK_COLS (the full-width leaves): the first
    and last column blocks of BLOCK_COLS coordinates are held (phase 13
    holds every column of its first flush). Shapes of more than HEAVY
    elements take milliseconds per call: the kernel is timed eagerly over
    5 calls, the plain version (over at most one block, ``plain_cols``)
    and ``torch.median`` over one call."""
    import torch
    from repro_torch.agg import kernel
    serve, train = serve_launches(), train_launches()
    served = serve | train
    rows = []
    for shape in sorted({sh for _, sh in served},
                        key=lambda sh: (sh[2], sh[1])):
        _, m, p = shape
        big = p > BLOCK_COLS
        heavy = m * p > HEAVY
        cols = [slice(0, BLOCK_COLS), slice(p - BLOCK_COLS, p)] if big \
            else [slice(0, p)]
        v = torch.randn(shape, generator=g, device="cuda")
        ops = {op for op, sh in served if sh == shape} | {"median"}
        if shape == DCQ_AT:
            ops.add("dcq")
        for op in sorted(ops):
            sc = torch.rand((1, p), generator=g, device="cuda") + 0.1 \
                if op == "dcq" else None
            where = f"{op} serve shape {shape}"
            got = kernel.ostat(v, op, sc)
            p999 = max_err = p999_ref = 0.0
            for c in cols:
                vc, sc_c, gc = v[..., c], None if sc is None else sc[..., c], \
                    got[..., c]
                plain = kernel.ostat_plain(vc, op, sc_c)
                p999 = max(p999, _hold(gc, plain, where))
                max_err = max(max_err, err_stats(gc, plain)[0])
                q = err_stats(gc, _reference(op, vc, sc_c, 0)[0])[1]
                check(q <= TOL, f"{where}: p99.9 error {q:.3g} against the "
                      f"reference exceeds {TOL}")
                p999_ref = max(p999_ref, q)
                del plain
            vc = v[..., cols[0]].contiguous()
            sc_c = None if sc is None else sc[..., cols[0]].contiguous()
            if heavy:
                plain_ms = _event_ms(
                    lambda: kernel.ostat_plain(vc, op, sc_c))[1]
            else:
                plain_ms = graph_ms(
                    lambda: kernel.ostat_plain(vc, op, sc_c), 3)

            def run():
                return kernel.ostat(v, op, sc)
            ms = eager_ms(run, 5) if heavy else graph_ms(run, 100)
            call_ms = ms if heavy else eager_ms(run, 100)
            tm_ms = tm_err = lib_ms = lib_err = None
            if op == "mean":
                def tmean():
                    return torch.mean(v, dim=-2)
                if heavy:
                    out, lib_ms = _event_ms(tmean)
                else:
                    out, lib_ms = tmean(), graph_ms(tmean, 100)
                lib_err = (out - got).abs().max().item()
                del out
            if op == "median":
                def tmed():
                    return torch.median(v, dim=-2).values
                if heavy:
                    out, tm_ms = _event_ms(tmed)
                else:
                    out, tm_ms = tmed(), graph_ms(tmed, 100)
                tm_err = (out - got).abs().max().item()
                del out
                if m % 2:
                    lib_ms = tm_ms
                elif v.numel() <= BLOCK_COLS:
                    lib_ms = graph_ms(_library(op, v, 0), 100)
            b_ms, b_by = bound(op, shape, 0)
            plan = kernel.ostat_plan(1, m, p, *kernel._card(0))
            paths = [name for name, sett in (("serve", serve),
                                             ("train", train))
                     if (op, shape) in sett]
            rows.append({"op": op, "shape": list(shape), "ms": ms,
                         "paths": paths,
                         "max_abs_err_vs_library": lib_err,
                         "eager_ms": call_ms, "plain_ms": plain_ms,
                         "plain_cols": vc.shape[-1],
                         "held_cols": sum(c.stop - c.start for c in cols),
                         "library_ms": lib_ms, "torch_median_ms": tm_ms,
                         "max_abs_err_vs_torch_median": tm_err,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "max_abs_err": max_err, "p999_rel_err": p999,
                         "p999_rel_err_vs_reference": p999_ref,
                         "plan": dataclasses.asdict(plan)})
            del got, vc, sc_c
            print(f"[3] {'+'.join(paths) or 'serve':11s} {op:8s} "
                  f"{str(shape):20s} kernel {ms:.4f} ms "
                  f"(eager call {call_ms:.4f} ms)  plain {plain_ms:.4f} ms"
                  f"{f' (one {BLOCK_COLS}-column block)' if big else ''}  "
                  f"torch.median "
                  f"{'-' if tm_ms is None else f'{tm_ms:.4f} ms'}  library "
                  f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}  bound "
                  f"{b_ms * 1e3:.3f} us ({b_by})  max|err| {max_err:.3g}  "
                  f"p99.9 <= {p999:.3g}  vs ref p99.9 {p999_ref:.3g}"
                  f"{' (first and last blocks held)' if big else ''}  plan "
                  f"{plan}", flush=True)
        del v
    torch.cuda.empty_cache()
    return rows


def held_against_plain(run, first=None, distinct=False):
    """Call ``run()`` with the first ``first`` kernel launches (every one
    when None; with ``distinct``, the first launch at each ``(op, shape)``)
    held against ``ostat_plain`` on the same tensors
    (``kth``/``median`` bit-equal, the other ops at the p99.9 gate; over
    column blocks where a launch is wider than BLOCK_COLS). Returns the
    set of ``(op, (B, m, p))`` of every launch, held or not, the largest
    p99.9 error and the number held; the plain calls launch nothing and
    count nothing. Both ways in are wrapped: ``agg.ostat`` (the registry's
    kernel forms) and ``kernel.ostat`` (the masked bisect forms)."""
    import repro_torch.agg as agg
    from repro_torch.agg import kernel
    real = kernel.ostat
    check(agg.ostat is real, "repro_torch.agg.ostat is not kernel.ostat")
    seen, worst, held = set(), 0.0, 0

    def ostat_held(values, op, scale=None, **kw):
        nonlocal worst, held
        got = real(values, op, scale, **kw)
        shape = tuple(values.shape)
        shape = (1,) * (3 - len(shape)) + shape
        if (first is not None and held >= first) or (
                distinct and (op, shape) in seen):
            seen.add((op, shape))
            return got
        seen.add((op, shape))
        held += 1
        plain = blockwise(lambda v, sc: kernel.ostat_plain(v, op, sc, **kw),
                          values, scale)
        worst = max(worst, _hold(got, plain,
                                 f"{op} main-path launch at {shape}"))
        return got

    agg.ostat = kernel.ostat = ostat_held
    try:
        run()
    finally:
        agg.ostat = kernel.ostat = real
    return seen, worst, held


def untimed(seen):
    """Launched shapes that phase 3 did not time."""
    return sorted({sh for _, sh in seen} - set(timed_shapes()))


def expected_launches(cfg) -> int:
    """Dispatch decisions of one protocol run, all through wire_aggregate:
    the s1 summary and the theta_med anchor (medians), the R2b variance
    median in untrusted mode, and the six estimates (theta_cq, g_cq, H1,
    gdiff_cq, g_os, h3). Trusted, all six take ``cfg.aggregator``;
    untrusted, g_cq does and the rest are medians. An aggregator without
    a kernel form (geomedian) runs its plain PyTorch reference and decides
    nothing. Each decision for the kernel is one B1 launch (before the
    table, every decision on the card was)."""
    from repro_torch.agg import get_aggregator
    k = get_aggregator(cfg.aggregator).kernel is not None
    if cfg.center_trust == "untrusted":
        return 8 + k
    return 2 + 6 * k


SLICE_RUNS = (
    # name, model, m, n, byz fraction, center trust
    ("fig1-logistic", "logistic", 50, 1000, 0.0, "trusted"),
    ("fig1-logistic-byz10", "logistic", 50, 1000, 0.1, "trusted"),
    ("fig1-poisson", "poisson", 50, 1000, 0.0, "trusted"),
    ("fig1-untrusted", "logistic", 50, 1000, 0.0, "untrusted"),
    ("fig3-m80", "logistic", 80, 500, 0.0, "trusted"),
)
REPS = 20
P = 10
TIMED = 5


def phase_slice():
    import torch
    from repro_torch.attacks import byzantine_mask
    from repro_torch.configs.base import ProtocolConfig
    from repro_torch.core.losses import get_problem
    from repro_torch.core.protocol import DPQNProtocol, monte_carlo_mrse
    from repro_torch.data.synthetic import make_shards, target_theta
    out = []
    for i, (name, model, m, n, alpha, trust) in enumerate(SLICE_RUNS):
        g = torch.Generator(device="cuda")
        g.manual_seed(100 + i)
        X, y = make_shards(g, model, m, n, P)
        mask = byzantine_mask(g, m, alpha) if alpha else None
        cfg = ProtocolConfig(eps=30.0, delta=0.05, aggregator="dcq",
                             center_trust=trust)
        proto = DPQNProtocol(get_problem(model), cfg)
        # warm-up, with every launch held against the plain version
        seen, held_err, _ = held_against_plain(
            lambda: proto.run_monte_carlo(REPS, X, y, mask, "scale", -3.0,
                                          generator=g))
        torch.cuda.synchronize()
        missing = untimed(seen)
        check(not missing, f"{name}: phase 3 does not time the main "
              f"path's shapes {missing}")
        secs = []
        mark = launch_mark()
        for _ in range(TIMED):
            t0 = time.perf_counter()
            res = proto.run_monte_carlo(REPS, X, y, mask, "scale", -3.0,
                                        generator=g)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        launches = check_launches(mark, TIMED * expected_launches(cfg),
                                  f"{name} ({TIMED} runs)")
        check(launches > 0, f"{name}: the main path launched B1 no time")
        for f in ("theta_cq", "theta_os", "theta_qn"):
            t = getattr(res, f)
            check(tuple(t.shape) == (REPS, P), f"{name}: {f} shape "
                  f"{tuple(t.shape)}")
            check(bool(torch.isfinite(t).all()), f"{name}: {f} not finite")
        trace = device_profile(
            lambda: proto.run_monte_carlo(REPS, X, y, mask, "scale", -3.0,
                                          generator=g),
            statistics.median(secs))
        target = target_theta(P)
        row = {"run": name, "model": model, "m": m, "n": n, "p": P,
               "reps": REPS, "byz_frac": alpha, "center_trust": trust,
               "eps": cfg.eps, "delta": cfg.delta,
               "mrse_cq": monte_carlo_mrse(res.theta_cq, target),
               "mrse_os": monte_carlo_mrse(res.theta_os, target),
               "mrse_qn": monte_carlo_mrse(res.theta_qn, target),
               "seconds": secs,
               "reps_per_s": REPS / statistics.median(secs),
               "launches_per_run": launches // TIMED,
               "held_launches": sorted([op, list(sh)] for op, sh in seen),
               "held_p999_err": held_err, "trace": trace}
        out.append(row)
        print(f"[4] {name:20s} MRSE qn {row['mrse_qn']} (cq "
              f"{row['mrse_cq']}, os {row['mrse_os']})  "
              f"{row['reps_per_s']} replicates/s  kernel launches/run "
              f"{row['launches_per_run']}", flush=True)
        print(f"    every launch of the warm-up run held against the "
              f"plain version (p99.9 err <= {held_err:.3g}): "
              f"{row['held_launches']}", flush=True)
        if trace is None:
            print("    profiler: no device events in the trace (device "
                  "idle share not measured)", flush=True)
        else:
            check(trace["kernels_us"]["ostat_kernel"] > 0, f"{name}: the "
                  f"trace holds no device kernel named ostat_kernel")
            print(f"    profiler: device busy {trace['device_busy_us']} us "
                  f"of {trace['wall_us']} us wall (idle share "
                  f"{trace['idle_share']}), {trace['device_events']} device "
                  f"events, ostat {trace['kernels_us']['ostat_kernel']} us; "
                  f"busiest "
                  f"{trace['top']}", flush=True)
    return out


def phase_card_vs_cpu():
    """The Figure 1 setting, trusted and untrusted center, with the draws
    made once on the CPU and handed to both sides."""
    import torch
    from repro_torch.configs.base import ProtocolConfig
    from repro_torch.core.losses import get_problem
    from repro_torch.core.protocol import DPQNProtocol, transmission_names
    from repro_torch.data.synthetic import make_shards
    m, n = 50, 1000
    prob = get_problem("logistic")
    out = {}
    for trust in ("trusted", "untrusted"):
        g = torch.Generator()
        g.manual_seed(7)
        X, y = make_shards(g, "logistic", m, n, P)
        cfg = ProtocolConfig(eps=30.0, delta=0.05, aggregator="dcq",
                             center_trust=trust)
        noise = {name: torch.randn(
            (REPS, m if name == "R2b var" else m + 1, P), generator=g)
            for name in transmission_names(cfg)}
        mark = launch_mark()
        with platform_rule():
            card = DPQNProtocol(prob, cfg).run_monte_carlo(REPS, X, y,
                                                           noise=noise)
        torch.cuda.synchronize()
        check(check_launches(mark, expected_launches(cfg), f"{trust} card "
                             f"run") == expected_launches(cfg),
              f"{trust} card run: not every decision the kernel")
        cpu = DPQNProtocol(prob, cfg, device="cpu").run_monte_carlo(
            REPS, X, y, noise=noise)
        worst = {}
        for f in ("theta_cq", "theta_os", "theta_qn"):
            a, b = getattr(card, f).cpu(), getattr(cpu, f)
            worst[f] = float(((a - b).abs() / (1e-4 + 1e-4 * b.abs())).max())
            check(torch.allclose(a, b, atol=1e-4, rtol=1e-4),
                  f"{trust}: card and CPU disagree on {f}: max |diff| "
                  f"{(a - b).abs().max().item():.3g}")
        out[trust] = worst
        print(f"[5] card vs CPU (kernel vs reference), Figure 1 setting, "
              f"{trust} center: largest |diff| / (1e-4 + 1e-4 |cpu|) per "
              f"field {worst}", flush=True)
    return out


# ------------------------------------------------------ the sweep (A7-A8)

def _preset(name, extra):
    """The scenarios ``--preset name`` plus ``extra`` CLI arguments runs."""
    from repro_torch.sweep import build_preset
    scens = build_preset(name)
    if extra:
        acct = extra[extra.index("--accountant") + 1]
        scens = [dataclasses.replace(s, accountant=acct) for s in scens]
    return scens


def phase_sweep():
    """Each preset through ``python -m repro_torch.sweep``'s ``main`` on
    the card, in full; the first group's launches held against the plain
    version, every launch at a shape phase 3 timed. A scenario's launches
    are its decisions for the kernel, at most its aggregations."""
    import contextlib
    import io
    from repro_torch.sweep import artifact, cli, group_scenarios
    out_dir = ROOT / "build"
    rows = []
    for name, extra in SWEEP_RUNS:
        tag = name + "".join(f"-{a.lstrip('-')}" for a in extra)
        scens = _preset(name, extra)
        groups = group_scenarios(scens)
        first = sum(expected_launches(s.protocol_config())
                    for s in next(iter(groups.values())))
        path = out_dir / f"sweep_{tag}.json"
        log = io.StringIO()
        rc = []
        mark = launch_mark()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            seen, held_err, held = held_against_plain(
                lambda: rc.append(cli.main(
                    ["--preset", name, "--out", str(path), "--no-resume",
                     "--device", "cuda", *extra])), first=first)
        wall = time.perf_counter() - t0
        (out_dir / f"sweep_{tag}.log").write_text(log.getvalue())
        check(rc == [0], f"sweep {tag}: the CLI returned {rc}")
        art = artifact.load(str(path))            # validates the schema
        recs = art["scenarios"]
        want = {s.scenario_id(): s for s in scens}
        check(set(recs) == set(want), f"sweep {tag}: {len(recs)} records "
              f"for {len(want)} scenarios")
        expect = 0
        for sid, s in want.items():
            e = expected_launches(s.protocol_config())
            expect += e
            got = recs[sid]["timing"]["launches"]
            check(got == e, f"sweep {tag}: {sid} made {got} kernel "
                  f"launches, expected {e}")
            metrics = recs[sid]["metrics"]
            check(all(math.isfinite(v) for v in metrics.values()),
                  f"sweep {tag}: {sid} has a non-finite metric {metrics}")
        launches = check_launches(mark, expect, f"sweep {tag}")
        check(held == first, f"sweep {tag}: held {held} launches of the "
              f"first group's {first}")
        missing = untimed(seen)
        check(not missing, f"sweep {tag}: phase 3 does not time the "
              f"launched shapes {missing}")
        diverging = sorted(sid for sid, r in recs.items()
                           if r["metrics"].get("mrse_qn", 0.0) > 10.0)
        row = {"preset": tag, "scenarios": len(scens),
               "groups": len(groups), "wall_s": wall,
               "scenarios_per_s": len(scens) / wall, "launches": launches,
               "held_first_group": held, "held_p999_err": held_err,
               "shapes": sorted([op, list(sh)] for op, sh in seen),
               "diverging_mrse_gt_10": diverging}
        rows.append(row)
        print(f"[9] sweep {tag}: {len(scens)} scenarios in {len(groups)} "
              f"groups, {wall} s wall, {row['scenarios_per_s']} "
              f"scenarios/s, {launches} kernel launches ({expect} "
              f"decisions; the first {held} held against the plain "
              f"version, p99.9 err <= {held_err:.3g}); all metrics finite, "
              f"{len(diverging)} with MRSE qn > 10", flush=True)
        if name == "paper":
            print_paper(recs)
    rows.append(profile_fig_eps())
    return rows


def print_paper(recs):
    """The Figure 1 logistic MRSE-vs-eps rows and the Table 1
    accuracies of the paper preset's artifact."""
    for r in recs.values():
        s = r["scenario"]
        if s["dataset"] == "synthetic" and s["problem"] == "logistic" \
                and s["m"] == 50:
            mt = r["metrics"]
            print(f"    fig-eps logistic byz {s['byz_frac']} eps "
                  f"{'noiseless' if s['noiseless'] else s['eps']}: MRSE cq "
                  f"{mt['mrse_cq']} os {mt['mrse_os']} qn {mt['mrse_qn']}")
    for r in recs.values():
        s = r["scenario"]
        if s["dataset"] == "digits":
            print(f"    table1 pair {tuple(s['pair'])} eps {s['eps']} byz "
                  f"{s['byz_frac']}: accuracy {r['metrics']['accuracy']}")


def profile_fig_eps():
    """A profiler trace of one fig-eps group (logistic, 5 budgets, 5
    replicates each, m = 50, n = 1000, p = 10) through the executor, its
    data already built; idle share against the unprofiled median of
    three runs."""
    import torch
    from repro_torch.sweep import SweepExecutor, fig_eps_scenarios
    scens = fig_eps_scenarios("logistic")
    ex = SweepExecutor(device="cuda")
    ex.run(scens)
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        ex.run(scens)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    wall = statistics.median(secs)
    trace = device_profile(lambda: ex.run(scens), wall)
    row = {"preset": "fig-eps logistic group (profiled)",
           "scenarios": len(scens), "wall_s": wall,
           "scenarios_per_s": len(scens) / wall, "trace": trace}
    if trace is None:
        print("[9] profiler: no device events in the trace (idle share "
              "not measured)", flush=True)
    else:
        print(f"[9] fig-eps logistic group, 5 scenarios x 5 replicates: "
              f"{wall} s wall ({len(scens) / wall} scenarios/s); profiler: "
              f"device busy {trace['device_busy_us']} us, idle share "
              f"{trace['idle_share']}, {trace['device_events']} device "
              f"events, ostat {trace['kernels_us']['ostat_kernel']} us; "
              f"busiest {trace['top']}", flush=True)
    return row


BASELINE_RUNS = 20


def phase_baselines():
    """Newton and GD at the Figure 1 size on the card (logistic, m = 50,
    n = 1000, p = 10, eps = 30), 20 single runs each with every launch
    held against the plain version, beside theta_qn over 20 replicates."""
    import torch
    from repro_torch.configs.base import ProtocolConfig
    from repro_torch.core.baselines import gd_estimator, newton_estimator
    from repro_torch.core.losses import get_problem
    from repro_torch.core.protocol import DPQNProtocol, monte_carlo_mrse
    from repro_torch.data.synthetic import make_shards, target_theta
    from repro_torch.sweep.comm import comm_record
    g = torch.Generator(device="cuda")
    g.manual_seed(900)
    X, y = make_shards(g, "logistic", 50, 1000, P)
    cfg = ProtocolConfig(eps=30.0, delta=0.05)
    prob = get_problem("logistic")
    fns = {"newton": newton_estimator, "gd": gd_estimator}
    thetas = {"newton": [], "gd": []}
    bytes_pm = {}

    def runs():
        for _ in range(BASELINE_RUNS):
            for name, fn in fns.items():
                res = fn(prob, cfg, X, y, generator=g)
                thetas[name].append(res.theta)
                bytes_pm[name] = res.bytes_per_machine

    mark = launch_mark()
    seen, held_err, held = held_against_plain(runs)
    launches = check_launches(mark, BASELINE_RUNS * (4 + 20), "baselines")
    check(("median", (1, 51, 100)) in seen, "baselines: no Hessian median "
          "at (1, 51, 100)")
    secs = {}
    for name, fn in fns.items():       # host clock, no launch held
        t = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn(prob, cfg, X, y, generator=g)
            torch.cuda.synchronize()
            t.append(time.perf_counter() - t0)
        secs[name] = statistics.median(t)
    missing = untimed(seen)
    check(not missing, f"baselines: phase 3 does not time {missing}")
    qn = DPQNProtocol(prob, cfg, device="cuda").run_monte_carlo(
        BASELINE_RUNS, X, y, generator=g)
    target = target_theta(P, "cuda")
    row = {"launches": launches, "held": held, "held_p999_err": held_err,
           "mrse": {k: monte_carlo_mrse(torch.stack(v), target)
                    for k, v in thetas.items()},
           "seconds_per_run": secs,
           "bytes_per_machine": dict(bytes_pm, qn=comm_record(
               P, cfg)["bytes_per_machine"])}
    row["mrse"]["qn"] = monte_carlo_mrse(qn.theta_qn, target)
    for k, v in row["mrse"].items():
        check(math.isfinite(v), f"baselines: {k} MRSE {v}")
    print(f"[9b] baselines at Figure 1 size, {BASELINE_RUNS} runs each: "
          f"MRSE newton {row['mrse']['newton']} gd {row['mrse']['gd']} "
          f"(theta_qn {row['mrse']['qn']}); bytes per machine "
          f"{row['bytes_per_machine']}; median s per unheld run "
          f"{row['seconds_per_run']}; {launches} kernel launches, all held "
          f"against the plain version (p99.9 err <= {held_err:.3g})",
          flush=True)
    return row


def _rel_err(a, b):
    """Largest |a - b| / (1e-4 + 1e-4 * scale), with scale the largest
    |b| of each row (a diverging replicate is compared relatively)."""
    import torch
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    scale = b.abs().amax(dim=-1, keepdim=True).clamp_min(1.0) \
        if b.dim() else b.abs().clamp_min(1.0)
    return float(((a - b).abs() / (1e-4 + 1e-4 * scale)).max())


def phase_sweep_vs_cpu():
    """One fig-eps group (logistic, 10% Byzantine, 5 budgets) through the
    executor and one run of each baseline, card against CPU, with data and
    draws made once on the CPU and handed to both sides."""
    import torch
    from repro_torch.configs.base import ProtocolConfig
    from repro_torch.core.baselines import gd_estimator, newton_estimator
    from repro_torch.core.losses import get_problem
    from repro_torch.sweep import SweepExecutor, fig_eps_scenarios
    from repro_torch.sweep.data import build_data, replicate_draws
    scens = fig_eps_scenarios("logistic", byz_frac=0.1)
    drawn = {s.scenario_id(): build_data(s, "cpu") + replicate_draws(s, "cpu")
             for s in scens}
    mark = launch_mark()
    with platform_rule():
        card = SweepExecutor(device="cuda", inputs=lambda s: drawn[
            s.scenario_id()]).run(scens)
    torch.cuda.synchronize()
    expect = sum(expected_launches(s.protocol_config()) for s in scens)
    sweep_launches = check_launches(mark, expect, "card sweep group")
    check(sweep_launches == expect, f"card sweep group: {sweep_launches} "
          f"B1 launches under the platform rule, expected {expect}")
    cpu = SweepExecutor(device="cpu", inputs=lambda s: drawn[
        s.scenario_id()]).run(scens)
    worst = 0.0
    for s in scens:
        a = card["scenarios"][s.scenario_id()]
        b = cpu["scenarios"][s.scenario_id()]
        for k, v in b["metrics"].items():
            worst = max(worst, abs(a["metrics"][k] - v)
                        / (1e-4 + 1e-4 * abs(v)))
        worst = max(worst, _rel_err(a["thetas_qn"], b["thetas_qn"]))
        check(a["spend"]["sigmas"][1:] == b["spend"]["sigmas"][1:],
              f"{s.scenario_id()}: card and CPU sigmas differ")
    check(worst <= 1.0, f"card and CPU sweep disagree: largest error "
          f"{worst} of the 1e-4 bound")
    g = torch.Generator()
    g.manual_seed(31)
    X, y, _ = drawn[scens[0].scenario_id()][:3]
    cfg = ProtocolConfig(eps=30.0, delta=0.05)
    prob = get_problem("logistic")
    m1, p = X.shape[0], X.shape[-1]
    newton_noise = {"R1 theta": torch.randn((m1, p), generator=g),
                    "R2 grad": torch.randn((m1, p), generator=g),
                    "R2 hessian": torch.randn((m1, p, p), generator=g)}
    gd_noise = {f"GD round {t}": torch.randn((m1, p), generator=g)
                for t in range(20)}
    base, base_launches = {}, 0
    for name, fn, noise in (("newton", newton_estimator, newton_noise),
                            ("gd", gd_estimator, gd_noise)):
        mark = launch_mark()
        with platform_rule():
            a = fn(prob, cfg, X.cuda(), y.cuda(), noise=noise).theta.cpu()
        base_launches += check_launches(mark, 20 if name == "gd" else 4,
                                        f"card {name}")
        b = fn(prob, cfg, X, y, noise=noise).theta
        base[name] = _rel_err(a, b)
        check(base[name] <= 1.0, f"{name}: card and CPU disagree (largest "
              f"error {base[name]} of the 1e-4 bound)")
    check(base_launches == 4 + 20, f"card baselines made {base_launches} "
          f"kernel launches")
    print(f"[10] card vs CPU on CPU-drawn data and draws: fig-eps logistic "
          f"10% Byzantine group (5 budgets x 5 replicates), metrics and "
          f"thetas at {worst} of the atol = rtol = 1e-4 bound; newton "
          f"{base['newton']}, gd {base['gd']} of it", flush=True)
    return {"sweep_worst": worst, "baselines_worst": base,
            "launches": sweep_launches + base_launches}


# ------------------------------------------- the serving path (A9, B1)

def serve_untimed(seen):
    """Launches of phases 11-14 at an (op, shape) phase 3 did not time."""
    return sorted(seen - serve_launches())


def train_untimed(seen):
    """Launches of phases 15-20 at an (op, shape) phase 3 did not time."""
    return sorted(seen - train_launches())


def phase_serve_fleets():
    """The reference's serve benchmark setting on the card: per fleet a
    timed service (4 rounds, then a 70% round through an explicit flush),
    the counter set to 0 just before it and read just after; a buffer
    against its dense prefix at three fills; a second service's first two
    rounds held against the plain version; a profiler trace of one round."""
    import torch
    from repro_torch.agg import aggregate_masked
    from repro_torch.serve import AggregationService, ServeConfig
    rows = []
    for m in SERVE_FLEETS:
        g = torch.Generator(device="cuda")
        g.manual_seed(500 + m)
        part = int(PARTIAL * m)
        batches = [torch.randn((m, SERVE_P), generator=g, device="cuda")
                   for _ in range(SERVE_ROUNDS + 1)]
        # comparison launches, both at the planner's lanes (the buffer's
        # bucket and the dense prefix's may have measured others)
        for k in (1, part, m):
            check(torch.equal(
                aggregate_masked(batches[0], k, "dcq_mad", backend="bisect"),
                aggregate_masked(batches[0][:k].clone(), k, "dcq_mad",
                                 backend="bisect")),
                f"fleet {m}: the buffer at fill {k} and its dense prefix "
                f"aggregate differently")
        cfg = ServeConfig(method="dcq_mad", capacity=m, eps=1.0, dp_n=100,
                          lr=0.1, ingest_block=min(1024, m), seed=0)
        svc = AggregationService(torch.zeros(SERVE_P, device="cuda"), cfg)
        torch.cuda.synchronize()
        secs = []

        def run():
            for r in range(SERVE_ROUNDS):
                t0 = time.perf_counter()
                svc.submit_many(batches[r])     # the capacity flush
                secs.append(time.perf_counter() - t0)
            svc.submit_many(batches[-1][:part])
            svc.flush()

        mark = launch_mark()
        seen, _, _ = held_against_plain(run, first=0)
        launches = check_launches(mark, SERVE_ROUNDS + 1, f"fleet {m}")
        fills = [h["fill"] for h in svc.history]
        check(fills == [m] * SERVE_ROUNDS + [part], f"fleet {m}: fills "
              f"{fills}")
        check(bool(torch.isfinite(svc.theta).all()), f"fleet {m}: theta "
              f"not finite")
        missing = serve_untimed(seen)
        check(not missing, f"fleet {m}: phase 3 did not time {missing}")
        held_svc = AggregationService(torch.zeros(SERVE_P, device="cuda"),
                                      cfg)
        mark = launch_mark()
        _, held_err, held = held_against_plain(
            lambda: [held_svc.submit_many(b) for b in batches[:2]])
        check(check_launches(mark, 2, f"fleet {m}, two held rounds")
              == held, f"fleet {m}: held {held} launches of two rounds")
        steady = statistics.median(secs[1:])
        trace = device_profile(lambda: svc.submit_many(batches[1]), steady)
        hist = svc.history
        row = {"m": m, "p": SERVE_P, "rounds": SERVE_ROUNDS,
               "partial_fill": part, "launches": launches,
               "cold_round_ms": secs[0] * 1e3,
               "steady_round_ms": steady * 1e3,
               "cold_flush_ms": hist[0]["flush_s"] * 1e3,
               "steady_flush_ms": statistics.median(
                   h["flush_s"] for h in hist[1:SERVE_ROUNDS]) * 1e3,
               "partial_flush_ms": hist[SERVE_ROUNDS]["flush_s"] * 1e3,
               "ingest_to_update_ms": statistics.mean(
                   h["latency_s"] for h in hist[1:SERVE_ROUNDS]) * 1e3,
               "updates_per_s": m / steady, "held": held,
               "held_p999_err": held_err,
               "shapes": sorted([op, list(sh)] for op, sh in seen),
               "trace": trace}
        rows.append(row)
        print(f"[11] fleet m={m} p={SERVE_P} dcq_mad eps=1: cold round "
              f"{row['cold_round_ms']} ms (flush {row['cold_flush_ms']} "
              f"ms), steady round {row['steady_round_ms']} ms (flush "
              f"{row['steady_flush_ms']} ms), ingest-to-update "
              f"{row['ingest_to_update_ms']} ms, {row['updates_per_s']} "
              f"updates/s; partial round at fill {part}: flush "
              f"{row['partial_flush_ms']} ms; {launches} B1 launches; "
              f"buffer == dense prefix at fills (1, {part}, {m}); two "
              f"rounds held (p99.9 err <= {held_err:.3g})", flush=True)
        if trace is None:
            print("     profiler: no device events in the trace (idle share "
                  "not measured)", flush=True)
        else:
            print(f"     profiler, one round: device busy "
                  f"{trace['device_busy_us']} us of {trace['wall_us']} us "
                  f"wall (idle share {trace['idle_share']}), "
                  f"{trace['device_events']} device events, ostat "
                  f"{trace['kernels_us']['ostat_kernel']} us; busiest "
                  f"{trace['top']}", flush=True)
    return rows


def phase_serve_launcher():
    """``python -m repro_torch.launch.serve``'s ``main`` on the card: a
    first run with every launch held against the plain version, then the
    run whose launches are counted."""
    import contextlib
    import io
    import torch
    from repro_torch.core.transport import tree_leaves
    from repro_torch.launch import serve as launcher
    held_mark = launch_mark()
    with contextlib.redirect_stdout(io.StringIO()):
        _, held_err, held = held_against_plain(
            lambda: launcher.main(list(LAUNCH_ARGV)))
    log, box = io.StringIO(), []
    mark = launch_mark()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        seen, _, _ = held_against_plain(
            lambda: box.append(launcher.main(list(LAUNCH_ARGV))), first=0)
    wall = time.perf_counter() - t0
    svc = box[0]
    leaves = tree_leaves(svc.theta)
    want = len(leaves) * LAUNCH_ROUNDS
    launches = check_launches(mark, want, f"launcher ({len(leaves)} leaves "
                              f"x {LAUNCH_ROUNDS} rounds)")
    check_launches(held_mark, 2 * want, "launcher, held and counted runs")
    check(held == want, f"launcher: held {held} launches, expected {want}")
    fills = [h["fill"] for h in svc.history]
    check(fills == [LAUNCH_FILL] * LAUNCH_ROUNDS, f"launcher: fills {fills}")
    check(all(bool(torch.isfinite(t).all()) for t in leaves),
          "launcher: theta not finite")
    check(len(svc.ledger) == want and all(e["noise"] for e in svc.ledger),
          f"launcher: {len(svc.ledger)} ledger entries, expected {want}")
    check(len(svc.accountant.records) == LAUNCH_ROUNDS,
          f"launcher: {len(svc.accountant.records)} accountant records")
    missing = serve_untimed(seen)
    check(not missing, f"launcher: phase 3 did not time {missing}")
    for line in log.getvalue().splitlines():
        print(f"[12] {line}", flush=True)
    print(f"[12] launcher: {wall} s wall, {launches} B1 launches "
          f"({len(leaves)} leaves x {LAUNCH_ROUNDS} rounds), the held run's "
          f"{held} held against the plain version (p99.9 err <= "
          f"{held_err:.3g})", flush=True)
    return {"argv": list(LAUNCH_ARGV), "wall_s": wall, "launches": launches,
            "leaves": len(leaves),
            "params": sum(t.numel() for t in leaves),
            "history": svc.history, "held": held, "held_p999_err": held_err,
            "log": log.getvalue()}


def phase_serve_wide():
    """glm4-9b's parameters at full width, 2 layers, bf16, as the served
    theta of a 4-machine ring: WIDE_ROUNDS, one service each, the first
    round's launches held against the plain version over column blocks."""
    import torch
    from repro_torch.core.transport import tree_leaves, tree_map
    from repro_torch.launch.serve import fleet_round
    from repro_torch.models.model import Model
    from repro_torch.serve import AggregationService, FlushPolicy, ServeConfig
    cfg = wide_config()
    g = torch.Generator(device="cuda")
    g.manual_seed(1313)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, generator=g)
    theta = tree_map(torch.Tensor.detach, model.params())
    n_leaves = len(tree_leaves(theta))
    n_params = sum(t.numel() for t in tree_leaves(theta))
    check(n_leaves == WIDE_LEAVES and n_params == WIDE_PARAMS,
          f"full-width theta: {n_leaves} leaves, {n_params} parameters")
    print(f"[13] {GLM} at full width, {WIDE_LAYERS} layers: {n_leaves} "
          f"leaves, {n_params} parameters in bf16, "
          f"{n_params * 2} bytes per machine row; capacity {WIDE_CAP}",
          flush=True)
    rows, seen_all, launches_all = [], set(), 0
    peak = torch.cuda.max_memory_allocated()
    for i, (rule, fill, eps, n_byz) in enumerate(WIDE_ROUNDS):
        torch.cuda.reset_peak_memory_stats()
        mem = {"start": torch.cuda.memory_allocated()}
        mask = (torch.arange(fill, device="cuda") < n_byz) if n_byz else None
        ups = fleet_round(g, theta, fill, mask,
                          "signflip" if n_byz else "none", -3.0)
        mem["updates"] = torch.cuda.memory_allocated()
        mem["updates_peak"] = torch.cuda.max_memory_allocated()
        svc = AggregationService(
            theta, ServeConfig(method=rule, capacity=WIDE_CAP, eps=eps,
                               lr=0.1, ingest_block=WIDE_CAP, seed=i),
            policy=FlushPolicy())
        torch.cuda.synchronize()

        def run():
            svc.submit_many(ups)
            if fill < WIDE_CAP:
                svc.flush()                   # the explicit flush

        mem["service"] = torch.cuda.memory_allocated()
        mark = launch_mark()
        seen, held_err, held = held_against_plain(
            run, first=n_leaves if i == 0 else 0)
        launches = check_launches(mark, n_leaves, f"full width round {i}")
        mem["round_peak"] = torch.cuda.max_memory_allocated()
        peak = max(peak, mem["round_peak"])
        launches_all += launches
        seen_all |= seen
        h = svc.history
        check(len(h) == 1 and h[0]["fill"] == fill, f"full width round "
              f"{i}: history {h}")
        rows.append({"rule": rule, "fill": fill, "eps": eps,
                     "signflip": n_byz, "launches": launches,
                     "flush_ms": h[0]["flush_s"] * 1e3,
                     "latency_ms": h[0]["latency_s"] * 1e3,
                     "held": held, "held_p999_err": held_err,
                     "ledger_sigma_max": max(e["sigma"] for e in svc.ledger),
                     "memory": mem})
        held_txt = f"held against the plain version, p99.9 err <= " \
            f"{held_err:.3g}" if held else "not held"
        print(f"[13] round {i}: {rule} at fill {fill}, eps {eps}, "
              f"{n_byz} signflip: flush {rows[-1]['flush_ms']} ms "
              f"({held_txt}), {launches} B1 launches; device memory bytes "
              f"{mem}", flush=True)
        del svc, ups
    check(all(bool(torch.isfinite(t).all()) for t in tree_leaves(theta)),
          "full width: theta not finite")
    missing = serve_untimed(seen_all)
    check(not missing, f"full width: phase 3 did not time {missing}")
    print(f"[13] peak device memory {peak} bytes (limit 64e9)", flush=True)
    check(peak <= 64e9, f"full width: peak device memory {peak} bytes")
    del model, theta
    torch.cuda.empty_cache()
    return {"leaves": n_leaves, "params": n_params, "rounds": rows,
            "launches": launches_all, "max_memory_allocated": peak}


def phase_serve_vs_cpu():
    """The same CPU-drawn updates and noise to a service on the card and
    one on the CPU, m = VS_CPU_M, 3 rounds, the last partial."""
    import torch
    from repro_torch.serve import AggregationService, FlushPolicy, ServeConfig
    g = torch.Generator()
    g.manual_seed(1414)
    fills = (VS_CPU_M, VS_CPU_M, int(PARTIAL * VS_CPU_M))
    ups = [torch.randn((n, SERVE_P), generator=g) for n in fills]
    noise = [torch.randn((VS_CPU_M, SERVE_P), generator=g) for _ in fills]
    out, launches, seen_all = {}, 0, set()
    for rule in ("dcq_mad", "median"):
        cfg = ServeConfig(method=rule, capacity=VS_CPU_M, eps=1.0, lr=0.1,
                          ingest_block=1024, seed=14)
        pol = FlushPolicy(capacity_frac=None)
        card = AggregationService(torch.zeros(SERVE_P), cfg, pol)
        cpu = AggregationService(torch.zeros(SERVE_P), cfg, pol,
                                 device="cpu")

        def run():
            for u, z in zip(ups, noise):
                card.submit_many(u.cuda())
                card.flush(noise=z)

        mark = launch_mark()
        with platform_rule():
            seen, _, _ = held_against_plain(run, first=0)
        n = check_launches(mark, len(fills), f"{rule} on the card")
        check(n == len(fills), f"{rule}: {n} B1 launches on the card "
              f"under the platform rule, expected {len(fills)}")
        launches += n
        seen_all |= seen
        for u, z in zip(ups, noise):
            cpu.submit_many(u)
            cpu.flush(noise=z)
        a, b = card.theta.cpu(), cpu.theta
        diff = (a - b).abs().max().item()
        if rule == "median":
            check(torch.equal(a, b), f"median: card and CPU thetas differ "
                  f"(max |diff| {diff:.3g}; must be bit-equal)")
        else:
            check(torch.allclose(a, b, atol=1e-5, rtol=1e-5), f"{rule}: "
                  f"card and CPU thetas disagree (max |diff| {diff:.3g})")
        check(card.ledger == cpu.ledger, f"{rule}: ledgers differ")
        out[rule] = diff
    missing = serve_untimed(seen_all)
    check(not missing, f"serve card vs CPU: phase 3 did not time {missing}")
    print(f"[14] serve card vs CPU on CPU-drawn updates and noise, m = "
          f"{VS_CPU_M}, fills {fills}: max |theta diff| dcq_mad "
          f"{out['dcq_mad']} (atol = rtol = 1e-5), median {out['median']} "
          f"(bit-equal); ledgers equal", flush=True)
    return {"fills": list(fills), "max_abs_theta_diff": out,
            "launches": launches}


# ----------------------------------------------------------- training

def _step_loop(step, params, state, batches, key, mask, launches_per_step):
    """Run ``step`` on each batch, timing each step between
    synchronisations; returns (params, state, per-step seconds, losses,
    grad norms). Fails unless every step makes ``launches_per_step``
    dispatch decisions, one B1 launch for each decision for the kernel."""
    import torch
    secs, losses, norms = [], [], []
    for batch in batches:
        mark = launch_mark()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch, key, mask)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        check_launches(mark, launches_per_step, "a training step")
        losses.append(metrics["loss"])
        norms.append(metrics["grad_norm"])
    losses = [float(x) for x in losses]
    norms = [float(x) for x in norms]
    check(all(math.isfinite(x) for x in losses + norms),
          f"training: non-finite loss or grad norm ({losses}, {norms})")
    return params, state, secs, losses, norms


def phase_train_wide():
    """Phase 15: glm4-9b at full width cut to WIDE_LAYERS layers, bf16, 4
    machines of one train_4k sequence each, AdamW, dcq_mad, machine 0
    signflipped, remat: a warm-up step with every B1 launch held against
    the plain version, TRAIN_TIMED timed steps, one profiled step, then
    TRAIN_DP_STEPS steps with per-leaf calibrated DP noise."""
    import torch
    from repro_torch.core.transport import leaf_paths, tree_leaves
    from repro_torch.data.lm import make_batch
    from repro_torch.dist.grad_agg import GradAggConfig
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainer import (TrainConfig, Trainer,
                                           make_train_step)
    cfg = wide_config()
    g = torch.Generator(device="cuda")
    g.manual_seed(1515)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, generator=g, remat=True)
    params = model.params()
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    check(len(leaves) == WIDE_LEAVES and n_params == WIDE_PARAMS,
          f"full-width training tree: {len(leaves)} leaves, {n_params} "
          f"parameters")
    dims = [t.numel() for t in leaves]
    n_steps = 1 + TRAIN_TIMED + 1 + TRAIN_DP_STEPS
    # batches made before any timed step: a vectorised chain, a handful
    # of device operations each
    batches = [make_batch(g, cfg, TRAIN_M, TRAIN_SEQ) for _ in range(n_steps)]
    tokens = TRAIN_M * TRAIN_SEQ
    mask = torch.arange(TRAIN_M, device="cuda") < 1
    agg = GradAggConfig(method="dcq_mad", attack="signflip")
    opt = AdamW(lr=TRAIN_LR)
    step = make_train_step(model, opt, TrainConfig(n_machines=TRAIN_M,
                                                   agg=agg))
    state = opt.init(params)
    mem = {"after_init": torch.cuda.max_memory_allocated()}
    print(f"[15] {GLM} at full width, {WIDE_LAYERS} layers: {len(leaves)} "
          f"leaves {dict(zip(leaf_paths(params), dims))}, {n_params} "
          f"parameters in bf16; {TRAIN_M} machines x 1 sequence of "
          f"{TRAIN_SEQ} tokens; AdamW lr {TRAIN_LR}, dcq_mad, machine 0 "
          f"signflipped, remat", flush=True)

    # warm-up: every launch held against the plain version
    box = []
    mark = launch_mark()
    t0 = time.perf_counter()
    seen, held_err, held = held_against_plain(
        lambda: box.append(step(params, state, batches[0], None, mask)))
    warm_s = time.perf_counter() - t0
    params, state, metrics = box.pop()
    n = check_launches(mark, WIDE_LEAVES, "warm-up step")
    check(held == n, f"warm-up step: {n} launches, {held} held")
    warm_loss = float(metrics["loss"])
    check(math.isfinite(warm_loss), f"warm-up loss {warm_loss}")
    del metrics
    mem["after_warmup"] = torch.cuda.max_memory_allocated()
    missing = train_untimed(seen)
    check(not missing, f"training: phase 3 did not time {missing}")
    print(f"[15] warm-up step: loss {warm_loss}, {held} B1 launches held "
          f"against the plain version over column blocks (p99.9 err <= "
          f"{held_err:.3g}), {warm_s} s with the holds", flush=True)

    # timed steps
    mark = launch_mark()
    params, state, secs, losses, norms = _step_loop(
        step, params, state, batches[1:1 + TRAIN_TIMED], None, mask,
        WIDE_LEAVES)
    launches = launch_mark()[0] - mark[0]
    med = statistics.median(secs)
    print(f"[15] {TRAIN_TIMED} timed steps: ms {[x * 1e3 for x in secs]}, "
          f"median {med * 1e3} ms, {tokens / med} tokens/s; losses "
          f"{losses}; grad norms {norms}; B1 launches {launches} "
          f"({launches // TRAIN_TIMED} per step)", flush=True)

    # one step under the profiler
    box = []
    batch = batches[1 + TRAIN_TIMED]
    mark = launch_mark()
    trace = device_profile(
        lambda: box.append(step(params, state, batch, None, mask)), med)
    params, state, metrics = box.pop()
    launches += check_launches(mark, WIDE_LEAVES, "profiled step")
    del metrics, box
    if trace is None:
        print("[15] profiler: no device events in the trace (device idle "
              "share not measured)", flush=True)
    else:
        b1 = trace["kernels_us"]["ostat_kernel"]
        trace["b1_share_of_busy"] = b1 / trace["device_busy_us"]
        print(f"[15] profiler, one step: device busy "
              f"{trace['device_busy_us']} us of {trace['wall_us']} us wall "
              f"(idle share {trace['idle_share']}), "
              f"{trace['device_events']} device events, B1 {b1} us "
              f"({trace['b1_share_of_busy']} of busy); busiest "
              f"{trace['top']}", flush=True)
    mem["after_timed"] = torch.cuda.max_memory_allocated()

    # phase 33's cell: the same step traced on meta against one real step
    mark = launch_mark()
    DRY_CELLS["train_wide"] = dry_cell(
        "15", lambda m, mesh: make_train_step(
            m, opt, TrainConfig(n_machines=TRAIN_M, agg=agg), mesh),
        model, params, state, lambda p: opt.init(p), batches[1], mask,
        (TRAIN_M, TRAIN_SEQ), med)
    params, state = DRY_CELLS["train_wide"].pop("result")
    launches += check_launches(mark, WIDE_LEAVES, "phase 33's train cell")

    # per-leaf calibrated DP noise: a new AdamW state, the old one freed
    del state, step
    torch.cuda.empty_cache()
    dp_agg = dataclasses.replace(agg, dp_eps=1.0, dp_n=TRAIN_DP_N)
    trainer = Trainer(model, opt, TrainConfig(n_machines=TRAIN_M,
                                              agg=dp_agg))
    dp_rows = []
    mark = launch_mark()
    params, state, _ = trainer.fit(
        params, batches[-TRAIN_DP_STEPS:], g, byz_mask=mask,
        callback=lambda i, m: dp_rows.append((float(m["loss"]),
                                              float(m["grad_norm"]))))
    launches += check_launches(mark, WIDE_LEAVES * TRAIN_DP_STEPS,
                               "DP steps")
    check(all(math.isfinite(x) for row in dp_rows for x in row),
          f"DP steps: non-finite loss or grad norm {dp_rows}")
    ledger = trainer.ledger
    check(ledger["steps"] == TRAIN_DP_STEPS
          and len(ledger["per_step"]) == WIDE_LEAVES
          and [r["dim"] for r in ledger["per_step"]] == dims
          and all(r["sigma"] > 0 for r in ledger["per_step"]),
          f"DP ledger {ledger}")
    print(f"[15] {TRAIN_DP_STEPS} steps with per-leaf DP noise (eps 1, "
          f"dp_n {TRAIN_DP_N}): loss, grad norm {dp_rows}; ledger "
          f"{len(ledger['per_step'])} records per step, sigmas "
          f"{[r['sigma'] for r in ledger['per_step']]}, total eps "
          f"{ledger['total_eps']}", flush=True)
    check(all(bool(torch.isfinite(t).all()) for t in tree_leaves(params)),
          "full-width training: parameters not finite")
    peak = max(torch.cuda.max_memory_allocated(), mem["after_timed"])
    mem["peak"] = peak
    print(f"[15] peak device memory {peak} bytes (limit 64e9); by stage "
          f"{mem}", flush=True)
    check(peak <= 64e9, f"full-width training: peak device memory {peak}")
    del model, params, state, trainer, batches
    torch.cuda.empty_cache()
    return {"leaves": WIDE_LEAVES, "params": n_params, "dims": dims,
            "machines": TRAIN_M, "seq": TRAIN_SEQ, "tokens_per_step": tokens,
            "warmup_loss": warm_loss, "warmup_s": warm_s, "held": held,
            "held_p999_err": held_err, "step_ms": [x * 1e3 for x in secs],
            "median_step_ms": med * 1e3, "tokens_per_s": tokens / med,
            "losses": losses, "grad_norms": norms,
            "launches_per_step": launches // (TRAIN_TIMED + 2
                                              + TRAIN_DP_STEPS),
            "decisions_per_step": WIDE_LEAVES, "launches": launches,
            "trace": trace, "dp_steps": dp_rows,
            "dp_ledger": ledger["per_step"], "memory": mem,
            "max_memory_allocated": peak}


def phase_train_launcher():
    """Phase 16: ``python -m repro_torch.launch.train``'s ``main`` on the
    card: a first run with every launch held against the plain version,
    then the run whose launches and losses are counted."""
    import contextlib
    import io
    from repro_torch.launch import train as launcher
    want = WIDE_LEAVES * TRAIN_STEPS
    held_mark = launch_mark()
    with contextlib.redirect_stdout(io.StringIO()):
        seen, held_err, held = held_against_plain(
            lambda: launcher.main(list(TRAIN_ARGV)))
    check_launches(held_mark, want, "train launcher, held run")
    log, box = io.StringIO(), []
    mark = launch_mark()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        box.append(launcher.main(list(TRAIN_ARGV)))
    wall = time.perf_counter() - t0
    launches = check_launches(mark, want, f"train launcher ({WIDE_LEAVES} "
                              f"leaves x {TRAIN_STEPS} steps)")
    losses = box[0]
    check(held == want, f"train launcher: held {held}, expected {want}")
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"train launcher: losses {losses}")
    check(losses[-1] < losses[0], f"train launcher: the loss did not fall "
          f"({losses[0]} -> {losses[-1]})")
    missing = train_untimed(seen)
    check(not missing, f"train launcher: phase 3 did not time {missing}")
    for line in log.getvalue().splitlines():
        print(f"[16] {line}", flush=True)
    print(f"[16] train launcher: {wall} s wall ({wall / TRAIN_STEPS * 1e3} "
          f"ms per step), losses {losses}, {launches} B1 launches "
          f"({WIDE_LEAVES} decisions per step); the held run's {held} "
          f"launches held "
          f"against the plain version (p99.9 err <= {held_err:.3g})",
          flush=True)
    return {"argv": list(TRAIN_ARGV), "wall_s": wall, "losses": losses,
            "launches": launches, "held": held, "held_p999_err": held_err,
            "log": log.getvalue()}


def grads_card_vs_cpu(models, params, batch, tcfg):
    """Every machine's loss and gradient of ``batch`` (``machine_grads``,
    before the wire) on the card and on the CPU, ``models`` and ``params``
    card first. Fails unless the losses agree within rtol 1e-4. Returns
    the largest ``|card - cpu| / max |cpu|`` over the leaves, and the
    largest ``|cpu|``."""
    import torch
    from repro_torch.core.transport import tree_leaves
    from repro_torch.train.trainer import machine_grads
    (lc, gc), (lp, gp) = (
        machine_grads(model, p, {k: v.to(dev) for k, v in batch.items()},
                      tcfg)
        for model, p, dev in zip(models, params, ("cuda", "cpu")))
    check(torch.allclose(lc.cpu(), lp, rtol=1e-4, atol=0), f"per-machine "
          f"losses {lc.tolist()} on the card, {lp.tolist()} on the CPU")
    err = top = 0.0
    for a, b in zip(tree_leaves(gc), tree_leaves(gp)):
        scale = b.abs().max().item()
        top = max(top, scale)
        err = max(err, (a.cpu() - b).abs().max().item() / scale)
    return err, top


def phase_train_vs_cpu():
    """Phase 17: the reduced glm4-9b in f32 trained on the card and on the
    CPU from the same weights, tokens and standard-normal draws (made on
    the CPU): VS_CPU_STEPS steps of dcq_mad with per-leaf DP noise (eps 1,
    dp_n = batch / machines) and machine 0 signflipped. Both sides run
    B1's algorithm (``use_pallas=True``: the kernel on the card, its plain
    version on the CPU), so the CQ thresholds are the same constants.
    Both models recompute their blocks in the backward pass (remat).
    Before each step the per-machine gradients, which the noise would
    drown in the aggregate, are held card against CPU leaf for leaf within
    1e-4 of the leaf's largest magnitude."""
    import torch
    from repro_torch.agg import kernel
    from repro_torch.configs import get_config
    from repro_torch.core.transport import tree_leaves, tree_map
    from repro_torch.data.lm import make_batch
    from repro_torch.dist.grad_agg import GradAggConfig
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainer import TrainConfig, make_train_step
    cfg = get_config(GLM, reduced=True)
    gen = torch.Generator().manual_seed(1717)
    cpu = Model(cfg, device="cpu", generator=gen, remat=True)
    card = Model(cfg, device="meta", remat=True)
    card.load_state_dict({k: v.cuda() for k, v in cpu.state_dict().items()},
                         assign=True)
    agg = GradAggConfig(method="dcq_mad", attack="signflip", dp_eps=1.0,
                        dp_n=VS_CPU_BATCH // TRAIN_M, use_pallas=True)
    tcfg = TrainConfig(n_machines=TRAIN_M, agg=agg)
    opt = AdamW(lr=TRAIN_LR)
    steps = {dev: make_train_step(mod, opt, tcfg)
             for dev, mod in (("cuda", card), ("cpu", cpu))}
    states = {"cuda": opt.init(card.params()), "cpu": opt.init(cpu.params())}
    params = {"cuda": card.params(), "cpu": cpu.params()}
    masks = {dev: torch.arange(TRAIN_M, device=dev) < 1
             for dev in ("cuda", "cpu")}
    rows = []
    kernel.launches = 0
    seen = set()
    for i in range(VS_CPU_STEPS):
        batch = make_batch(gen, cfg, VS_CPU_BATCH, VS_CPU_SEQ)
        noise = tree_map(lambda p: torch.randn((TRAIN_M,) + tuple(p.shape),
                                               generator=gen),
                         params["cpu"])
        # the per-machine gradients before the wire: the backward pass
        # (SDPA, the checkpointed blocks, the sums into the stacked
        # leaves) on the card against the CPU, free of the wire's noise
        grad_err, grad_max = grads_card_vs_cpu(
            (card, cpu), (params["cuda"], params["cpu"]), batch, tcfg)
        check(grad_err <= 1e-4, f"train card vs CPU, step {i}: per-machine "
              f"gradients disagree (max |diff| / leaf scale {grad_err})")
        out = {}
        for dev in ("cuda", "cpu"):
            def run(dev=dev):
                out[dev] = steps[dev](
                    params[dev], states[dev],
                    {k: v.to(dev) for k, v in batch.items()}, None,
                    masks[dev], with_agg=True,
                    noise=tree_map(lambda z: z.to(dev), noise))
            if dev == "cuda":
                s, _, _ = held_against_plain(run, first=0)
                seen |= s
            else:
                run()
            params[dev], states[dev], _ = out[dev]
        mc, mp = out["cuda"][2], out["cpu"][2]
        agg_diff = max((a.cpu() - b).abs().max().item() for a, b in
                       zip(tree_leaves(mc["agg"]), tree_leaves(mp["agg"])))
        for a, b in zip(tree_leaves(mc["agg"]), tree_leaves(mp["agg"])):
            check(torch.allclose(a.cpu(), b, atol=1e-4, rtol=1e-4),
                  f"train card vs CPU, step {i}: aggregated gradients "
                  f"disagree (max |diff| {agg_diff})")
        lc, lp = mc["loss"].item(), mp["loss"].item()
        check(math.isclose(lc, lp, rel_tol=1e-4), f"train card vs CPU, step "
              f"{i}: losses {lc} and {lp}")
        rows.append({"step": i, "loss_card": lc, "loss_cpu": lp,
                     "max_rel_grad_diff": grad_err,
                     "max_abs_grad": grad_max,
                     "max_abs_agg_diff": agg_diff})
    check(kernel.launches == WIDE_LEAVES * VS_CPU_STEPS,
          f"train card vs CPU: {kernel.launches} B1 launches")
    missing = train_untimed(seen)
    check(not missing, f"train card vs CPU: phase 3 did not time {missing}")
    total = close = 0
    worst = 0.0
    for a, b in zip(tree_leaves(params["cuda"]), tree_leaves(params["cpu"])):
        d = (a.detach().cpu() - b.detach()).abs()
        total += d.numel()
        close += int((d <= 1e-5).sum())
        worst = max(worst, d.max().item())
    apart = total - close
    bound_all = 2 * TRAIN_LR * VS_CPU_STEPS
    check(close >= 0.9999 * total, f"train card vs CPU: {apart} of {total} "
          f"parameters differ by more than 1e-5")
    check(worst <= bound_all, f"train card vs CPU: a parameter differs by "
          f"{worst} > 2 lr steps = {bound_all}")
    print(f"[17] train card vs CPU, reduced {GLM} f32, batch "
          f"{VS_CPU_BATCH} x {VS_CPU_SEQ}, {TRAIN_M} machines, "
          f"{VS_CPU_STEPS} steps of dcq_mad with eps 1: per step {rows}; "
          f"parameters: {apart} of {total} apart by more than 1e-5, max "
          f"|diff| {worst} (limit {bound_all})", flush=True)
    return {"steps": rows, "params_apart": apart, "params": total,
            "max_abs_param_diff": worst, "launches": kernel.launches}


# ------------------------------------------------ quasi-Newton training

def phase_qn_wide():
    """Phase 18: the quasi-Newton protocol as the train step at full width
    (glm4-9b, WIDE_LAYERS layers, bf16): TRAIN_M machines of QN_BATCH
    sequences of QN_SEQ tokens, ``TreeProtocolConfig(hist=QN_HIST)`` with
    the other defaults (dcq_mad), machine 0 signflipped, remat. A warm-up
    step with every B1 launch held against the plain version, QN_TIMED
    timed steps, one profiled step, then QN_DP_STEPS steps at eps 1 with
    the calibrated per-leaf sigmas (checked for running, launches and
    memory only: at n = 2 rows per machine the sigmas are large by
    design). Every step must make QN_LAUNCHES B1 launches; the peak of the
    steps after the warm-up must stay under QN_PEAK."""
    import torch
    from repro_torch.configs.base import TreeProtocolConfig
    from repro_torch.core import dp
    from repro_torch.core.bfgs import LBFGSMemory
    from repro_torch.core.transport import tree_leaves
    from repro_torch.data.lm import make_batch
    from repro_torch.models.model import Model
    from repro_torch.train.trainer import QNTrainConfig, make_qn_train_step
    cfg = wide_config()
    g = torch.Generator(device="cuda")
    g.manual_seed(1818)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, generator=g, remat=True)
    params = model.params()
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    check(len(leaves) == WIDE_LEAVES and n_params == WIDE_PARAMS,
          f"QN full-width tree: {len(leaves)} leaves, {n_params} parameters")
    n_steps = 1 + QN_TIMED + 1 + QN_DP_STEPS
    batches = [make_batch(g, cfg, QN_BATCH, QN_SEQ) for _ in range(n_steps)]
    tokens = QN_BATCH * QN_SEQ
    mask = torch.arange(TRAIN_M, device="cuda") < 1
    proto = TreeProtocolConfig(hist=QN_HIST)
    step = make_qn_train_step(model, QNTrainConfig(
        n_machines=TRAIN_M, attack="signflip", protocol=proto))
    mem_state = LBFGSMemory.init_like(QN_HIST, params, machines=TRAIN_M)
    mem = {"after_init": torch.cuda.max_memory_allocated()}
    print(f"[18] {GLM} at full width, {WIDE_LAYERS} layers, {n_params} bf16 "
          f"parameters in {len(leaves)} leaves; {TRAIN_M} machines x "
          f"{QN_BATCH // TRAIN_M} sequences of {QN_SEQ} tokens; "
          f"TreeProtocolConfig(hist={QN_HIST}) ({proto}); machine 0 "
          f"signflipped, remat; L-BFGS memory "
          f"{sum(t.numel() * t.element_size() for t in tree_leaves(mem_state.s_hist)) * 2} "
          f"bytes", flush=True)

    # warm-up: every launch held against the plain version
    box = []
    mark = launch_mark()
    t0 = time.perf_counter()
    seen, held_err, held = held_against_plain(lambda: box.append(
        step(params, mem_state, batches[0], None, mask)))
    warm_s = time.perf_counter() - t0
    params, mem_state, metrics = box.pop()
    n = check_launches(mark, QN_LAUNCHES, "QN warm-up step")
    check(held == n, f"QN warm-up step: {n} launches, {held} held")
    warm_loss = float(metrics["loss"])
    check(math.isfinite(warm_loss), f"QN warm-up loss {warm_loss}")
    del metrics
    mem["warmup_with_holds"] = torch.cuda.max_memory_allocated()
    missing = train_untimed(seen)
    check(not missing, f"QN training: phase 3 did not time {missing}")
    print(f"[18] warm-up step: loss {warm_loss}, counts "
          f"{mem_state.count.tolist()}, {held} B1 launches held against the "
          f"plain version over column blocks (p99.9 err <= {held_err:.3g}), "
          f"{warm_s} s with the holds; peak {mem['warmup_with_holds']} "
          f"bytes with them", flush=True)

    # the steps' own peak, from here on
    torch.cuda.reset_peak_memory_stats()
    mark = launch_mark()
    params, mem_state, secs, losses, norms = _step_loop(
        step, params, mem_state, batches[1:1 + QN_TIMED], None, mask,
        QN_LAUNCHES)
    launches = launch_mark()[0] - mark[0]
    med = statistics.median(secs)
    mem["timed"] = torch.cuda.max_memory_allocated()
    print(f"[18] {QN_TIMED} timed steps: ms {[x * 1e3 for x in secs]}, "
          f"median {med * 1e3} ms, {tokens / med} tokens/s; losses "
          f"{losses}; grad norms {norms}; counts "
          f"{mem_state.count.tolist()}; B1 launches {launches} "
          f"({launches // QN_TIMED} per step); peak {mem['timed']} bytes",
          flush=True)

    box = []
    batch = batches[1 + QN_TIMED]
    mark = launch_mark()
    trace = device_profile(lambda: box.append(
        step(params, mem_state, batch, None, mask)), med)
    params, mem_state, metrics = box.pop()
    launches += check_launches(mark, QN_LAUNCHES, "QN profiled step")
    check(math.isfinite(float(metrics["loss"])), "QN profiled step: loss")
    del metrics, box
    if trace is None:
        print("[18] profiler: no device events in the trace (device idle "
              "share not measured)", flush=True)
    else:
        b1 = trace["kernels_us"]["ostat_kernel"]
        trace["b1_share_of_busy"] = b1 / trace["device_busy_us"]
        print(f"[18] profiler, one step: device busy "
              f"{trace['device_busy_us']} us of {trace['wall_us']} us wall "
              f"(idle share {trace['idle_share']}), "
              f"{trace['device_events']} device events, B1 {b1} us "
              f"({trace['b1_share_of_busy']} of busy); busiest "
              f"{trace['top']}", flush=True)

    # phase 33's cell: the same step traced on meta against one real step
    mark = launch_mark()
    DRY_CELLS["qn_wide"] = dry_cell(
        "18", lambda m, mesh: make_qn_train_step(m, QNTrainConfig(
            n_machines=TRAIN_M, attack="signflip", protocol=proto), mesh),
        model, params, mem_state,
        lambda p: LBFGSMemory.init_like(QN_HIST, p, machines=TRAIN_M),
        batches[1], mask, (QN_BATCH, QN_SEQ), med)
    params, mem_state = DRY_CELLS["qn_wide"].pop("result")
    launches += check_launches(mark, QN_LAUNCHES, "phase 33's QN cell")

    # eps = 1 with the calibrated per-leaf sigmas (n = 2 rows a machine)
    dp_step = make_qn_train_step(model, QNTrainConfig(
        n_machines=TRAIN_M, attack="signflip",
        protocol=TreeProtocolConfig(hist=QN_HIST, eps=1.0)))
    sigmas = dp.calibrate_tree_sigmas(params, QN_BATCH // TRAIN_M, 1.0,
                                      proto.delta)
    dp_rows = []
    for batch in batches[-QN_DP_STEPS:]:
        mark = launch_mark()
        params, mem_state, metrics = dp_step(params, mem_state, batch, g,
                                             mask)
        launches += check_launches(mark, QN_LAUNCHES, "QN DP step")
        dp_rows.append((float(metrics["loss"]),
                        float(metrics["grad_norm"])))
    mem["dp"] = torch.cuda.max_memory_allocated()
    check(tuple(mem_state.count.shape) == (TRAIN_M,),
          f"QN memory count {tuple(mem_state.count.shape)}")
    print(f"[18] {QN_DP_STEPS} steps at eps 1 (per-leaf sigmas "
          f"{ {k: [round(s, 3) for s in tree_leaves(v)] for k, v in sigmas.items()} }): "
          f"loss, grad norm {dp_rows} (not required finite: the sigmas at "
          f"n = 2 are large by design); counts {mem_state.count.tolist()}",
          flush=True)
    peak = max(mem["dp"], mem["timed"])
    mem["reserved"] = torch.cuda.max_memory_reserved()
    print(f"[18] peak device memory of the steps {peak} bytes (limit "
          f"{QN_PEAK:.0f}); by stage {mem}", flush=True)
    check(peak <= QN_PEAK, f"QN full width: peak device memory {peak}")
    del model, params, mem_state, step, dp_step, batches
    torch.cuda.empty_cache()
    return {"leaves": WIDE_LEAVES, "params": n_params, "machines": TRAIN_M,
            "batch": QN_BATCH, "seq": QN_SEQ, "hist": QN_HIST,
            "tokens_per_step": tokens, "warmup_loss": warm_loss,
            "warmup_s": warm_s, "held": held, "held_p999_err": held_err,
            "step_ms": [x * 1e3 for x in secs], "median_step_ms": med * 1e3,
            "tokens_per_s": tokens / med, "losses": losses,
            "grad_norms": norms,
            "launches_per_step": launches // (QN_TIMED + 2 + QN_DP_STEPS),
            "decisions_per_step": QN_LAUNCHES,
            "launches": launches, "trace": trace, "dp_steps": dp_rows,
            "memory": mem, "max_memory_allocated": peak}


def phase_qn_launcher():
    """Phase 19: ``python -m repro_torch.launch.train --optimizer qn`` on
    the card (reduced glm4-9b, 12 steps, 4 machines, 25% signflip): a
    first run with every launch held against the plain version, then the
    counted run, whose checkpoint must hold the reference's keys and read
    back through ``restore`` into an ``LBFGSMemory`` equal to what was
    written."""
    import contextlib
    import io

    import numpy as np
    import torch
    from repro_torch.checkpoint import checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core.bfgs import LBFGSMemory
    from repro_torch.core.transport import leaf_paths, tree_leaves
    from repro_torch.launch import train as launcher
    from repro_torch.models.model import Model
    ck = ROOT / "build" / "qn_launcher.npz"
    ck.parent.mkdir(exist_ok=True)
    argv = list(QN_ARGV) + ["--ckpt", str(ck)]
    want = QN_LAUNCHES * TRAIN_STEPS
    held_mark = launch_mark()
    with contextlib.redirect_stdout(io.StringIO()):
        seen, held_err, held = held_against_plain(lambda: launcher.main(argv))
    check_launches(held_mark, want, "QN launcher, held run")
    log, box = io.StringIO(), []
    mark = launch_mark()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        box.append(launcher.main(argv))
    wall = time.perf_counter() - t0
    launches = check_launches(mark, want, f"QN launcher ({QN_LAUNCHES} per "
                              f"step x {TRAIN_STEPS})")
    losses = box[0]
    check(held == want, f"QN launcher: held {held}, expected {want}")
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"QN launcher: losses {losses}")
    missing = train_untimed(seen)
    check(not missing, f"QN launcher: phase 3 did not time {missing}")
    model = Model(get_config(GLM, reduced=True), device="cuda")
    tmpl = LBFGSMemory.init_like(5, model.params(), machines=TRAIN_M)
    paths = leaf_paths(model.params())
    with np.load(ck) as z:
        keys = set(z.files) - {"__step__", "__meta__"}
        expect = ({f"params/{p}" for p in paths}
                  | {f"opt/{i}/{p}" for i in (0, 1) for p in paths}
                  | {"opt/2"})
        check(keys == expect, f"QN checkpoint keys {sorted(keys ^ expect)} "
              f"differ from the reference's")
        raw = {k: z[k].copy() for k in keys}
    _, mem_state, step, meta = checkpoint.restore(str(ck), model.params(),
                                                  tmpl)
    check(isinstance(mem_state, LBFGSMemory) and step == TRAIN_STEPS
          and meta.get("optimizer") == "qn", f"QN checkpoint: step {step}, "
          f"meta {meta}")
    for i, tree in ((0, mem_state.s_hist), (1, mem_state.y_hist)):
        for p, t in zip(paths, tree_leaves(tree)):
            check(np.array_equal(t.cpu().numpy(), raw[f"opt/{i}/{p}"]),
                  f"QN checkpoint: opt/{i}/{p} read back differs")
    check(np.array_equal(mem_state.count.cpu().numpy(), raw["opt/2"]),
          "QN checkpoint: the count read back differs")
    for line in log.getvalue().splitlines():
        print(f"[19] {line}", flush=True)
    print(f"[19] QN launcher: {wall} s wall ({wall / TRAIN_STEPS * 1e3} ms "
          f"per step), losses {losses}, {launches} B1 launches "
          f"({QN_LAUNCHES} per step); the held run's {held} launches held "
          f"against the plain version (p99.9 err <= {held_err:.3g}); "
          f"checkpoint {len(keys)} keys, counts "
          f"{mem_state.count.tolist()} read back equal", flush=True)
    return {"argv": argv, "wall_s": wall, "losses": losses,
            "launches": launches, "held": held, "held_p999_err": held_err,
            "ckpt_keys": len(keys), "counts": mem_state.count.tolist(),
            "log": log.getvalue()}


def _share_close(a_tree, b_tree, tol=1e-4):
    """(coordinates apart by more than atol = rtol = ``tol``, all
    coordinates, the largest |a - b|) of two trees, ``a`` on the card."""
    import torch
    from repro_torch.core.transport import tree_leaves
    apart = total = 0
    worst = 0.0
    for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)):
        a = a.detach().cpu()
        apart += int((~torch.isclose(a, b, atol=tol, rtol=tol)).sum())
        total += a.numel()
        worst = max(worst, (a - b).abs().max().item())
    return apart, total, worst


def phase_qn_vs_cpu():
    """Phase 20: the QN step card against CPU on the reduced glm4-9b in
    f32 (batch 8 x 128, 4 machines, hist 5, machine 0 signflipped, every
    sigma QN_VS_CPU_SIGMA with CPU-drawn normals handed to both sides),
    QN_VS_CPU_STEPS steps of each run of QN_VS_CPU_RUNS (an aggregator and
    the seed of its weights, tokens and draws), each step from the CPU's
    state (the card's parameters and memory set to the CPU's before it:
    over several steps the curvature amplifies every difference). Per
    step: every machine's R2 gradient at the CPU's theta_cq, computed on
    both sides, within 1e-4 of the leaf's largest magnitude; the counts
    equal, the losses and the grad norm within rtol 1e-4. The median is
    continuous: theta_cq, theta_os, theta_qn and the memory's s and y
    within atol = rtol = 1e-4 on every coordinate. dcq_mad at m = 4 flips
    where a machine value lies at a threshold, and R5's two-loop spreads a
    flip of g_os into every direction: theta_cq and theta_os on 99.99% of
    the coordinates, theta_qn and the memory on 99.9%
    (tests/test_torch_qn_train.py::test_steps_under_gradient_rounding)."""
    from repro_torch.agg import kernel
    runs, seen = [], set()
    kernel.launches = 0
    for agg, seed in QN_VS_CPU_RUNS:
        runs.append(_qn_vs_cpu_run(agg, seed, seen))
    check(kernel.launches == QN_LAUNCHES * QN_VS_CPU_STEPS * len(runs),
          f"QN card vs CPU: {kernel.launches} B1 launches")
    missing = train_untimed(seen)
    check(not missing, f"QN card vs CPU: phase 3 did not time {missing}")
    fields = ("theta_cq", "theta_os", "theta_qn", "s_hist", "y_hist")
    gaps = {}
    for r in runs:
        g = {f: max(x[f]["max_abs_diff"] for x in r["steps"]) for f in fields}
        g["apart"] = [{f: x[f]["apart"] for f in fields} for x in r["steps"]]
        g["grad"] = max(x["max_rel_grad_diff"] for x in r["steps"])
        gaps[f"{r['aggregator']} seed {r['seed']}"] = g
    print(f"[20] QN card vs CPU, reduced {GLM} f32, batch {VS_CPU_BATCH} x "
          f"{VS_CPU_SEQ}, {TRAIN_M} machines, hist {QN_VS_CPU_HIST}, "
          f"{QN_VS_CPU_STEPS} steps a run, sigmas {QN_VS_CPU_SIGMA}: "
          f"largest gaps and coordinates apart per step {gaps}", flush=True)
    return {"runs": runs, "largest_gaps": gaps, "launches": kernel.launches}


def _qn_vs_cpu_run(agg: str, seed: int, seen: set) -> dict:
    """One run of phase 20: ``agg`` on the weights, tokens and draws of
    ``seed``; adds the B1 launches' shapes to ``seen``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TreeProtocolConfig
    from repro_torch.core import dp
    from repro_torch.core.bfgs import LBFGSMemory
    from repro_torch.core.protocol import protocol_tree_rounds
    from repro_torch.core.transport import tree_map
    from repro_torch.data.lm import make_batch
    from repro_torch.models.model import Model
    from repro_torch.train.trainer import (TrainConfig, make_grad_fn,
                                           split_machines)
    cfg = get_config(GLM, reduced=True)
    gen = torch.Generator().manual_seed(seed)
    cpu = Model(cfg, device="cpu", generator=gen, remat=True)
    card = Model(cfg, device="meta", remat=True)
    card.load_state_dict({k: v.cuda() for k, v in cpu.state_dict().items()},
                         assign=True)
    proto = TreeProtocolConfig(hist=QN_VS_CPU_HIST, eps=1.0, aggregator=agg)
    sigmas = {name: QN_VS_CPU_SIGMA for name in dp.TREE_TRANSMISSIONS}
    grad_fns = {"cuda": make_grad_fn(card), "cpu": make_grad_fn(cpu)}
    masks = {dev: torch.arange(TRAIN_M, device=dev) < 1
             for dev in ("cuda", "cpu")}
    theta = tree_map(lambda x: x.detach().clone(), cpu.params())
    mem_cpu = LBFGSMemory.init_like(proto.hist, theta, machines=TRAIN_M)
    shares = {"theta_cq": 0.9999, "theta_os": 0.9999, "theta_qn": 0.999,
              "s_hist": 0.999, "y_hist": 0.999}
    if agg == "median":
        shares = dict.fromkeys(shares, 1.0)
    rows = []
    for i in range(QN_VS_CPU_STEPS):
        where = f"QN card vs CPU, {agg} seed {seed}, step {i}"
        batch = make_batch(gen, cfg, VS_CPU_BATCH, VS_CPU_SEQ)
        noise = {name: tree_map(lambda p: torch.randn(
            (TRAIN_M,) + tuple(p.shape), generator=gen), theta)
            for name in dp.TREE_TRANSMISSIONS}
        out = {}
        for dev in ("cuda", "cpu"):
            to = (lambda t: t.to(dev)) if dev == "cuda" else (lambda t: t)
            mem = mem_cpu.clone() if dev == "cpu" else LBFGSMemory(
                tree_map(to, mem_cpu.s_hist), tree_map(to, mem_cpu.y_hist),
                to(mem_cpu.count))

            def run(dev=dev, mem=mem, to=to):
                out[dev] = protocol_tree_rounds(
                    None, tree_map(to, theta),
                    split_machines({k: to(v) for k, v in batch.items()},
                                   TRAIN_M),
                    grad_fns[dev], proto, mem=mem, byz_mask=masks[dev],
                    attack="signflip", sigmas=sigmas,
                    noise={k: tree_map(to, v) for k, v in noise.items()})
            if dev == "cuda":
                mark = launch_mark()
                with platform_rule():
                    s, _, _ = held_against_plain(run, first=0)
                seen |= s
                check(check_launches(mark, QN_LAUNCHES, where)
                      == QN_LAUNCHES, f"{where}: not every decision the "
                      f"kernel under the platform rule")
            else:
                run()
        oc, op = out["cuda"], out["cpu"]
        # R2's per-machine gradients at the CPU's theta_cq, both sides
        grad_err, grad_max = grads_card_vs_cpu(
            (card, cpu), (tree_map(lambda t: t.cuda(), op.theta_cq),
                          op.theta_cq), batch, TrainConfig(n_machines=TRAIN_M))
        check(grad_err <= 1e-4, f"{where}: R2 per-machine gradients "
              f"disagree (max |diff| / leaf scale {grad_err})")
        row = {"step": i, "max_rel_grad_diff": grad_err,
               "max_abs_grad": grad_max}
        for f, share in shares.items():
            a, b = ((getattr(oc.mem, f), getattr(op.mem, f)) if "hist" in f
                    else (getattr(oc, f), getattr(op, f)))
            apart, total, worst = _share_close(a, b)
            row[f] = {"apart": apart, "of": total, "max_abs_diff": worst}
            check(apart <= (1 - share) * total, f"{where}: {f} {apart} of "
                  f"{total} coordinates apart by more than 1e-4 (allowed "
                  f"{(1 - share) * total:.0f})")
        check(torch.equal(oc.mem.count.cpu(), op.mem.count),
              f"{where}: counts {oc.mem.count.tolist()} and "
              f"{op.mem.count.tolist()}")
        for f in ("losses", "grad_norm"):
            a, b = getattr(oc, f).cpu(), getattr(op, f)
            row[f] = (a.tolist(), b.tolist())
            check(torch.allclose(a, b, rtol=1e-4, atol=0),
                  f"{where}: {f} {a.tolist()} and {b.tolist()}")
        row["counts"] = op.mem.count.tolist()
        rows.append(row)
        theta, mem_cpu = op.theta_qn, op.mem
        del out, oc, op
    return {"aggregator": agg, "seed": seed, "steps": rows}


# --------------------------------------------- the model zoo's families

@contextlib.contextmanager
def slstm_clock():
    """Host-clock seconds inside every ``xlstm.slstm_forward`` while the
    context is open: its forward (and its recomputation under remat when
    that runs outside a backward window), and its backward, from the
    gradient reaching its output to the gradient leaving its input, read
    by two identity autograd nodes at its ends. Yields ``{"forward_s",
    "backward_s", "windows"}``; ``windows`` counts the backward passes.
    The stamps add no synchronisation: in a host-bound step the host's
    clock is the step's."""
    import torch
    from repro_torch.models import xlstm
    acc = {"forward_s": 0.0, "backward_s": 0.0, "windows": 0}
    opened = []

    class Stamp(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, at_output):
            ctx.at_output = at_output
            return x.view_as(x)

        @staticmethod
        def backward(ctx, grad):
            now = time.perf_counter()
            if ctx.at_output:
                opened.append(now)
            else:
                acc["backward_s"] += now - opened.pop()
                acc["windows"] += 1
            return grad, None

    plain = xlstm.slstm_forward

    def stamped(p, x, cfg):
        t0 = time.perf_counter()
        y = Stamp.apply(plain(p, Stamp.apply(x, False), cfg), True)
        if not opened:        # a recomputation inside a window is in it
            acc["forward_s"] += time.perf_counter() - t0
        return y
    xlstm.slstm_forward = stamped
    try:
        yield acc
    finally:
        xlstm.slstm_forward = plain


def _xlstm_probe(model, batch, tag: str) -> dict:
    """The step sizes' probe of phase 21, one machine's first protocol
    round up to theta_os on ``batch`` (its rows) with no wire between the
    moves: the gradient g0 at the model's parameters theta0, theta_cq =
    theta0 - local_lr x g0, its gradient g_cq, theta_os = theta_cq - lr x
    g_cq (with an empty memory R3's direction is the gradient itself), for
    the defaults (local_lr, lr) and for XLSTM_STEP_SIZES: the losses, the
    gradient norms and max|theta_os|. Fails unless XLSTM_STEP_SIZES's are
    finite."""
    import torch
    from repro_torch.configs.base import TreeProtocolConfig
    from repro_torch.core.transport import tree_leaves, tree_map
    from repro_torch.train.trainer import make_grad_fn
    grad_fn = make_grad_fn(model)

    def norm(tree):
        return math.sqrt(sum(float(torch.dot(x.reshape(-1).float(),
                                             x.reshape(-1).float()))
                             for x in tree_leaves(tree)))

    def moved(tree, by, lr):
        with torch.no_grad():
            return tree_map(lambda t, d: t - lr * d, tree, by)
    theta0 = model.params()
    loss0, g0 = grad_fn(theta0, batch)
    row = {"loss": float(loss0), "grad_norm": norm(g0), "runs": {}}
    defaults = TreeProtocolConfig()
    for local_lr, lr in ((defaults.local_lr, defaults.lr), XLSTM_STEP_SIZES):
        theta_cq = moved(theta0, g0, local_lr)
        loss_cq, g_cq = grad_fn(theta_cq, batch)
        theta_os = moved(theta_cq, g_cq, lr)
        del theta_cq
        with torch.no_grad():
            loss_os = float(model.loss(batch, params=theta_os)[0])
        row["runs"][f"{local_lr}, {lr}"] = {
            "loss_cq": float(loss_cq), "grad_norm_cq": norm(g_cq),
            "loss_os": loss_os,
            "max_abs_theta_os": max(float(t.abs().max())
                                    for t in tree_leaves(theta_os))}
        del g_cq, theta_os
    del g0
    print(f"[{tag}] step-size probe, machine 0 from init: loss "
          f"{row['loss']}, gradient norm {row['grad_norm']}; (local_lr, lr) "
          f"-> {row['runs']}", flush=True)
    mine = row["runs"][f"{XLSTM_STEP_SIZES[0]}, {XLSTM_STEP_SIZES[1]}"]
    check(all(math.isfinite(v) for v in mine.values()),
          f"xLSTM probe at {XLSTM_STEP_SIZES}: {mine}")
    return row


def _xlstm_decode(model, g) -> dict:
    """XLSTM_DECODE: B requests from an empty cache, greedy, the step time
    on the host clock between synchronisations."""
    import torch
    B, steps = XLSTM_DECODE
    cache = model.init_cache(B, steps)
    tok = torch.randint(0, model.cfg.vocab, (B, 1), generator=g,
                        device="cuda")
    model.decode_step(model.init_cache(B, steps), {"tokens": tok})
    secs = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.decode_step(cache, {"tokens": tok})
        tok = logits.argmax(-1)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        check(bool(torch.isfinite(logits).all()), "xLSTM decode: logits")
    check(cache["pos"] == steps, f"xLSTM decode: pos {cache['pos']}")
    return {"batch": B, "steps": steps, "seconds": secs,
            "median_step_ms": statistics.median(secs) * 1e3,
            "tokens_per_s": B * steps / sum(secs)}


def _zoo_qn_wide(tag: str, arch: str, seed: int) -> dict:
    """One of phases 21-23, 27 and 28: ``arch`` at full width cut to
    ZOO_WIDE's depth, bf16, the quasi-Newton step at
    ``TreeProtocolConfig(hist=...)`` with the other defaults (lr 0.5,
    dcq_mad, K 10), TRAIN_M machines of ZOO_WIDE's rows x tokens (the
    vlm's rows also hold its n_patches patch embeddings, so a row is
    tokens + n_patches positions; the audio's tokens are (rows, tokens,
    n_codebooks)), machine 0 signflipped, remat: a warm-up step
    with the first launch at each (op, shape) held against the plain
    version over column blocks, the timed steps and one profiled step.
    Every step must make 5 x leaves B1 launches; the peak of the steps
    after the warm-up must stay under ZOO_PEAK."""
    import torch
    from repro_torch.configs.base import TreeProtocolConfig
    from repro_torch.core.bfgs import LBFGSMemory
    from repro_torch.core.transport import tree_leaves
    from repro_torch.data.lm import make_batch
    from repro_torch.models.model import Model
    from repro_torch.train.trainer import QNTrainConfig, make_qn_train_step
    layers, n_leaves, n_params, hist, (rows, seq), timed = ZOO_WIDE[arch]
    per_step = 5 * n_leaves
    cfg = zoo_config(arch)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, generator=g, remat=True)
    params = model.params()
    leaves = tree_leaves(params)
    n = sum(t.numel() for t in leaves)
    check(len(leaves) == n_leaves and n == n_params,
          f"{arch} cut to {layers} layers: {len(leaves)} leaves, {n} "
          f"parameters")
    batches = [make_batch(g, cfg, rows, seq) for _ in range(timed + 2)]
    # positions a step: the vlm's patches are positions of its sequence
    tokens = rows * (seq + (cfg.n_patches if cfg.family == "vlm" else 0))
    mask = torch.arange(TRAIN_M, device="cuda") < 1
    proto = TreeProtocolConfig(hist=hist)
    if arch == XLSTM:
        proto = dataclasses.replace(proto, local_lr=XLSTM_STEP_SIZES[0],
                                    lr=XLSTM_STEP_SIZES[1])
    step = make_qn_train_step(model, QNTrainConfig(
        n_machines=TRAIN_M, attack="signflip", protocol=proto))
    mem_state = LBFGSMemory.init_like(hist, params, machines=TRAIN_M)
    mem = {"after_init": torch.cuda.max_memory_allocated()}
    copies = sum(t.numel() * t.element_size()
                 for t in tree_leaves(mem_state.s_hist)) * 2
    print(f"[{tag}] {arch} ({cfg.citation}) at full width, {layers} "
          f"layers, {n} parameters in {len(leaves)} leaves "
          f"({sorted({str(t.dtype) for t in leaves})}); {TRAIN_M} machines "
          f"x {rows // TRAIN_M} sequences of {tokens // rows} positions "
          f"({seq} tokens); {proto}; machine "
          f"0 signflipped, remat; L-BFGS memory {copies} bytes", flush=True)
    probe = None
    if arch == XLSTM:
        probe = _xlstm_probe(model, {k: v[:rows // TRAIN_M]
                                     for k, v in batches[0].items()}, tag)

    box = []
    mark = launch_mark()
    t0 = time.perf_counter()
    seen, held_err, held = held_against_plain(lambda: box.append(
        step(params, mem_state, batches[0], None, mask)), distinct=True)
    warm_s = time.perf_counter() - t0
    params, mem_state, metrics = box.pop()
    warm_launches = check_launches(mark, per_step, f"{arch} QN warm-up step")
    warm_loss = float(metrics["loss"])
    check(math.isfinite(warm_loss), f"{arch} QN warm-up loss {warm_loss}")
    del metrics
    mem["warmup_with_holds"] = torch.cuda.max_memory_allocated()
    missing = train_untimed(seen)
    check(not missing, f"{arch} QN: phase 3 did not time {missing}")
    print(f"[{tag}] warm-up step: loss {warm_loss}, {warm_launches} B1 "
          f"launches ({per_step} decisions), "
          f"the first at each of {held} (op, shape) held against the plain "
          f"version over column blocks (p99.9 err <= {held_err:.3g}), "
          f"{warm_s} s with the holds", flush=True)

    torch.cuda.reset_peak_memory_stats()
    mark = launch_mark()
    with (slstm_clock() if arch == XLSTM else contextlib.nullcontext()) \
            as clock:
        params, mem_state, secs, losses, norms = _step_loop(
            step, params, mem_state, batches[1:1 + timed], None, mask,
            per_step)
    launches = launch_mark()[0] - mark[0]
    med = statistics.median(secs)
    print(f"[{tag}] {timed} timed steps: ms {[x * 1e3 for x in secs]}, "
          f"median {med * 1e3} ms, {tokens / med} tokens/s; losses "
          f"{losses}; grad norms {norms}; counts "
          f"{mem_state.count.tolist()}; B1 launches {launches}", flush=True)

    box = []
    mark = launch_mark()
    trace = device_profile(lambda: box.append(
        step(params, mem_state, batches[1 + timed], None, mask)), med)
    params, mem_state, metrics = box.pop()
    launches += check_launches(mark, per_step, f"{arch} QN profiled step")
    check(math.isfinite(float(metrics["loss"])), f"{arch} profiled loss")
    del metrics, box
    peak = torch.cuda.max_memory_allocated()
    mem["steps"] = peak
    mem["reserved"] = torch.cuda.max_memory_reserved()
    if trace is None:
        print(f"[{tag}] profiler: no device events in the trace (device "
              f"idle share not measured)", flush=True)
    else:
        b1 = trace["kernels_us"]["ostat_kernel"]
        trace["b1_share_of_busy"] = b1 / trace["device_busy_us"]
        print(f"[{tag}] profiler, one step: device busy "
              f"{trace['device_busy_us']} us of {trace['wall_us']} us wall "
              f"(idle share {trace['idle_share']}), "
              f"{trace['device_events']} device events, B1 {b1} us "
              f"({trace['b1_share_of_busy']} of busy); busiest "
              f"{trace['top']}", flush=True)
    row = {"arch": arch, "layers": layers, "leaves": n_leaves,
           "params": n, "machines": TRAIN_M, "rows": rows, "seq": seq,
           "hist": hist, "tokens_per_step": tokens, "warmup_loss": warm_loss,
           "warmup_s": warm_s, "held": held, "held_p999_err": held_err,
           "step_ms": [x * 1e3 for x in secs], "median_step_ms": med * 1e3,
           "tokens_per_s": tokens / med, "losses": losses,
           "grad_norms": norms,
           "launches_per_step": (launches + warm_launches) // (timed + 2),
           "decisions_per_step": per_step,
           "launches": launches, "trace": trace, "memory": mem,
           "max_memory_allocated": peak}
    if arch == XLSTM:
        # 4 gradients a machine a step (R1, R2, two in R4), each through
        # every sLSTM layer the cut depth keeps once
        windows = timed * 4 * TRAIN_M * sum(i < cfg.n_layers
                                            for i in cfg.slstm_at)
        check(clock["windows"] == windows, f"sLSTM clock: "
              f"{clock['windows']} backward windows, expected {windows}")
        inside = clock["forward_s"] + clock["backward_s"]
        row["probe"] = probe
        row["slstm_clock"] = clock
        row["slstm_share_of_steps"] = inside / sum(secs)
        row["decode"] = _xlstm_decode(model, g)
        print(f"[{tag}] sLSTM loop inside the {timed} timed steps (host "
              f"clock): forward {clock['forward_s']} s, backward "
              f"{clock['backward_s']} s over {clock['windows']} windows, "
              f"{row['slstm_share_of_steps']} of the steps' "
              f"{sum(secs)} s; decode B = {XLSTM_DECODE[0]}: "
              f"{row['decode']['tokens_per_s']} tokens/s, median step "
              f"{row['decode']['median_step_ms']} ms", flush=True)
    print(f"[{tag}] peak device memory of the steps {peak} bytes (limit "
          f"{ZOO_PEAK:.0f}); by stage {mem}", flush=True)
    check(peak <= ZOO_PEAK, f"{arch} QN: peak device memory {peak}")
    del model, params, mem_state, step, batches
    torch.cuda.empty_cache()
    return row


def phase_zoo_xlstm():
    """Phase 21: xlstm-125m at full width cut to 6 layers (53 leaves),
    QN step at hist 5, then its decode."""
    return _zoo_qn_wide("21", XLSTM, 2121)


def phase_zoo_moe():
    """Phase 22: qwen3-moe-30b-a3b at full width cut to 1 layer (13
    leaves), QN step at hist 1; then its decode cut to MOE_DECODE_LAYERS
    layers, B = DECODE_B, ctx-short and ctx-32k as phase 7, every B2
    launch held against the plain version in a pass before the timed
    one."""
    import torch
    from repro_torch.kernels import gqa_decode as gqa
    from repro_torch.models.model import Model
    row = _zoo_qn_wide("22", MOE, 2222)
    cfg = zoo_config(MOE, MOE_DECODE_LAYERS)
    g = torch.Generator(device="cuda")
    g.manual_seed(2223)
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, generator=g)
    seen, runs = set(), []
    for name, start in (("ctx-short", 0),
                        ("ctx-32k", DECODE_LEN - PROMPT - GEN)):
        run = _decode_run(model, name, start, g, hold_all=True, seen=seen,
                          hold=gqa_check_model)
        runs.append(run)
        tr = run["trace"]
        b2 = None if tr is None else sum(tr["kernels_us"].values())
        print(f"[22] decode {name:9s} ({MOE_DECODE_LAYERS} layers, B = "
              f"{DECODE_B}, {DECODE_LEN}-slot cache): "
              f"{run['tokens_per_s']} tokens/s, median step "
              f"{run['median_step_ms']} ms; B2 launches "
              f"{run['gqa_launches']}, {run['held_launches']} held against "
              f"the plain version (max|err| {run['held_max_abs_err']:.3g})"
              + ("" if tr is None else
                 f"; profiler, one step: busy {tr['device_busy_us']} us of "
                 f"{tr['wall_us']} us (idle share {tr['idle_share']}), B2 "
                 f"{b2} us ({b2 / tr['device_busy_us']} of busy)"),
              flush=True)
    missing = gqa_untimed(seen)
    check(not missing, f"moe decode: phase 6 did not time {missing}")
    row["decode"] = {"layers": MOE_DECODE_LAYERS, "runs": runs,
                     "max_memory_allocated":
                         torch.cuda.max_memory_allocated()}
    del model
    gqa.launches = 0
    torch.cuda.empty_cache()
    return row


def _zoo_decode(tag: str, arch: str, seed: int) -> dict:
    """The full-width, full-depth decode of phases 23, 27 and 28: ``arch``
    (bf16, weights drawn on the card from a seeded generator), B =
    DECODE_B, ZOO_DECODE's cache, ctx-short and ctx-<slots> as phase 7;
    every B2 launch of each run held against the plain version in a pass
    before the timed one (the warm-up step's only where ZOO_DECODE says
    so), by ``gqa_check_model`` (the kernel's P is two bf16 parts: its
    bf16 output may move by 2^-16 x max|v| where a model's terms cancel,
    phase 22), and one step profiled (B2's share of busy)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import gqa_decode as gqa
    from repro_torch.models.model import Model
    length, n_params, per_step, hold_all = ZOO_DECODE[arch]
    cfg = get_config(arch)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, generator=g)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(p.numel() for p in model.parameters())
    n_attn = model.n_shared if cfg.family == "hybrid" else cfg.n_layers
    check(n == n_params and n_attn == per_step, f"{arch} at full width and "
          f"depth: {n} parameters, {n_attn} attention layers")
    print(f"[{tag}] decode {arch} at full width and depth: {cfg.n_layers} "
          f"layers ({n_attn} with attention, head dim {cfg.head_dim}, Hq "
          f"{cfg.n_heads}, Hkv {cfg.n_kv_heads}), {n} bf16 parameters drawn "
          f"on the card in {init_s:.3f} s; B = {DECODE_B}, cache {length} "
          f"slots", flush=True)
    seen, runs = set(), []
    for name, start in (("ctx-short", 0),
                        (f"ctx-{length}", length - PROMPT - GEN)):
        run = _decode_run(model, name, start, g, hold_all=hold_all,
                          seen=seen, hold=gqa_check_model, length=length)
        runs.append(run)
        tr = run["trace"]
        b2 = None if tr is None else sum(tr["kernels_us"].values())
        print(f"[{tag}] decode {name:10s}: {run['tokens_per_s']} tokens/s, "
              f"median step {run['median_step_ms']} ms; B2 launches "
              f"{run['gqa_launches']} ({per_step} a step), "
              f"{run['held_launches']} held against the plain version "
              f"(max|err| {run['held_max_abs_err']:.3g})"
              + ("" if tr is None else
                 f"; profiler, one step: busy {tr['device_busy_us']} us of "
                 f"{tr['wall_us']} us (idle share {tr['idle_share']}), B2 "
                 f"{b2} us ({b2 / tr['device_busy_us']} of busy)"),
              flush=True)
    missing = gqa_untimed(seen)
    check(not missing, f"{arch} decode: phase 6 did not time {missing}")
    if arch == HYBRID:
        LONG["long_500k_" + arch] = long_decode(tag, model, g,
                                                LONG_HYBRID_STEPS)
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tag}] decode peak device memory {peak} bytes", flush=True)
    del model
    gqa.launches = 0
    torch.cuda.empty_cache()
    return {"arch": arch, "layers": cfg.n_layers, "params": n,
            "attention_layers": n_attn, "cache_slots": length,
            "init_s": init_s, "runs": runs, "max_memory_allocated": peak}


def phase_zoo_hybrid():
    """Phase 23: zamba2-7b at full width cut to 6 layers (one shared
    attention insertion, 20 leaves), QN step at hist 1; then its decode
    at full width and depth (81 layers, 13 insertions of the shared
    attention block, head dim 112), B = DECODE_B, a 4,096-slot cache."""
    row = _zoo_qn_wide("23", HYBRID, 2323)
    row["decode"] = _zoo_decode("23", HYBRID, 2324)
    return row


def phase_zoo_vlm():
    """Phase 27: llava-next-mistral-7b at full width cut to 2 layers (13
    leaves), QN step at hist 1 over 4 machines x 2 rows of 576 patch
    embeddings and 3,520 text tokens; then its decode at full width and
    depth (32 layers), a 32,768-slot cache."""
    row = _zoo_qn_wide("27", LLAVA, 2727)
    row["decode"] = _zoo_decode("27", LLAVA, 2728)
    return row


def phase_zoo_audio():
    """Phase 28: musicgen-medium at full width cut to 12 layers (12
    leaves), QN step at hist 1 over 4 machines x 2 rows of 1,500 frames
    of 4 codebooks; then its decode at full width and depth (48 layers),
    a 2,048-slot cache."""
    row = _zoo_qn_wide("28", MUSICGEN, 2828)
    row["decode"] = _zoo_decode("28", MUSICGEN, 2829)
    return row


def phase_zoo_launchers():
    """Phase 24: both launchers at their defaults (xlstm-125m, reduced):
    the serve launcher's documented command (17 leaves, 3 rounds at fill
    12, median, eps 1: 51 launches and 51 ledger records), then
    ``train --steps ZOO_TRAIN_STEPS`` with AdamW (17 launches a step) and with
    ``--optimizer qn`` (85 a step); the first launch at each (op, shape)
    of each run held against the plain version."""
    import contextlib
    import io

    import torch
    from repro_torch.core.transport import tree_leaves
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as train_launcher
    leaves = 17
    out, logs = {}, {}
    runs = (("serve", serve_launcher.main, list(ZOO_SERVE_ARGV),
             leaves * ZOO_SERVE_ROUNDS),
            ("train", train_launcher.main,
             ["--steps", str(ZOO_TRAIN_STEPS)], leaves * ZOO_TRAIN_STEPS),
            ("train-qn", train_launcher.main,
             ["--steps", str(ZOO_TRAIN_STEPS), "--optimizer", "qn"],
             5 * leaves * ZOO_TRAIN_STEPS))
    for name, main, argv, want in runs:
        log, box = io.StringIO(), []
        mark = launch_mark()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            seen, err, held = held_against_plain(
                lambda: box.append(main(argv)), distinct=True)
        wall = time.perf_counter() - t0
        launches = check_launches(mark, want, f"{name} launcher at its "
                                  f"defaults")
        missing = (serve_untimed if name == "serve" else train_untimed)(seen)
        check(not missing, f"{name} launcher: phase 3 did not time "
              f"{missing}")
        res = box[0]
        if name == "serve":
            check([h["fill"] for h in res.history]
                  == [ZOO_SERVE_FILL] * ZOO_SERVE_ROUNDS
                  and len(res.ledger) == leaves * ZOO_SERVE_ROUNDS
                  and all(bool(torch.isfinite(t).all())
                          for t in tree_leaves(res.theta)),
                  f"serve launcher: fills {[h['fill'] for h in res.history]}"
                  f", {len(res.ledger)} ledger records")
            summary = {"fills": [h["fill"] for h in res.history],
                       "flush_ms": [h["flush_s"] * 1e3
                                    for h in res.history],
                       "ledger": len(res.ledger)}
        else:
            check(len(res) == ZOO_TRAIN_STEPS
                  and all(map(math.isfinite, res)),
                  f"{name} launcher: losses {res}")
            summary = {"losses": res,
                       "ms_per_step": wall / ZOO_TRAIN_STEPS * 1e3}
        out[name] = dict(summary, argv=argv, wall_s=wall,
                         launches=launches, decisions=want, held=held,
                         held_p999_err=err)
        logs[name] = log.getvalue()
        for line in log.getvalue().splitlines()[-3:]:
            print(f"[24] {name}: {line}", flush=True)
        print(f"[24] {name} {' '.join(argv)}: {wall} s wall, "
              f"{launches} B1 launches ({want} decisions), the first at "
              f"each of {held} "
              f"(op, shape) held (p99.9 err <= {err:.3g}); {summary}",
              flush=True)
    out["logs"] = logs
    out["launches"] = sum(out[name]["launches"] for name, *_ in runs)
    return out


def phase_zoo_smoke():
    """Phase 25: ``python -m repro_torch.sweep --preset zoo-smoke`` on the
    card (7 training scenarios of 2 steps over the four families' reduced
    configs): 7 records, 5 x leaves launches a step, every launch at a
    shape phase 3 timed, the first at each (op, shape) held against the
    plain version."""
    import contextlib
    import io

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.sweep import build_preset, cli, load
    out = ROOT / "build" / "sweep_zoo-smoke.json"
    out.parent.mkdir(exist_ok=True)
    scens = build_preset("zoo-smoke")
    leaves = {a: len(list(Model(get_config(a, reduced=True),
                                device="meta").parameters()))
              for a in {s.arch for s in scens}}
    want = sum(5 * s.steps * leaves[s.arch] for s in scens)
    log, box = io.StringIO(), []
    mark = launch_mark()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        seen, err, held = held_against_plain(lambda: box.append(cli.main(
            ["--preset", "zoo-smoke", "--out", str(out), "--no-resume"])),
            distinct=True)
    wall = time.perf_counter() - t0
    (ROOT / "build" / "sweep_zoo-smoke.log").write_text(log.getvalue())
    check(box[0] == 0, f"zoo-smoke exited {box[0]}")
    art = load(str(out))
    check(len(art["scenarios"]) == len(scens) == 7,
          f"zoo-smoke: {len(art['scenarios'])} records")
    launches = check_launches(mark, want, "zoo-smoke")
    missing = train_untimed(seen)
    check(not missing, f"zoo-smoke: phase 3 did not time {missing}")
    rows = {sid: {"loss_first": r["metrics"]["loss_first"],
                  "loss_last": r["metrics"]["loss_last"],
                  "seconds": r["timing"]["group_seconds"],
                  "launches": r["timing"]["launches"]}
            for sid, r in art["scenarios"].items()}
    for s in scens:
        m = art["scenarios"][s.scenario_id()]["metrics"]
        if s.eps <= 0:
            check(all(map(math.isfinite, m["losses"])),
                  f"zoo-smoke {s.scenario_id()}: losses {m['losses']}")
    print(f"[25] zoo-smoke on the card: 7 scenarios in {wall} s wall, "
          f"{launches} B1 launches ({want} decisions), the first at each of "
          f"{held} (op, shape) held (p99.9 err <= {err:.3g}); per scenario "
          f"{rows}", flush=True)
    return {"wall_s": wall, "launches": launches, "held": held,
            "held_p999_err": err, "scenarios": rows}


def _y_at_points(grad_fn, oc, op, pushed, mb) -> dict:
    """The second witness of the memory's y in phase 26: ``grad_fn`` (the
    CPU's) takes each pushed machine's raw gradient difference at the
    card's theta_os and theta_cq (``oc``), held against the card's y at 1e-4
    of its largest magnitude; beside it the part of the card-CPU gap in y
    that the points alone make (the CPU's y at the card's points less the
    CPU's y at its own, ``op``), and the gap itself."""
    import torch
    from repro_torch.core.transport import tree_leaves, tree_map
    to_cpu = (lambda t: t.cpu())
    t_os, t_cq = tree_map(to_cpu, oc.theta_os), tree_map(to_cpu, oc.theta_cq)
    card = [h.cpu() for h in tree_leaves(oc.mem.y_hist)]
    mine = tree_leaves(op.mem.y_hist)
    apart = total = 0
    scale = max(h.abs().max().item() for h in card)
    same_gap = points_gap = end_gap = 0.0
    for j in pushed.tolist():
        b = tree_map(lambda x, j=j: x[j], mb)
        g1 = tree_leaves(grad_fn(t_os, b)[1])
        g0 = tree_leaves(grad_fn(t_cq, b)[1])
        for a, c, hc, hp in zip(g1, g0, card, mine):
            y = a - c
            apart += int((~torch.isclose(y, hc[j, -1], atol=1e-4 * scale,
                                         rtol=1e-4)).sum())
            total += y.numel()
            same_gap = max(same_gap, (y - hc[j, -1]).abs().max().item())
            points_gap = max(points_gap, (y - hp[j, -1]).abs().max().item())
            end_gap = max(end_gap, (hc[j, -1] - hp[j, -1]).abs().max().item())
    return {"apart": apart, "of": total, "max_abs_diff": same_gap,
            "points_alone_max_abs": points_gap, "card_vs_cpu_max_abs": end_gap,
            "y_scale": scale}


def _zoo_vs_cpu(arch: str, seed: int, y_share: float = 1.0) -> dict:
    """One family of phase 26 (``arch`` an id, or HYBRID_112); returns its
    gaps. The memory's y is held at
    1e-4 of its largest magnitude on ``y_share`` of the coordinates, and
    when that is below 1 at 1e-3 on all; the CPU's own y taken at the
    card's theta_os and theta_cq (the gradient code alone, the points
    made equal) must equal the card's y of every machine that pushed at
    1e-4 of its largest magnitude on every coordinate."""
    import torch
    from repro_torch.configs.base import TreeProtocolConfig
    from repro_torch.core.bfgs import LBFGSMemory
    from repro_torch.core.protocol import protocol_tree_rounds
    from repro_torch.core.transport import tree_leaves, tree_map
    from repro_torch.data.lm import make_batch
    from repro_torch.kernels import gqa_decode as gqa
    from repro_torch.models.model import Model
    from repro_torch.train.trainer import make_grad_fn, split_machines
    cfg = vs_cpu_config(arch)
    gen = torch.Generator().manual_seed(seed)
    cpu = Model(cfg, device="cpu", generator=gen, remat=True)
    card = Model(cfg, device="meta", remat=True)
    card.load_state_dict({k: v.cuda() for k, v in cpu.state_dict().items()},
                         assign=True)
    models = {"cuda": card, "cpu": cpu}
    batch = make_batch(gen, cfg, ZOO_VS_CPU_BATCH, ZOO_VS_CPU_SEQ)
    row = {"arch": arch}
    # the loss and its gradients, leaf for leaf
    out = {}
    for dev, mod in models.items():
        leaves = tree_leaves(mod.params())
        loss, _ = mod.loss({k: v.to(dev) for k, v in batch.items()})
        out[dev] = (loss.item(), torch.autograd.grad(loss, leaves))
    row["loss"] = (out["cuda"][0], out["cpu"][0])
    check(abs(out["cuda"][0] / out["cpu"][0] - 1) <= 1e-5,
          f"{arch} card vs CPU: losses {row['loss']}")
    gap = max((a.cpu() - b).abs().max().item()
              / max(b.abs().max().item(), 1e-30)
              for a, b in zip(out["cuda"][1], out["cpu"][1]))
    row["max_rel_grad_diff"] = gap
    check(gap <= 1e-4, f"{arch} card vs CPU: gradients {gap} of the leaf's "
          f"scale apart")
    # two median QN steps, each from the CPU's state
    proto = TreeProtocolConfig(aggregator="median")
    theta = tree_map(lambda x: x.detach().clone(), cpu.params())
    mem_cpu = LBFGSMemory.init_like(proto.hist, theta, machines=TRAIN_M)
    seen, steps = set(), []
    for i in range(2):
        mb = make_batch(gen, cfg, ZOO_VS_CPU_BATCH, ZOO_VS_CPU_SEQ)
        count_in = mem_cpu.count.clone()
        res = {}
        for dev in ("cuda", "cpu"):
            to = (lambda t, d=dev: t.to(d))
            mem = LBFGSMemory(tree_map(to, mem_cpu.s_hist),
                              tree_map(to, mem_cpu.y_hist),
                              to(mem_cpu.count))

            def run(dev=dev, mem=mem, to=to):
                res[dev] = protocol_tree_rounds(
                    None, tree_map(to, theta),
                    split_machines({k: to(v) for k, v in mb.items()},
                                   TRAIN_M),
                    make_grad_fn(models[dev]), proto, mem=mem,
                    byz_mask=torch.arange(TRAIN_M, device=dev) < 1,
                    attack="signflip")
            if dev == "cuda":
                mark = launch_mark()
                with platform_rule():
                    s, _, _ = held_against_plain(run, first=0)
                seen |= s
                n_leaves = len(tree_leaves(theta))
                check(check_launches(mark, 5 * n_leaves, f"{arch} QN card "
                                     f"vs CPU") == 5 * n_leaves,
                      f"{arch} QN card vs CPU: not every decision the "
                      f"kernel under the platform rule")
            else:
                run()
        oc, op = res["cuda"], res["cpu"]
        check(torch.equal(oc.mem.count.cpu(), op.mem.count),
              f"{arch} QN step {i}: counts")
        # the CPU's run moved mem_cpu's count in place
        pushed = torch.nonzero(op.mem.count > count_in).flatten()
        check(pushed.numel() > 0, f"{arch} QN step {i}: no machine pushed")
        gaps = {"y_same_points": _y_at_points(
            make_grad_fn(cpu), oc, op, pushed,
            split_machines(mb, TRAIN_M))}
        check(gaps["y_same_points"]["apart"] == 0,
              f"{arch} QN step {i}: the CPU's y at the card's points "
              f"{gaps['y_same_points']}")
        for f in ("theta_cq", "theta_os", "theta_qn", "s_hist", "y_hist"):
            a, b = ((getattr(oc.mem, f), getattr(op.mem, f)) if "hist" in f
                    else (getattr(oc, f), getattr(op, f)))
            pairs = [(x.cpu(), y) for x, y in zip(tree_leaves(a),
                                                  tree_leaves(b))]
            # y: each machine's raw gradient difference, at an atol of
            # 1e-4 x its largest magnitude
            scale = max(y.abs().max().item() for _, y in pairs) \
                if f == "y_hist" else 1.0

            def apart(tol):
                return sum(int((~torch.isclose(x, y, atol=tol * scale,
                                               rtol=1e-4)).sum())
                           for x, y in pairs)
            total = sum(y.numel() for _, y in pairs)
            worst = max((x - y).abs().max().item() for x, y in pairs)
            gaps[f] = {"apart": apart(1e-4), "of": total,
                       "max_abs_diff": worst}
            loose = f == "y_hist" and y_share < 1
            check(gaps[f]["apart"] <= (1 - y_share) * total if loose
                  else gaps[f]["apart"] == 0,
                  f"{arch} QN step {i}: {f} {gaps[f]['apart']} of {total} "
                  f"coordinates apart by more than 1e-4 (largest {worst})")
            check(not loose or apart(1e-3) == 0,
                  f"{arch} QN step {i}: y apart by more than 1e-3")
        steps.append(gaps)
        theta, mem_cpu = op.theta_qn, op.mem
    row["qn_steps"] = steps
    missing = train_untimed(seen)
    check(not missing, f"{arch} card vs CPU: phase 3 did not time {missing}")
    # decode
    B = ZOO_VS_CPU_BATCH // 4
    caches = {dev: m.init_cache(B, ZOO_VS_CPU_DECODE)
              for dev, m in models.items()}
    tok = batch["tokens"][:B, :1]
    worst, gseen = 0.0, set()
    before = gqa.launches
    for t in range(ZOO_VS_CPU_DECODE):
        lc, caches["cpu"] = cpu.decode_step(caches["cpu"], {"tokens": tok})
        box = []
        held_gqa_against_plain(lambda: box.append(card.decode_step(
            caches["cuda"], {"tokens": tok.cuda()})), gseen)
        lg = box[0][0].cpu()
        worst = max(worst, (lg - lc).abs().max().item())
        check(torch.allclose(lg, lc, atol=1e-4, rtol=1e-4),
              f"{arch} decode step {t}: logits {(lg - lc).abs().max()}")
        check(torch.equal(lg.argmax(-1), lc.argmax(-1)),
              f"{arch} decode step {t}: greedy tokens differ")
        tok = _step_tokens(cfg, lc.argmax(-1))
    n_attn = 0 if cfg.family == "ssm" else card.n_shared \
        if cfg.family == "hybrid" else cfg.n_layers
    check(gqa.launches - before == ZOO_VS_CPU_DECODE * n_attn,
          f"{arch} decode: {gqa.launches - before} B2 launches")
    check(not gqa_untimed(gseen), f"{arch} decode: phase 6 did not time "
          f"{gqa_untimed(gseen)}")
    row["decode"] = {"steps": ZOO_VS_CPU_DECODE, "max_abs_logit_diff": worst,
                     "b2_launches": gqa.launches - before}
    return row


def phase_zoo_vs_cpu():
    """Phase 26: each reduced family (xLSTM, MoE, hybrid, vlm, audio, and
    the hybrid at head dim 112) in f32 on the card
    and on the CPU from the same weights and tokens: the loss within rtol
    1e-5 and its gradients leaf for leaf within 1e-4 of the leaf's largest
    magnitude; two median QN steps (machine 0 signflipped, hist 5), each
    from the CPU's state: theta_cq, theta_os, theta_qn and the memory's s
    within atol = rtol = 1e-4 on every coordinate, its y (raw gradient
    differences) at an atol of 1e-4 of its largest magnitude on every
    coordinate (on ZOO_VS_CPU_Y_SHARE of them, and at 1e-3 on all, where
    that says so), and the CPU's y at the card's theta_os and theta_cq
    equal to the card's at the same tolerance on every coordinate
    (``_y_at_points``); ZOO_VS_CPU_DECODE greedy decode steps (B = 2):
    logits within atol = rtol = 1e-4, the same tokens, every B2 launch
    held against the plain version."""
    from repro_torch.agg import kernel
    kernel.launches = 0
    rows = [_zoo_vs_cpu(arch, 2600 + i, ZOO_VS_CPU_Y_SHARE.get(arch, 1.0))
            for i, arch in enumerate(ZOO_VS_CPU)]
    for r in rows:
        print(f"[26] card vs CPU, reduced {r['arch']} f32: losses "
              f"{r['loss']}, gradients {r['max_rel_grad_diff']} of the leaf "
              f"scale apart; QN median steps {r['qn_steps']}; decode "
              f"{r['decode']}", flush=True)
    return {"families": rows, "launches": kernel.launches}


# ------------------------------------------------- GQA flash-decode (B2)

#: the main path's attention shape: glm4-9b (Hq = 32, Hkv = 2, Dh = 128),
#: B = 8 requests, a 32,768-slot cache, bf16
MAIN = (8, 32768, 32, 2, 128)
#: tests/test_kernels.py::test_gqa_decode_shape_sweep
GQA_SWEEP = ((2, 128, 8, 2, 64), (3, 96, 4, 4, 128), (1, 1024, 16, 2, 128),
             (4, 33, 8, 1, 64))
RAGGED = (1, 100, 1000, 4096, 8000, 16384, 30000, 32768)
#: qwen3-moe's decode shape (phase 22: Hq = 32, Hkv = 4, Dh = 128, B = 8,
#: a 32,768-slot cache, bf16) and the reduced moe and hybrid decodes of
#: phase 26 (Hq = Hkv = 4, Dh = 64, B = 2, ZOO_VS_CPU_DECODE slots, f32)
MOE_MAIN = (8, 32768, 32, 4, 128)
ZOO_REDUCED = (2, 8, 4, 4, 64)
#: the decode shapes of the catalogue's last slice (B = 8, bf16): zamba2-7b
#: at full width (Hq = Hkv = 32, Dh 112, its 4,096-slot context), llava (g =
#: 4 at Hkv 8, as phi3.5-moe and minitron), musicgen (Hq = Hkv = 24, Dh 64,
#: a 2,048-slot cache) and starcoder2 (g = 12 at Hkv 4, as mistral-large);
#: each at cache_len 16, half, full and a ragged vector. zamba2's also in
#: f32, and the reduced hybrid at head dim 112 of phase 26 (f32, B = 2)
ZAMBA_MAIN = (8, 4096, 32, 32, 112)
LLAVA_MAIN = (8, 32768, 32, 8, 128)
MUSICGEN_MAIN = (8, 2048, 24, 24, 64)
STARCODER_MAIN = (8, 32768, 48, 4, 128)
ZOO_REDUCED_112 = (2, 8, 2, 2, 112)
#: the model decode shapes: held by gqa_check_model (see there), with
#: whether gqa_check would also hold them recorded beside
MODEL_SHAPES = (MOE_MAIN, ZAMBA_MAIN, LLAVA_MAIN, MUSICGEN_MAIN,
                STARCODER_MAIN)


def _ragged(S):
    """A ragged cache_len vector of 8 from 1 to S."""
    return [1, S // 256, S // 32, S // 8, S // 4, S // 2, S - 37, S]


def gqa_cases():
    """Phase 6's (shape, dtype, cache lengths, label) cases."""
    import torch
    cases = [(MAIN, torch.bfloat16, [n] * MAIN[0], f"main len {n}")
             for n in (16, 4096, 32768)]
    cases.append((MAIN, torch.bfloat16, list(RAGGED), "main ragged"))
    cases += [(MOE_MAIN, torch.bfloat16, [n] * MOE_MAIN[0], f"moe len {n}")
              for n in (16, 4096, 32768)]
    for label, sh in (("zamba2", ZAMBA_MAIN), ("llava", LLAVA_MAIN),
                      ("musicgen", MUSICGEN_MAIN),
                      ("starcoder2", STARCODER_MAIN)):
        S = sh[1]
        cases += [(sh, torch.bfloat16, [n] * sh[0], f"{label} len {n}")
                  for n in (16, S // 2, S)]
        cases.append((sh, torch.bfloat16, _ragged(S), f"{label} ragged"))
    cases.append((ZAMBA_MAIN, torch.float32, _ragged(ZAMBA_MAIN[1]),
                  "zamba2 f32 ragged"))
    cases += [(sh, dt, None, "sweep") for sh in GQA_SWEEP
              for dt in (torch.float32, torch.bfloat16)]
    cases.append((ZOO_REDUCED, torch.float32, None, "zoo reduced"))
    cases.append((ZOO_REDUCED_112, torch.float32, None, "zoo reduced 112"))
    return cases


def gqa_untimed(seen):
    """B2 launches ``((B, S, Hq, Hkv, Dh), dtype)`` at a shape phase 6 did
    not time."""
    timed = {(sh, str(dt).split(".")[-1]) for sh, dt, _, _ in gqa_cases()}
    return sorted(seen - timed)


def gqa_bound(q, k, cache_len, read_dh=None):
    """(least ms the card could take, "bytes" or "operations") for one
    decode at these inputs: q, K and V up to cache_len, and the output,
    each moved once; 4 * Hq * Dh flops per valid slot (QK^T and PV) at the
    tensor-core bf16 peak for bf16 inputs and the fp32 peak for f32.
    ``read_dh`` counts K and V rows of that width instead (what the bf16
    kernel reads at Dh 112: two 64-column boxes a row)."""
    import torch
    B, Hq, Dh = q.shape
    Hkv = k.shape[2]
    slots = int(cache_len.clamp(0, k.shape[1]).sum())
    nbytes = q.element_size() * (2 * q.numel()
                                 + 2 * slots * Hkv * (read_dh or Dh))
    flops = 4 * Hq * Dh * slots
    peak = PEAK_BF16 if q.dtype == torch.bfloat16 else PEAK_FP32
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gqa_check(got, q, k, v, cache_len, where):
    """Hold a kernel result against the plain version on the same inputs:
    f32 at atol = 2e-5, rtol = 1e-4; bf16 to one bf16 rounding of the plain
    version in bf16, and at atol = rtol = 0.05 of the plain version on the
    f32-widened inputs. Returns max |kernel - plain|."""
    import torch
    check(got.dtype == q.dtype and bool(torch.isfinite(got).all()),
          f"{where}: kernel output of the wrong dtype or not finite")
    ok, plain = _gqa_check_holds(got, q, k, v, cache_len)
    err = (got.float() - plain.float()).abs().max().item()
    check(ok, f"{where}: kernel and plain version disagree (max |err| "
          f"{err:.3g})")
    return err


def gqa_check_model(got, q, k, v, cache_len, where):
    """``gqa_check`` with an atol that scales with the values, for the
    shapes of qwen3-moe's decode (phases 6 and 22). The kernel keeps the
    probabilities as two bf16 parts, |p - hi - lo| <= 2^-16 p
    (csrc/gqa_decode.cu), so its f32 output moves by up to 2^-16 x
    sum_t p_t |v_t| <= 2^-16 x max|v| before the one rounding to bf16;
    where the terms cancel to an output far below max|v|, that is more
    than ``gqa_check``'s bf16 atol of 1e-6 and rtol of one rounding
    (measured: qwen3-moe's own decode, 2.6e-6 at an element of 5.7e-5
    with max|v| 3.8, the kernel's f32 path within 4.5e-7 of a float64
    reference; random inputs at the moe shape, cache_len 16, failed
    ``gqa_check`` at a max |err| of 0.00195). bf16: within rtol 2^-7 and
    atol 2^-16 x max|v| of the plain version, and within atol = rtol =
    0.05 of the plain version on the f32-widened inputs; f32 as
    ``gqa_check``. Returns max |kernel - plain|."""
    import torch
    from repro_torch.kernels import gqa_decode as gqa
    if q.dtype == torch.float32:
        return gqa_check(got, q, k, v, cache_len, where)
    plain = gqa.gqa_decode_plain(q, k, v, cache_len)
    check(got.dtype == q.dtype and bool(torch.isfinite(got).all()),
          f"{where}: kernel output of the wrong dtype or not finite")
    n = int(cache_len.max())
    atol = 2.0 ** -16 * v[:, :n].float().abs().max().item()
    wide = gqa.gqa_decode_plain(q.float(), k.float(), v.float(), cache_len)
    err = (got.float() - plain.float()).abs().max().item()
    check(torch.allclose(got.float(), plain.float(), atol=atol,
                         rtol=2.0 ** -7)
          and torch.allclose(got.float(), wide, atol=0.05, rtol=0.05),
          f"{where}: kernel and plain version disagree (max |err| "
          f"{err:.3g}, atol {atol:.3g})")
    return err


def _gqa_check_holds(got, q, k, v, cache_len):
    """(whether ``gqa_check``'s gates hold, the plain version's output):
    enforced by ``gqa_check``, recorded at the model shapes that
    ``gqa_check_model`` holds."""
    import torch
    from repro_torch.kernels import gqa_decode as gqa
    plain = gqa.gqa_decode_plain(q, k, v, cache_len)
    if q.dtype == torch.float32:
        return torch.allclose(got, plain, atol=2e-5, rtol=1e-4), plain
    wide = gqa.gqa_decode_plain(q.float(), k.float(), v.float(), cache_len)
    return (torch.allclose(got.float(), plain.float(), atol=1e-6,
                           rtol=2.0 ** -7)
            and torch.allclose(got.float(), wide, atol=0.05, rtol=0.05)), \
        plain


def _gqa_inputs(g, shape, dtype, lens=None):
    import torch
    B, S, Hq, Hkv, Dh = shape
    q = torch.randn((B, Hq, Dh), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, S, Hkv, Dh), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, S, Hkv, Dh), generator=g, device="cuda").to(dtype)
    if lens is None:
        cl = torch.randint(1, S + 1, (B,), generator=g, device="cuda",
                           dtype=torch.int32)
    else:
        cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, k, v, cl


def phase_gqa(ptxas: dict):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import gqa_decode as gqa
    for fn, use in ptxas.items():
        if "gqa_split" in fn:
            print(f"[6] {fn}: {use}", flush=True)
    g = torch.Generator(device="cuda")
    g.manual_seed(4321)
    rows = []
    for shape, dtype, lens, label in gqa_cases():
        q, k, v, cl = _gqa_inputs(g, shape, dtype, lens)
        got = gqa.gqa_decode(q, k, v, cl)
        model_shape = shape in MODEL_SHAPES
        hold = gqa_check_model if model_shape else gqa_check
        err = hold(got, q, k, v, cl, f"{label} {shape} {dtype}")
        strict = _gqa_check_holds(got, q, k, v, cl)[0] if model_shape \
            else True
        S, Dh = shape[1], shape[4]
        mask = (torch.arange(S, device="cuda")[None] < cl[:, None]) \
            [:, None, None, :]
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)

        def lib():
            return F.scaled_dot_product_attention(
                q[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True,
                scale=gqa.softmax_scale(Dh))
        lib_err = (lib()[:, :, 0].float() - got.float()).abs().max().item()
        big = shape[0] * shape[1] >= DECODE_B * 2048     # the model shapes
        ms = graph_ms(lambda: gqa.gqa_decode(q, k, v, cl), 20 if big else 100)
        call_ms = eager_ms(lambda: gqa.gqa_decode(q, k, v, cl), 20)
        plain_ms = graph_ms(lambda: gqa.gqa_decode_plain(q, k, v, cl),
                            3 if big else 20)
        lib_ms = graph_ms(lib, 20 if big else 100)
        b_ms, b_by = gqa_bound(q, k, cl)
        # the bf16 kernel reads a Dh-112 row as two 64-column boxes
        read_dh = 128 if Dh == 112 and dtype == torch.bfloat16 else Dh
        read_ms = gqa_bound(q, k, cl, read_dh)[0]
        plan = gqa.plan_for(q, k)
        row = {"label": label, "shape": list(shape),
               "plan": dataclasses.asdict(plan),
               "dtype": str(dtype).split(".")[-1],
               "cache_len": cl.tolist(), "ms": ms, "eager_ms": call_ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "max_abs_err_vs_library": lib_err, "bound_ms": b_ms,
               "bound_by": b_by, "x_bound": ms / b_ms, "max_abs_err": err,
               "bytes_read_bound_ms": read_ms,
               "held_by": hold.__name__, "gqa_check_holds": strict}
        rows.append(row)
        print(f"[6] {label:12s} {str(shape):26s} {row['dtype']:8s} kernel "
              f"{ms:.4f} ms (eager call {call_ms:.4f} ms)  plain "
              f"{plain_ms:.4f} ms  library {lib_ms:.4f} ms (max|err| "
              f"{lib_err:.3g})  bound {b_ms * 1e3:.3f} us ({b_by}, "
              f"x{ms / b_ms:.1f}"
              + (f"; {read_ms * 1e3:.3f} us at the bytes the kernel reads"
                 if read_dh != Dh else "")
              + f")  max|err| {err:.3g} ({hold.__name__}"
              + ("" if not model_shape else
                 f"; gqa_check {'holds' if strict else 'does not hold'}")
              + ")  plan "
              f"{plan.n_chunks} chunks ({plan.chunk} slots at S), "
              f"{plan.blocks} blocks on {plan.slots} slots, {plan.waves} "
              f"wave(s)", flush=True)
        del q, k, v
    # length invariance at the main shape: garbage of 100x the scale past
    # cache_len leaves the output bit-equal
    q, k, v, cl = _gqa_inputs(g, MAIN, torch.bfloat16, list(RAGGED))
    clean = gqa.gqa_decode(q, k, v, cl)
    past = (torch.arange(MAIN[1], device="cuda")[None] >= cl[:, None]) \
        [..., None, None]
    junk = 100.0 * torch.randn(k.shape, generator=g, device="cuda")
    k.copy_(torch.where(past, junk.to(k.dtype), k))
    v.copy_(torch.where(past, junk.to(v.dtype), v))
    dirty = gqa.gqa_decode(q, k, v, cl)
    check(torch.equal(clean, dirty), "main ragged: garbage past cache_len "
          "changed the kernel's output")
    print("[6] length invariance: garbage (100x) past cache_len leaves the "
          "output bit-equal at the main shape, ragged lengths", flush=True)
    return rows


# ------------------------------------------------ the decode slice (B2)

GLM = "glm4-9b"
DECODE_B = 8
DECODE_LEN = 32768
PROMPT = 16
GEN = 48


def held_gqa_against_plain(run, seen=None, hold=None):
    """Call ``run()`` with every B2 launch held against the plain version
    on the same tensors (``gqa_check``). Returns the number of launches
    held and the largest |kernel - plain|; the plain calls launch nothing
    and count nothing. Each launch's ``((B, S, Hq, Hkv, Dh), dtype)`` goes
    into ``seen`` where one is given; ``hold`` (default ``gqa_check``)
    does the holding."""
    from repro_torch.kernels import gqa_decode as gqa
    real = gqa.gqa_decode
    held, worst = 0, 0.0

    def gqa_held(q, k, v, cache_len):
        nonlocal held, worst
        got = real(q, k, v, cache_len)
        if seen is not None:
            seen.add(((q.shape[0], k.shape[1], q.shape[1], k.shape[2],
                       q.shape[2]), str(q.dtype).split(".")[-1]))
        worst = max(worst, (hold or gqa_check)(got, q, k, v, cache_len,
                                               f"main-path launch {held}"))
        held += 1
        return got

    gqa.gqa_decode = gqa_held
    try:
        run()
    finally:
        gqa.gqa_decode = real
    return held, worst


def _step_tokens(cfg, ids):
    """A decode step's tokens from (B, 1) ids: the audio family's are the
    ids on each of its codebooks, (B, 1, n_codebooks), as make_batch tiles
    the chain."""
    if cfg.family == "audio":
        return ids[..., None].repeat(1, 1, cfg.n_codebooks)
    return ids


def _decode_run(model, name, start, g, hold_all=False, seen=None,
                hold=None, length=DECODE_LEN):
    """One decode run of PROMPT + GEN steps from ``start`` with a cache of
    ``length`` slots: a held warm-up step (with ``hold_all``, every step
    of the run, each launch held; undone by resetting pos: the slots it
    wrote are written again, with the same values, by the timed steps),
    then the timed steps, with the B2 counter set to 0 just before them
    and read just after. B2 launches once a step per attention layer (a
    hybrid's shared-attention insertions)."""
    import torch
    from repro_torch.kernels import gqa_decode as gqa
    cfg = model.cfg
    n_attn = model.n_shared if cfg.family == "hybrid" else cfg.n_layers
    cache = model.init_cache(DECODE_B, length)
    if start:
        # stand-in for a prefill: the JAX package's decode path has none
        # (a hybrid's recurrent state stays at zero)
        for key in ("k", "v"):
            cache["attn"][key][:, :, :start].normal_(generator=g)
        cache["pos"] = start
    prompt = torch.randint(0, cfg.vocab, (DECODE_B, PROMPT), generator=g,
                           device="cuda")
    n_held = PROMPT + GEN if hold_all else 1

    def warm():
        tok = prompt[:, :1]
        for t in range(n_held):
            logits, _ = model.decode_step(
                cache, {"tokens": _step_tokens(cfg, tok)})
            tok = prompt[:, t + 1:t + 2] if t + 1 < PROMPT \
                else logits.argmax(-1)
    held, held_err = held_gqa_against_plain(warm, seen, hold)
    check(held == n_held * n_attn, f"{name}: warm-up made {held} B2 "
          f"launches, expected {n_held * n_attn}")
    cache["pos"] = start
    torch.cuda.synchronize()
    gqa.launches = 0
    secs, tok = [], prompt[:, :1]
    for t in range(PROMPT + GEN):
        t0 = time.perf_counter()
        logits, cache = model.decode_step(
            cache, {"tokens": _step_tokens(cfg, tok)})
        tok = prompt[:, t + 1:t + 2] if t + 1 < PROMPT \
            else logits.argmax(-1)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        check(bool(torch.isfinite(logits).all()), f"{name}: step {t} gave "
              f"non-finite logits")
    launches = gqa.launches
    steps = PROMPT + GEN
    check(launches == steps * n_attn, f"{name}: {launches} B2 "
          f"launches in {steps} steps, expected {steps * n_attn}")
    check(tuple(logits.shape) == (DECODE_B, 1, cfg.vocab),
          f"{name}: logits shape {tuple(logits.shape)}")
    check(cache["pos"] == start + steps, f"{name}: pos {cache['pos']}")
    med = statistics.median(secs)
    cache["pos"] = start + steps - 1          # the last step once more
    trace = device_profile(
        lambda: model.decode_step(cache, {"tokens": _step_tokens(cfg, tok)}),
        med, kernels=("gqa_split", "gqa_combine"))
    if trace is not None:
        for kn in ("gqa_split", "gqa_combine"):
            check(trace["kernels_us"][kn] > 0, f"{name}: the trace holds no "
                  f"device kernel named {kn}")
    row = {"run": name, "start": start, "steps": steps, "batch": DECODE_B,
           "cache_slots": length, "end_pos": start + steps, "seconds": secs,
           "median_step_ms": med * 1e3,
           "tokens_per_s": DECODE_B * steps / sum(secs),
           "gqa_launches": launches, "held_launches": held,
           "held_max_abs_err": held_err, "trace": trace}
    del cache
    return row


def phase_decode():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = get_config(GLM)
    g = torch.Generator(device="cuda")
    g.manual_seed(2024)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, generator=g)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    check(cfg.n_layers == 40 and cfg.d_model == 4096
          and round(n_params / 1e9, 2) == 9.40,
          f"glm4-9b at {cfg.n_layers} layers, {n_params} parameters")
    print(f"[7] {GLM}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params} parameters in bf16, drawn on the card in "
          f"{init_s:.3f} s; B = {DECODE_B}, cache {DECODE_LEN} slots",
          flush=True)
    rows = []
    for name, start in (("ctx-short", 0),
                        ("ctx-32k", DECODE_LEN - PROMPT - GEN)):
        row = _decode_run(model, name, start, g)
        rows.append(row)
        tr = row["trace"]
        print(f"[7] {name:9s} steps {row['steps']} from pos {start}: "
              f"{row['tokens_per_s']} tokens/s, median step "
              f"{row['median_step_ms']} ms; B2 launches {row['gqa_launches']}"
              f" ({row['gqa_launches'] // row['steps']} per step); warm-up "
              f"step: {row['held_launches']} launches held against the plain"
              f" version (max|err| {row['held_max_abs_err']:.3g})",
              flush=True)
        if tr is None:
            print("    profiler: no device events in the trace (device idle "
                  "share not measured)", flush=True)
        else:
            b2 = sum(tr["kernels_us"].values())
            print(f"    profiler, one step: device busy "
                  f"{tr['device_busy_us']} us of {tr['wall_us']} us wall "
                  f"(idle share {tr['idle_share']}), {tr['device_events']} "
                  f"device events, B2 {b2} us ({b2 / tr['device_busy_us']} "
                  f"of busy); busiest {tr['top']}", flush=True)
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"[7] peak device memory {peak} bytes, {peak / total} of the "
          f"card's {total}", flush=True)
    # phase 33's decode cell and phase 34's long shapes, on this model
    DRY_CELLS["decode_32k"] = dry_decode_cell(model, g, rows[1])
    LONG["prefill_32k"] = long_prefill(model, g)
    LONG["long_500k"] = long_decode("7", model, g, LONG_STEPS)
    del model
    torch.cuda.empty_cache()
    return {"params": n_params, "init_s": init_s, "runs": rows,
            "max_memory_allocated": peak, "card_memory": total}


def phase_decode_vs_cpu():
    """Full width, depth cut to 2 layers so that the CPU copy fits, f32."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import gqa_decode as gqa
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config(GLM), n_layers=2, dtype="float32")
    g = torch.Generator(device="cuda")
    g.manual_seed(77)
    card = Model(cfg, generator=g)
    cpu = Model(cfg, device="meta")
    cpu.load_state_dict({k: t.cpu() for k, t in card.state_dict().items()},
                        assign=True)
    B, steps = 2, 12
    cc, gc = cpu.init_cache(B, 16), card.init_cache(B, 16)
    tok = torch.randint(0, cfg.vocab, (B, 1), generator=g,
                        device="cuda").cpu()
    gqa.launches = 0
    worst = 0.0
    for t in range(steps):
        lc, cc = cpu.decode_step(cc, {"tokens": tok})
        lg, gc = card.decode_step(gc, {"tokens": tok.cuda()})
        lg = lg.cpu()
        diff = (lg - lc).abs()
        worst = max(worst, diff.max().item())
        check(torch.allclose(lg, lc, atol=1e-3, rtol=1e-3),
              f"step {t}: card and CPU logits disagree (max |diff| "
              f"{diff.max().item():.3g})")
        check(torch.equal(lg.argmax(-1), lc.argmax(-1)),
              f"step {t}: card and CPU pick different greedy tokens")
        tok = lc.argmax(-1)
    check(gqa.launches == steps * cfg.n_layers,
          f"card run made {gqa.launches} B2 launches")
    print(f"[8] card vs CPU, {GLM} at full width cut to 2 layers, f32, "
          f"B = {B}, {steps} steps: max |logit diff| {worst}, greedy tokens "
          f"equal", flush=True)
    del card, cpu
    torch.cuda.empty_cache()
    return {"layers": cfg.n_layers, "batch": B, "steps": steps,
            "max_abs_logit_diff": worst}


# ------------------------------------------- the multi-device layer (A10)

def _steps_argv(argv, steps):
    """A launcher command with its ``--steps`` set to ``steps``."""
    argv = list(argv)
    argv[argv.index("--steps") + 1] = str(steps)
    return argv


def _fig1_inputs():
    """Figure 1's data (logistic, m = 50, n = 1,000, p = 10, 10%
    Byzantine) and REPS replicates of draws for every transmission, made
    on the card from one seed."""
    import torch
    from repro_torch.attacks import byzantine_mask
    from repro_torch.configs.base import ProtocolConfig
    from repro_torch.core.protocol import transmission_names
    from repro_torch.data.synthetic import make_shards
    g = torch.Generator(device="cuda")
    g.manual_seed(2929)
    m, n = 50, 1000
    X, y = make_shards(g, "logistic", m, n, P)
    cfg = ProtocolConfig(eps=30.0, delta=0.05, aggregator="dcq")
    return {"X": X, "y": y, "mask": byzantine_mask(g, m, 0.1), "cfg": cfg,
            "noise": {name: torch.randn((REPS, m + 1, P), generator=g,
                                        device="cuda")
                      for name in transmission_names(cfg)}}


def _median_run_s(fn, runs: int = 3) -> float:
    import torch
    secs = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return statistics.median(secs)


def phase_sharded():
    """Phase 29: the multi-device layer at world 1 on the card (NCCL, a
    process group started in this process): Figure 1's Monte-Carlo run
    (20 replicates, 10% Byzantine, scale -3) through the sharded
    protocol's machine map against ``DPQNProtocol.run_monte_carlo`` on the
    same draws, and one replicate through ``run_sharded`` against
    ``DPQNProtocol.run``, within atol = rtol = 1e-5; ``python -m
    repro_torch.sweep --preset paper --sharded`` against phase 9's
    artifact (every scenario's thetas, relatively as phase 10 compares;
    ``n_devices`` 1); both training launchers' phase 16 and 19 commands
    cut to SHARDED_STEPS steps, with ``--sharded`` and without: the same
    losses. Returns the report and Figure 1's world-1 result (phase 31
    holds its ranks against it)."""
    import contextlib
    import io

    import torch
    import torch.distributed as dist
    from repro_torch.core.losses import get_problem
    from repro_torch.core.protocol import DPQNProtocol
    from repro_torch.dist.sharded_protocol import machine_map, run_sharded
    from repro_torch.core.transport import tree_leaves
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as launcher
    from repro_torch.launch.cli import sharded_run
    from repro_torch.sweep import artifact, cli
    inp = _fig1_inputs()
    cfg, prob = inp["cfg"], get_problem("logistic")
    args = (inp["X"], inp["y"], inp["mask"], "scale", -3.0)
    one = {k: v[0] for k, v in inp["noise"].items()}
    out = {}
    mark = launch_mark()
    plain = DPQNProtocol(prob, cfg).run_monte_carlo(REPS, *args,
                                                    noise=inp["noise"])
    plain_one = DPQNProtocol(prob, cfg).run(*args, noise=one)
    torch.cuda.synchronize()
    launches = check_launches(mark, 2 * expected_launches(cfg),
                              "unsharded Figure 1 runs")
    with sharded_run(None, "cuda", True) as mesh:
        check(dist.get_backend() == "nccl" and mesh.size() == 1,
              f"world-1 mesh: {mesh}, backend {dist.get_backend()}")
        proto = DPQNProtocol(prob, cfg, machine_map=machine_map(mesh))
        mark = launch_mark()
        sharded = proto.run_monte_carlo(REPS, *args, noise=inp["noise"])
        sharded_one = run_sharded(prob, cfg, mesh, *args, noise=one)
        torch.cuda.synchronize()
        launches += check_launches(mark, 2 * expected_launches(cfg),
                                   "sharded Figure 1 runs")
        gaps, equal = {}, []
        for f in ("theta_cq", "theta_os", "theta_qn"):
            for tag, a, b in (("mc", getattr(sharded, f), getattr(plain, f)),
                              ("one", sharded_one[f], getattr(plain_one, f))):
                gaps[f"{tag} {f}"] = (a - b).abs().max().item()
                equal.append(torch.equal(a, b))
                check(torch.allclose(a, b, atol=1e-5, rtol=1e-5),
                      f"world 1: sharded {tag} {f} apart by "
                      f"{gaps[f'{tag} {f}']}")
        mark = launch_mark()
        ms = {"sharded": _median_run_s(lambda: proto.run_monte_carlo(
            REPS, *args, noise=inp["noise"])) * 1e3,
            "unsharded": _median_run_s(lambda: DPQNProtocol(
                prob, cfg).run_monte_carlo(REPS, *args,
                                           noise=inp["noise"])) * 1e3}
        launches += launch_mark()[0] - mark[0]
        out["fig1"] = {"largest_gaps": gaps, "bit_equal": all(equal),
                       "run_ms": ms}
        print(f"[29] world 1 (NCCL, in process), Figure 1 (20 replicates, "
              f"10% Byzantine, scale -3): sharded against unsharded "
              f"largest gaps {gaps}, bit-equal {all(equal)}; a run "
              f"{ms['sharded']} ms sharded, {ms['unsharded']} ms "
              f"unsharded", flush=True)

        # the paper preset with --sharded, against phase 9's artifact
        path = ROOT / "build" / "sweep_paper_sharded.json"
        log = io.StringIO()
        mark = launch_mark()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc = cli.main(["--preset", "paper", "--out", str(path),
                           "--no-resume", "--device", "cuda", "--sharded"])
        wall = time.perf_counter() - t0
        (ROOT / "build" / "sweep_paper_sharded.log").write_text(
            log.getvalue())
        check(rc == 0, f"sweep paper --sharded: the CLI returned {rc}")
        art = artifact.load(str(path))
        ref = artifact.load(str(ROOT / "build" / "sweep_paper.json"))
        expect = sum(expected_launches(s.protocol_config())
                     for s in _preset("paper", ()))
        n = check_launches(mark, expect, "sweep paper --sharded")
        launches += n
        check(art["meta"]["n_devices"] == 1 and set(art["scenarios"])
              == set(ref["scenarios"]), f"sweep paper --sharded: meta "
              f"{art['meta']}, {len(art['scenarios'])} records")
        worst, same = 0.0, 0
        for sid, rec in ref["scenarios"].items():
            a = art["scenarios"][sid]
            worst = max(worst, _rel_err(a["thetas_qn"], rec["thetas_qn"]))
            same += a["thetas_qn"] == rec["thetas_qn"] \
                and a["metrics"] == rec["metrics"]
        check(worst <= 1.0, f"sweep paper --sharded against phase 9: "
              f"largest error {worst} of the 1e-4 bound")
        out["sweep_paper"] = {"scenarios": len(ref["scenarios"]),
                              "wall_s": wall, "launches": n,
                              "worst_of_1e-4_bound": worst,
                              "bit_equal_scenarios": same}
        print(f"[29] sweep --preset paper --sharded: {len(ref['scenarios'])}"
              f" scenarios in {wall} s, {n} B1 launches ({expect} "
              f"decisions), n_devices 1; "
              f"thetas against phase 9's artifact at {worst} of the 1e-4 "
              f"bound, {same} scenarios bit-equal", flush=True)

        # both launchers, with --sharded and without
        out["launchers"] = {}
        for name, argv, per_step in (("adamw", TRAIN_ARGV, WIDE_LEAVES),
                                     ("qn", QN_ARGV, QN_LAUNCHES)):
            argv = _steps_argv(argv, SHARDED_STEPS)
            runs = {}
            for tag, extra in (("unsharded", []), ("sharded",
                                                   ["--sharded"])):
                mark = launch_mark()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    runs[tag] = launcher.main(argv + extra)
                runs[tag + "_s"] = time.perf_counter() - t0
                launches += check_launches(mark, per_step * SHARDED_STEPS,
                                           f"{name} launcher {tag}")
            check(runs["sharded"] == runs["unsharded"]
                  and all(map(math.isfinite, runs["sharded"])),
                  f"{name} launcher: losses {runs['sharded']} with "
                  f"--sharded, {runs['unsharded']} without")
            out["launchers"][name] = {"argv": argv, **runs}
            print(f"[29] train launcher {name}, {SHARDED_STEPS} steps: "
                  f"losses {runs['sharded']} with --sharded, equal to "
                  f"the unsharded run's ({runs['sharded_s']} s and "
                  f"{runs['unsharded_s']} s wall)", flush=True)

        # the serve launcher's phase 12 command, with --sharded and without
        serve = {}
        for tag, extra in (("unsharded", []), ("sharded", ["--sharded"])):
            mark = launch_mark()
            log = io.StringIO()
            with contextlib.redirect_stdout(log), flushes() as rounds:
                svc = serve_launcher.main(list(LAUNCH_ARGV) + extra)
            leaves = tree_leaves(svc.theta)
            launches += check_launches(mark, len(leaves) * LAUNCH_ROUNDS,
                                       f"serve launcher {tag}")
            serve[tag] = {"fills": [h["fill"] for h in svc.history],
                          "rounds": rounds, "theta": [t.clone()
                                                      for t in leaves],
                          "log": log.getvalue()}
        a, b = serve["sharded"], serve["unsharded"]
        same = a["fills"] == b["fills"] == [LAUNCH_FILL] * LAUNCH_ROUNDS \
            and len(a["rounds"]) == len(b["rounds"]) == LAUNCH_ROUNDS \
            and all(torch.equal(x, y) for ra, rb in zip(a["rounds"],
                                                         b["rounds"])
                    for x, y in zip(ra, rb)) \
            and all(torch.equal(x, y) for x, y in zip(a["theta"],
                                                       b["theta"]))
        check("[serve] ring buffer sharded over 1 device(s)" in a["log"],
              "serve launcher --sharded: no sharding line")
        check(same, f"serve launcher: --sharded at world 1 differs from the "
              f"unsharded run (fills {a['fills']} and {b['fills']})")
        out["serve_launcher"] = {"argv": list(LAUNCH_ARGV),
                                 "fills": a["fills"], "bit_equal": same}
        print(f"[29] serve launcher {' '.join(LAUNCH_ARGV)}: with --sharded "
              f"(world 1) every round's aggregate, the fills {a['fills']} "
              f"and the final theta equal the unsharded run's bit for bit",
              flush=True)
    check(not dist.is_initialized(), "phase 29 left its process group")
    out["launches"] = launches
    return out, {"inputs": inp, "world1": sharded}


def phase_train_wide_sharded():
    """Phase 30: phase 15's full-width training at world 1 with
    ``GradAggConfig(strategy="sharded")`` (glm4-9b cut to 2 layers, 4
    machines x 4,096 tokens, dcq_mad, machine 0 signflipped, remat). One
    step's per-machine gradients are aggregated leaf by leaf both ways,
    unsharded (the first B1 launch at each leaf shape held against the
    plain version over column blocks) and through the gather (``sharded_aggregate_leaf``), and the whole wire
    (attack and aggregation) both ways: equal bit for bit. The gather's
    ms per leaf. Then a warm-up step, SHARDED_TIMED timed steps and one
    profiled step of the sharded trainer: step ms, tokens/s, idle share,
    peak memory (fails above 64 GB)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.transport import tree_leaves, tree_leaves_like
    from repro_torch.data.lm import make_batch
    from repro_torch.dist.collectives import (gather_machines,
                                              sharded_aggregate_leaf,
                                              tree_machine_specs)
    from repro_torch.dist.grad_agg import (GradAggConfig,
                                           aggregate_machine_axis,
                                           robust_aggregate)
    from repro_torch.dist.sharded_protocol import machine_map
    from repro_torch.launch.cli import sharded_run
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainer import (TrainConfig, machine_grads,
                                           make_train_step)
    cfg = wide_config()
    g = torch.Generator(device="cuda")
    g.manual_seed(1515)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, generator=g, remat=True)
    params = model.params()
    batches = [make_batch(g, cfg, TRAIN_M, TRAIN_SEQ)
               for _ in range(3 + SHARDED_TIMED)]
    tokens = TRAIN_M * TRAIN_SEQ
    mask = torch.arange(TRAIN_M, device="cuda") < 1
    agg = GradAggConfig(method="dcq_mad", attack="signflip",
                        strategy="sharded")
    plain_agg = dataclasses.replace(agg, strategy="replicated")
    tcfg = TrainConfig(n_machines=TRAIN_M, agg=agg)
    launches = 0
    with sharded_run(TRAIN_M, "cuda", True) as mesh:
        losses, grads = machine_grads(model, params, batches[0], tcfg,
                                      machine_map(mesh))
        specs = tree_machine_specs(grads, mesh)
        leaves = tree_leaves(grads)
        spec_list = tree_leaves_like(specs, grads)
        check(all(s == ("machines",) + (None,) * (len(s) - 1)
                  for s in spec_list), f"machine specs {spec_list}")
        unsharded = []
        mark = launch_mark()
        seen, held_err, held = held_against_plain(lambda: unsharded.extend(
            aggregate_machine_axis(v, plain_agg) for v in leaves),
            distinct=True)
        check(held == len(seen) == len({v.numel() for v in leaves}),
              f"held {held} of the unsharded aggregation's launches at "
              f"{sorted(seen)}")
        gather_ms, equal = [], []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for v, spec, want in zip(leaves, spec_list, unsharded):
            got = sharded_aggregate_leaf(v, agg, mesh, spec)
            equal.append(torch.equal(got, want))
            del got
            start.record()
            full = gather_machines(v, mesh)
            end.record()
            end.synchronize()
            gather_ms.append(start.elapsed_time(end))
            del full
        del unsharded
        wire = [robust_aggregate(grads, a, None, mask, mesh=m_,
                                 machine_specs=s_)
                for a, m_, s_ in ((plain_agg, None, None),
                                  (agg, mesh, specs))]
        wire_equal = all(torch.equal(a, b) for a, b in
                         zip(tree_leaves(wire[0]), tree_leaves(wire[1])))
        torch.cuda.synchronize()
        launches += check_launches(mark, 4 * WIDE_LEAVES,
                                   "both-ways aggregation")
        check(all(equal) and wire_equal, f"the gathered aggregate differs "
              f"from the unsharded one: leaves {equal}, wire {wire_equal}")
        del wire, grads, leaves, losses
        mem = {"after_both_ways": torch.cuda.max_memory_allocated()}
        print(f"[30] {GLM} at full width, {WIDE_LAYERS} layers, world 1: "
              f"one step's per-machine gradients aggregated leaf by leaf "
              f"unsharded ({held} leaf shapes' launches held against the "
              f"plain version, p99.9 err <= {held_err:.3g}) and through "
              f"the gather, and "
              f"the whole wire both ways: equal bit for bit; gather ms per "
              f"leaf {gather_ms} (sum {sum(gather_ms)})", flush=True)

        opt = AdamW(lr=TRAIN_LR)
        step = make_train_step(model, opt, tcfg, mesh)
        state = opt.init(params)
        mark = launch_mark()
        params, state, metrics = step(params, state, batches[1], None, mask)
        warm_loss = float(metrics["loss"])
        check_launches(mark, WIDE_LEAVES, "sharded warm-up step")
        check(math.isfinite(warm_loss), f"sharded warm-up step: loss "
              f"{warm_loss}")
        del metrics
        params, state, secs, step_losses, norms = _step_loop(
            step, params, state, batches[2:2 + SHARDED_TIMED], None, mask,
            WIDE_LEAVES)
        med = statistics.median(secs)
        box = []
        trace = device_profile(lambda: box.append(step(
            params, state, batches[-1], None, mask)), med)
        params, state, metrics = box.pop()
        del metrics, box
        launches += check_launches(mark, WIDE_LEAVES * (2 + SHARDED_TIMED),
                                   "sharded steps")
    check(not dist.is_initialized(), "phase 30 left its process group")
    peak = torch.cuda.max_memory_allocated()
    mem["peak"] = peak
    b1 = None
    if trace is not None:
        b1 = trace["kernels_us"]["ostat_kernel"] / trace["device_busy_us"]
        trace["b1_share_of_busy"] = b1
    print(f"[30] sharded trainer: warm-up loss {warm_loss}; "
          f"{SHARDED_TIMED} timed steps ms {[x * 1e3 for x in secs]}, "
          f"median {med * 1e3} ms, {tokens / med} tokens/s, losses "
          f"{step_losses}; profiled step: idle share "
          f"{None if trace is None else trace['idle_share']}, B1 {b1} of "
          f"busy; peak {peak} bytes (limit 64e9)", flush=True)
    check(peak <= 64e9, f"sharded full-width training: peak {peak}")
    del model, params, state, step, batches
    torch.cuda.empty_cache()
    return {"held": held, "held_p999_err": held_err,
            "leaves_equal": equal, "wire_equal": wire_equal,
            "gather_ms": gather_ms, "gather_ms_sum": sum(gather_ms),
            "warmup_loss": warm_loss, "step_ms": [x * 1e3 for x in secs],
            "median_step_ms": med * 1e3, "tokens_per_s": tokens / med,
            "losses": step_losses, "grad_norms": norms, "trace": trace,
            "memory": mem, "max_memory_allocated": peak,
            "launches": launches}


def _ranks_work(mesh, inp):
    """What phase 31 runs on every rank of ``mesh``, and at world 1 as
    the reference: Figure 1's Monte-Carlo run on ``inp``'s data and draws,
    RANKS_QN_STEPS QN steps of the reduced glm4-9b, its weights, its
    batches and its draws from seeded generators, the same in every
    process, and the service of the reduced glm4-9b's parameters with its
    ring buffer over the mesh (RANKS_SERVE). Returns this rank's thetas,
    the parameters after each QN step, this rank's machines' L-BFGS
    memory, every served round's aggregate, the served theta and fills,
    and its B1 launches and dispatch decisions."""
    import torch
    from repro_torch.agg import dispatch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TreeProtocolConfig
    from repro_torch.core import dp
    from repro_torch.core.losses import get_problem
    from repro_torch.core.protocol import DPQNProtocol
    from repro_torch.core.transport import tree_leaves
    from repro_torch.data.lm import make_batch
    from repro_torch.dist.sharded_protocol import machine_map
    from repro_torch.models.model import Model
    from repro_torch.train.trainer import QNTrainConfig, QNTrainer
    mark = launch_mark()
    log0 = dispatch.decisions()
    mm = machine_map(mesh)
    res = DPQNProtocol(get_problem("logistic"), inp["cfg"],
                       machine_map=mm).run_monte_carlo(
        REPS, inp["X"], inp["y"], inp["mask"], "scale", -3.0,
        noise=inp["noise"])
    out = {"fig1": {f: getattr(res, f).cpu() for f in
                    ("theta_cq", "theta_os", "theta_qn")}}
    cfg = get_config(GLM, reduced=True)
    g = torch.Generator(device="cuda")
    g.manual_seed(3131)
    model = Model(cfg, generator=g, remat=True)
    batches = [make_batch(g, cfg, RANKS_QN_BATCH, RANKS_QN_SEQ)
               for _ in range(RANKS_QN_STEPS)]
    trainer = QNTrainer(model, QNTrainConfig(
        n_machines=RANKS_QN_M, attack="signflip",
        protocol=TreeProtocolConfig(hist=RANKS_QN_HIST, eps=1.0,
                                    aggregator="median")), mesh)
    sigmas = {name: RANKS_QN_SIGMA for name in dp.TREE_TRANSMISSIONS}
    params = model.params()
    mem = trainer.init_memory(params)
    key = torch.Generator(device="cuda")
    key.manual_seed(2020)
    mask = torch.arange(RANKS_QN_M, device="cuda") < 1
    out["params"], out["losses"] = [], []
    for batch in batches:
        params, mem, metrics = trainer.step_fn(params, mem, batch, key, mask,
                                               sigmas=sigmas)
        out["params"].append([t.detach().cpu().clone()
                              for t in tree_leaves(params)])
        out["losses"].append(metrics["loss_per_machine"].cpu())
    torch.cuda.synchronize()
    out["mem"] = {"s": [t.cpu() for t in tree_leaves(mem.s_hist)],
                  "y": [t.cpu() for t in tree_leaves(mem.y_hist)],
                  "count": mem.count.cpu()}
    out["serve"] = _ranks_serve(mesh)
    out["rank"], out["world"] = mm.rank, mm.world
    out["launches"], out["kernel_decisions"], out["decisions"] = (
        a - b for a, b in zip(launch_mark(), mark))
    out["decision_log"] = {k: n - log0.get(k, 0)
                           for k, n in dispatch.decisions().items()
                           if n > log0.get(k, 0)}
    return out


def _ranks_serve(mesh):
    """The service of phase 31 on ``mesh``: the reduced glm4-9b's
    parameters (seeded) as theta, a ring of RANKS_SERVE_C slots split over
    the ranks, dcq_mad at eps 1, each round's arrivals (RANKS_SERVE_FILLS,
    the last partial) drawn from a seeded generator, the same on every
    rank; every round's aggregate, the fills and the final theta."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.keys import stream_generator
    from repro_torch.core.transport import tree_leaves, tree_map
    from repro_torch.launch.serve import fleet_round
    from repro_torch.models.model import Model
    from repro_torch.serve import AggregationService, FlushPolicy, ServeConfig
    cfg = get_config(GLM, reduced=True)
    model = Model(cfg, generator=stream_generator(31, "params",
                                                  device="cuda"))
    theta = tree_map(lambda t: t.detach().clone(), model.params())
    svc = AggregationService(theta, ServeConfig(
        method="dcq_mad", capacity=RANKS_SERVE_C, eps=1.0, lr=0.1,
        ingest_block=RANKS_SERVE_C // 2, seed=31),
        policy=FlushPolicy(capacity_frac=None), sharding=mesh)
    with flushes() as rounds:
        for r, n in enumerate(RANKS_SERVE_FILLS):
            g = stream_generator(31, "data", r, "cuda")
            svc.submit_many(fleet_round(g, theta, n, None, "none", -3.0))
            svc.flush()
    torch.cuda.synchronize()
    return {"rounds": [[t.cpu() for t in r] for r in rounds],
            "fills": [h["fill"] for h in svc.history],
            "theta": [t.cpu() for t in tree_leaves(svc.theta)],
            "rows": tree_leaves(svc.buffer.arrays)[0].shape[0]}


def _rank_main(rank, world, store, inputs, out_dir):
    """One rank of phase 31 (a spawned process): a gloo group through a
    FileStore, every tensor on cuda:0; writes ``out_dir/rank<r>.pt``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cuda", (world,),
                                mesh_dim_names=("machines",))
        inp = torch.load(inputs, weights_only=False)
        inp = {k: ({n: t.cuda() for n, t in v.items()}
                   if isinstance(v, dict) else
                   v.cuda() if isinstance(v, torch.Tensor) else v)
               for k, v in inp.items()}
        torch.save(_ranks_work(mesh, inp), f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def phase_ranks_on_one_card(fig1):
    """Phase 31: RANKS spawned processes on the one card, a gloo group
    (NCCL will not put two ranks on one device) whose tensors all live on
    cuda:0, gloo gathering them through host buffers. Figure 1's run (51
    shards, 17 a rank) on phase 29's data and draws, against phase 29's
    world-1 result within atol = rtol = 1e-5; the QN step on the reduced
    glm4-9b at RANKS_QN_M machines (2 a rank) for RANKS_QN_STEPS steps
    against the same steps at world 1 (NCCL, in this process): the
    parameters after every step and each rank's machines' memory within
    atol = rtol = 1e-4 on every coordinate. The B1 launches of every rank
    are counted."""
    import multiprocessing

    import torch
    from repro_torch.launch.cli import sharded_run
    base = ROOT / "build" / "ranks"
    base.mkdir(parents=True, exist_ok=True)
    for old in base.iterdir():
        old.unlink()
    inp = {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict)
               else v.cpu() if isinstance(v, torch.Tensor) else v)
           for k, v in fig1["inputs"].items()}
    inputs = str(base / "inputs.pt")
    torch.save(inp, inputs)
    with sharded_run(None, "cuda", True) as mesh:
        one = _ranks_work(mesh, {k: ({n: t.cuda() for n, t in v.items()}
                                     if isinstance(v, dict) else
                                     v.cuda() if isinstance(v, torch.Tensor)
                                     else v) for k, v in inp.items()})
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, RANKS, str(
        base / "store"), inputs, str(base))) for r in range(RANKS)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    wall = time.perf_counter() - t0
    for p in procs:
        if p.is_alive():
            p.kill()
    check(all(p.exitcode == 0 for p in procs), f"ranks on one card: exit "
          f"codes {[p.exitcode for p in procs]}")
    ranks = [torch.load(base / f"rank{r}.pt", weights_only=False)
             for r in range(RANKS)]
    world1 = {f: getattr(fig1["world1"], f).cpu()
              for f in ("theta_cq", "theta_os", "theta_qn")}
    gaps = {"fig1": 0.0, "params": 0.0, "mem": 0.0, "losses": 0.0}
    k = RANKS_QN_M // RANKS
    for r, got in enumerate(ranks):
        check(got["world"] == RANKS and got["rank"] == r,
              f"rank {r}: world {got['world']}, rank {got['rank']}")
        for f, want in world1.items():
            a = got["fig1"][f]
            gaps["fig1"] = max(gaps["fig1"], (a - want).abs().max().item())
            check(torch.allclose(a, want, atol=1e-5, rtol=1e-5),
                  f"rank {r}: Figure 1 {f} apart from world 1 by "
                  f"{(a - want).abs().max().item()}")
        for step, (pa, pb) in enumerate(zip(got["params"], one["params"])):
            for a, b in zip(pa, pb):
                gaps["params"] = max(gaps["params"],
                                     (a - b).abs().max().item())
                check(torch.allclose(a, b, atol=1e-4, rtol=1e-4),
                      f"rank {r}: QN step {step} parameters apart from "
                      f"world 1 by {(a - b).abs().max().item()}")
        for a, b in zip(got["losses"], one["losses"]):
            gaps["losses"] = max(gaps["losses"], (a - b).abs().max().item())
        mine = slice(r * k, (r + 1) * k)
        check(torch.equal(got["mem"]["count"], one["mem"]["count"][mine]),
              f"rank {r}: memory counts {got['mem']['count'].tolist()}")
        for h in ("s", "y"):
            for a, b in zip(got["mem"][h], one["mem"][h]):
                b = b[mine]
                check(a.shape == b.shape, f"rank {r}: memory {h} shape "
                      f"{tuple(a.shape)}, world 1's rows {tuple(b.shape)}")
                gaps["mem"] = max(gaps["mem"], (a - b).abs().max().item())
                check(torch.allclose(a, b, atol=1e-4, rtol=1e-4),
                      f"rank {r}: memory {h} apart from world 1 by "
                      f"{(a - b).abs().max().item()}")
    n_leaves = len(one["serve"]["theta"])
    for r, got in enumerate(ranks):
        a, b = got["serve"], one["serve"]
        check(a["rows"] == RANKS_SERVE_C // RANKS and b["rows"]
              == RANKS_SERVE_C, f"rank {r}: serve rows {a['rows']}, world "
              f"1's {b['rows']}")
        check(a["fills"] == b["fills"] == list(RANKS_SERVE_FILLS),
              f"rank {r}: serve fills {a['fills']}, world 1's {b['fills']}")
        same = len(a["rounds"]) == len(b["rounds"]) == len(
            RANKS_SERVE_FILLS) and all(
            torch.equal(x, y) for ra, rb in zip(a["rounds"], b["rounds"])
            for x, y in zip(ra, rb)) and all(
            torch.equal(x, y) for x, y in zip(a["theta"], b["theta"]))
        check(same, f"rank {r}: the served rounds or theta differ from "
              f"world 1's")
    launches = [got["launches"] for got in ranks]
    want = expected_launches(fig1["inputs"]["cfg"]) \
        + QN_LAUNCHES * RANKS_QN_STEPS + n_leaves * len(RANKS_SERVE_FILLS)
    for got in ranks + [one]:
        check(got["decisions"] == want
              and got["launches"] == got["kernel_decisions"] == want,
              f"rank {got['rank']}: {got['decisions']} decisions (expected "
              f"{want}), {got['launches']} B1 launches for "
              f"{got['kernel_decisions']} decisions for the kernel")
    print(f"[31] {RANKS} ranks on one card (gloo, CUDA tensors): Figure 1 "
          f"(51 shards, 17 a rank) and {RANKS_QN_STEPS} QN steps of the "
          f"reduced {GLM} at {RANKS_QN_M} machines ({k} a rank, hist "
          f"{RANKS_QN_HIST}, median, signflip) against world 1: largest "
          f"gaps {gaps}; the reduced {GLM} served on a ring of "
          f"{RANKS_SERVE_C} ({RANKS_SERVE_C // RANKS} a rank), fills "
          f"{list(RANKS_SERVE_FILLS)}: every round's aggregate and the "
          f"theta equal world 1's bit for bit; B1 launches per rank "
          f"{launches} ({want} decisions each); {wall} s wall for the "
          f"ranks", flush=True)
    return {"ranks": RANKS, "largest_gaps": gaps, "wall_s": wall,
            "launches_per_rank": launches, "decisions_per_rank": want,
            "launches": sum(launches) + one["launches"],
            "counts": one["mem"]["count"].tolist(),
            "serve": {"capacity": RANKS_SERVE_C,
                      "fills": list(RANKS_SERVE_FILLS), "bit_equal": True},
            "decision_logs": [got["decision_log"] for got in ranks]}


# ----------------------------------------------- measured dispatch (A13)

def _fleet_flush_ms(m: int, backend) -> list:
    """Phase 11's fleet of ``m`` (dcq_mad, eps 1, p = SERVE_P) served for
    SERVE_ROUNDS full rounds and one at PARTIAL fill with the masked
    backend ``backend`` (None: the table's decision); each flush's ms."""
    import torch
    from repro_torch.serve import AggregationService, ServeConfig
    g = torch.Generator(device="cuda")
    g.manual_seed(500 + m)
    batches = [torch.randn((m, SERVE_P), generator=g, device="cuda")
               for _ in range(SERVE_ROUNDS + 1)]
    svc = AggregationService(torch.zeros(SERVE_P, device="cuda"), ServeConfig(
        method="dcq_mad", capacity=m, eps=1.0, dp_n=100, lr=0.1,
        ingest_block=min(1024, m), seed=0, masked_backend=backend))
    for b in batches[:SERVE_ROUNDS]:
        svc.submit_many(b)
    svc.submit_many(batches[-1][:int(PARTIAL * m)])
    svc.flush()
    return [h["flush_s"] * 1e3 for h in svc.history]


def phase_dispatch(phase_logs: dict, rank_logs: list):
    """Phase 32: the measured dispatch table. The committed
    ``tables/cuda.json`` loaded, its meta printed beside this card's;
    ``autotune`` at FAST_SHAPES into ``build/`` with every recorded kernel
    candidate within its gate; phase 11's three fleets' flushes under the
    table's decision, under a forced ``bisect`` and a forced ``sort``; and
    the decision log of the whole run, phase by phase (the ranks of phase
    31 from their own processes), failing on any ``fallback-unmeasured``
    decision (no CPU table exists, so every such decision is the card's)."""
    from repro_torch.agg import autotune, dispatch
    table = dispatch.DispatchTable.load(dispatch.TABLE_DIR / "cuda.json")
    card = phase_device_line()
    match = table.meta.get("nvidia_smi") == card
    print(f"[32] committed table {dispatch.TABLE_DIR / 'cuda.json'}: "
          f"{len(table.entries)} entries, meta {table.meta}; measured on "
          f"this card and limit: {match} (this card: {card})", flush=True)
    t0 = time.perf_counter()
    fast = autotune.autotune(shapes=autotune.FAST_SHAPES, reps=10,
                             verbose=False)
    fast_s = time.perf_counter() - t0
    fast.save(ROOT / "build" / "dispatch_fast.json")
    gates = [(k, b, r["gate_err"]) for k, e in fast.entries.items()
             for b, r in e["backends"].items()
             if b in dispatch.KERNEL_BACKENDS]
    worst = max(err for *_, err in gates)
    check(gates and worst <= 5e-4, f"autotune --fast: a kernel candidate "
          f"past its gate ({worst})")
    print(f"[32] autotune at FAST_SHAPES in {fast_s} s: "
          f"{len(fast.entries)} entries, best "
          f"{ {k: e['best'] for k, e in sorted(fast.entries.items())} }; "
          f"{len(gates)} kernel records, largest gate error {worst}",
          flush=True)
    fleets = {}
    for m in SERVE_FLEETS:
        dec = dispatch.decide("masked:dcq_mad", 1, m, SERVE_P, "cuda")
        ms = {name: _fleet_flush_ms(m, backend) for name, backend in
              (("table", None), ("bisect", "bisect"), ("sort", "sort"))}
        fleets[m] = {"decision": dataclasses.asdict(dec), "flush_ms": ms,
                     "steady_ms": {k: statistics.median(v[1:SERVE_ROUNDS])
                                   for k, v in ms.items()},
                     "partial_ms": {k: v[-1] for k, v in ms.items()}}
        print(f"[32] fleet m={m} dcq_mad: the table decides "
              f"{dec.backend} {dec.params} ({dec.source}); steady flush ms "
              f"{fleets[m]['steady_ms']}, the {int(PARTIAL * m)}-fill flush "
              f"ms {fleets[m]['partial_ms']}", flush=True)
    unmeasured = []
    for label, log in list(phase_logs.items()) + [
            (f"31 rank {r}", log) for r, log in enumerate(rank_logs)]:
        rows = sorted(log.items())
        print(f"[32] decisions of phase {label}: "
              f"{sum(log.values())} ({'; '.join(f'{k} x{n}' for k, n in rows)})",
              flush=True)
        unmeasured += [(label, k) for k, n in rows
                       if k[2] == "fallback-unmeasured"]
    check(not unmeasured, f"fallback-unmeasured decisions on the card: "
          f"{unmeasured}")
    return {"table_meta": table.meta, "table_entries": len(table.entries),
            "measured_on_this_card": match, "autotune_fast_s": fast_s,
            "autotune_fast_worst_gate_err": worst, "fleets": fleets,
            "decisions": {label: [[*k, n] for k, n in sorted(log.items())]
                          for label, log in phase_logs.items()},
            "rank_decisions": [[[*k, n] for k, n in sorted(log.items())]
                               for log in rank_logs]}



# ------------------------------------------- the machine model (phases 33-35)

#: phase 33's cells (filled by phases 15, 18 and 7) and phase 34's long
#: shapes (phases 7 and 23)
DRY_CELLS: dict = {}
LONG: dict = {}


def _meta_like(tree):
    """``tree``'s tensors as meta tensors of their shapes and dtypes."""
    import torch
    from repro_torch.core.transport import tree_map
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def _flop_counter():
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import roofline
    return FlopCounterMode(display=False,
                           custom_mapping=roofline.SDPA_FORMULAS)


def _storage_bytes(*trees):
    """The bytes of the distinct storages under ``trees`` (an L-BFGS
    memory's among them)."""
    from repro_torch.launch.roofline import tensors_of
    seen = {}
    for t in tensors_of(trees):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def _dry_report(tag, name, counts, flops, peak, raw_peak, step_s,
                model_flops, trace_s, card_s):
    """Phase 33's holds and line for one cell: the traced FLOPs within
    DRY_FLOPS_TOL of the card's count, the traced peak within
    DRY_PEAK_TOL of the card's (``peak``: ``max_memory_allocated`` over
    the step less what was allocated before it besides the step's own
    inputs, which the trace counts; ``raw_peak`` the reading itself);
    MFU = model_flops / (step s x 989e12), and the memory term's share of
    the measured step."""
    from repro_torch.launch import mesh as meshmod
    row = {"predicted_flops": counts.flops, "counted_flops": flops,
           "flops_rel_gap": abs(counts.flops - flops) / max(flops, 1),
           "predicted_peak": counts.peak, "measured_peak": peak,
           "max_memory_allocated": raw_peak,
           "peak_rel_gap": abs(counts.peak - peak) / max(peak, 1),
           "predicted_bytes": counts.bytes,
           "launches_traced": dict(counts.launches),
           "step_ms": step_s * 1e3, "model_flops": model_flops,
           "mfu": model_flops / (step_s * meshmod.PEAK_FLOPS_BF16),
           "memory_term_s": counts.bytes / meshmod.HBM_BW,
           "memory_share": counts.bytes / meshmod.HBM_BW / step_s,
           "compute_term_s": counts.flops / meshmod.PEAK_FLOPS_BF16,
           "trace_s": trace_s, "card_step_s": card_s}
    print(f"[33] {name} (in phase {tag}): FLOPs predicted {counts.flops} "
          f"counted {flops} (gap {row['flops_rel_gap']}); peak predicted "
          f"{counts.peak} measured {peak} bytes (gap {row['peak_rel_gap']}; "
          f"max_memory_allocated {raw_peak}, the rest of the process's "
          f"{raw_peak - peak} left out);"
          f" step {row['step_ms']} ms, MFU {row['mfu']}, memory term "
          f"{row['memory_term_s']} s = {row['memory_share']} of the step; "
          f"trace {trace_s} s, counted step {card_s} s", flush=True)
    check(row["flops_rel_gap"] <= DRY_FLOPS_TOL, f"phase 33 {name}: traced "
          f"FLOPs {counts.flops} against {flops} counted on the card")
    check(row["peak_rel_gap"] <= DRY_PEAK_TOL, f"phase 33 {name}: traced "
          f"peak {counts.peak} against {peak} measured on the card")
    return row


def dry_cell(tag, make_step, model, params, state, make_state, batch,
             mask, rows_seq, step_s):
    """A training cell of phase 33: ``make_step(model, mesh)``'s step
    traced on the meta device at the mesh {data 1, model 1} under the
    counting mode, then one real step of the phase's own model on its
    current ``params`` and ``state`` under ``FlopCounterMode`` with the
    device's peak reset just before it. Returns the row, with the real
    step's ``(params, state)`` under "result"."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import roofline
    from repro_torch.models.model import Model
    t0 = t_cell = time.perf_counter()
    meta = Model(model.cfg, device="meta", remat=True)
    mp = meta.params()
    ms, mb, mm = make_state(mp), _meta_like(batch), _meta_like(mask)
    counts = roofline.CountingMode().track(mp, ms, mb, mm)
    with counts:
        make_step(meta, {"data": 1, "model": 1})(mp, ms, mb, None, mm)
    trace_s = time.perf_counter() - t0
    step = make_step(model, None)
    torch.cuda.synchronize()
    other = torch.cuda.memory_allocated() - _storage_bytes(params, state,
                                                           batch, mask)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _flop_counter() as fc:
        params, state, metrics = step(params, state, batch, None, mask)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    raw = torch.cuda.max_memory_allocated()
    check(math.isfinite(float(metrics["loss"])), f"phase 33 cell {tag}: "
          f"loss")
    rows, seq = rows_seq
    mf = roofline.model_flops(model.cfg, ShapeConfig("cell", seq, rows,
                                                     "train"))
    row = _dry_report(tag, f"phase {tag}'s step", counts,
                      fc.get_total_flops(), raw - other, raw, step_s, mf,
                      trace_s, card_s)
    row["result"] = (params, state)
    row["cell_s"] = time.perf_counter() - t_cell
    return row


def dry_decode_cell(model, g, run_row):
    """Phase 33's decode cell: one ``decode_step`` of phase 7's model
    (B = DECODE_B) against a DECODE_LEN-slot cache at position S - 1,
    traced on meta and run on the card under ``FlopCounterMode``; the
    step time is the ctx-32k run's median."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import gqa_decode as gqa
    from repro_torch.launch import roofline
    from repro_torch.models.model import Model
    cfg = model.cfg
    t0 = t_cell = time.perf_counter()
    meta = Model(cfg, device="meta")
    mp = meta.params()
    mcache = meta.init_cache(DECODE_B, DECODE_LEN)
    mcache["pos"] = DECODE_LEN - 1
    mtok = {"tokens": torch.empty((DECODE_B, 1), dtype=torch.int64,
                                  device="meta")}
    counts = roofline.CountingMode().track(mp, mcache, mtok)
    with counts:
        meta.decode_step(mcache, mtok, params=mp)
    trace_s = time.perf_counter() - t0
    cache = model.init_cache(DECODE_B, DECODE_LEN)
    cache["pos"] = DECODE_LEN - 1
    tok = {"tokens": torch.randint(0, cfg.vocab, (DECODE_B, 1), generator=g,
                                   device="cuda")}
    before = gqa.launches
    torch.cuda.synchronize()
    other = torch.cuda.memory_allocated() - _storage_bytes(
        model.params(), cache, tok)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _flop_counter() as fc:
        logits, _ = model.decode_step(cache, tok)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    raw = torch.cuda.max_memory_allocated()
    launches = gqa.launches - before
    check(launches == cfg.n_layers and bool(torch.isfinite(logits).all()),
          f"phase 33 decode cell: {launches} B2 launches")
    mf = roofline.model_flops(cfg, ShapeConfig("cell", DECODE_LEN, DECODE_B,
                                               "decode"))
    row = _dry_report("7", "phase 7's ctx-32k decode step", counts,
                      fc.get_total_flops(), raw - other, raw,
                      run_row["median_step_ms"] / 1e3, mf, trace_s, card_s)
    row["gqa_launches"] = launches
    del cache
    row["cell_s"] = time.perf_counter() - t_cell
    return row


def long_prefill(model, g):
    """Phase 34's prefill_32k on phase 7's model: PREFILL_B rows of 32,768
    tokens through ``Model.forward`` (a warm-up pass, then the timed one).
    The last position's logits are held against another path to them: a
    forward over the first 32,767 tokens gives each layer's K and V
    (taken where ``flash.flash_attention`` receives them), they fill a
    decode cache, and one ``decode_step`` at position 32,767 attends
    through B2 (each launch held against the plain version) where the
    prefill ran cuDNN's fused attention. Held: the relative L2 error of
    every row's logits within PREFILL_REL_TOL and the same greedy token.
    Returns the row, with the cell's own seconds."""
    import torch
    from repro_torch.configs import SHAPES
    from repro_torch.launch import roofline
    from repro_torch.models import flash
    t_cell = time.perf_counter()
    cfg, S = model.cfg, SHAPES["prefill_32k"].seq_len
    tokens = torch.randint(0, cfg.vocab, (PREFILL_B, S), generator=g,
                           device="cuda")
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        last = model.forward({"tokens": tokens})[0][:, -1].clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = model.forward({"tokens": tokens})[0][:, -1].clone()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    kv, attend = [], flash.flash_attention

    def keep(q, k, v, **kw):
        kv.append((k, v))
        return attend(q, k, v, **kw)
    flash.flash_attention = keep
    try:
        with torch.no_grad():
            model.forward({"tokens": tokens[:, :-1]})
    finally:
        flash.flash_attention = attend
    check(len(kv) == cfg.n_layers, f"prefill_32k: {len(kv)} attentions")
    cache = model.init_cache(PREFILL_B, S)
    for i, (k, v) in enumerate(kv):
        cache["attn"]["k"][i, :, :S - 1] = k
        cache["attn"]["v"][i, :, :S - 1] = v
    del kv
    cache["pos"] = S - 1
    out = {}

    def step():
        out["logits"] = model.decode_step(cache, {"tokens": tokens[:, -1:]})[0]
    held, gqa_err = held_gqa_against_plain(step, None, gqa_check_model)
    del cache
    a, b = out["logits"][:, 0].float(), last.float()
    rel = ((a - b).norm(dim=-1) / b.norm(dim=-1)).max().item()
    err, scale = (a - b).abs().max().item(), b.abs().max().item()
    same = bool((a.argmax(-1) == b.argmax(-1)).all())
    check(bool(torch.isfinite(last).all()) and held == cfg.n_layers
          and rel <= PREFILL_REL_TOL and same,
          f"prefill_32k: the last logits apart from the decode path by a "
          f"relative L2 error of {rel} (max|err| {err}, largest |logit| "
          f"{scale}, the same greedy token: {same}; {held} B2 launches)")
    mf = roofline.model_flops(cfg, dataclasses.replace(
        SHAPES["prefill_32k"], global_batch=PREFILL_B))
    from repro_torch.launch import mesh as meshmod
    row = {"batch": PREFILL_B, "seq": S, "seconds": secs,
           "tokens_per_s": PREFILL_B * S / secs, "model_flops": mf,
           "mfu": mf / (secs * meshmod.PEAK_FLOPS_BF16),
           "held_rel_l2": rel, "held_max_abs_err": err,
           "largest_logit": scale, "gqa_held": held,
           "gqa_max_abs_err": gqa_err, "max_memory_allocated": peak}
    row["cell_s"] = time.perf_counter() - t_cell
    print(f"[34] prefill_32k on {GLM} at full width and depth: B = "
          f"{PREFILL_B} (of 32) x {S} tokens in {secs} s, "
          f"{row['tokens_per_s']} tokens/s, MFU {row['mfu']}; last logits "
          f"held against a decode step on the first {S - 1} tokens' K/V "
          f"(relative L2 {rel}, max|err| {err}, largest {scale}; {held} B2 "
          f"launches held, max|err| {gqa_err}); peak {peak} bytes; the "
          f"cell took {row['cell_s']} s", flush=True)
    return row


def long_decode(tag, model, g, steps):
    """Phase 34's long_500k on a model of phase 7 or 23: ``adapt_config``'s
    4,096-slot ring (B = 1), every slot filled from the generator and
    ``pos`` set to 524,287; ``steps`` steps past the wrap with every B2
    launch held against the plain version at cache_len 4,096
    (``gqa_check_model``), then the same steps timed with the B2 counter
    set to 0 just before them."""
    import torch
    from repro_torch.configs import SHAPES
    from repro_torch.configs.shapes import LONG_WINDOW, adapt_config
    from repro_torch.kernels import gqa_decode as gqa
    t_cell = time.perf_counter()
    cfg, shape = model.cfg, SHAPES["long_500k"]
    win = adapt_config(cfg, shape)
    check(win.sliding_window == LONG_WINDOW, f"long_500k: {cfg.name} "
          f"window {win.sliding_window}")
    model.cfg = win
    try:
        cache = model.init_cache(1, shape.seq_len)
    finally:
        model.cfg = cfg
    check(cache["attn"]["k"].shape[2] == LONG_WINDOW, f"long_500k ring "
          f"{tuple(cache['attn']['k'].shape)}")
    for key in ("k", "v"):
        cache["attn"][key].normal_(generator=g)
    start = shape.seq_len - 1
    n_attn = model.n_shared if cfg.family == "hybrid" else cfg.n_layers
    tok0 = torch.randint(0, cfg.vocab, (1, 1), generator=g, device="cuda")
    lens = []

    def run(secs=None):
        cache["pos"], tok = start, tok0
        for _ in range(steps):
            t0 = time.perf_counter()
            logits, _ = model.decode_step(cache, {"tokens": _step_tokens(
                cfg, tok)})
            tok = logits.argmax(-1)
            if secs is not None:
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            check(bool(torch.isfinite(logits).all()), f"long_500k {cfg.name}"
                  f": non-finite logits")

    def hold(got, q, k, v, cache_len, where):
        lens.append(int(cache_len.min()))
        return gqa_check_model(got, q, k, v, cache_len, where)
    held, err = held_gqa_against_plain(run, None, hold)
    check(held == steps * n_attn and set(lens) == {LONG_WINDOW},
          f"long_500k {cfg.name}: {held} B2 launches held at cache_len "
          f"{sorted(set(lens))}")
    torch.cuda.synchronize()
    gqa.launches = 0
    secs = []
    run(secs)
    launches = gqa.launches
    check(launches == steps * n_attn and cache["pos"] == start + steps,
          f"long_500k {cfg.name}: {launches} B2 launches, pos "
          f"{cache['pos']}")
    med = statistics.median(secs)
    row = {"arch": cfg.name, "steps": steps, "ring": LONG_WINDOW,
           "start_pos": start, "held": held, "held_max_abs_err": err,
           "gqa_launches": launches, "median_step_ms": med * 1e3,
           "tokens_per_s": 1 / med}
    del cache
    row["cell_s"] = time.perf_counter() - t_cell
    print(f"[34] long_500k on {cfg.name} at full width and depth (phase "
          f"{tag}'s model): a {LONG_WINDOW}-slot ring, B = 1, {steps} steps "
          f"from pos {start} past the wrap; {held} B2 launches held against "
          f"the plain version at cache_len {LONG_WINDOW} (max|err| {err}); "
          f"then {launches} launches timed, median step {med * 1e3} ms; "
          f"the cell took {row['cell_s']} s", flush=True)
    return row


def _cells_seconds(tag, cells, where):
    """Print and return each cell's own seconds (spent inside the phases
    ``where``) and their sum."""
    own = {name: row["cell_s"] for name, row in cells.items()}
    total = sum(own.values())
    print(f"[{tag}] the cells' own seconds (inside phases {where}): {own}, "
          f"{total} s in all", flush=True)
    return total


def phase_dry_run():
    """Phase 33: the dry run's counting mode against the card, the cells
    filled in phases 15, 18 and 7 (each held there)."""
    check(set(DRY_CELLS) == {"train_wide", "qn_wide", "decode_32k"},
          f"phase 33 cells {sorted(DRY_CELLS)}")
    return dict(DRY_CELLS), _cells_seconds("33", DRY_CELLS, "15, 18, 7")


def phase_long_shapes():
    """Phase 34: prefill_32k and long_500k, run in phases 7 and 23."""
    check(set(LONG) == {"prefill_32k", "long_500k",
                        "long_500k_" + HYBRID}, f"phase 34 {sorted(LONG)}")
    return dict(LONG), _cells_seconds("34", LONG, "7, 23")


def _payload_work(mesh):
    """Phase 35's steps on ``mesh`` ((data 2, model 2), or None: world 1
    unsharded): the reduced glm4-9b (f32) from a seeded generator,
    PAYLOAD_STEPS AdamW steps (dcq_mad) and QN steps (the median) at
    PAYLOAD_M machines of RANKS_QN_BATCH x RANKS_QN_SEQ, machine 0
    signflipped, every sigma RANKS_QN_SIGMA on whole-leaf draws made alike
    in every process. Returns the whole parameters after each step (each
    rank's slices gathered), losses, grad norms, the bytes this rank holds
    and its B1 launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TreeProtocolConfig
    from repro_torch.core import dp
    from repro_torch.core.transport import tree_leaves, tree_map
    from repro_torch.data.lm import make_batch
    from repro_torch.dist.collectives import mesh_axis
    from repro_torch.dist.grad_agg import GradAggConfig
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainer import (QNTrainConfig, QNTrainer,
                                           TrainConfig, make_train_step)
    mark = launch_mark()
    cfg = get_config(GLM, reduced=True)
    g = torch.Generator(device="cuda")
    g.manual_seed(3535)
    model = Model(cfg, generator=g, remat=True)
    init = tree_map(lambda t: t.detach().clone(), model.params())
    batches = [make_batch(g, cfg, RANKS_QN_BATCH, RANKS_QN_SEQ)
               for _ in range(PAYLOAD_STEPS)]
    gz = torch.Generator(device="cuda")
    gz.manual_seed(3536)

    def normals():
        return tree_map(lambda p: torch.randn(
            (PAYLOAD_M,) + tuple(p.shape), generator=gz, device="cuda"),
            init)
    adamw_noise = [normals() for _ in batches]
    qn_noise = [{n: normals() for n in dp.TREE_TRANSMISSIONS}
                for _ in batches]
    mask = torch.arange(PAYLOAD_M, device="cuda") < 1

    def held(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    def whole(pl, tree):
        return [t.detach().cpu().clone() for t in tree_leaves(
            tree if pl is None else pl.unshard(tree))]
    out = {}
    model.load_params(init)
    opt = AdamW(lr=PAYLOAD_LR)
    step = make_train_step(model, opt, TrainConfig(
        n_machines=PAYLOAD_M, agg=GradAggConfig(
            method="dcq_mad", attack="signflip", dp_sigma=RANKS_QN_SIGMA)),
        mesh)
    pl = step.payload
    params = model.params() if pl is None else pl.shard(model.params())
    state = opt.init(params)
    rec = {"params": [], "loss": [], "grad_norm": []}
    for batch, z in zip(batches, adamw_noise):
        params, state, met = step(params, state, batch, None, mask, noise=z)
        rec["params"].append(whole(pl, params))
        rec["loss"].append(float(met["loss"]))
        rec["grad_norm"].append(float(met["grad_norm"]))
    rec["held"] = {"params": held(params), "moments": held((state.mu,
                                                           state.nu))}
    out["adamw"] = rec
    model.load_params(init)
    trainer = QNTrainer(model, QNTrainConfig(
        n_machines=PAYLOAD_M, attack="signflip", protocol=TreeProtocolConfig(
            hist=RANKS_QN_HIST, eps=1.0, aggregator="median")), mesh)
    pl = trainer.payload
    params = model.params() if pl is None else pl.shard(model.params())
    mem = trainer.init_memory(params)
    sigmas = {n: RANKS_QN_SIGMA for n in dp.TREE_TRANSMISSIONS}
    rec = {"params": [], "loss": [], "grad_norm": []}
    for batch, z in zip(batches, qn_noise):
        params, mem, met = trainer.step_fn(params, mem, batch, None, mask,
                                           sigmas=sigmas, noise=z)
        rec["params"].append(whole(pl, params))
        rec["loss"].append(float(met["loss"]))
        rec["grad_norm"].append(float(met["grad_norm"]))
    rec["held"] = {"params": held(params),
                   "memory": held((mem.s_hist, mem.y_hist))}
    out["qn"] = rec
    torch.cuda.synchronize()
    if mesh is not None:
        out["coords"] = {a: mesh_axis(mesh, a).rank
                         for a in ("machines", "model")}
    out["launches"] = launch_mark()[0] - mark[0]
    return out


def _payload_rank(rank, world, store, out_dir):
    """One rank of phase 35 (a spawned process): a gloo group through a
    FileStore, every tensor on cuda:0, the mesh (data 2, model 2)."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cuda", (2, world // 2),
                                mesh_dim_names=("data", "model"))
        torch.save(_payload_work(mesh), f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def phase_payload():
    """Phase 35: payload dims over "model" on the one card, PAYLOAD_RANKS
    spawned gloo ranks as (data 2, model 2) (NCCL will not put two ranks
    on one device; nothing here measures NCCL across cards), against the
    unsharded world-1 run in this process on the same weights, batches
    and draws: the parameters of both steps after every step within
    atol = rtol = 1e-5 on every coordinate (a machine's 3 rows do not
    split over the model group, so every rank's gradient is the whole
    batch's), losses and grad norms within 1e-5; the bytes each rank
    holds against the unsharded run's."""
    import multiprocessing

    import torch
    base = ROOT / "build" / "payload"
    base.mkdir(parents=True, exist_ok=True)
    for old in base.iterdir():
        old.unlink()
    one = _payload_work(None)
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_payload_rank, args=(
        r, PAYLOAD_RANKS, str(base / "store"), str(base)))
        for r in range(PAYLOAD_RANKS)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    wall = time.perf_counter() - t0
    for p in procs:
        if p.is_alive():
            p.kill()
    check(all(p.exitcode == 0 for p in procs), f"phase 35: exit codes "
          f"{[p.exitcode for p in procs]}")
    ranks = [torch.load(base / f"rank{r}.pt", weights_only=False)
             for r in range(PAYLOAD_RANKS)]
    gaps = {"adamw": 0.0, "qn": 0.0, "metrics": 0.0}
    for r, got in enumerate(ranks):
        for kind in ("adamw", "qn"):
            for i, (pa, pb) in enumerate(zip(got[kind]["params"],
                                             one[kind]["params"])):
                for a, b in zip(pa, pb):
                    gaps[kind] = max(gaps[kind], (a - b).abs().max().item())
                    check(torch.allclose(a, b, atol=1e-5, rtol=1e-5),
                          f"phase 35 rank {r}: {kind} step {i} apart from "
                          f"world 1 by {(a - b).abs().max().item()}")
            for f in ("loss", "grad_norm"):
                for a, b in zip(got[kind][f], one[kind][f]):
                    gaps["metrics"] = max(gaps["metrics"], abs(a - b))
                    check(math.isclose(a, b, rel_tol=1e-5, abs_tol=1e-5),
                          f"phase 35 rank {r}: {kind} {f} {a} against {b}")
        for kind, k in (("adamw", "params"), ("adamw", "moments"),
                        ("qn", "params"), ("qn", "memory")):
            # the L-BFGS memory is also split over the machines ("data")
            mine = got[kind]["held"][k] * (2 if k == "memory" else 1)
            full = one[kind]["held"][k]
            check(full / 2 < mine < full, f"phase 35 rank {r}: holds "
                  f"{got[kind]['held'][k]} bytes of {kind} {k} against "
                  f"{full}")
    launches = [got["launches"] for got in ranks]
    held = {f"{kind} {k}": [got[kind]["held"][k] for got in ranks]
            + [one[kind]["held"][k]]
            for kind, k in (("adamw", "params"), ("adamw", "moments"),
                            ("qn", "params"), ("qn", "memory"))}
    print(f"[35] {PAYLOAD_RANKS} ranks on one card as (data 2, model 2) "
          f"(gloo, CUDA tensors): the reduced {GLM} at {PAYLOAD_M} machines"
          f", {PAYLOAD_STEPS} AdamW steps (dcq_mad) and {PAYLOAD_STEPS} QN "
          f"steps (the median) against world 1 unsharded: largest gaps "
          f"{gaps}; bytes held per rank (ranks 0-3, then world 1) {held}; "
          f"B1 launches per rank {launches}, world 1 {one['launches']}; "
          f"{wall} s wall for the ranks. No NCCL across cards is measured "
          f"here", flush=True)
    return {"ranks": PAYLOAD_RANKS, "largest_gaps": gaps, "held": held,
            "wall_s": wall, "launches_per_rank": launches,
            "launches": sum(launches) + one["launches"],
            "coords": [got["coords"] for got in ranks]}


def phase_device_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ main

def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device is available; this script runs only on the "
             "card")
    src = ROOT / "src"
    for cu in ("agg/csrc/ostat.cu", "kernels/csrc/gqa_decode.cu"):
        if not (src / "repro_torch" / cu).is_file():
            fail(f"no port under {src}: run from the root of a checkout")
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.agg import dispatch
    t_start = time.perf_counter()
    phase_s, phase_logs = {}, {}

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        before = dispatch.decisions()
        out = fn(*args)
        phase_logs[label] = {k: n - before.get(k, 0)
                             for k, n in dispatch.decisions().items()
                             if n > before.get(k, 0)}
        phase_s[label] = time.perf_counter() - t0
        return out

    card, name = timed("1", phase_device)
    build_s = timed("2", phase_build)
    rows, edges, serve_rows = timed("3", phase_kernel)
    slice_rows = timed("4", phase_slice)
    vs_cpu = timed("5", phase_card_vs_cpu)
    gqa_rows = timed("6", phase_gqa, build_s["ptxas"])
    decode = timed("7", phase_decode)
    decode_vs_cpu = timed("8", phase_decode_vs_cpu)
    sweep_rows = timed("9", phase_sweep)
    baselines = timed("9b", phase_baselines)
    sweep_vs_cpu = timed("10", phase_sweep_vs_cpu)
    serve_fleets = timed("11", phase_serve_fleets)
    serve_launcher = timed("12", phase_serve_launcher)
    serve_wide = timed("13", phase_serve_wide)
    serve_vs_cpu = timed("14", phase_serve_vs_cpu)
    train_wide = timed("15", phase_train_wide)
    train_launcher = timed("16", phase_train_launcher)
    train_vs_cpu = timed("17", phase_train_vs_cpu)
    qn_wide = timed("18", phase_qn_wide)
    qn_launcher = timed("19", phase_qn_launcher)
    qn_vs_cpu = timed("20", phase_qn_vs_cpu)
    zoo_xlstm = timed("21", phase_zoo_xlstm)
    zoo_moe = timed("22", phase_zoo_moe)
    zoo_hybrid = timed("23", phase_zoo_hybrid)
    zoo_launchers = timed("24", phase_zoo_launchers)
    zoo_smoke = timed("25", phase_zoo_smoke)
    zoo_vs_cpu = timed("26", phase_zoo_vs_cpu)
    zoo_vlm = timed("27", phase_zoo_vlm)
    zoo_audio = timed("28", phase_zoo_audio)
    sharded, fig1 = timed("29", phase_sharded)
    wide_sharded = timed("30", phase_train_wide_sharded)
    ranks = timed("31", phase_ranks_on_one_card, fig1)
    del fig1
    dry, phase_s["33 cells (inside 15, 18, 7)"] = timed("33", phase_dry_run)
    long_shapes, phase_s["34 cells (inside 7, 23)"] = timed(
        "34", phase_long_shapes)
    payload = timed("35", phase_payload)
    dispatched = timed("32", phase_dispatch, dict(phase_logs),
                       ranks.pop("decision_logs"))
    check("jax" not in sys.modules and "repro" not in sys.modules,
          "JAX or the JAX package was imported")

    main_row = next(r for r in rows
                    if r["op"] == "dcq" and r["shape"] == [20, 51, 10])
    entry = {"name": "ostat", "route": "cuda",
             "source": "src/repro_torch/agg/csrc/ostat.cu",
             "replaces": "src/repro/agg/kernel.py:173",
             "launches": sum(r["launches_per_run"] * TIMED
                             for r in slice_rows)
             + sum(r.get("launches", 0) for r in sweep_rows)
             + baselines["launches"] + sweep_vs_cpu["launches"]
             + sum(r["launches"] for r in serve_fleets)
             + serve_launcher["launches"] + serve_wide["launches"]
             + serve_vs_cpu["launches"] + train_wide["launches"]
             + train_launcher["launches"] + train_vs_cpu["launches"]
             + qn_wide["launches"] + qn_launcher["launches"]
             + qn_vs_cpu["launches"] + zoo_xlstm["launches"]
             + zoo_moe["launches"] + zoo_hybrid["launches"]
             + zoo_launchers["launches"] + zoo_smoke["launches"]
             + zoo_vs_cpu["launches"] + zoo_vlm["launches"]
             + zoo_audio["launches"] + sharded["launches"]
             + wide_sharded["launches"] + ranks["launches"]
             + payload["launches"],
             "max_abs_err": main_row["max_abs_err"],
             "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
             "bound_ms": main_row["bound_ms"],
             "bound_by": main_row["bound_by"],
             "library_ms": main_row["library_ms"],
             "at": {"op": "dcq", "shape": [20, 51, 10]},
             "by_shape": rows,
             "serve_shapes": [r for r in serve_rows if "serve" in r["paths"]
                              or not r["paths"]],
             "train_shapes": [r for r in serve_rows
                              if "train" in r["paths"]]}
    full = next(r for r in gqa_rows if r["label"] == "main len 32768")
    gqa_entry = {"name": "gqa_decode", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/gqa_decode.cu",
                 "replaces": "src/repro/kernels/gqa_decode.py:32",
                 "launches": sum(r["gqa_launches"] for r in decode["runs"]
                                 + zoo_moe["decode"]["runs"]
                                 + zoo_hybrid["decode"]["runs"]
                                 + zoo_vlm["decode"]["runs"]
                                 + zoo_audio["decode"]["runs"]
                                 + [dry["decode_32k"], long_shapes[
                                     "long_500k"], long_shapes[
                                     "long_500k_" + HYBRID]]),
                 "max_abs_err": full["max_abs_err"], "ms": full["ms"],
                 "plain_ms": full["plain_ms"], "bound_ms": full["bound_ms"],
                 "bound_by": full["bound_by"],
                 "library_ms": full["library_ms"],
                 "at": {"shape": full["shape"], "dtype": full["dtype"],
                        "cache_len": DECODE_LEN},
                 "by_shape": gqa_rows}
    seconds = time.perf_counter() - t_start
    report = {"card": card, "device": name, "build_s": build_s,
              "kernels": [entry, gqa_entry], "ostat_edges": edges,
              "slice": slice_rows,
              "card_vs_cpu": vs_cpu, "decode": decode,
              "decode_card_vs_cpu": decode_vs_cpu, "sweep": sweep_rows,
              "baselines": baselines, "sweep_card_vs_cpu": sweep_vs_cpu,
              "serve_fleets": serve_fleets, "serve_launcher": serve_launcher,
              "serve_wide": serve_wide, "serve_card_vs_cpu": serve_vs_cpu,
              "train_wide": train_wide, "train_launcher": train_launcher,
              "train_card_vs_cpu": train_vs_cpu,
              "qn_wide": qn_wide, "qn_launcher": qn_launcher,
              "qn_card_vs_cpu": qn_vs_cpu, "zoo_xlstm": zoo_xlstm,
              "zoo_moe": zoo_moe, "zoo_hybrid": zoo_hybrid,
              "zoo_launchers": zoo_launchers, "zoo_smoke": zoo_smoke,
              "zoo_card_vs_cpu": zoo_vs_cpu, "zoo_vlm": zoo_vlm,
              "zoo_audio": zoo_audio, "sharded": sharded,
              "train_wide_sharded": wide_sharded,
              "ranks_on_one_card": ranks, "dispatch": dispatched,
              "dry_run": dry, "long_shapes": long_shapes,
              "payload": payload,
              "phase_seconds": phase_s, "seconds": seconds}
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(f"chip_smoke: build {build_s['total_s']:.3f} s, whole run "
          f"{seconds:.3f} s; seconds by phase {phase_s}", flush=True)
    print(json.dumps({"kernels": [
        {k: e[k] for k in ("name", "route", "source", "replaces",
                           "launches", "max_abs_err", "ms", "plain_ms",
                           "bound_ms", "bound_by", "library_ms")}
        for e in (entry, gqa_entry)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
