#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of ZEUS, and of its LM serving path, on
one NVIDIA GPU (Hopper).

    python3 chip_smoke.py        # from the repository root, on a GPU host

Phases (any failure exits non-zero):
  1. the card's name and power limit, and torch's CUDA version;
  2. build the seven kernel sources from src/repro_torch/kernels/csrc (one
     nvcc each, in parallel);
  3. hold each kernel against its plain PyTorch version on the card at the
     shapes its solves give it: B1, B3 and B4 at the paper, scale and
     mean-field shapes, with value-only f == value+grad f bitwise and
     ackley's NaN gradient at the origin; B1a and B1b (three variants by D,
     ops.fused_obj_variant: row groups of P = ops.fused_obj_row_threads(D)
     threads to D = 16, a warp a row staged through a ring of shared-memory
     tiles by bulk copies to D = 1815, a warp a row from device memory
     above) also at D = 1, 2, 5, 8, 16, 17, 32, 33, 64, 128, 300, 1815,
     1816 and 8192 for all four objectives, at 4096 rows and at a ragged
     row count (fused_ragged_rows) from x's base and from views 1, 2 and 3
     floats into a buffer, each with the same three checks; the fast
     cosine and sine of B1 and B5 (objective.cuh trig_fast_path) bitwise
     equal to cosf and sinf on every float of their range; B2, B7a and B7b
     (one kernel of
     three variants chosen by D, ops.update_variant) at the paper (512 × 5),
     scale (16384 × 128) and mean-field (131072 × 8) shapes and at both
     edges of each variant (300 lanes of D = 32 and 33; 256 of
     ops.update_smem_dim() and one past it; 64 of D = 300), each with H' ==
     H bitwise on ρ = 0 lanes, B7b's H' == B7a's bitwise, a B7 lane on the
     engine's stand-in pair (1, …, 1) finite, and 64 lanes launched alone
     bitwise equal to the same lanes in the batch; B6 at the
     mean-field shape in both noise modes, with non-finite rows, and at a
     row count that is no multiple of the block (anisotropic bitwise);
     B5/B5b at the megakernel solves' shapes (paper: all four objectives;
     scale: ackley) with frozen lanes, an ackley lane at the origin and an
     uphill lane (rung and α equal but at certified knife edges; H' == H on
     frozen lanes; lanes bitwise equal to the plain version and f', g'
     bitwise equal to B1b at the kernel's x' counted and printed); B8
     (flash attention) at the phi3-mini prefill shape (B=4, S=2048,
     H=KV=32, hd=96, bf16, causal), the starcoder2-15b GQA shape (B=1,
     S=2048, H=48, KV=4, hd=128, bf16, causal) and two ragged float32
     shapes (B=2, Sq=Sk=333, H=4, KV=2, hd=64, causal and not); and the
     shapes a compacted sweep's smallest buckets give B1a, B1b, B2 and
     B5/B5b (check_tiny_buckets: 1, 2, 3 and 5 lanes of D = 5 and 128), each
     against its plain version and bitwise equal to the same lanes inside a
     64-lane launch, with the sweep's row sums and norms at those row counts
     printed against the same rows of 16384;
  3b. the schedules down to buckets of 1, 2, 4 and 8 lanes end to end
     (check_tiny_solves): 64 rosenbrock lanes, all but 1, 2, 3 or 5 at the
     optimum, spread over four chunks of 16, 5 sweeps at D = 5 and 128 in
     both batched modes, compacted, repacked and compacted, and auto, each
     equal to the static solve;
  4. drive the main paths, `zeus` on "cuda", one solve at a time, with
     every launch counter set to 0 just before each solve and read just
     after, each solve's kernels required to have launched (exact counts
     where the path fixes them) and every other kernel not at all:
       paper          — the README example: rastrigin, D=5, 2048 particles,
                        iter_pso=8, iter_bfgs=100, theta=1e-4,
                        required_c=400, lane_chunk=512 (batched sweep);
       scale          — ackley, D=128, 16384 starts, iter_pso=5,
                        iter_bfgs=100, unchunked (a 1.07 GB H stack);
       per_lane-paper — paper with sweep_mode="per_lane",
                        hessian_impl="pallas" (B7a once per chunk-sweep);
       per_lane-scale — scale, the same way;
       lbfgs-scale-batched / lbfgs-scale-per_lane — scale with
                        solver="lbfgs" (memory 10), in both sweep modes;
       wolfe-paper    — per_lane-paper with linesearch="wolfe";
       meanfield      — phase1="meanfield": rastrigin, D=8, 2^20
                        particles, iter_pso=5, iter_bfgs=100, theta=1e-4,
                        required_c=1000, lane_chunk=131072 (B6 iter_pso
                        times);
       sequential     — sequential_zeus (the paper's Alg. 1 baseline) on
                        the paper objective with 64 particles;
       megakernel-paper / megakernel-scale — paper and scale with
                        sweep_mode="megakernel" (B5 once per chunk-sweep,
                        B2 and the ladder's B1a never);
       megakernel-ladder-scale — megakernel-scale with ladder_len=4 (the
                        adaptive ladder, then B5b once per chunk-sweep);
       compact-scale  — scale with compact_every=1: equal to scale's solve
                        (x, fval, grad_norm, status, n_evals, sweeps,
                        n_converged), eval_rows and chunk-steps at most its;
       repack-paper   — paper with repack_every=1 and compact_every=1:
                        equal to paper's solve, chunk-steps at most its;
       auto-megakernel-scale — megakernel-scale with schedule="auto": equal
                        to megakernel-scale's lanes (n_evals aside: shorter
                        ladders probe less), one B5 or B5b per chunk-step;
                        then schedule="replay" of its trace, equal to it in
                        every field;
       dijet          — the paper's application (examples/fit_dijet.py) in
                        float32: 40 bins of 1000-6000 GeV, counts drawn at
                        TRUE = (-2, 10, 4.5, 0.3) from seed 7, 512
                        particles, iter_pso=10, iter_bfgs=300, θ=1e-2,
                        required_c=32, box [-5, 15]: best_f <= nll(TRUE) +
                        1, 90% of the pulls within ±2σ, n_converged >= 32;
                        B2, B3 and B4, no B1 (the NLL has no fused body);
     and the LM serving path (phi3-mini-3.8b at full width, bf16 weights
     drawn from torch.Generator("cuda").manual_seed(0)), each run with
     every counter set to 0 just before and read just after, B8 launched
     exactly as the path fixes it and no ZEUS kernel at all:
       lm-prefill     — make_prefill_step(last_only=True), full depth, on
                        B=4 × S=2048 token ids from a seed: 32 B8 launches a
                        call (one a layer); warm wall time;
       lm-generate    — greedy_generate, full depth, B=4, a 32-token
                        prompt, 16 new tokens, max_seq 48: no B8 launch
                        (decode attends against the cache); tokens/s;
       lm-parity      — on lm-generate's prompt, the bf16 full-depth
                        prefill's last logits (32 B8 launches) and the
                        decode path's, each against a float32 evaluation of
                        the same weights (32 more): the prefill no farther
                        from it than 1.1× the decode path (mean |Δ| / std);
                        and phi3-mini at full width with 4 layers in
                        float32 ("highest" matmul precision) on a 256-token
                        prompt: the prefill's logits at every position (4
                        B8 launches) against the decode path's, and each
                        against a float64 evaluation on the host, the
                        prefill no farther from it than 2× the decode path
                        (mean |Δ| / std). The prefill-vs-decode differences
                        (against 5e-3, the JAX test's bound for reduced
                        configs) and the bf16 argmax agreement are printed:
                        at this random init the model's own conditioning
                        sets them (BF16_REF_RATIO, F32_REF_RATIO);
     then (4b), for paper and scale, the first 3 batched sweeps and, for
     the two per-lane pallas solves, the first 3 per-lane sweeps, each from
     the kernel path's state, through the kernels and through the plain
     versions; for the three megakernel solves, the first 3 sweeps through
     the megakernel and through the staged kernels (B1a, B1b, B2), with the
     lanes bitwise equal on x', f' and g' counted: rung (or trial count)
     and status must agree except at certified knife edges, and the state
     within tolerance; time
     cluster_solutions on paper and scale (at scale, on the first 1024 and
     2048 converged lanes: its host loop is O(lanes × clusters)); and
     (4c) profile each solve and one lm-prefill call once more, device
     activity only (device-busy share, top kernels);
  4e. fault-tolerant solves and the cost-model controller, each with every
     launch counter set to 0 just before and read just after, its launches
     required exactly as the path fixes them (a resumed solve runs no init
     and only the sweeps after its snapshot; a heal re-initialises each
     chunk holding a lane to heal with one B1b and one B3):
       ckpt-paper / ckpt-megakernel-paper — paper and megakernel-paper with
                        checkpoint_every=4: equal to phase 4's solve in
                        every field with its launches; preempted at sweep 6
                        (Preempted(6), newest snapshot 4); resumed through
                        solve_phase2(resume_from=) on the phase-1 starts,
                        equal again;
       zeus-resume    — the same through zeus(resume=): raw, best_x and
                        pso_best_f equal to phase 4's paper;
       retry-paper / retry-megakernel-paper — paper on both batched modes
                        with FaultPlan.random(seed=0, n_sweeps=8,
                        n_lanes=2048, n_nan=64, n_kill=16): with
                        retry_budget=2 fewer lanes end failed than without,
                        the re-seeds and heal launches those the plan fixes;
                        then checkpoint_every=2, preempted at 5 and resumed
                        (the retry stream from the snapshot): equal to the
                        uninterrupted retry solve;
       ckpt-overhead  — the reference's overhead cell (ackley, B=1024, D=64,
                        100 sweeps, no lane stops) with and without
                        checkpoint_every=25 (2 kept), warm walls in turns and
                        their ratio beside the design target 1.05 (printed,
                        not required); the two array-equal;
       cost-model-scale — auto-megakernel-scale with auto_cost_model=True in
                        measured mode: plans, fitted c_row and c_launch,
                        warm wall beside auto-megakernel-scale's; the replay
                        of its trace equal in every field but telemetry;
       ckpt-scale     — scale with checkpoint_every=50, checkpoint_keep=1
                        (1.07 GB snapshots; the temporary directory's disk
                        must hold two): equal to scale, preempted at 75
                        (newest snapshot 50) and resumed, equal again; each
                        snapshot's bytes, device-to-host copy ms and write
                        s, and the checkpointed wall over scale's warm
                        wall; the directory is removed at the end;
  4f. the solve service (serve/service.py over HostedSolve), each drain
     with every launch counter set to 0 before its first submit (the
     pool's open and init included) and read after it, its launches
     required exactly as the path fixes them (one chunk-step a sweep; an
     admission re-initialises the admitted rows with one B1b and one B3):
       serve-paper    — the reference bench's serve cell: rastrigin, D=16,
                        32 slots, 96 one-start requests at sweep 0, budgets
                        alternating (2, 32), theta=1e-30, ls_iters=20, on
                        the batched and the megakernel sweep: a warm drain,
                        then the continuous service and drain_then_refill,
                        all requests done, every lane's sweeps exactly its
                        budget, drain / continuous sweeps >= 1.3, request
                        0 and the first request admitted after sweep 0
                        array-equal to solo_reference at width 32; sweeps,
                        walls, solves/s, admit latency in sweeps and ms,
                        and the continuous drain once more under the
                        profiler (device-busy share);
       serve-scale    — ackley, D=128, 16384 slots (a 1.07 GB H stack), 64
                        requests of 512 starts, budgets alternating (25,
                        100), theta=1e-4, batched, admit_every=1: all done,
                        the launches, solo parity at width 16384 for
                        request 0 and the first request admitted mid-flight;
                        the per-pump split on the host clock (lane_view,
                        harvest + admit, segment, the pool's telemetry);
       serve-cli      — repro_torch.launch.serve.main with
                        tests/test_system.py's arguments on the card: four
                        requests drained, each converged with two lanes;
  4g. the float64 path (ROADMAP A19a), with phases of its own, after the
     LM runs: (3) B1a/B1b, B2, B3 and B4 through their float64 symbols
     against their float64 plain versions to TOL64 (1e-12), at the
     paper-f64, scale-f64 and dijet-f64 shapes (B1 on the ladder rows for
     all four objectives, value-only f == value+grad f bitwise; B3 of 64
     lanes alone bitwise the same lanes of the batch), B1 at D = 1, 5, 16,
     17, 128, 907 and 908 (both sides of the rows/staged edge and of the
     float64 staged/direct edge, ops.fused_obj_staged_max_dim(float64))
     at 4096 rows and at a ragged count from an aligned base and from 8
     bytes past a 16-byte boundary, and B2 at the cells' shapes and at D =
     32/33 and 168/169 (ops.update_smem_dim(float64)), H' == H bitwise on
     ρ = 0 lanes and 64 lanes alone bitwise the same lanes of the batch;
     every path still to port (ROADMAP A19b) raising NotImplementedError
     naming A19b on the card, no kernel launched;
     (4) the cells, each with every counter set to 0 just before and read
     just after, only the float64 counters non-zero and exactly as the
     batched sweep fixes them:
       paper-f64      — paper with dtype="float64" (B1a, B1b, B2, B3, B4);
       scale-f64      — scale with dtype="float64": a 2.15 GB float64 H
                        stack and its H' (B1a, B1b, B2, B3, B4);
       dijet-f64      — dijet with dtype="float64", the counts' rate in
                        float64 as the example computes it: the example's
                        two assertions and n_converged >= 32 (B2, B3, B4);
     (4c) each profiled; (5) each float64 kernel at each of its cells timed
     beside its plain version, both bounds (bytes at 8 bytes an element;
     fp64 operations at 34 TFLOP/s) and, for B3, torch.bmm in float64;
  4d. peak device memory of run_multistart at the scale shape (3 sweeps),
     unchunked and with lane_chunk 4096 and 1024: chunking must lower it;
  5. time each kernel with CUDA events beside its plain version, its bound
     and the one PyTorch call that computes the same function, where there
     is one: torch.bmm for B3, scaled_dot_product_attention (timed only;
     the port never calls it) for B8 at the phi3-mini and starcoder2
     shapes; B2, B7a and B7b at every shape phase 3 holds them at; B1a and
     B1b also at 131072 rows of D = 8 and 16 (rastrigin) and at D = 128
     (ackley) at 327680 and 16384 rows, warm and cold (cycling through 128
     MiB of copies), beside the staged kernel's element-loop body counted
     from its SASS (cuobjdump) and the issue bound it gives; B3 and
     torch.bmm at the paper shape in 21 pairs taken in turns (medians and their
     ratio); the host's enqueue cost of one call of each kernel wrapper and
     of torch.bmm at the paper shapes (µs a call over 2000 calls with no
     synchronise, on the host clock); and that the stream a wrapper
     launches on (kernels/_build.stream, a raw handle) is
     torch.cuda.current_stream().cuda_stream, also inside
     torch.cuda.stream(side), where a launch is held against its plain
     version;
  6. print one JSON line {"kernels": [...]} with the measurements (B1a's
     and B1b's entries name their variant and layout at the cell's D; the
     float64 entries, named <kernel>_f64/<cell>, add "dtype", "bytes_ms"
     and "ops_ms"), the
     script's own time, the card's name and power limit, and last
     {"ok": true, "device": {...}}.

`python3 chip_smoke.py --chunk-memory` runs phase 4d alone, against the
repro_torch beside the script (to compare two trees on one card).
`python3 chip_smoke.py --launch-path` runs only phase 5's host enqueue
costs and B3 against torch.bmm at the paper shapes, the same way (copy the
script into another checkout and run the two in turns).
`python3 chip_smoke.py --fused` runs only B1a's and B1b's checks and times
of phases 3 and 5, the same way. `python3 chip_smoke.py --tiny` runs only
the tiny-bucket checks of phases 3 and 3b, and `--serve` the service
cells of phase 4f, and `--f64` the float64 phases (4g).

It imports neither JAX nor the JAX package `repro`.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
FP64_OPS_PER_S = 34e12  # H100 SXM fp64 outside the tensor cores (the kernels use no DMMA)
# dense bf16 tensor-core peak by the card's name (NVIDIA data sheets); an
# H100 or H200 SXM part, named "H100 80GB HBM3" or "H200", takes the default
BF16_PEAK = (("H100 PCIe", 756e12), ("H100 NVL", 835e12))
BF16_PEAK_DEFAULT = 989e12
K_LADDER = 20  # BFGSOptions.ls_iters: rows of the Armijo ladder per lane
SWEEPS_COMPARED = 3
# kernel vs plain version on identical inputs: |k - p| <= ATOL·scale + RTOL·|p|
# with scale = max(1, max|p|). The two sum D terms in different orders,
# which moves fp32 results by a few ulps of the largest term.
RTOL, ATOL = 1e-5, 1e-5
# one sweep of the kernel path vs the plain path from the same state, per
# lane: |Δ| <= STATE_TOL·max(1, the lane's largest |entry|). g' and H' round
# relative to a lane's largest terms (cancellation), not elementwise.
STATE_TOL = 1e-3
# a lane whose accepted rung differs between the paths is a knife-edge
# accept when its Armijo margin |f(x + α_r p) − threshold_r| at the
# disputed rung r is at most this fraction of max(1, |threshold_r|)
KNIFE_EDGE = 1e-5
# cluster_solutions runs on every converged lane up to this many, else on
# the first CLUSTER_SAMPLES of them
CLUSTER_ALL_MAX = 4096
CLUSTER_SAMPLES = (1024, 2048)

# kernel op -> (CUDA source, the TPU kernel it replaces)
SOURCES = {
    "fused_value": ("src/repro_torch/kernels/csrc/fused_obj.cu",
                    "src/repro/kernels/fused_obj.py:119"),
    "fused_value_grad": ("src/repro_torch/kernels/csrc/fused_obj.cu",
                         "src/repro/kernels/fused_obj.py:140"),
    "guarded_update_direction": ("src/repro_torch/kernels/csrc/bfgs_update.cu",
                                 "src/repro/kernels/bfgs_update.py:150"),
    "direction": ("src/repro_torch/kernels/csrc/direction.cu",
                  "src/repro/kernels/direction.py:29"),
    "pso_step_update": ("src/repro_torch/kernels/csrc/pso_step.cu",
                        "src/repro/kernels/pso_step.py:34"),
    "meanfield_step_update": ("src/repro_torch/kernels/csrc/meanfield_step.cu",
                              "src/repro/kernels/meanfield_step.py:51"),
    "bfgs_update": ("src/repro_torch/kernels/csrc/bfgs_update.cu",
                    "src/repro/kernels/bfgs_update.py:110"),
    "bfgs_update_direction": ("src/repro_torch/kernels/csrc/bfgs_update.cu",
                              "src/repro/kernels/bfgs_update.py:127"),
    "sweep_megakernel_full": ("src/repro_torch/kernels/csrc/sweep_megakernel.cu",
                              "src/repro/kernels/sweep_megakernel.py:188"),
    "sweep_megakernel_commit": ("src/repro_torch/kernels/csrc/sweep_megakernel.cu",
                                "src/repro/kernels/sweep_megakernel.py:225"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:76"),
}
# the batched dense-BFGS path's kernels (the PR-12 cells paper and scale)
BATCHED_KERNELS = ("fused_value", "fused_value_grad", "guarded_update_direction",
                   "direction", "pso_step_update")
# the cells at which each kernel is timed, in the kernels line
KERNEL_CELLS = {
    **{k: ("paper", "scale") for k in BATCHED_KERNELS},
    **{k: ("paper", "scale", "meanfield")
       for k in ("fused_value", "fused_value_grad", "guarded_update_direction")},
    "bfgs_update": ("per_lane-paper", "per_lane-scale"),
    "bfgs_update_direction": ("per_lane-scale",),
    "meanfield_step_update": ("meanfield",),
    "sweep_megakernel_full": ("megakernel-paper", "megakernel-scale"),
    "sweep_megakernel_commit": ("megakernel-ladder-scale",),
    "flash_attention": ("lm-prefill",),
}
# the megakernel inputs each of those cells is timed and held on
MEGAKERNEL_CASE = {"megakernel-paper": "megakernel-paper",
                   "megakernel-scale": "megakernel-scale",
                   "megakernel-ladder-scale": "megakernel-scale"}
# B5/B5b above the single-read threshold (ops.megakernel_smem_dim): the
# two streaming passes over H, held on every run beside the single-read
# shapes (paper D = 5 through cp.async, scale D = 128 through a bulk copy)
STREAMING_CASE = ("megakernel-streaming", "ackley", 64, 300)
# B2, B7a and B7b (one kernel, csrc/bfgs_update.cu) at the cells' shapes and
# at both edges of each variant (ops.update_variant): (label, lanes, D), D
# None for the single-read threshold ops.update_smem_dim() and one past it
UPDATE_SHAPES = (("paper", 512, 5), ("scale", 16384, 128), ("meanfield", 131072, 8),
                 ("small edge", 300, 32), ("single-read first", 300, 33),
                 ("single-read edge", 256, None), ("streaming first", 256, None),
                 ("streaming", 64, 300))
# the update shape at which each cell's B2, B7a or B7b entry is held and timed
UPDATE_SHAPE_OF = {"paper": "paper", "scale": "scale", "meanfield": "meanfield",
                   "per_lane-paper": "paper", "per_lane-scale": "scale"}
UPDATE_KERNELS = ("guarded_update_direction", "bfgs_update", "bfgs_update_direction")
ALONE_LANES = 64  # lanes launched alone and in the batch, bitwise equal
B3_PAIRS = 21  # B3 and torch.bmm at the paper shape, timed in turns
# B1a/B1b at every row layout (ops.fused_obj_row_threads), both sides of the
# whole-warp threshold (D = 16 / 17), of one stride (32 / 33), the cells'
# D = 128, a ring of 16-row tiles (300), both edges of the staged variant
# (ops.fused_obj_staged_max_dim(), 1815, and 1816, direct) and one D above
# them (direct)
FUSED_DIMS = (1, 2, 5, 8, 16, 17, 32, 33, 64, 128, 300, 1815, 1816, 8192)
FUSED_ROWS = 4096
# Each D also at a ragged row count, no multiple of any tile (2048/P rows at
# D <= 16, ops.fused_obj_tile_rows(D) rows above), from x's base and from
# views 1, 2 and 3 floats into a buffer (a base that is not 16-byte
# aligned). Staged, the count gives every block of the grid several turns of
# its ring; at odd D the last tile's rows·D·4 bytes are no multiple of 16.
FUSED_OFFSETS = (0, 1, 2, 3)


def fused_ragged_rows(D) -> int:
    return 4099 if D <= 16 else 300_007 if D <= 300 else 20_001 if D <= 2048 else 3001


FUSED_TIMED = ((131072, 8), (131072, 16))  # (rows, D), rastrigin, phase 5
# B1a/B1b at the scale cell's D = 128 (ackley), phase 5: the ladder's rows
# and the commit's (and a fallback rung's), each warm (back to back) and
# cold (cycling through FUSED_COLD_BYTES of copies, past the 50 MB L2)
FUSED_D128_ROWS = (327_680, 16_384)
FUSED_COLD_BYTES = 128 << 20
ENQUEUE_CALLS = 2000  # calls a wrapper, no synchronise, for the host's cost
# the kernels a compacted sweep runs on its smallest buckets (phase 3):
# B1a/B1b, B2 and B5/B5b at N lanes of D, each against its plain version
# and bitwise equal to the same lanes inside a TINY_BASE-lane launch
TINY_LANES = (1, 2, 3, 5)
TINY_DIMS = (("rastrigin", 5), ("ackley", 128))
TINY_BASE = 64
# the dijet fit (examples/fit_dijet.py): TRUE = (log p0, p1, p2, p3), the
# bin edges in GeV and the seed of the simulated counts
DIJET_TRUE = (-2.0, 10.0, 4.5, 0.3)
DIJET_EDGES = (1000.0, 6000.0, 41)
DIJET_SEED = 7
# the fields a schedule's solve must share with its static counterpart
SAME_FIELDS = ("x", "fval", "grad_norm", "status", "n_evals")
# float64 (ROADMAP A19a): B1a/B1b, B2, B3 and B4 in double, on the batched
# dense-BFGS path. Kernel against plain version on identical float64
# inputs: |k - p| <= TOL64·max(1, max|p|) + TOL64·|p| (sums in another
# order move a double result by a few ulps of the largest term).
TOL64 = 1e-12
# the float64 cells (phase 4): the float32 cell each copies, in float64
F64_CELLS = {"paper-f64": "paper", "scale-f64": "scale", "dijet-f64": "dijet"}
# the cells at which each float64 kernel is held (phase 3) and timed (phase
# 5); the dijet NLL has no fused body, so B1 never runs there
F64_KERNEL_CELLS = {
    "fused_value": ("paper-f64", "scale-f64"),
    "fused_value_grad": ("paper-f64", "scale-f64"),
    "guarded_update_direction": ("paper-f64", "scale-f64", "dijet-f64"),
    "direction": ("paper-f64", "scale-f64", "dijet-f64"),
    "pso_step_update": ("paper-f64", "scale-f64", "dijet-f64"),
}
# B1a/B1b in float64 at each row layout's edge (rows to 16, staged from 17),
# the scale cell's 128 and both edges of the staged variant
# (ops.fused_obj_staged_max_dim(float64) = 907, and 908, direct), each at
# FUSED_ROWS rows and at a ragged count from the base and from a view 8
# bytes past a 16-byte boundary (the bulk copies' unaligned head)
F64_FUSED_DIMS = (1, 5, 16, 17, 128, 907, 908)
F64_FUSED_OFFSETS = (0, 1)
# B2 in float64 at the cells' shapes and both edges of each variant
# (ops.update_variant(D, float64): small to 32, single read to
# ops.update_smem_dim(float64) = 168, streaming above)
F64_UPDATE_SHAPES = (("paper-f64", 512, 5), ("scale-f64", 16384, 128),
                     ("dijet-f64", 512, 4), ("small edge", 300, 32),
                     ("single-read first", 300, 33), ("single-read edge", 256, None),
                     ("streaming first", 256, None))
# phase 4e: the phase-4 solves its cells are held against
FAULT_BASES = ("paper", "megakernel-paper", "scale", "auto-megakernel-scale")
# checkpoint cadence, snapshots kept and preemption sweep of each cell
CKPT_PAPER = dict(every=4, keep=3, preempt=6)
CKPT_SCALE = dict(every=50, keep=1, preempt=75)
CKPT_RETRY = dict(every=2, keep=3, preempt=5)
# the reference's checkpoint-overhead cell (DESIGN.md §15,
# benchmarks/engine_bench.py CKPT_*): ackley, B = 1024, D = 64, 100 sweeps,
# theta so small that no lane stops, a snapshot every 25 sweeps, 2 kept;
# its design target, printed beside the measured ratio and not required
CKPT_OVERHEAD = dict(objective="ackley", lanes=1024, dim=64, sweeps=100, every=25,
                     keep=2, seed=3 * 1024 + 64, rounds=3)
CKPT_DESIGN_RATIO = 1.05
# retry-paper's fault plan (FaultPlan.random's arguments) and retry budget
RETRY_PLAN = dict(seed=0, n_sweeps=8, n_lanes=2048, n_nan=64, n_kill=16)
RETRY_BUDGET = 2
ENERGY_READS = 50  # reads of the energy probe timed beside cost-model-scale
MEANFIELD_RAGGED_N = 100_003  # no multiple of the kernels' 256-thread blocks
# phase 4f, the solve service. serve-paper: the reference bench's serve cell
# (benchmarks/engine_bench.py SERVE_*): 96 one-start requests at sweep 0,
# budgets alternating (2, 32), theta so small that every lane retires at its
# deadline; the drain-then-refill baseline must take at least SERVE_FLOOR
# times the continuous service's sweeps (the reference's BENCH_SERVE_FLOOR)
SERVE_PAPER = dict(objective="rastrigin", dim=16, slots=32, requests=96, n_starts=1,
                   budgets=(2, 32), theta=1e-30, admit_every=1)
SERVE_FLOOR = 1.3
# serve-scale: several fits queued against one pool at the scale cell's
# width (a 1.07 GB H stack): 64 requests of 512 starts, two pool-widths
SERVE_SCALE = dict(objective="ackley", dim=128, slots=16384, requests=64, n_starts=512,
                   budgets=(25, 100), theta=1e-4, admit_every=1)
# serve-cli: tests/test_system.py's arguments for the service launcher
SERVE_CLI = ["--problems", "rastrigin:3,ackley:2", "--requests", "4", "--n-starts", "2",
             "--iter-max", "30", "--slots", "4"]
# B8 against its plain version: |k - p| <= tol + tol·|p|. float32: the JAX
# test's 2e-4. bf16: 1e-2 for unit-normal inputs — the kernel rounds P to
# bf16 before P·V where the plain version keeps it in float32, and both
# round the output to bf16, whose ulp at |o| in [1, 2) is 2⁻⁷ ≈ 7.8e-3.
FLASH_TOL = {"float32": 2e-4, "bfloat16": 1e-2}
# The bf16 cases beyond the two LM shapes hold the TMA path at its edges:
# ragged lengths (TMA zero-fills rows past S, which the kernel still masks),
# Sq != Sk, and the head dims whose rows take a 32- or 64-byte swizzle.
# (name, B, Sq, Sk, H, KV, hd, dtype, causal)
FLASH_CASES = (
    ("phi3-mini prefill", 4, 2048, 2048, 32, 32, 96, "bfloat16", True),
    ("starcoder2-15b GQA", 1, 2048, 2048, 48, 4, 128, "bfloat16", True),
    ("ragged causal", 2, 333, 333, 4, 2, 64, "float32", True),
    ("ragged non-causal", 2, 333, 333, 4, 2, 64, "float32", False),
    ("bf16 ragged causal", 2, 333, 333, 4, 2, 64, "bfloat16", True),
    ("bf16 ragged non-causal", 2, 333, 333, 4, 2, 64, "bfloat16", False),
    ("bf16 Sq != Sk", 2, 200, 333, 4, 2, 128, "bfloat16", False),
    ("bf16 hd 16", 2, 333, 333, 4, 2, 16, "bfloat16", True),
    ("bf16 hd 32", 2, 333, 333, 4, 2, 32, "bfloat16", True),
)
LM_ARCH = "phi3-mini-3.8b"
PREFILL_B, PREFILL_S = 4, 2048
GEN_B, GEN_PROMPT, GEN_NEW, GEN_MAX_SEQ = 4, 32, 16, 48
PARITY_LAYERS, PARITY_B, PARITY_S = 4, 2, 256
PARITY_TOL = 5e-3  # max |Δ| / std, tests/test_models.py::test_decode_matches_forward
# bf16 at full depth: printed, with the argmax agreement on rows whose
# top-2 margin exceeds ARGMAX_MARGIN·std, and required: the prefill (B8)
# stands no farther from a float32 evaluation of the same weights than
# BF16_REF_RATIO × the decode path does (mean |Δ| / std). At this random
# init the bf16 model is chaotic: q, k and v have rms ~10 (the reference's
# init takes fan_in = shape[-2], the head axis of a (d, H, hd) weight), the
# attention logits reach the hundreds, and any two bf16 evaluation orders — the
# flash prefill, the reference's direct prefill, the decode path — end on
# other argmaxes; so the argmax rule cannot be required here.
ARGMAX_MARGIN = 1e-2
BF16_REF_RATIO = 1.1
# float32 at full width: the same conditioning, unsaturated. Rounding grows
# fast with depth (on an H100: prefill vs decode 1.0e-4, 1.9e-3 and 4.8e-2
# of std at 1, 2 and 4 layers, with the reference's direct prefill and the
# decode path as far from a float64 evaluation as the flash prefill), so
# the result is printed against PARITY_TOL, and the prefill is required to
# stand no farther from a float64 evaluation than F32_REF_RATIO × the
# decode path (mean |Δ| / std, which a few chaotic positions do not sway as
# they sway the max).
F32_REF_RATIO = 2.0


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def solves():
    """The solves of phase 4. `must` names the kernels that must launch,
    `exact(res)` the launch counts the path fixes; every other kernel must
    not launch at all."""
    from repro_torch.core import (BFGSOptions, MeanFieldPSOOptions, PSOOptions,
                                  ZeusOptions)

    paper_pso = PSOOptions(n_particles=2048, iter_pso=8)
    paper_bfgs = BFGSOptions(iter_bfgs=100, theta=1e-4, required_c=400,
                             ad_mode="forward")
    scale_pso = PSOOptions(n_particles=16384, iter_pso=5)

    def per_lane(pso_iters):
        # one per-lane step per chunk and sweep: B3 for p, B7a for H'
        return lambda res: {"bfgs_update": res.raw.map_trips,
                            "direction": res.raw.map_trips,
                            "pso_step_update": pso_iters}

    def auto_megakernel(res, counts):
        # one B5 or B5b a sweep, by the ladder of the window's plan
        return (counts["sweep_megakernel_full"] + counts["sweep_megakernel_commit"]
                == res.raw.map_trips)

    def megakernel(pso_iters, n_chunks, full):
        # one B5 (full ladder) or B5b (adaptive ladder) per chunk and sweep;
        # B1b and B3 at init only, once per chunk; never B2; no ladder B1a
        # with the full ladder
        def exact(res):
            trips = res.raw.map_trips
            counts = {"sweep_megakernel_full": trips if full else 0,
                      "sweep_megakernel_commit": 0 if full else trips,
                      "guarded_update_direction": 0, "fused_value_grad": n_chunks,
                      "direction": n_chunks, "pso_step_update": pso_iters}
            if full:
                counts["fused_value"] = 0
            return counts
        return exact

    return {
        "paper": dict(
            objective="rastrigin", dim=5, seed=0, cluster=True, compare="batched",
            opts=ZeusOptions(pso=paper_pso, bfgs=paper_bfgs, lane_chunk=512,
                             sweep_mode="batched"),
            must=BATCHED_KERNELS),
        "scale": dict(
            objective="ackley", dim=128, seed=1, cluster=True, compare="batched",
            opts=ZeusOptions(pso=scale_pso, bfgs=BFGSOptions(iter_bfgs=100),
                             sweep_mode="batched"),
            must=BATCHED_KERNELS),
        "per_lane-paper": dict(
            objective="rastrigin", dim=5, seed=0, compare="per_lane",
            opts=ZeusOptions(
                pso=paper_pso, bfgs=dataclasses.replace(paper_bfgs, hessian_impl="pallas"),
                lane_chunk=512, sweep_mode="per_lane"),
            exact=per_lane(8)),
        "per_lane-scale": dict(
            objective="ackley", dim=128, seed=1, compare="per_lane",
            opts=ZeusOptions(
                pso=scale_pso, bfgs=BFGSOptions(iter_bfgs=100, hessian_impl="pallas"),
                sweep_mode="per_lane"),
            exact=per_lane(5)),
        "lbfgs-scale-batched": dict(
            objective="ackley", dim=128, seed=1,
            opts=ZeusOptions(pso=scale_pso, bfgs=BFGSOptions(iter_bfgs=100),
                             solver="lbfgs", sweep_mode="batched"),
            must=("fused_value", "fused_value_grad"),
            exact=lambda res: {"pso_step_update": 5}),
        "lbfgs-scale-per_lane": dict(
            objective="ackley", dim=128, seed=1,
            opts=ZeusOptions(pso=scale_pso, bfgs=BFGSOptions(iter_bfgs=100),
                             solver="lbfgs", sweep_mode="per_lane"),
            exact=lambda res: {"pso_step_update": 5}),
        "wolfe-paper": dict(
            objective="rastrigin", dim=5, seed=0,
            opts=ZeusOptions(
                pso=paper_pso,
                bfgs=dataclasses.replace(paper_bfgs, hessian_impl="pallas",
                                         linesearch="wolfe"),
                lane_chunk=512, sweep_mode="per_lane"),
            exact=per_lane(8)),
        "meanfield": dict(
            objective="rastrigin", dim=8, seed=2,
            opts=ZeusOptions(
                phase1="meanfield",
                meanfield=MeanFieldPSOOptions(n_particles=2**20, iter_pso=5),
                bfgs=BFGSOptions(iter_bfgs=100, theta=1e-4, required_c=1000),
                lane_chunk=131072, sweep_mode="batched"),
            must=("fused_value", "fused_value_grad", "guarded_update_direction",
                  "direction"),
            exact=lambda res: {"meanfield_step_update": 5}),
        "sequential": dict(
            objective="rastrigin", dim=5, seed=3, sequential=True,
            opts=ZeusOptions(
                pso=PSOOptions(n_particles=64, iter_pso=8),
                bfgs=dataclasses.replace(paper_bfgs, hessian_impl="pallas",
                                         sweep_mode="per_lane")),
            must=("bfgs_update", "direction")),
        "megakernel-paper": dict(
            objective="rastrigin", dim=5, seed=0, compare="megakernel",
            opts=ZeusOptions(pso=paper_pso, bfgs=paper_bfgs, lane_chunk=512,
                             sweep_mode="megakernel"),
            exact=megakernel(8, 4, full=True)),
        "megakernel-scale": dict(
            objective="ackley", dim=128, seed=1, compare="megakernel",
            opts=ZeusOptions(pso=scale_pso, bfgs=BFGSOptions(iter_bfgs=100),
                             sweep_mode="megakernel"),
            exact=megakernel(5, 1, full=True)),
        "megakernel-ladder-scale": dict(
            objective="ackley", dim=128, seed=1, compare="megakernel",
            opts=ZeusOptions(pso=scale_pso, bfgs=BFGSOptions(iter_bfgs=100, ladder_len=4),
                             sweep_mode="megakernel"),
            must=("fused_value",), exact=megakernel(5, 1, full=False)),
        # the sweep schedules: each solve must equal its static counterpart
        "compact-scale": dict(
            objective="ackley", dim=128, seed=1, equals="scale",
            opts=ZeusOptions(pso=scale_pso, bfgs=BFGSOptions(iter_bfgs=100),
                             sweep_mode="batched", compact_every=1),
            must=BATCHED_KERNELS, exact=lambda res: {"pso_step_update": 5}),
        "repack-paper": dict(
            objective="rastrigin", dim=5, seed=0, equals="paper",
            opts=ZeusOptions(pso=paper_pso, bfgs=paper_bfgs, lane_chunk=512,
                             sweep_mode="batched", repack_every=1, compact_every=1),
            must=BATCHED_KERNELS, exact=lambda res: {"pso_step_update": 8}),
        "auto-megakernel-scale": dict(
            objective="ackley", dim=128, seed=1, equals="megakernel-scale", replay=True,
            opts=ZeusOptions(pso=scale_pso, bfgs=BFGSOptions(iter_bfgs=100),
                             sweep_mode="megakernel", schedule="auto"),
            may=("fused_value", "sweep_megakernel_full", "sweep_megakernel_commit"),
            exact=lambda res: {"guarded_update_direction": 0, "fused_value_grad": 1,
                               "direction": 1, "pso_step_update": 5},
            check=auto_megakernel),
        # the paper's application, in float32 (fit_dijet.py's settings)
        "dijet": dict(
            dijet=True, dim=4, seed=3,
            opts=ZeusOptions(pso=PSOOptions(n_particles=512, iter_pso=10),
                             bfgs=BFGSOptions(iter_bfgs=300, theta=1e-2, required_c=32,
                                              ad_mode="forward"),
                             sweep_mode="batched"),
            must=("guarded_update_direction",),
            exact=lambda res: {"direction": 1, "pso_step_update": 10}),
    }


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------
def time_ms(fn, target_ms=200.0) -> float:
    """Mean ms per call over a CUDA-event-timed run of back-to-back calls
    (after warm-up), sized to about target_ms."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    reps = max(5, min(500, int(target_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(kernel_out, plain_out, rtol=RTOL, atol=ATOL):
    """(max_abs_err, max_rel_err, ok) of kernel vs plain on finite entries;
    non-finite entries must agree in position and kind."""
    import torch

    k, p = kernel_out.double(), plain_out.double()
    same_nonfinite = torch.equal(torch.isnan(k), torch.isnan(p)) and torch.equal(
        torch.isinf(k) & ~torch.isnan(k), torch.isinf(p) & ~torch.isnan(p))
    fin = torch.isfinite(p) & torch.isfinite(k)
    if not bool(fin.any()):
        return 0.0, 0.0, same_nonfinite
    err = (k - p).abs()[fin]
    ref = p.abs()[fin]
    scale = max(1.0, float(ref.max()))
    ok = bool((err <= atol * scale + rtol * ref).all()) and same_nonfinite
    # relative error over entries of at least 1e-3 of the largest
    return float(err.max()), float((err / ref.clamp_min(1e-3 * scale)).max()), ok


def kernel_cases(solve, name, dim, gen, dtype=None):
    """The kernels' inputs at the shapes this solve gives them: the Armijo
    ladder (K·C rows), the commit value+grad (C rows), the first direction
    (C lanes) and the PSO step (N particles), C being the lane chunk; in
    `dtype` (float32 unless given), in the objective's box."""
    import torch
    from repro_torch.core import get_objective

    dtype = torch.float32 if dtype is None else dtype
    obj = get_objective(name)
    n = solve["opts"].pso.n_particles
    C = solve["opts"].lane_chunk or n

    def box(*shape):
        return obj.lower + (obj.upper - obj.lower) * torch.rand(
            shape, generator=gen, device="cuda", dtype=dtype)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)

    ladder = box(K_LADDER * C, dim)
    ladder[0].zero_()  # ackley's origin row: f finite, gradient NaN
    A = 0.1 * normal(C, dim, dim) / math.sqrt(dim)
    H = torch.eye(dim, device="cuda", dtype=dtype) + 0.5 * (A + A.transpose(1, 2))
    return dict(
        ladder=ladder, commit=box(C, dim).contiguous(), H=H.contiguous(),
        g_new=normal(C, dim),
        pso=[box(n, dim), normal(n, dim), box(n, dim), box(dim),
             torch.rand(n, dim, generator=gen, device="cuda", dtype=dtype),
             torch.rand(n, dim, generator=gen, device="cuda", dtype=dtype)],
    )


def bounds(kname, case, dim, objective):
    """(bound_ms, bound_by): the larger of bytes over 3.35 TB/s and fp32
    operations over 67 TFLOP/s, each input read once and each output
    written once; a transcendental counts as one operation."""
    return larger(*bytes_ops_ms(kname, case, dim, objective))


def larger(t_bytes, t_ops):
    """(bound_ms, bound_by) from the two times."""
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bytes_ops_ms(kname, case, dim, objective):
    """(bytes ms, operations ms) of B1a, B1b, B3 or B4 on `case`, in the
    case's element type: its bytes over 3.35 TB/s, its operations over the
    type's peak (fp32 67, fp64 34 TFLOP/s)."""
    import torch

    t = case["H"] if "H" in case else case["ladder"]
    f4 = t.element_size()
    peak = FP64_OPS_PER_S if t.dtype is torch.float64 else FP32_OPS_PER_S
    if kname in ("fused_value", "fused_value_grad"):
        N = case["ladder" if kname == "fused_value" else "commit"].shape[0]
        nbytes = N * dim * f4 + N * f4
        per_elem = {"sphere": 2, "rastrigin": 6, "rosenbrock": 8, "ackley": 5}[objective]
        ops = N * dim * per_elem
        if kname == "fused_value_grad":
            nbytes += N * dim * f4
            ops += N * dim * {"sphere": 1, "rastrigin": 5, "rosenbrock": 9,
                              "ackley": 6}[objective]
    elif kname == "direction":
        B = case["H"].shape[0]
        nbytes = B * dim * dim * f4 + 2 * B * dim * f4
        ops = 2 * B * dim * dim
    else:  # pso_step_update
        N = case["pso"][0].shape[0]
        nbytes = 7 * N * dim * f4 + dim * f4
        ops = 11 * N * dim
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3


def swarm_cases(gen):
    """Inputs of B6 at the mean-field solve's shape (2^20 × 8) and at a
    ragged row count, with an inf in row 3 and a NaN in row 7."""
    import torch

    def swarm(N, D):
        x = 5.12 * (2.0 * torch.rand(N, D, generator=gen, device="cuda") - 1.0)
        x[3, 1] = float("inf")
        x[7, 0] = float("nan")
        return dict(x=x, v=torch.randn(N, D, generator=gen, device="cuda"),
                    xbar=torch.randn(D, generator=gen, device="cuda"),
                    xi=torch.randn(N, D, generator=gen, device="cuda"))

    return {"meanfield": swarm(2**20, 8), "meanfield-ragged": swarm(MEANFIELD_RAGGED_N, 8)}


def meanfield_bounds(case):
    """bounds() for B6, from the case's shapes."""
    N, D = case["x"].shape
    nbytes = 5 * N * D * 4 + D * 4
    ops = 8 * N * D  # d, w·v, λ·d, σ·d, ·ξ, two adds, x + v'
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def update_cases(gen, shapes=UPDATE_SHAPES, dtype=None):
    """Inputs of B2, B7a and B7b at UPDATE_SHAPES: H = I + a small symmetric
    term and g' for all three; for B2 (guarded) every seventh lane frozen
    (ρ = 0, δx and δg zeroed) and ρ = 1/δxᵀδg elsewhere; for B7a/B7b
    (unguarded) the same pairs unfrozen, lane 0 on the engine's stand-in
    pair (1, …, 1). In `dtype` (float32 unless given)."""
    import torch
    from repro_torch.kernels import ops

    dtype = torch.float32 if dtype is None else dtype

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)

    smem_dim = ops.update_smem_dim(dtype)
    cases = {}
    for label, B, D in shapes:
        if D is None:
            D = smem_dim if label == "single-read edge" else smem_dim + 1
        A = 0.1 * normal(B, D, D) / math.sqrt(D)
        H = torch.eye(D, device="cuda", dtype=dtype) + 0.5 * (A + A.transpose(1, 2))
        dx = normal(B, D)
        dg = dx * (1.0 + torch.rand(B, D, generator=gen, device="cuda", dtype=dtype))
        frozen = torch.arange(B, device="cuda") % 7 == 0  # the guard's ρ = 0 lanes
        rho = torch.where(frozen, 0.0, 1.0 / torch.sum(dx * dg, dim=-1))
        udx, udg = dx.clone(), dg.clone()
        udx[0] = 1.0
        udg[0] = 1.0
        cases[label] = dict(
            H=H.contiguous(), g_new=normal(B, D), frozen=frozen, rho=rho.contiguous(),
            dx=torch.where(frozen[:, None], 0.0, dx), dg=torch.where(frozen[:, None], 0.0, dg),
            udx=udx, udg=udg)
    return cases


def update_calls(c):
    """kernel name -> (CUDA wrapper, plain version, arguments) for an
    update case."""
    from repro_torch.kernels import bfgs_update as bu

    guarded = (c["H"], c["dx"], c["dg"], c["g_new"], c["rho"])
    unguarded = (c["H"], c["udx"], c["udg"])
    return {
        "guarded_update_direction": (bu.guarded_update_direction_cuda,
                                     bu.guarded_update_direction_plain, guarded),
        "bfgs_update": (bu.bfgs_update_cuda, bu.bfgs_update_plain, unguarded),
        "bfgs_update_direction": (bu.update_direction_cuda, bu.update_direction_plain,
                                  unguarded + (c["g_new"],)),
    }


def update_bounds(kname, B, D, f4=4, peak=FP32_OPS_PER_S):
    """bounds() for B2, B7a and B7b at B lanes of D: read H, δx, δg, write H';
    u = Hδg, s, and 8 ops an entry of H'; B2 also reads g' and ρ and writes
    p' (2·D² more ops), B7a reduces δxᵀδg, B7b does both. Elements of f4
    bytes, operations at `peak`."""
    return larger(*update_bytes_ops_ms(kname, B, D, f4, peak))


def update_bytes_ops_ms(kname, B, D, f4=4, peak=FP32_OPS_PER_S):
    """(bytes ms, operations ms) of update_bounds."""
    if kname == "guarded_update_direction":
        nbytes = 2 * B * D * D * f4 + 4 * B * D * f4 + B * f4
        ops = B * (12 * D * D + 2 * D)
    else:
        nbytes = 2 * B * D * D * f4 + 2 * B * D * f4
        ops = B * (10 * D * D + 4 * D)
        if kname == "bfgs_update_direction":
            nbytes += 2 * B * D * f4  # read g', write p'
            ops += 2 * B * D * D
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3


def bitwise_equal(a, b) -> bool:
    import torch

    bits = torch.int64 if a.element_size() == 8 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(bits), b.view(bits))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def check_kernels(cases_by_solve, solve_cfg):
    """Phase 3: every kernel against its plain version on the card."""
    import torch
    from repro_torch.kernels import direction, fused_obj, pso_step

    errors = {}
    for sname, case in cases_by_solve.items():
        objective, dim = solve_cfg[sname]["objective"], solve_cfg[sname]["dim"]
        results = {}
        # B1a/B1b at the ladder and commit shapes, for this solve's objective
        # and, at the ladder shape, for all four (both variants, bitwise f)
        for obj_name in fused_obj.FUSED_OBJECTIVES:
            x = case["ladder"]
            fk, _ = fused_obj.value_grad_cuda(obj_name, x, with_grad=False)
            fkg, gk = fused_obj.value_grad_cuda(obj_name, x, with_grad=True)
            fp, gp = fused_obj.value_grad_plain(obj_name, x)
            require(torch.equal(fk.view(torch.int32), fkg.view(torch.int32)),
                    f"{sname}/{obj_name}: value-only f is not bitwise equal to "
                    "value+grad f")
            ea = compare(fk, fp)
            eb = compare(gk, gp)
            require(ea[2] and eb[2], f"{sname}/{obj_name}: fused kernel disagrees "
                    f"with plain (f {ea[:2]}, g {eb[:2]})")
            print(f"check {sname} {obj_name:10s} ladder N={x.shape[0]} D={dim}: "
                  f"f abs/rel {ea[0]:.3g}/{ea[1]:.3g}, g abs/rel {eb[0]:.3g}/{eb[1]:.3g},"
                  f" value-only f bitwise equal")
            if obj_name == "ackley":
                require(bool(torch.isnan(gk[0]).all()) and bool(torch.isfinite(fkg[0])),
                        f"{sname}: ackley gradient at the origin is not NaN")
            if obj_name == objective:
                results["fused_value"] = ea
        fk, gk = fused_obj.value_grad_cuda(objective, case["commit"])
        fp, gp = fused_obj.value_grad_plain(objective, case["commit"])
        ea, eb = compare(fk, fp), compare(gk, gp)
        require(ea[2] and eb[2], f"{sname}: fused_value_grad disagrees")
        results["fused_value_grad"] = (max(ea[0], eb[0]), max(ea[1], eb[1]), True)

        e = compare(direction.direction_cuda(case["H"], case["g_new"]),
                    direction.direction_plain(case["H"], case["g_new"]))
        require(e[2], f"{sname}: direction disagrees {e[:2]}")
        results["direction"] = e

        xk, vk = pso_step.pso_step_cuda(*case["pso"], 0.5, 1.2, 1.5)
        xp, vp = pso_step.pso_step_plain(*case["pso"], 0.5, 1.2, 1.5)
        ex, ev = compare(xk, xp), compare(vk, vp)
        require(ex[2] and ev[2], f"{sname}: pso_step disagrees")
        results["pso_step_update"] = (max(ex[0], ev[0]), max(ex[1], ev[1]), True)

        torch.cuda.synchronize()
        for k, (abs_e, rel_e, _) in results.items():
            print(f"check {sname} {k}: max_abs_err={abs_e:.3g} max_rel_err={rel_e:.3g}")
        errors[sname] = results
    return errors


def fused_layout(D, dtype=None) -> str:
    """B1a/B1b's variant and row layout at D, as ops.fused_obj_variant,
    fused_obj_row_threads, fused_obj_tile_rows and fused_obj_stages give
    them (in float32 unless `dtype` is given)."""
    from repro_torch.kernels import ops

    if not hasattr(ops, "fused_obj_variant"):  # a tree from before the variants (--fused)
        return "before the variants by D"
    kw = {} if dtype is None else {"dtype": dtype}
    variant = ops.fused_obj_variant(D, **kw)
    if variant == "rows":
        P = ops.fused_obj_row_threads(D)
        return f"rows: {P} thread{'s' if P > 1 else ''} a row, {32 // P} rows a warp"
    if variant == "staged":
        return (f"staged: a warp a row, tiles of {ops.fused_obj_tile_rows(D, **kw)} rows "
                f"in a ring of {ops.fused_obj_stages(D, **kw)} stages")
    return "direct: a warp a row from device memory"


def fused_inputs(name, rows, D, offset, gen, dtype=None):
    """`rows` × D starts in the objective's box, row 0 at the origin, as a
    contiguous view `offset` elements into a buffer (float32 unless `dtype`
    is given)."""
    import torch
    from repro_torch.core import get_objective

    dtype = torch.float32 if dtype is None else dtype
    obj = get_objective(name)
    buf = torch.empty(rows * D + offset, device="cuda", dtype=dtype)
    x = buf[offset:].view(rows, D)
    x.copy_(obj.lower + (obj.upper - obj.lower) * torch.rand(
        rows, D, generator=gen, device="cuda", dtype=dtype))
    x[0] = 0.0
    return x


def check_fused_dims(gen):
    """Phase 3, B1a and B1b at every D in FUSED_DIMS, for all four objectives,
    at FUSED_ROWS rows and at fused_ragged_rows(D) rows from each of
    FUSED_OFFSETS: within RTOL/ATOL of the plain version, value-only f ==
    value+grad f bitwise, and ackley's gradient NaN at the origin (row 0)
    with a finite f there."""
    import torch
    from repro_torch.kernels import fused_obj

    for D in FUSED_DIMS:
        layouts = [(FUSED_ROWS, 0)] + [(fused_ragged_rows(D), o) for o in FUSED_OFFSETS]
        for rows, offset in layouts:
            worst_f = worst_g = 0.0
            for name in fused_obj.FUSED_OBJECTIVES:
                x = fused_inputs(name, rows, D, offset, gen)
                fk, _ = fused_obj.value_grad_cuda(name, x, with_grad=False)
                fkg, gk = fused_obj.value_grad_cuda(name, x)
                fp, gp = fused_obj.value_grad_plain(name, x)
                where = f"B1 D={D} N={rows} offset {offset} {name}"
                require(bitwise_equal(fk, fkg), f"{where}: value-only f is not bitwise "
                        "equal to value+grad f")
                ea, eb = compare(fk, fp), compare(gk, gp)
                require(ea[2] and eb[2], f"{where}: fused kernel disagrees with plain "
                        f"(f {ea[:2]}, g {eb[:2]})")
                if name == "ackley":
                    require(bool(torch.isnan(gk[0]).all()) and bool(torch.isfinite(fkg[0])),
                            f"{where}: ackley gradient at the origin is not NaN")
                worst_f, worst_g = max(worst_f, ea[0]), max(worst_g, eb[0])
                del x, fk, fkg, gk, fp, gp
            torch.cuda.synchronize()
            print(f"check B1 N={rows} D={D} offset {offset} ({fused_layout(D)}), all four "
                  f"objectives: max_abs_err f {worst_f:.3g} g {worst_g:.3g}; value-only f == "
                  "value+grad f bitwise; ackley's gradient NaN at the origin")


def check_trig():
    """Phase 3: the fast cosine and sine that B1a/B1b and B5/B5b take
    (objective.cuh trig_fast_path) bitwise equal to cosf and sinf on every
    float t with |t| < 105615, the fast path's range: 2·bits(105615) of them."""
    import numpy as np
    from repro_torch.kernels import fused_obj

    t0 = time.perf_counter()
    n_cos, n_sin, n = fused_obj.trig_check_cuda()
    want = 2 * int(np.float32(105615.0).view(np.uint32))
    require(n == want, f"trig check compared {n} floats, expected {want}")
    require(n_cos == 0 and n_sin == 0, f"trig_fast_path differs from cosf on {n_cos} and "
            f"from sinf on {n_sin} of {n} floats")
    print(f"check trig_fast_path: bitwise equal to cosf and sinf on all {n} floats with "
          f"|t| < 105615 ({time.perf_counter() - t0:.3f} s)")


def check_updates(cases):
    """Phase 3, B2, B7a and B7b at every update shape, each in the variant
    its D selects: against the plain versions; H' == H bitwise on the ρ = 0
    lanes (B2); B7b's H' == B7a's bitwise; the stand-in lane finite (B7a);
    and ALONE_LANES lanes launched alone bitwise equal to the same lanes
    inside the full batch (all three)."""
    import torch
    from repro_torch.kernels import ops

    errors = {}
    for label, c in cases.items():
        B, D = c["g_new"].shape
        variant = ops.update_variant(D)
        lo = max(0, min(5, B - ALONE_LANES))  # off the small variant's 8-lane blocks
        alone = slice(lo, min(B, lo + ALONE_LANES))
        outs = {}
        for kname, (kern, plain, args) in update_calls(c).items():
            got = kern(*args)
            want = plain(*args)
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            errs = [compare(k, p) for k, p in zip(got, want)]
            require(all(e[2] for e in errs), f"update {label} ({variant}): {kname} "
                    f"disagrees with plain {[e[:2] for e in errs]}")
            errors[kname, label] = (max(e[0] for e in errs), max(e[1] for e in errs), True)
            sub = kern(*(t[alone].contiguous() for t in args))
            sub = sub if isinstance(sub, tuple) else (sub,)
            require(all(bitwise_equal(k[alone], part) for k, part in zip(got, sub)),
                    f"update {label} ({variant}): {kname} of lanes {lo}..{alone.stop - 1}"
                    " alone differs from the same lanes in the batch")
            outs[kname] = got
            del want
        frozen = c["frozen"]
        require(bitwise_equal(outs["guarded_update_direction"][0][frozen], c["H"][frozen]),
                f"update {label} ({variant}): H' != H bitwise on rho = 0 lanes")
        require(bitwise_equal(outs["bfgs_update_direction"][0], outs["bfgs_update"][0]),
                f"update {label} ({variant}): update_direction H' != bfgs_update H'")
        require(bool(torch.isfinite(outs["bfgs_update"][0][0]).all()),
                f"update {label} ({variant}): stand-in lane not finite")
        del outs
        torch.cuda.synchronize()
        print(f"check update {label} B={B} D={D} ({variant}): max_abs_err "
              + ", ".join(f"{k} {errors[k, label][0]:.3g}" for k in UPDATE_KERNELS)
              + f"; H' == H bitwise on {int(frozen.sum())} rho = 0 lanes; B7b H' == B7a "
              f"H' bitwise; stand-in lane finite; lanes {lo}..{alone.stop - 1} alone =="
              " in batch bitwise")
    return errors


def solves_f64():
    """The float64 cells of phase 4: paper, scale and dijet with
    dtype="float64", each launching only the float64 kernels, exactly as
    often as the batched sweep fixes: per chunk-step one B1a (the ladder),
    one B1b (the commit) and one B2; at init one B1b and one B3 a chunk; B4
    iter_pso times (dijet: no B1, its NLL has no fused body)."""
    base = solves()

    def exact(pso_iters, n_chunks, fused=True):
        def counts(res):
            trips = res.raw.map_trips
            out = {"guarded_update_direction_f64": trips, "direction_f64": n_chunks,
                   "pso_step_update_f64": pso_iters}
            if fused:
                out.update(fused_value_f64=trips, fused_value_grad_f64=n_chunks + trips)
            return out
        return counts

    cells = {}
    for cell, src in F64_CELLS.items():
        cfg = {k: v for k, v in base[src].items()
               if k not in ("must", "exact", "compare", "cluster")}
        cfg["opts"] = dataclasses.replace(base[src]["opts"], dtype="float64")
        cells[cell] = cfg
    cells["paper-f64"]["exact"] = exact(8, 4)
    cells["scale-f64"]["exact"] = exact(5, 1)
    cells["dijet-f64"]["exact"] = exact(10, 1, fused=False)
    return cells


def f64_cases(solve_cfg, gen):
    """Phase 3 inputs of the float64 cells, in float64: kernel_cases at each
    cell's shapes (the dijet cell's in sphere's box: it runs no B1)."""
    import torch

    return {cell: kernel_cases(cfg, cfg.get("objective", "sphere"), cfg["dim"], gen,
                               torch.float64)
            for cell, cfg in solve_cfg.items()}


def check_f64_kernels(cases, solve_cfg):
    """Phase 3, float64: B1a/B1b (all four objectives on the ladder rows,
    value-only f == value+grad f bitwise, ackley's NaN gradient at the
    origin; the commit rows), B3 (and ALONE_LANES lanes alone bitwise equal
    to the same lanes of the batch) and B4, each against its plain version
    at TOL64, at the float64 cells' shapes. Returns {(kernel, cell): (abs,
    rel, ok)}."""
    import torch
    from repro_torch.kernels import direction, fused_obj, pso_step

    errors = {}
    for cell, case in cases.items():
        objective, dim = solve_cfg[cell].get("objective"), solve_cfg[cell]["dim"]
        if cell in F64_KERNEL_CELLS["fused_value"]:
            for obj_name in fused_obj.FUSED_OBJECTIVES:
                x = case["ladder"]
                fk, _ = fused_obj.value_grad_cuda(obj_name, x, with_grad=False)
                fkg, gk = fused_obj.value_grad_cuda(obj_name, x)
                fp, gp = fused_obj.value_grad_plain(obj_name, x)
                require(fk.dtype == torch.float64 and gk.dtype == torch.float64,
                        f"{cell}/{obj_name}: float64 B1 returned {fk.dtype}/{gk.dtype}")
                require(bitwise_equal(fk, fkg), f"{cell}/{obj_name}: float64 value-only f "
                        "is not bitwise equal to value+grad f")
                ea, eb = compare(fk, fp, TOL64, TOL64), compare(gk, gp, TOL64, TOL64)
                require(ea[2] and eb[2], f"{cell}/{obj_name}: float64 fused kernel "
                        f"disagrees with plain (f {ea[:2]}, g {eb[:2]})")
                if obj_name == "ackley":
                    require(bool(torch.isnan(gk[0]).all()) and bool(torch.isfinite(fkg[0])),
                            f"{cell}: float64 ackley gradient at the origin is not NaN")
                if obj_name == objective:
                    errors["fused_value", cell] = ea
                print(f"check {cell} {obj_name:10s} ladder N={x.shape[0]} D={dim} float64: "
                      f"f abs/rel {ea[0]:.3g}/{ea[1]:.3g}, g abs/rel {eb[0]:.3g}/{eb[1]:.3g}, "
                      "value-only f bitwise equal")
                del fk, fkg, gk, fp, gp
            fk, gk = fused_obj.value_grad_cuda(objective, case["commit"])
            fp, gp = fused_obj.value_grad_plain(objective, case["commit"])
            ea, eb = compare(fk, fp, TOL64, TOL64), compare(gk, gp, TOL64, TOL64)
            require(ea[2] and eb[2], f"{cell}: float64 fused_value_grad disagrees")
            errors["fused_value_grad", cell] = (max(ea[0], eb[0]), max(ea[1], eb[1]), True)

        H, g = case["H"], case["g_new"]
        pk = direction.direction_cuda(H, g)
        e = compare(pk, direction.direction_plain(H, g), TOL64, TOL64)
        require(e[2] and pk.dtype == torch.float64, f"{cell}: float64 direction disagrees "
                f"{e[:2]}")
        alone = slice(5, 5 + ALONE_LANES)
        require(bitwise_equal(pk[alone], direction.direction_cuda(
            H[alone].contiguous(), g[alone].contiguous())),
            f"{cell}: float64 direction of {ALONE_LANES} lanes alone differs from the batch")
        errors["direction", cell] = e

        xk, vk = pso_step.pso_step_cuda(*case["pso"], 0.5, 1.2, 1.5)
        xp, vp = pso_step.pso_step_plain(*case["pso"], 0.5, 1.2, 1.5)
        ex, ev = compare(xk, xp, TOL64, TOL64), compare(vk, vp, TOL64, TOL64)
        require(ex[2] and ev[2] and xk.dtype == torch.float64,
                f"{cell}: float64 pso_step disagrees")
        errors["pso_step_update", cell] = (max(ex[0], ev[0]), max(ex[1], ev[1]), True)
        torch.cuda.synchronize()
        for (k, c), (abs_e, rel_e, _) in errors.items():
            if c == cell:
                print(f"check {cell} {k} float64: max_abs_err={abs_e:.3g} "
                      f"max_rel_err={rel_e:.3g}")
    return errors


def check_f64_fused_dims(gen):
    """Phase 3, float64 B1a and B1b at every D in F64_FUSED_DIMS for all four
    objectives, at FUSED_ROWS rows and at fused_ragged_rows(D) rows from
    each of F64_FUSED_OFFSETS doubles into a buffer: within TOL64 of the
    plain version, value-only f == value+grad f bitwise, ackley's gradient
    NaN at the origin."""
    import torch
    from repro_torch.kernels import fused_obj

    f64 = torch.float64
    for D in F64_FUSED_DIMS:
        layouts = [(FUSED_ROWS, 0)] + [(fused_ragged_rows(D), o) for o in F64_FUSED_OFFSETS]
        for rows, offset in layouts:
            worst_f = worst_g = 0.0
            for name in fused_obj.FUSED_OBJECTIVES:
                x = fused_inputs(name, rows, D, offset, gen, f64)
                fk, _ = fused_obj.value_grad_cuda(name, x, with_grad=False)
                fkg, gk = fused_obj.value_grad_cuda(name, x)
                fp, gp = fused_obj.value_grad_plain(name, x)
                where = f"B1 float64 D={D} N={rows} offset {offset} {name}"
                require(bitwise_equal(fk, fkg), f"{where}: value-only f is not bitwise "
                        "equal to value+grad f")
                ea, eb = compare(fk, fp, TOL64, TOL64), compare(gk, gp, TOL64, TOL64)
                require(ea[2] and eb[2], f"{where}: fused kernel disagrees with plain "
                        f"(f {ea[:2]}, g {eb[:2]})")
                if name == "ackley":
                    require(bool(torch.isnan(gk[0]).all()) and bool(torch.isfinite(fkg[0])),
                            f"{where}: ackley gradient at the origin is not NaN")
                worst_f, worst_g = max(worst_f, ea[0]), max(worst_g, eb[0])
                del x, fk, fkg, gk, fp, gp
            torch.cuda.synchronize()
            print(f"check B1 float64 N={rows} D={D} offset {offset} ({fused_layout(D, f64)}),"
                  f" all four objectives: max_abs_err f {worst_f:.3g} g {worst_g:.3g}; "
                  "value-only f == value+grad f bitwise; ackley's gradient NaN at the origin")


def check_f64_updates(cases):
    """Phase 3, float64 B2 at every F64_UPDATE_SHAPES shape, in the variant
    its D selects: against the plain version at TOL64, H' == H bitwise on
    the ρ = 0 lanes, and ALONE_LANES lanes launched alone bitwise equal to
    the same lanes inside the batch. Returns {(kernel, label): errors}."""
    import torch
    from repro_torch.kernels import bfgs_update as bu
    from repro_torch.kernels import ops

    errors = {}
    for label, c in cases.items():
        B, D = c["g_new"].shape
        variant = ops.update_variant(D, torch.float64)
        lo = max(0, min(5, B - ALONE_LANES))
        alone = slice(lo, min(B, lo + ALONE_LANES))
        args = (c["H"], c["dx"], c["dg"], c["g_new"], c["rho"])
        got = bu.guarded_update_direction_cuda(*args)
        want = bu.guarded_update_direction_plain(*args)
        errs = [compare(k, p, TOL64, TOL64) for k, p in zip(got, want)]
        require(all(e[2] for e in errs) and got[0].dtype == torch.float64,
                f"update float64 {label} ({variant}): B2 disagrees with plain "
                f"{[e[:2] for e in errs]}")
        errors["guarded_update_direction", label] = (max(e[0] for e in errs),
                                                     max(e[1] for e in errs), True)
        sub = bu.guarded_update_direction_cuda(*(t[alone].contiguous() for t in args))
        require(all(bitwise_equal(k[alone], part) for k, part in zip(got, sub)),
                f"update float64 {label} ({variant}): lanes {lo}..{alone.stop - 1} alone "
                "differ from the same lanes in the batch")
        frozen = c["frozen"]
        require(bitwise_equal(got[0][frozen], c["H"][frozen]),
                f"update float64 {label} ({variant}): H' != H bitwise on rho = 0 lanes")
        del got, want, sub
        torch.cuda.synchronize()
        print(f"check update float64 {label} B={B} D={D} ({variant}): max_abs_err "
              f"{errors['guarded_update_direction', label][0]:.3g}; H' == H bitwise on "
              f"{int(frozen.sum())} rho = 0 lanes; lanes {lo}..{alone.stop - 1} alone == "
              "in batch bitwise")
    return errors


def check_f64_refusals():
    """Phase 4g: every float64 path still to port (ROADMAP A19b) raises
    NotImplementedError naming A19b on the card, as on the CPU, before any
    kernel launches."""
    import torch
    from repro_torch.core import (BatchedDenseBFGS, EngineOptions, MeanFieldPSOOptions,
                                  PSOOptions, ZeusOptions, get_objective, open_multistart,
                                  run_multistart, sequential_zeus, zeus)
    from repro_torch.core.bfgs import serial_bfgs
    from repro_torch.kernels import ops
    from repro_torch.launch.faults import FaultPlan
    from repro_torch.serve.service import ProblemRegistry

    obj = get_objective("sphere")
    x0 = torch.zeros((4, 2), dtype=torch.float64, device="cuda")

    def solve(**kw):
        opts = ZeusOptions(pso=PSOOptions(n_particles=8, iter_pso=1), dtype="float64", **kw)
        return lambda: zeus(obj.fn, 2, obj.lower, obj.upper, opts, device="cuda")

    paths = {
        "megakernel": solve(sweep_mode="megakernel"),
        "per_lane": solve(sweep_mode="per_lane"),
        "lbfgs": solve(solver="lbfgs"),
        "meanfield": solve(phase1="meanfield",
                           meanfield=MeanFieldPSOOptions(n_particles=8, iter_pso=1)),
        "ladder_len": solve(ladder_len=4),
        "compact_every": solve(compact_every=1),
        "repack_every": solve(repack_every=1, lane_chunk=4),
        "schedule": solve(schedule="auto"),
        "retry": solve(retry_budget=1),
        "fault_plan": solve(fault_plan=FaultPlan(preempt_at_sweep=3)),
        "checkpoint": solve(checkpoint_every=2, checkpoint_dir="unused"),
        "resume": lambda: zeus(obj.fn, 2, obj.lower, obj.upper,
                               ZeusOptions(dtype="float64"), device="cuda", resume="unused"),
        "engine megakernel": lambda: run_multistart(
            obj.fn, x0, BatchedDenseBFGS(), EngineOptions(sweep_mode="megakernel"),
            device="cuda"),
        "sequential_zeus": lambda: sequential_zeus(
            obj.fn, 0, 2, -1.0, 1.0, ZeusOptions(dtype="float64"), device="cuda"),
        "serial_bfgs": lambda: serial_bfgs(obj.fn, x0[0], device="cuda"),
        "open_multistart": lambda: open_multistart(
            obj.fn, x0, BatchedDenseBFGS(), EngineOptions(lane_deadlines=True),
            device="cuda"),
        "service": lambda: ProblemRegistry().register("s", "sphere", 2,
                                                      ZeusOptions(dtype="float64")),
    }
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for name, call in paths.items():
        try:
            call()
        except NotImplementedError as e:
            require("A19b" in str(e), f"float64 {name}: the refusal does not name A19b: {e}")
        else:
            raise SmokeFailure(f"float64 {name} ran instead of raising NotImplementedError")
    torch.cuda.synchronize()
    launched = {k: n for k, n in ops.launch_counts().items() if n}
    require(not launched, f"a refused float64 path launched kernels: {launched}")
    print(f"check float64 refusals: all {len(paths)} A19b paths raise NotImplementedError "
          "naming A19b on the card, no kernel launched")


def time_f64_kernels(cases, upd_cases, solve_cfg):
    """Phase 5, float64: each kernel at each of its F64_KERNEL_CELLS, kernel
    and plain version in turns (plain, kernel, kernel, plain), beside both
    bounds (bytes at 8 bytes an element over 3.35 TB/s, operations over
    fp64's 34 TFLOP/s) and, for B3, torch.bmm on the same float64 inputs."""
    import torch
    from repro_torch.kernels import bfgs_update as bu
    from repro_torch.kernels import direction, fused_obj, pso_step

    timings = {}
    for cell, case in cases.items():
        objective, dim = solve_cfg[cell].get("objective"), solve_cfg[cell]["dim"]
        u = upd_cases[cell]
        uargs = (u["H"], u["dx"], u["dg"], u["g_new"], u["rho"])
        pairs = {
            "fused_value": (
                lambda: fused_obj.value_grad_cuda(objective, case["ladder"], False),
                lambda: fused_obj.value_grad_plain(objective, case["ladder"], False), None),
            "fused_value_grad": (
                lambda: fused_obj.value_grad_cuda(objective, case["commit"]),
                lambda: fused_obj.value_grad_plain(objective, case["commit"]), None),
            "guarded_update_direction": (
                lambda: bu.guarded_update_direction_cuda(*uargs),
                lambda: bu.guarded_update_direction_plain(*uargs), None),
            "direction": (
                lambda: direction.direction_cuda(case["H"], case["g_new"]),
                lambda: direction.direction_plain(case["H"], case["g_new"]),
                lambda: torch.bmm(case["H"], case["g_new"][:, :, None])),
            "pso_step_update": (
                lambda: pso_step.pso_step_cuda(*case["pso"], 0.5, 1.2, 1.5),
                lambda: pso_step.pso_step_plain(*case["pso"], 0.5, 1.2, 1.5), None),
        }
        for kname, (kern, plain, lib) in pairs.items():
            if cell not in F64_KERNEL_CELLS[kname]:
                continue
            p1, k1, k2, p2 = time_ms(plain), time_ms(kern), time_ms(kern), time_ms(plain)
            lib_ms = time_ms(lib) if lib is not None else None
            if kname == "guarded_update_direction":
                B, D = u["g_new"].shape
                t_bytes, t_ops = update_bytes_ops_ms(kname, B, D, 8, FP64_OPS_PER_S)
            else:
                t_bytes, t_ops = bytes_ops_ms(kname, case, dim, objective)
            bound_ms, bound_by = larger(t_bytes, t_ops)
            timings[kname, cell] = dict(ms=min(k1, k2), plain_ms=min(p1, p2),
                                        library_ms=lib_ms, bound_ms=bound_ms,
                                        bound_by=bound_by, bytes_ms=t_bytes, ops_ms=t_ops)
            print(f"time {cell} {kname} float64: kernel {k1:.4f}/{k2:.4f} ms, plain "
                  f"{p1:.4f}/{p2:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; bytes "
                  f"{t_bytes:.4f}, fp64 operations {t_ops:.4f})"
                  + (f", torch.bmm {lib_ms:.4f} ms" if lib_ms is not None else ""))
    return timings


def f64_entries(launches, errors, timings, solve_cfg):
    """The float64 kernels' entries of the kernels line."""
    import torch
    from repro_torch.kernels import ops

    entries = []
    for kname, cells in F64_KERNEL_CELLS.items():
        source, replaces = SOURCES[kname]
        for cell in cells:
            t = timings[kname, cell]
            entries.append(dict(
                name=f"{kname}_f64/{cell}", route="cuda", source=source, replaces=replaces,
                dtype="float64", launches=launches[cell][f"{kname}_f64"],
                max_abs_err=errors[kname, cell][0], ms=t["ms"], plain_ms=t["plain_ms"],
                bound_ms=t["bound_ms"], bound_by=t["bound_by"], bytes_ms=t["bytes_ms"],
                ops_ms=t["ops_ms"], library_ms=t["library_ms"]))
            dim = solve_cfg[cell]["dim"]
            if kname in ("fused_value", "fused_value_grad"):
                entries[-1]["variant"] = ops.fused_obj_variant(dim, torch.float64)
                entries[-1]["layout"] = f"{fused_layout(dim, torch.float64)} at D = {dim}"
            elif kname == "guarded_update_direction":
                entries[-1]["variant"] = ops.update_variant(dim, torch.float64)
    return entries


def float64_phases(gen):
    """Phases 3, 4, 4c and 5 of the float64 path (ROADMAP A19a). Returns the
    kernels line's float64 entries and the cells' launch counts."""
    import torch

    cfg = solves_f64()
    cases = f64_cases(cfg, gen)
    errors = check_f64_kernels(cases, cfg)
    check_f64_fused_dims(gen)
    upd_cases = update_cases(torch.Generator(device="cuda").manual_seed(64),
                             F64_UPDATE_SHAPES, torch.float64)
    errors.update(check_f64_updates(upd_cases))
    check_f64_refusals()
    launches, _, _ = run_solves(cfg)  # phase 4, the float64 cells
    profile_solves(cfg)  # phase 4c
    timings = time_f64_kernels(cases, upd_cases, cfg)  # phase 5
    entries = f64_entries(launches, errors, timings, cfg)
    del cases, upd_cases
    torch.cuda.empty_cache()
    return entries, launches


def check_meanfield_step(cases):
    """Phase 3, B6 against its plain version in both noise modes."""
    import torch
    from repro_torch.kernels import meanfield_step

    errors = {}
    for cell in ("meanfield", "meanfield-ragged"):
        c = cases[cell]
        worst = 0.0
        for noise in meanfield_step.NOISE_MODES:
            args = (c["x"], c["v"], c["xbar"], c["xi"], 0.5, 1.2, 0.3, noise)
            outs = meanfield_step.meanfield_step_cuda(*args)
            plains = meanfield_step.meanfield_step_plain(*args)
            for k, p in zip(outs, plains):
                e = compare(k, p)
                require(e[2], f"{cell} {noise}: meanfield_step disagrees {e[:2]}")
                worst = max(worst, e[0])
                if noise == "anisotropic":
                    fin = torch.isfinite(p)
                    require(torch.equal(k[fin], p[fin]) and torch.equal(fin, torch.isfinite(k)),
                            f"{cell}: anisotropic meanfield_step not bitwise equal")
            print(f"check {cell} meanfield_step {noise} N={c['x'].shape[0]} D="
                  f"{c['x'].shape[1]}: max_abs_err {worst:.3g}"
                  + (", bitwise equal" if noise == "anisotropic" else ""))
        errors["meanfield_step_update", cell] = (worst, 0.0, True)
    torch.cuda.synchronize()
    return errors


def megakernel_case(objective, C, dim, gen, timed=False):
    """Inputs of B5/B5b for C lanes of D, as a sweep finds them: starts in
    the box, H = I + a small symmetric term, g = ∇f and the descent p = −Hg,
    every seventh lane frozen, lane 0 at the origin with p = 0 (ackley's
    gradient is NaN there), lane 1 uphill (p = g) so that its ladder may run
    out, and the Armijo thresholds as the staged ladder computes them."""
    import torch
    from repro_torch.core import get_objective
    from repro_torch.core.linesearch import exhaustion_alpha, ladder_thresholds
    from repro_torch.kernels import direction, fused_obj

    obj = get_objective(objective)
    X = obj.lower + (obj.upper - obj.lower) * torch.rand(
        C, dim, generator=gen, device="cuda")
    X[0] = 0.0
    F, G = fused_obj.value_grad_plain(objective, X)
    A = 0.1 * torch.randn(C, dim, dim, generator=gen, device="cuda") / math.sqrt(dim)
    H = (torch.eye(dim, device="cuda") + 0.5 * (A + A.transpose(1, 2))).contiguous()
    P = direction.direction_plain(H, torch.nan_to_num(G))
    P[0] = 0.0
    P[1] = G[1]
    active = torch.arange(C, device="cuda") % 7 != 0
    alphas, rhs = ladder_thresholds(F, G, P, 0.3, K_LADDER)
    return dict(objective=objective, X=X, P=P, G=G, H=H,
                active=active, rhs=rhs, alphas=alphas,
                exhaust=exhaustion_alpha(K_LADDER), timed=timed)


def megakernel_cases(solve_cfg, gen, cells=("megakernel-paper", "megakernel-scale"),
                     streaming=True):
    """Inputs of B5/B5b at the megakernel solves' shapes (C lanes of D, C the
    lane chunk; megakernel_case). The paper shape has one case per fused
    objective; the scale shape runs ackley, and STREAMING_CASE holds D above
    the single-read threshold."""
    from repro_torch.kernels import fused_obj

    def case(objective, C, dim, timed):
        return megakernel_case(objective, C, dim, gen, timed)

    cases = {}
    for cell in cells:
        cfg = solve_cfg[cell]
        C = cfg["opts"].lane_chunk or cfg["opts"].pso.n_particles
        names = (fused_obj.FUSED_OBJECTIVES if cell == "megakernel-paper"
                 else (cfg["objective"],))
        for objective in names:
            # the solve's own objective is the one timed
            cases[cell, objective] = case(objective, C, cfg["dim"],
                                          objective == cfg["objective"])
    if streaming:
        cell, objective, C, dim = STREAMING_CASE
        cases[cell, objective] = case(objective, C, dim, False)
    return cases


def check_megakernels(cases):
    """Phase 3, B5 and B5b: each kernel against its plain version on the
    same inputs. Rung and α must be equal but at certified knife edges, x',
    f', g' within RTOL/ATOL, H' and p' within STATE_TOL of lane scale on the
    well-conditioned lanes, H' == H bitwise on the frozen lanes. Counts the
    lanes bitwise equal to the plain version, and those whose f', g' are
    bitwise B1b's at the kernel's own x'."""
    import types

    import torch
    from repro_torch.kernels import fused_obj, ops, sweep_megakernel

    errors = {}
    for (cell, objective), c in cases.items():
        args = (objective, c["X"], c["P"], c["G"], c["H"], c["active"])
        C, dim = c["X"].shape
        variant = {full: "single-read" if dim <= ops.megakernel_smem_dim(K_LADDER, full)
                   else "streaming" for full in (True, False)}
        kf = sweep_megakernel.sweep_megakernel_full_cuda(*args, c["rhs"], c["alphas"],
                                                         c["exhaust"])
        pf = sweep_megakernel.sweep_megakernel_full_plain(*args, c["rhs"], c["alphas"],
                                                          c["exhaust"])
        odd = kf[6] != pf[6]
        for i in torch.nonzero(odd).flatten().tolist():
            r = min(int(kf[6][i]), int(pf[6][i]))
            trial = (c["X"][i] + c["alphas"][r] * c["P"][i])[None]
            f_r = fused_obj.value_grad_plain(objective, trial, with_grad=False)[0][0]
            rhs = c["rhs"][r, i]
            margin = float((f_r - rhs).abs() / max(1.0, float(rhs.abs())))
            require(margin <= KNIFE_EDGE, f"{cell}/{objective}: B5 lane {i} accepts rung "
                    f"{int(kf[6][i])} vs plain {int(pf[6][i])}, margin {margin:.3g}")
        keep = ~odd
        require(torch.equal(kf[5][keep], pf[5][keep]), f"{cell}/{objective}: B5 α differs")
        results = {}
        for kname, k, p in (("sweep_megakernel_full", kf, pf),
                            ("sweep_megakernel_commit",
                             sweep_megakernel.sweep_megakernel_commit_cuda(*args, pf[5]),
                             sweep_megakernel.sweep_megakernel_commit_plain(*args, pf[5]))):
            rows = keep if kname == "sweep_megakernel_full" else torch.ones_like(keep)
            ex, ef, eg = (compare(k[j][rows], p[j][rows]) for j in range(3))
            require(ex[2] and ef[2] and eg[2], f"{cell}/{objective}: {kname} x'/f'/g' "
                    f"disagree (x {ex[:2]}, f {ef[:2]}, g {eg[:2]})")
            frozen = ~c["active"]
            require(torch.equal(k[3][frozen], c["H"][frozen]),
                    f"{cell}/{objective}: {kname} H' != H bitwise on frozen lanes")
            pre = types.SimpleNamespace(x=c["X"], g=c["G"], direction_state=c["H"],
                                        converged=frozen, failed=torch.zeros_like(frozen))
            kl = types.SimpleNamespace(x=k[0], g=k[2], direction_state=k[3])
            # non-finite entries (the origin lane's NaN gradient and p') in
            # the same places; the rest held per lane
            require(all(torch.equal(torch.isfinite(k[j]), torch.isfinite(p[j]))
                        for j in range(5)), f"{cell}/{objective}: {kname} non-finite "
                    "entries differ")
            finite = torch.isfinite(p[3]).all(2).all(1) & torch.isfinite(p[4]).all(1)
            well = rows & finite & well_conditioned(pre, kl, types.SimpleNamespace(g=p[2]),
                                                    dim)
            eh, okh = close_per_lane(k[3][well], p[3][well])
            ep, okp = close_per_lane(k[4][well], p[4][well])
            require(okh and okp, f"{cell}/{objective}: {kname} H'/p' differ "
                    f"({eh:.3g}, {ep:.3g} of lane scale)")
            same = torch.ones(C, dtype=torch.bool, device="cuda")
            for j in range(3):
                same &= (k[j].view(torch.int32).reshape(C, -1)
                         == p[j].view(torch.int32).reshape(C, -1)).all(1)
            fb, gb = fused_obj.value_grad_cuda(objective, k[0])
            b1b = ((fb.view(torch.int32) == k[1].view(torch.int32))
                   & (gb.view(torch.int32) == k[2].view(torch.int32)).all(1))
            print(f"check {cell} {objective} {kname} C={C} D={dim} "
                  f"({variant[kname.endswith('full')]}): "
                  f"{int(odd.sum()) if kname.endswith('full') else 0} knife-edge "
                  f"rungs; max_abs_err x {ex[0]:.3g} f {ef[0]:.3g} g {eg[0]:.3g}; H'/p' "
                  f"{eh:.3g}/{ep:.3g} of lane scale on {int(well.sum())} "
                  f"well-conditioned lanes; x', f', g' bitwise equal to plain on "
                  f"{int(same.sum())} of {C} lanes; f', g' bitwise B1b's on "
                  f"{int(b1b.sum())} of {C}")
            results[kname] = (max(ex[0], ef[0], eg[0]), 0.0, True)
        if c["timed"]:
            for kname, e in results.items():
                for kcell, case_cell in MEGAKERNEL_CASE.items():
                    if case_cell == cell and kcell in KERNEL_CELLS[kname]:
                        errors[kname, kcell] = e
    torch.cuda.synchronize()
    return errors


def check_tiny_buckets(gen):
    """Phase 3, the shapes a compacted sweep's smallest buckets give the
    kernels: N = TINY_LANES lanes of D (TINY_DIMS). B1a on the N lanes'
    K-rung ladder, B1b on their rows, B2 and B5/B5b on their state, each
    against its plain version (B5/B5b and B2 by check_megakernels and
    check_updates) and bitwise equal to the same lanes inside one
    TINY_BASE-lane launch; then the sweep's own row reductions
    (torch.sum, vector_norm) at N rows against the same rows at 16384,
    printed."""
    import torch
    from repro_torch.kernels import bfgs_update as bu
    from repro_torch.kernels import fused_obj, sweep_megakernel as sm

    def bits(t):
        return t.contiguous().view(torch.int32)

    for objective, D in TINY_DIMS:
        base = megakernel_case(objective, TINY_BASE, D, gen)
        upd = update_cases(gen, shapes=(("tiny base", TINY_BASE, D),))["tiny base"]
        check_updates(update_cases(gen, shapes=tuple((f"tiny N={N}", N, D)
                                                     for N in TINY_LANES)))
        args = ("X", "P", "G", "H", "active")
        b_full = sm.sweep_megakernel_full_cuda(objective, *(base[a] for a in args),
                                               base["rhs"], base["alphas"], base["exhaust"])
        b_commit = sm.sweep_megakernel_commit_cuda(objective, *(base[a] for a in args),
                                                   b_full[5])
        ladder = (base["X"][None] + base["alphas"][:, None, None] * base["P"][None])
        b_f = fused_obj.value_grad_cuda(objective, ladder.reshape(-1, D), with_grad=False)[0]
        b_vg = fused_obj.value_grad_cuda(objective, base["X"])
        b_upd = bu.guarded_update_direction_cuda(upd["H"], upd["dx"], upd["dg"],
                                                 upd["g_new"], upd["rho"])
        for N in TINY_LANES:
            sub = dict(base, **{a: base[a][:N].contiguous() for a in args},
                       rhs=base["rhs"][:, :N].contiguous())
            check_megakernels({(f"tiny N={N}", objective): sub})
            full = sm.sweep_megakernel_full_cuda(objective, *(sub[a] for a in args),
                                                 sub["rhs"], sub["alphas"], sub["exhaust"])
            commit = sm.sweep_megakernel_commit_cuda(objective, *(sub[a] for a in args),
                                                     full[5])
            require(all(torch.equal(bits(k), bits(b[:N])) for k, b in zip(full, b_full)),
                    f"tiny N={N} D={D}: B5 differs from the same lanes in a "
                    f"{TINY_BASE}-lane launch")
            require(all(torch.equal(bits(k), bits(b[:N])) for k, b in zip(commit, b_commit)),
                    f"tiny N={N} D={D}: B5b differs from the same lanes in a "
                    f"{TINY_BASE}-lane launch")
            rows = ladder[:, :N].reshape(-1, D).contiguous()
            f = fused_obj.value_grad_cuda(objective, rows, with_grad=False)[0]
            fp = fused_obj.value_grad_plain(objective, rows, with_grad=False)[0]
            vg = fused_obj.value_grad_cuda(objective, sub["X"])
            vgp = fused_obj.value_grad_plain(objective, sub["X"])
            ea, eb, eg = compare(f, fp), compare(vg[0], vgp[0]), compare(vg[1], vgp[1])
            require(ea[2] and eb[2] and eg[2], f"tiny N={N} D={D}: B1 disagrees with plain "
                    f"(ladder f {ea[:2]}, f {eb[:2]}, g {eg[:2]})")
            require(torch.equal(bits(f.reshape(K_LADDER, N)),
                                bits(b_f.reshape(K_LADDER, TINY_BASE)[:, :N]))
                    and all(torch.equal(bits(k), bits(b[:N])) for k, b in zip(vg, b_vg)),
                    f"tiny N={N} D={D}: B1 differs from the same rows in a "
                    f"{TINY_BASE}-lane launch")
            u = bu.guarded_update_direction_cuda(*(upd[a][:N].contiguous() for a in
                                                   ("H", "dx", "dg", "g_new", "rho")))
            require(all(torch.equal(bits(k), bits(b[:N])) for k, b in zip(u, b_upd)),
                    f"tiny N={N} D={D}: B2 differs from the same lanes in a "
                    f"{TINY_BASE}-lane launch")
            print(f"check tiny N={N} D={D} {objective}: B1a ladder ({K_LADDER * N} rows) "
                  f"max_abs_err {ea[0]:.3g}, B1b {max(eb[0], eg[0]):.3g}; B1a, B1b, B2, B5, "
                  f"B5b bitwise equal to the same lanes in a {TINY_BASE}-lane launch")
    torch.cuda.synchronize()
    for D in (5, 128):
        a = torch.randn(16384, D, generator=gen, device="cuda")
        b = torch.randn(16384, D, generator=gen, device="cuda")
        s_all, n_all = torch.sum(a * b, dim=-1), torch.linalg.vector_norm(a, dim=-1)
        same = {N: (torch.equal(bits(torch.sum(a[:N] * b[:N], dim=-1)), bits(s_all[:N])),
                    torch.equal(bits(torch.linalg.vector_norm(a[:N], dim=-1)),
                                bits(n_all[:N])))
                for N in (1, 2, 3, 4, 5, 8, 15, 16, 17, 64, 1024)}
        print(f"glue D={D}: row sums / norms of N rows bitwise equal to the same rows "
              "of 16384: " + ", ".join(f"N={N} {int(x)}/{int(y)}"
                                       for N, (x, y) in same.items()))


def check_tiny_solves(gen):
    """Phase 3b: the schedules down to buckets of 1, 2, 4 and 8 lanes, end
    to end. 64 rosenbrock lanes of D, all but n at the optimum (an exactly
    zero gradient: converged at init) and n from the box (never converged
    at θ = 1e-30), spread over the four chunks of 16, 5 sweeps, in both
    batched modes: compact_every=1, repack_every=1 with compact_every=1
    (lane_chunk 16) and schedule="auto" (window 1, ladders 2 and 20, lane
    chunk 16) must each equal the static solve (auto on x, fval, grad_norm
    and status: its shorter ladders probe less)."""
    import torch
    from repro_torch.core import BatchedDenseBFGS, EngineOptions, get_objective
    from repro_torch.core import run_multistart

    obj = get_objective("rosenbrock")
    spread = torch.tensor([0, 17, 34, 51, 63], device="cuda")
    schedules = {"compact": dict(compact_every=1),
                 "repack+compact": dict(lane_chunk=16, repack_every=1, compact_every=1),
                 "auto": dict(lane_chunk=16, schedule="auto", schedule_every=1,
                              auto_ladders=(2, 0))}
    for _, D in TINY_DIMS:
        for mode in ("batched", "megakernel"):
            for n in TINY_LANES:
                x0 = torch.ones(TINY_BASE, D, device="cuda")
                x0[spread[:n]] = obj.lower + (obj.upper - obj.lower) * torch.rand(
                    n, D, generator=gen, device="cuda")

                def solve(**kw):
                    return run_multistart(obj.fn, x0, BatchedDenseBFGS(), EngineOptions(
                        iter_max=5, theta=1e-30, sweep_mode=mode, **kw), device="cuda")

                static = solve()
                rows = []
                for name, kw in schedules.items():
                    res = solve(**kw)
                    fields = SAME_FIELDS[:4] if name == "auto" else SAME_FIELDS
                    bad = same_solve(res, static, fields)
                    require(not bad, f"tiny solve D={D} {mode} n={n} {name}: {bad} differ "
                            "from the static solve")
                    rows.append(f"{name} {res.eval_rows} rows / {res.map_trips} "
                                "chunk-steps")
                print(f"check tiny solve D={D} {mode}: {n} active of {TINY_BASE}, "
                      f"{static.iterations} sweeps, each schedule == static (static "
                      f"{static.eval_rows} rows / {static.map_trips} chunk-steps; "
                      + "; ".join(rows) + ")")


def _plain_path(objective):
    """The engine's batched objective and BFGS strategy, wired to the plain
    versions instead of the kernels (for the sweep-level comparison)."""
    from repro_torch.core import BatchedDenseBFGS, BatchedObjective, get_objective
    from repro_torch.core.objectives import register_batched_vg
    from repro_torch.kernels import bfgs_update, direction, fused_obj

    name = f"{objective}/plain"
    register_batched_vg(
        name, lambda X: fused_obj.value_grad_plain(objective, X),
        lambda X: fused_obj.value_grad_plain(objective, X, with_grad=False)[0])

    class PlainDenseBFGS(BatchedDenseBFGS):
        direction_op = staticmethod(direction.direction_plain)
        update_op = staticmethod(bfgs_update.guarded_update_direction_plain)

    return BatchedObjective(get_objective(objective).fn, name=name), PlainDenseBFGS()


def close_per_lane(got, ref, tol=STATE_TOL):
    """(max error over max(1, lane's largest |ref|), ok) lane by lane."""
    import torch

    B = ref.shape[0]
    if B == 0:
        return 0.0, True
    g, r = got.reshape(B, -1).double(), ref.reshape(B, -1).double()
    scale = r.abs().amax(dim=1).clamp_min(1.0)
    worst = float(((g - r).abs().amax(dim=1) / scale).max())
    return worst, worst <= tol


def well_conditioned(pre, kl, pl, dim):
    """(B,) lanes whose H update is well enough conditioned to hold the
    kernel path's H' (and p') to the plain path's.

    H' and p' hang on the secant pair. The two paths' own rounding of g'
    moves ρ = 1/δxᵀδg by η = |δx|·|Δg'| / |δxᵀδg| (relative), and one D-term
    sum in another order moves u = Hδg by D·2⁻²⁴ of |H||δg|; H' then moves
    by about that relative perturbation times the update's terms
    2|ρ||u||δx| + (2ρ²|s| + |ρ|)|δx|², |u| and |s| taken at their
    absolute-value bounds. Where that alone exceeds a tenth of the
    tolerance, the update is too ill-conditioned to hold either path to the
    other on H' and p'."""
    import torch

    dX, dG = kl.x - pre.x, kl.g - pre.g
    curv = torch.sum(dX * dG, dim=-1)
    updated = ~(pre.converged | pre.failed) & torch.isfinite(curv) & (curv > 1e-10)
    eta = torch.where(updated, torch.linalg.vector_norm(dX, dim=-1)
                      * torch.linalg.vector_norm(kl.g - pl.g, dim=-1) / curv, 0.0)
    pert = torch.clamp(eta, min=dim * 2.0 ** -24)
    u_abs = torch.sum(pre.direction_state.abs() * dG.abs()[:, None, :], dim=-1)
    s_abs = torch.sum(dG.abs() * u_abs, dim=-1)
    rho = torch.where(updated, 1.0 / curv, 0.0).abs()
    dxm = dX.abs().amax(dim=-1)
    terms = 2 * rho * u_abs.amax(dim=-1) * dxm + (2 * rho * rho * s_abs + rho) * dxm * dxm
    scale = kl.direction_state.abs().amax(dim=(1, 2)).clamp_min(1.0)
    return ~(pert * terms / scale > 0.1 * STATE_TOL)


def compare_sweeps(sname, cfg):
    """Phase 4b: the first sweeps of the solve, each taken from the kernel
    path's exact state two ways: for a batched solve through the kernels and
    through the plain versions; for a megakernel solve through the
    megakernel (B5, or the adaptive ladder and B5b) and through the staged
    kernels (B1a, B1b, B2), counting the lanes whose x', f' and g' come out
    bitwise equal."""
    import torch
    from repro_torch.core import (BatchedDenseBFGS, as_batched, batch_lanes_init,
                                  batch_lanes_step, get_objective, phase2_setup,
                                  run_pso)
    from repro_torch.core.engine import megakernel_lanes_step
    from repro_torch.core.linesearch import armijo_thresholds, ladder_alphas

    obj = get_objective(cfg["objective"])
    opts = cfg["opts"]
    gen = torch.Generator(device="cuda").manual_seed(cfg["seed"])
    starts = run_pso(obj.fn, cfg["dim"], obj.lower, obj.upper, opts.pso,
                     device="cuda", generator=gen).x
    _, eopts = phase2_setup(opts)
    k_bobj, k_strat = as_batched(obj.fn), BatchedDenseBFGS()
    mega = cfg["compare"] == "megakernel"
    if mega:
        k_step, (p_bobj, p_strat) = megakernel_lanes_step, (k_bobj, k_strat)
        paths = ("megakernel", "staged kernels")
    else:
        k_step, (p_bobj, p_strat) = batch_lanes_step, _plain_path(cfg["objective"])
        paths = ("kernels", "plain")
    kl = batch_lanes_init(k_bobj, k_strat, starts, eopts.theta)
    B = starts.shape[0]
    alphas = torch.as_tensor(ladder_alphas(eopts.ls_iters, "float32"), device="cuda")
    knife = ill = bitwise = stepped = 0
    worst = {}

    def bits(t):
        return t.view(torch.int32).reshape(B, -1)

    for sweep in range(SWEEPS_COMPARED):
        pre = kl
        kl, _, k_rung = k_step(k_bobj, k_strat, eopts, pre)
        pl, _, p_rung = batch_lanes_step(p_bobj, p_strat, eopts, pre)
        odd = k_rung != p_rung
        for i in torch.nonzero(odd).flatten().tolist():
            r = min(int(k_rung[i]), int(p_rung[i]))
            P = pre.p[i] if float(pre.p[i] @ pre.g[i]) < 0 else -pre.g[i]
            rhs = armijo_thresholds(pre.f[i:i + 1], (pre.g[i] @ P)[None], alphas,
                                    eopts.ls_c1)[r, 0]
            f_r = p_bobj.value_batch((pre.x[i] + alphas[r] * P)[None])[0]
            margin = float((f_r - rhs).abs() / max(1.0, float(rhs.abs())))
            require(margin <= KNIFE_EDGE,
                    f"{sname} sweep {sweep}: lane {i} accepts rung "
                    f"{int(k_rung[i])} ({paths[0]}) vs {int(p_rung[i])} ({paths[1]}), "
                    f"Armijo margin {margin:.3g} is no knife edge")
            print(f"knife-edge accept {sname} sweep {sweep} lane {i}: rung "
                  f"{int(k_rung[i])} vs {int(p_rung[i])}, margin {margin:.3g}")
            knife += 1
        # a status flip is a knife edge only where |g| sits at Θ
        flipped = ((kl.converged != pl.converged) | (kl.failed != pl.failed)) & ~odd
        for i in torch.nonzero(flipped).flatten().tolist():
            gn = float(torch.linalg.vector_norm(kl.g[i]))
            require(abs(gn - eopts.theta) <= 1e-3 * eopts.theta,
                    f"{sname} sweep {sweep}: lane {i} status differs at |g| = {gn:.6g}")
            print(f"knife-edge status {sname} sweep {sweep} lane {i}: |g| = {gn:.6g}")
            knife += 1
        keep = ~(odd | flipped)
        if mega:
            active = ~(pre.converged | pre.failed)
            same = ((bits(kl.x) == bits(pl.x)).all(1) & (bits(kl.f) == bits(pl.f)).all(1)
                    & (bits(kl.g) == bits(pl.g)).all(1))
            bitwise += int((same & active).sum())
            stepped += int(active.sum())
        for field in ("x", "f", "g"):
            e, ok = close_per_lane(getattr(kl, field)[keep], getattr(pl, field)[keep])
            require(ok, f"{sname} sweep {sweep}: {field} differs ({e:.3g} of lane scale)")
            worst[field] = max(worst.get(field, 0.0), e)
        well = keep & well_conditioned(pre, kl, pl, cfg["dim"])
        ill += int((keep & ~well).sum())
        for field in ("p", "direction_state"):
            e, ok = close_per_lane(getattr(kl, field)[well], getattr(pl, field)[well])
            require(ok, f"{sname} sweep {sweep}: {field} differs ({e:.3g} of lane scale)")
            worst[field] = max(worst.get(field, 0.0), e)
    print(f"sweeps {sname}: {SWEEPS_COMPARED} sweeps of {B} lanes, each from the kernel "
          f"path's state, {paths[0]} vs {paths[1]}: {knife} knife-edge lane-sweeps, "
          f"rung and status equal on the rest; {ill} lane-sweeps with an "
          "ill-conditioned update not held on H'/p'; max error over lane scale "
          + ", ".join(f"{k}={v:.3g}" for k, v in worst.items())
          + (f"; x', f', g' bitwise equal on {bitwise} of {stepped} active lane-sweeps"
             if mega else ""))


def compare_per_lane_sweeps(sname, cfg):
    """Phase 4b, per-lane path: the first sweeps of the solve, each taken
    from the kernel path's exact state through B3/B7a and through their
    plain versions (the evaluators are AD on both paths)."""
    import torch
    from repro_torch.core import DenseBFGS, get_objective, phase2_setup, run_pso
    from repro_torch.core.dual import grad_eval_cost
    from repro_torch.core.engine import lane_init, lane_step, per_lane_objective
    from repro_torch.core.linesearch import ladder_alphas
    from repro_torch.kernels import bfgs_update, direction

    class PlainDenseBFGS(DenseBFGS):
        def direction(self, H, G):
            return direction.direction_plain(H, G)

        def update_state(self, H, dX, dG):
            return bfgs_update.bfgs_update_plain(H, dX, dG)

    obj = get_objective(cfg["objective"])
    opts = cfg["opts"]
    gen = torch.Generator(device="cuda").manual_seed(cfg["seed"])
    starts = run_pso(obj.fn, cfg["dim"], obj.lower, obj.upper, opts.pso,
                     device="cuda", generator=gen).x
    k_strat, eopts = phase2_setup(opts)
    require(k_strat.hessian_impl == "pallas", f"{sname}: not a B7a solve")
    p_strat = PlainDenseBFGS()
    pobj = per_lane_objective(obj.fn, eopts.ad_mode)
    vg_cost = grad_eval_cost(cfg["dim"], eopts.ad_mode)
    kl = lane_init(pobj.value_and_grad_batch, k_strat, starts, eopts.theta, eopts.ad_mode)
    alphas = torch.as_tensor(ladder_alphas(eopts.ls_iters, "float32"), device="cuda")
    knife = ill = 0
    worst = {}
    for sweep in range(SWEEPS_COMPARED):
        pre = kl
        active = ~(pre.converged | pre.failed)
        kl = lane_step(pobj.value_batch, pobj.value_and_grad_batch, k_strat, eopts, pre)
        pl = lane_step(pobj.value_batch, pobj.value_and_grad_batch, p_strat, eopts, pre)
        n_k = kl.n_evals - pre.n_evals - vg_cost  # Armijo trials per lane
        n_p = pl.n_evals - pre.n_evals - vg_cost
        odd = active & (n_k != n_p)
        for i in torch.nonzero(odd).flatten().tolist():
            alpha = alphas[min(int(n_k[i]), int(n_p[i])) - 1]
            margins = []
            for strat in (k_strat, p_strat):  # each path's own p
                P = strat.direction(pre.direction_state[i:i + 1], pre.g[i:i + 1])[0]
                P = P if float(P @ pre.g[i]) < 0 else -pre.g[i]
                rhs = pre.f[i] + eopts.ls_c1 * alpha * (pre.g[i] @ P)
                f_a = pobj.value_batch((pre.x[i] + alpha * P)[None])[0]
                margins.append(float((f_a - rhs).abs() / max(1.0, float(rhs.abs()))))
            require(max(margins) <= KNIFE_EDGE,
                    f"{sname} sweep {sweep}: lane {i} takes {int(n_k[i])} trials "
                    f"(kernels) vs {int(n_p[i])} (plain), Armijo margins {margins} are "
                    "no knife edge")
            print(f"knife-edge accept {sname} sweep {sweep} lane {i}: trials "
                  f"{int(n_k[i])} vs {int(n_p[i])}, margins {margins}")
            knife += 1
        flipped = ((kl.converged != pl.converged) | (kl.failed != pl.failed)) & ~odd
        for i in torch.nonzero(flipped).flatten().tolist():
            gn = float(torch.linalg.vector_norm(kl.g[i]))
            require(abs(gn - eopts.theta) <= 1e-3 * eopts.theta,
                    f"{sname} sweep {sweep}: lane {i} status differs at |g| = {gn:.6g}")
            print(f"knife-edge status {sname} sweep {sweep} lane {i}: |g| = {gn:.6g}")
            knife += 1
        keep = ~(odd | flipped)
        for field in ("x", "f", "g"):
            e, ok = close_per_lane(getattr(kl, field)[keep], getattr(pl, field)[keep])
            require(ok, f"{sname} sweep {sweep}: {field} differs ({e:.3g} of lane scale)")
            worst[field] = max(worst.get(field, 0.0), e)
        well = keep & well_conditioned(pre, kl, pl, cfg["dim"])
        ill += int((keep & ~well).sum())
        e, ok = close_per_lane(kl.direction_state[well], pl.direction_state[well])
        require(ok, f"{sname} sweep {sweep}: H' differs ({e:.3g} of lane scale)")
        worst["H"] = max(worst.get("H", 0.0), e)
    print(f"sweeps {sname}: {SWEEPS_COMPARED} per-lane sweeps of {starts.shape[0]} lanes, "
          f"each from the kernel path's state, kernels (B3, B7a) vs plain: {knife} "
          f"knife-edge lane-sweeps, trial counts and status equal on the rest; {ill} "
          "lane-sweeps with an ill-conditioned update not held on H'; max error over "
          "lane scale " + ", ".join(f"{k}={v:.3g}" for k, v in worst.items()))


def dijet_problem(dtype="float32"):
    """The dijet fit's data and NLL (examples/fit_dijet.py): counts drawn
    at DIJET_TRUE (the rate computed in `dtype`), the NLL over them, its
    box."""
    import numpy as np
    import torch
    from repro_torch.core.objectives import make_dijet_nll, simulate_dijet_counts

    edges = np.linspace(*DIJET_EDGES)
    counts = simulate_dijet_counts(np.asarray(DIJET_TRUE), edges, seed=DIJET_SEED,
                                   dtype=getattr(torch, dtype))
    return edges, counts, make_dijet_nll(edges, counts), (-5.0, 15.0)


def run_solve(cfg, opts=None, resume=None):
    """One solve of cfg on the card, from its seed (with `opts` in place of
    cfg's options when given; resumed from the checkpoint root `resume`)."""
    import torch
    from repro_torch.core import get_objective, sequential_zeus, zeus

    opts = cfg["opts"] if opts is None else opts
    gen = torch.Generator(device="cuda").manual_seed(cfg["seed"])
    if cfg.get("dijet"):
        _, _, nll, (lower, upper) = dijet_problem(opts.dtype)
        return zeus(nll, cfg["dim"], lower, upper, opts, device="cuda", generator=gen)
    obj = get_objective(cfg["objective"])
    if cfg.get("sequential"):
        return sequential_zeus(obj.fn, cfg["seed"], cfg["dim"], obj.lower, obj.upper,
                               cfg["opts"], device="cuda")
    return zeus(obj.fn, cfg["dim"], obj.lower, obj.upper, opts, device="cuda",
                generator=gen, resume=resume)


def check_launches(sname, cfg, res, counts):
    """The solve's kernels launched (exactly as often as the path fixes,
    where it does), and no other kernel at all."""
    exact = cfg["exact"](res) if "exact" in cfg else {}
    for k, n in counts.items():
        if k in exact:
            require(n == exact[k], f"{sname}: kernel {k} launched {n} times, expected "
                    f"{exact[k]}")
        elif k in cfg.get("must", ()):
            require(n > 0, f"{sname}: kernel {k} was not launched on the main path")
        elif k not in cfg.get("may", ()):
            require(n == 0, f"{sname}: kernel {k} launched {n} times off its path")
    if "check" in cfg:
        require(cfg["check"](res, counts), f"{sname}: launches {counts} do not fit "
                f"map_trips {res.raw.map_trips}")


def run_solves(solve_cfg):
    """Phase 4: the main paths, one solve at a time, counters read around it.
    Returns the launch counts, the results the schedule cells and phase 4e
    compare against, and every solve's warm wall."""
    import torch
    from repro_torch.core import CONVERGED
    from repro_torch.kernels import ops

    launches, warms = {}, {}
    statics = {cfg["equals"] for cfg in solve_cfg.values() if "equals" in cfg}
    kept = {}
    for sname, cfg in solve_cfg.items():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_solve(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[sname] = ops.launch_counts()
        # the same solve again, warm (the first call pays one-time set-up)
        t1 = time.perf_counter()
        run_solve(cfg)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t1
        warms[sname] = warm
        best_f = float(res.best_f)
        require(math.isfinite(best_f), f"{sname}: best_f is not finite")
        require(tuple(res.best_x.shape) == (cfg["dim"],), f"{sname}: best_x shape")
        require(res.n_converged > 0, f"{sname}: no lane converged")
        check_launches(sname, cfg, res, launches[sname])
        if cfg.get("sequential"):
            print(f"solve {sname}: wall {wall:.4f} s (warm {warm:.4f} s; in-call "
                  f"{res.wall_time_s:.4f} s), started {res.n_started}, n_converged "
                  f"{res.n_converged}, n_failed {res.n_failed}, best_f {best_f:.6g}, "
                  f"launches {json.dumps(launches[sname])}")
        else:
            require(bool(torch.isfinite(res.raw.fval[res.raw.status == CONVERGED]).all()),
                    f"{sname}: a converged lane has a non-finite value")
            print(f"solve {sname}: wall {wall:.4f} s (warm {warm:.4f} s), sweeps "
                  f"{res.raw.iterations}, chunk-steps {res.raw.map_trips}, eval_rows "
                  f"{res.raw.eval_rows}, n_converged {res.n_converged}, best_f "
                  f"{best_f:.6g}, pso_best_f {float(res.pso_best_f):.6g}, launches "
                  f"{json.dumps(launches[sname])}")
            if cfg.get("cluster"):
                time_clustering(res.raw)
        if sname in statics or sname in FAULT_BASES:
            kept[sname] = res
        if "equals" in cfg:
            check_schedule(sname, cfg, res, kept[cfg["equals"]].raw)
        if cfg.get("dijet"):
            check_dijet(res)
        del res
        if cfg.get("compare") in ("batched", "megakernel"):
            compare_sweeps(sname, cfg)
        elif cfg.get("compare") == "per_lane":
            compare_per_lane_sweeps(sname, cfg)
        torch.cuda.empty_cache()
    return launches, kept, warms


def same_solve(a, b, fields=SAME_FIELDS):
    """The fields of two BFGSResults that differ (tensors compared with
    torch.equal), and iterations and n_converged."""
    import torch

    bad = [f for f in fields if not torch.equal(getattr(a, f), getattr(b, f))]
    return bad + [f for f in ("iterations", "n_converged") if getattr(a, f) != getattr(b, f)]


def check_schedule(sname, cfg, res, static):
    """A schedule's solve against its static counterpart: the same lanes
    (auto plans with shorter ladders consume fewer logical probes, so an
    auto solve's n_evals is held against its replay instead); for the auto
    cell, the replay of its trace, equal to it in every field."""
    import torch
    from repro_torch.core import schedule_trace_plans

    raw = res.raw
    auto = cfg["opts"].schedule == "auto"
    fields = tuple(f for f in SAME_FIELDS if not (auto and f == "n_evals"))
    bad = same_solve(raw, static, fields)
    require(not bad, f"{sname}: {bad} differ from {cfg['equals']}'s")
    require(raw.map_trips <= static.map_trips and raw.eval_rows <= static.eval_rows,
            f"{sname}: map_trips {raw.map_trips} / eval_rows {raw.eval_rows} above "
            f"{cfg['equals']}'s {static.map_trips} / {static.eval_rows}")
    print(f"  {sname} == {cfg['equals']} on {', '.join(fields)}, iterations and "
          f"n_converged; map_trips {raw.map_trips} vs {static.map_trips}, eval_rows "
          f"{raw.eval_rows} vs {static.eval_rows}")
    if not cfg.get("replay"):
        return
    plans = schedule_trace_plans(raw.schedule_trace)
    print(f"  {sname} plans by window: {list(plans)}")
    replay = dataclasses.replace(cfg["opts"], schedule="replay", schedule_plans=plans)
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = run_solve(cfg, replay)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    bad = same_solve(rep.raw, raw)
    bad += [f for f in ("eval_rows", "map_trips") if getattr(rep.raw, f) != getattr(raw, f)]
    if not torch.equal(rep.raw.schedule_trace, raw.schedule_trace):
        bad.append("schedule_trace")
    require(not bad, f"{sname}: its replay differs in {bad}")
    check_launches(f"{sname}-replay", cfg, rep, counts)
    print(f"solve {sname}-replay: wall {wall:.4f} s, sweeps {rep.raw.iterations}, "
          f"chunk-steps {rep.raw.map_trips}, eval_rows {rep.raw.eval_rows}, "
          f"n_converged {rep.n_converged}, launches {json.dumps(counts)}; equal to "
          f"{sname} in every field, the trace included")


# ---------------------------------------------------------------------------
# phase 4e: fault-tolerant solves and the cost-model controller
# ---------------------------------------------------------------------------
def same_result(a, b):
    """The fields of two BFGSResults that differ, every one but telemetry
    (the wall clock's)."""
    import torch

    bad = same_solve(a, b, SAME_FIELDS + ("n_restarts",))
    bad += [f for f in ("eval_rows", "map_trips", "n_failed") if getattr(a, f) != getattr(b, f)]
    ta, tb = a.schedule_trace, b.schedule_trace
    if (ta is None) != (tb is None) or (ta is not None and not torch.equal(ta, tb)):
        bad.append("schedule_trace")
    return bad


def counted(fn):
    """fn() on the card with every launch counter set to 0 just before and
    read just after: (result or the Preempted it raised, wall s, counts)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.faults import Preempted

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        out = fn()
    except Preempted as e:
        out = e.with_traceback(None)  # its frames would hold the solve's tensors
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, ops.launch_counts()


def expected_launches(mode, n_chunks, sweeps, init=True, pso=0, heals=0):
    """The launches of a batched or megakernel solve over n_chunks chunks
    with the full ladder: `sweeps` chunk-sweeps each, the init's B1b and B3
    once a chunk (none on resume), `heals` re-initialisations (one B1b and
    one B3 each: a heal sweep's groups with a lane to heal), B4 `pso`
    times; every other kernel never."""
    inits = n_chunks if init else 0
    steps = sweeps * n_chunks
    if mode == "batched":
        return {"fused_value": steps, "fused_value_grad": inits + steps + heals,
                "guarded_update_direction": steps, "direction": inits + heals,
                "pso_step_update": pso}
    return {"sweep_megakernel_full": steps, "fused_value_grad": inits + heals,
            "direction": inits + heals, "pso_step_update": pso}


def require_launches(label, counts, expected):
    bad = {k: (n, expected.get(k, 0)) for k, n in counts.items() if n != expected.get(k, 0)}
    require(not bad, f"{label}: launches (got, expected) {bad}")


def heal_plan(plan, iterations, width, budget, start=0):
    """What the fault plan fixes for a solve of `iterations` sweeps on an
    objective finite everywhere: a lane hit after sweep k - 1 heals at sweep
    k while its budget lasts. Returns (re-seeds, re-initialised groups) of
    the heal sweeps from `start` on; a group is a chunk of `width` lanes."""
    restarts, seeds, groups = {}, 0, 0
    for k in range(1, iterations):
        hit = {lane for s, lane in plan.nan_grads + plan.kill_lanes if s == k - 1}
        healed = sorted(lane for lane in hit if restarts.get(lane, 0) < budget)
        for lane in healed:
            restarts[lane] = restarts.get(lane, 0) + 1
        if k >= start:
            seeds += len(healed)
            groups += len({lane // width for lane in healed})
    return seeds, groups


class SnapshotLog:
    """Collects the engine's snapshot records (step, bytes, host-copy s,
    write s) from its logger while in a `with` block (across blocks)."""

    def __init__(self):
        self.records = []

    def __enter__(self):
        import logging

        self.logger = logging.getLogger("repro_torch.core.engine")
        self.handler = logging.Handler(logging.DEBUG)
        self.handler.emit = lambda record: self.records.append(record.args)
        self.level = self.logger.level
        self.logger.setLevel(logging.DEBUG)
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)


def ckpt_cell(label, cfg, base, base_counts, base_warm, tmp, every, keep, preempt,
              resume_direct=False):
    """A cell's solve checkpointed (equal to its phase-4 solve, the same
    launches; its wall beside that solve's warm wall), preempted (Preempted
    at `preempt`, the newest snapshot the cadence's last before it) and
    resumed (equal again; no init, the sweeps after the snapshot only).
    `resume_direct` resumes through solve_phase2 on the phase-1 starts
    instead of zeus(resume=)."""
    import os
    import torch
    from repro_torch.checkpoint import manager
    from repro_torch.core import get_objective, run_pso, solve_phase2
    from repro_torch.launch.faults import FaultPlan, Preempted

    opts = cfg["opts"]
    mode = opts.sweep_mode
    lanes = opts.pso.n_particles
    n_chunks = -(-lanes // opts.lane_chunk) if opts.lane_chunk else 1
    ck_opts = dataclasses.replace(opts, checkpoint_every=every, checkpoint_keep=keep,
                                  checkpoint_dir=os.path.join(tmp, label + "-ref"))
    with SnapshotLog() as snaps:
        res, wall, counts = counted(lambda: run_solve(cfg, ck_opts))
    bad = same_result(res.raw, base.raw)
    require(not bad, f"{label}: checkpointed solve differs from its phase-4 solve in {bad}")
    require(counts == base_counts, f"{label}: launches {counts}, phase 4's {base_counts}")
    steps = manager.committed_steps(ck_opts.checkpoint_dir)
    print(f"solve {label}: checkpoint_every={every}, keep={keep}: wall {wall:.4f} s "
          f"({wall / base_warm:.3f}x the uncheckpointed solve's warm {base_warm:.4f} s), "
          f"sweeps {res.raw.iterations}, snapshots kept at {steps}, equal to phase 4's solve "
          f"in every field, launches {json.dumps(counts)}")
    for step, nbytes, copy_s, write_s in snaps.records:
        print(f"  snapshot step {step}: {nbytes} bytes, device-to-host copy "
              f"{copy_s * 1e3:.2f} ms, write {write_s:.4f} s")
    del res

    pre_dir = os.path.join(tmp, label)
    pre_opts = dataclasses.replace(ck_opts, checkpoint_dir=pre_dir,
                                   fault_plan=FaultPlan(preempt_at_sweep=preempt))
    out, wall, counts = counted(lambda: run_solve(cfg, pre_opts))
    require(isinstance(out, Preempted) and out.sweep == preempt,
            f"{label}: no Preempted({preempt}): {out!r}")
    latest = manager.latest_step(pre_dir)
    require(latest == (preempt - 1) // every * every,
            f"{label}: newest snapshot at {latest} after the preemption at {preempt}")
    require_launches(f"{label}-preempted", counts, expected_launches(
        mode, n_chunks, preempt, pso=opts.pso.iter_pso))
    print(f"solve {label}-preempted: Preempted at sweep {out.sweep}, newest snapshot at "
          f"{latest}, wall {wall:.4f} s, launches {json.dumps(counts)}")

    res_opts = dataclasses.replace(ck_opts, checkpoint_dir=pre_dir)
    if resume_direct:
        obj = get_objective(cfg["objective"])
        gen = torch.Generator(device="cuda").manual_seed(cfg["seed"])
        starts = run_pso(obj.fn, cfg["dim"], obj.lower, obj.upper, opts.pso, device="cuda",
                         generator=gen).x
        raw, wall, counts = counted(lambda: solve_phase2(
            obj.fn, starts, res_opts, device="cuda", bounds=(obj.lower, obj.upper),
            resume_from=pre_dir))
        pso, entry = 0, "solve_phase2(resume_from=)"
    else:
        out, wall, counts = counted(lambda: run_solve(cfg, res_opts, resume=pre_dir))
        raw, pso, entry = out.raw, opts.pso.iter_pso, "zeus(resume=)"
        for f in ("best_x", "pso_best_f"):
            require(torch.equal(getattr(out, f), getattr(base, f)),
                    f"{label}: resumed {f} differs")
    bad = same_result(raw, base.raw)
    require(not bad, f"{label}: resumed solve differs from its phase-4 solve in {bad}")
    require_launches(f"{label}-resumed", counts, expected_launches(
        mode, n_chunks, raw.iterations - latest, init=False, pso=pso))
    print(f"solve {label}-resumed ({entry}) from step {latest}: wall {wall:.4f} s, equal to "
          f"phase 4's solve in every field{', best_x and pso_best_f too' if not resume_direct else ''}; "
          f"launches {json.dumps(counts)}")
    return counts


def ckpt_overhead():
    """The reference's checkpoint-overhead cell: the warm wall of the same
    solve with and without snapshots, in turns, and their ratio (printed
    beside the design target, not required); the two array-equal."""
    import shutil
    import statistics
    import tempfile
    import torch
    from repro_torch.core import BFGSOptions, batched_bfgs, get_objective

    cell = CKPT_OVERHEAD
    obj = get_objective(cell["objective"])
    gen = torch.Generator(device="cuda").manual_seed(cell["seed"])
    x0 = obj.lower + (obj.upper - obj.lower) * torch.rand(
        cell["lanes"], cell["dim"], generator=gen, device="cuda")
    plain = BFGSOptions(iter_bfgs=cell["sweeps"], theta=1e-30)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_overhead_")
    try:
        ck = dataclasses.replace(plain, checkpoint_every=cell["every"],
                                 checkpoint_keep=cell["keep"], checkpoint_dir=tmp)
        expected = expected_launches("batched", 1, cell["sweeps"])
        walls, results = {"plain": [], "checkpointed": []}, {}
        batched_bfgs(obj.fn, x0, plain, device="cuda")  # warm-up
        order = ["plain", "checkpointed", "checkpointed", "plain"] * cell["rounds"]
        snaps = SnapshotLog()
        for name in order[:2 * cell["rounds"]]:
            with snaps:
                res, wall, counts = counted(lambda: batched_bfgs(
                    obj.fn, x0, plain if name == "plain" else ck, device="cuda"))
            require(res.iterations == cell["sweeps"], f"ckpt-overhead: {res.iterations} sweeps")
            require_launches(f"ckpt-overhead-{name}", counts, expected)
            walls[name].append(wall)
            results[name] = res
        bad = same_result(results["plain"], results["checkpointed"])
        require(not bad, f"ckpt-overhead: checkpointed differs from plain in {bad}")
        p, c = statistics.median(walls["plain"]), statistics.median(walls["checkpointed"])
        print(f"solve ckpt-overhead ({cell['objective']}, B = {cell['lanes']}, D = "
              f"{cell['dim']}, {cell['sweeps']} sweeps, checkpoint_every={cell['every']}, "
              f"keep={cell['keep']}): warm wall plain {[round(w, 4) for w in walls['plain']]} s, "
              f"checkpointed {[round(w, 4) for w in walls['checkpointed']]} s; medians "
              f"{p:.4f} / {c:.4f} s, ratio {c / p:.3f} (design target {CKPT_DESIGN_RATIO}); "
              f"array-equal; launches {json.dumps(counts)}")
        copies = [r[2] * 1e3 for r in snaps.records]
        writes = [r[3] * 1e3 for r in snaps.records]
        print(f"  ckpt-overhead snapshots: {len(snaps.records)} of {snaps.records[0][1]} bytes; "
              f"device-to-host copy ms {[round(x, 2) for x in copies]}, write ms "
              f"{[round(x, 2) for x in writes]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts


def retry_cells(solve_cfg, tmp):
    """retry-paper on both batched modes: the fault plan with and without
    retries (fewer lanes end failed with them), the heals' launches exactly
    where the plan fixes them, then preempted and resumed with the retry
    stream restored from the snapshot, equal to the uninterrupted solve."""
    import os
    import torch
    from repro_torch.checkpoint import manager
    from repro_torch.launch.faults import FaultPlan, Preempted

    plan = FaultPlan.random(**RETRY_PLAN)
    launches = {}
    for cell in ("paper", "megakernel-paper"):
        cfg = solve_cfg[cell]
        opts = cfg["opts"]
        mode, width = opts.sweep_mode, opts.lane_chunk
        n_chunks = opts.pso.n_particles // width
        label = f"retry-{cell}"
        broken, _, _ = counted(lambda: run_solve(cfg, dataclasses.replace(opts, fault_plan=plan)))
        r_opts = dataclasses.replace(opts, fault_plan=plan, retry_budget=RETRY_BUDGET)
        res, wall, counts = counted(lambda: run_solve(cfg, r_opts))
        raw = res.raw
        seeds, groups = heal_plan(plan, raw.iterations, width, RETRY_BUDGET)
        require(int(raw.n_restarts.sum()) == seeds,
                f"{label}: {int(raw.n_restarts.sum())} re-seeds, the plan fixes {seeds}")
        require_launches(label, counts, expected_launches(
            mode, n_chunks, raw.iterations, pso=opts.pso.iter_pso, heals=groups))
        require(raw.n_failed < broken.raw.n_failed,
                f"{label}: n_failed {raw.n_failed}, without retry {broken.raw.n_failed}")
        require(res.n_converged > 0 and bool(torch.isfinite(res.best_f)), f"{label}: no result")
        print(f"solve {label}: FaultPlan.random({RETRY_PLAN}), retry_budget={RETRY_BUDGET}: "
              f"wall {wall:.4f} s, sweeps {raw.iterations}, n_restarts sum "
              f"{int(raw.n_restarts.sum())} ({groups} group re-inits), n_failed "
              f"{raw.n_failed} (without retry {broken.raw.n_failed}), n_converged "
              f"{res.n_converged} (without retry {broken.n_converged}), eval_rows "
              f"{raw.eval_rows}, launches {json.dumps(counts)}")
        launches[label] = counts

        every, preempt = CKPT_RETRY["every"], CKPT_RETRY["preempt"]
        ck = os.path.join(tmp, label)
        ck_opts = dataclasses.replace(r_opts, checkpoint_every=every,
                                      checkpoint_keep=CKPT_RETRY["keep"], checkpoint_dir=ck)
        out, _, _ = counted(lambda: run_solve(cfg, dataclasses.replace(
            ck_opts, fault_plan=dataclasses.replace(plan, preempt_at_sweep=preempt))))
        require(isinstance(out, Preempted) and out.sweep == preempt,
                f"{label}: no Preempted({preempt}): {out!r}")
        latest = manager.latest_step(ck)
        out, wall, counts = counted(lambda: run_solve(cfg, ck_opts, resume=ck))
        bad = same_result(out.raw, raw)
        require(not bad, f"{label}: resumed differs from the uninterrupted retry solve in {bad}")
        _, groups = heal_plan(plan, raw.iterations, width, RETRY_BUDGET, start=latest)
        require_launches(f"{label}-resumed", counts, expected_launches(
            mode, n_chunks, raw.iterations - latest, init=False, pso=opts.pso.iter_pso,
            heals=groups))
        print(f"solve {label}-resumed: preempted at {preempt}, resumed from step {latest} "
              f"(checkpoint_every={every}): wall {wall:.4f} s, equal to the uninterrupted "
              f"retry solve in every field, launches {json.dumps(counts)}")
    return launches


def cost_model_cell(solve_cfg, base_warm):
    """cost-model-scale: megakernel-scale under schedule="auto" with the
    cost model in measured mode: its plans, fitted costs and warm wall,
    and the replay of its trace, equal in every field but telemetry."""
    from repro_torch.core import schedule_trace_plans
    from repro_torch.launch.telemetry import telemetry_summary

    from repro_torch.launch.telemetry import probe_energy

    t0 = time.perf_counter()
    probe = probe_energy()
    t1 = time.perf_counter()
    for _ in range(ENERGY_READS):
        probe.read_j()
    t2 = time.perf_counter()
    print(f"energy probe: source {probe.source}, {(t1 - t0) * 1e3:.3f} ms to probe, "
          f"{(t2 - t1) / ENERGY_READS * 1e3:.3f} ms a read over {ENERGY_READS} reads (the "
          "engine reads it twice a window)")
    cfg = solve_cfg["auto-megakernel-scale"]
    opts = dataclasses.replace(cfg["opts"], auto_cost_model=True)
    launches = {}
    for run in ("first", "warm"):
        res, wall, counts = counted(lambda: run_solve(cfg, opts))
        check_launches(f"cost-model-scale ({run})", cfg, res, counts)
        raw = res.raw
        summary = telemetry_summary(raw.telemetry)
        print(f"solve cost-model-scale ({run}): wall {wall:.4f} s (auto-megakernel-scale warm "
              f"{base_warm:.4f} s), sweeps {raw.iterations}, chunk-steps {raw.map_trips}, "
              f"eval_rows {raw.eval_rows}, n_converged {res.n_converged}, plans by window "
              f"{list(schedule_trace_plans(raw.schedule_trace))}, fitted c_row "
              f"{summary['c_row']:.6g} s, c_launch {summary['c_launch']:.6g} s, telemetry "
              f"{json.dumps(summary)}, launches {json.dumps(counts)}")
        launches[f"cost-model-scale-{run}"] = counts
    replay = dataclasses.replace(cfg["opts"], schedule="replay",
                                 schedule_plans=schedule_trace_plans(raw.schedule_trace))
    rep, wall, counts = counted(lambda: run_solve(cfg, replay))
    bad = same_result(rep.raw, raw)
    require(not bad, f"cost-model-scale: its replay differs in {bad}")
    require(rep.raw.telemetry is None, "cost-model-scale: the replay carries telemetry")
    check_launches("cost-model-scale-replay", cfg, rep, counts)
    print(f"solve cost-model-scale-replay: wall {wall:.4f} s, equal to cost-model-scale in "
          f"every field but telemetry, launches {json.dumps(counts)}")
    return launches


def run_fault_solves(solve_cfg, launches, kept, warms):
    """Phase 4e (module docstring). Snapshots go to a fresh temporary
    directory, removed at the end; its disk must hold two of the scale
    cell's snapshots."""
    import shutil
    import tempfile
    import torch

    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        for label, cell, direct in (("ckpt-paper", "paper", True),
                                    ("ckpt-megakernel-paper", "megakernel-paper", True),
                                    ("zeus-resume", "paper", False)):
            out[label + "-resumed"] = ckpt_cell(
                label, solve_cfg[cell], kept[cell], launches[cell], warms[cell], tmp,
                **CKPT_PAPER, resume_direct=direct)
        out.update(retry_cells(solve_cfg, tmp))
        out["ckpt-overhead"] = ckpt_overhead()
        out.update(cost_model_cell(solve_cfg, warms["auto-megakernel-scale"]))

        # the scale cell last: its snapshots hold the 1.07 GB H stack
        B, D = solve_cfg["scale"]["opts"].pso.n_particles, solve_cfg["scale"]["dim"]
        need = 2 * B * (D * D + 4 * D + 3) * 4
        free = shutil.disk_usage(tmp).free
        print(f"ckpt-scale: {free / 2**30:.2f} GiB free under {tempfile.gettempdir()}, two "
              f"snapshots need {need / 2**30:.2f} GiB")
        require(free >= need, f"ckpt-scale: {free} bytes free, two snapshots need {need}")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["ckpt-scale-resumed"] = ckpt_cell(
            "ckpt-scale", solve_cfg["scale"], kept["scale"], launches["scale"],
            warms["scale"], tmp, **CKPT_SCALE)
        print(f"  ckpt-scale: the three solves in {time.perf_counter() - t0:.1f} s; "
              f"scale's warm wall {warms['scale']:.4f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 4f: the solve service
# ---------------------------------------------------------------------------
class ServeRun:
    """One drain of a cell's request stream through a fresh SolveService on
    the card: counters set to 0 before the first submit (the pool's open
    and its init are the path's too) and read after the drain; the
    admissions counted by wrapping the pool's HostedSolve.admit (a group
    takes one B1b and one B3 an admission that writes rows of it); with
    `split`, the host clock around each part of a pump."""

    def __init__(self, cell, mode, drain_then_refill=False, split=False, profile=False):
        import numpy as np
        import torch
        from repro_torch.core import BFGSOptions, ZeusOptions
        from repro_torch.kernels import ops
        from repro_torch.serve.service import ProblemRegistry, SolveRequest, SolveService

        self.cell, self.mode = cell, mode
        opts = ZeusOptions(bfgs=BFGSOptions(
            iter_bfgs=max(cell["budgets"]), theta=cell["theta"], ad_mode="reverse",
            ls_iters=K_LADDER, sweep_mode=mode))
        self.registry = ProblemRegistry()
        self.registry.register("serve", cell["objective"], cell["dim"], opts=opts)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        svc = SolveService(self.registry, slots=cell["slots"], max_queue=cell["requests"],
                           admit_every=cell["admit_every"],
                           drain_then_refill=drain_then_refill, device="cuda")
        budgets = cell["budgets"]
        self.requests = [SolveRequest("serve", seed=i, n_starts=cell["n_starts"],
                                      iter_max=budgets[i % len(budgets)])
                         for i in range(cell["requests"])]
        self.rids = [svc.submit(r) for r in self.requests]
        pool = svc._pools["serve"]
        self.admit_groups = 0
        width = pool.host._sweeper.width
        real_admit = pool.host.admit

        def admit(carry, mask, X, deadlines):
            m = np.asarray(mask, bool).reshape(-1, width)
            self.admit_groups += int(m.any(axis=1).sum())
            return real_admit(carry, mask, X, deadlines)

        pool.host.admit = admit
        self.split = None
        if split:
            self.split = {"lane_view": 0.0, "harvest+admit": 0.0, "segment": 0.0,
                          "telemetry": 0.0, "pumps": 0}
            timed = lambda key, fn: self._timed(key, fn)
            pool.host.lane_view = timed("lane_view", pool.host.lane_view)
            svc._harvest = timed("harvest+admit", svc._harvest)
            svc._admit = timed("harvest+admit", svc._admit)
            pool.host.segment = timed("segment", pool.host.segment)
            pool.telem.begin = timed("telemetry", pool.telem.begin)
            pool.telem.end = timed("telemetry", pool.telem.end)
        prof = None
        if profile:
            from torch.profiler import ProfilerActivity, profile as torch_profile

            prof = torch_profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        self.results = svc.drain()
        torch.cuda.synchronize()
        self.wall = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
        self.prof = prof
        self.counts = ops.launch_counts()
        self.svc, self.pool = svc, pool
        self.stats = svc.stats()
        self.sweeps = self.stats["pool_sweeps"]["serve"]

    def _timed(self, key, fn):
        import torch

        def wrapper(*args, **kwargs):
            if key == "lane_view":
                self.split["pumps"] += 1
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if key == "segment":
                torch.cuda.synchronize()
            self.split[key] += time.perf_counter() - t0
            return out
        return wrapper

    def check(self, label):
        """All requests done, every lane's sweeps exactly its budget where
        it did not converge (all of them at theta = 1e-30), and the
        launches the path fixes."""
        from repro_torch.core import CONVERGED

        require(len(self.results) == len(self.requests),
                f"{label}: {len(self.results)} of {len(self.requests)} requests done")
        for rid, req in zip(self.rids, self.requests):
            res = self.results[rid]
            require(len(res.lanes) == req.n_starts, f"{label}: request {rid} lanes")
            for lane in res.lanes:
                ran = lane.retire_sweep - lane.admit_sweep
                require(ran == req.iter_max if lane.status != CONVERGED
                        else ran <= req.iter_max,
                        f"{label}: request {rid} lane ran {ran} sweeps, budget "
                        f"{req.iter_max}, status {lane.status}")
        trips = self.pool.carry.trips
        require(trips == self.sweeps, f"{label}: {trips} chunk-steps over {self.sweeps} sweeps")
        require_launches(label, self.counts, expected_launches(
            self.mode, 1, self.sweeps, heals=self.admit_groups))

    def check_solo(self, label):
        """Request 0 and the first request admitted after sweep 0 against
        the request alone in a fresh batch of the pool's width: x, f, |g|,
        status and n_evals array-equal."""
        import numpy as np
        from repro_torch.serve.service import solo_reference

        later = next(e["rid"] for e in self.svc.ledger
                     if e["event"] == "admit" and e["sweep"] > 0)
        for rid in (0, later):
            res = self.results[rid]
            ref = solo_reference(self.registry.get("serve"), self.requests[rid],
                                 slots=self.cell["slots"], device="cuda")
            n = len(res.lanes)
            got = {"x": np.stack([l.x for l in res.lanes]),
                   "fval": np.array([l.fval for l in res.lanes], np.float32),
                   "grad_norm": np.array([l.grad_norm for l in res.lanes], np.float32),
                   "status": np.array([l.status for l in res.lanes], np.int32),
                   "n_evals": np.array([l.n_evals for l in res.lanes], np.int32)}
            bad = [f for f, v in got.items()
                   if not np.array_equal(v, getattr(ref, f)[:n].cpu().numpy())]
            admits = sorted({l.admit_sweep for l in res.lanes})
            require(not bad, f"{label}: request {rid} (admitted at sweeps {admits[:4]}) "
                    f"differs from its solo run in {bad}")
            print(f"  {label}: request {rid} ({n} lanes, admitted at sweeps "
                  f"{admits[:4]}{'...' if len(admits) > 4 else ''}) array-equal to its solo "
                  f"run at width {self.cell['slots']} on x, fval, grad_norm, status, n_evals")

    def line(self, label):
        st = self.stats
        sps = st["solves_per_sec"]
        return (f"solve {label}: {len(self.results)} requests, sweeps {self.sweeps}, wall "
                f"{self.wall:.4f} s, solves/s {sps if sps is None else round(sps, 2)}, "
                f"admit latency p50/p95 {st['admit_latency_sweeps_p50']:.1f} / "
                f"{st['admit_latency_sweeps_p95']:.1f} sweeps, "
                f"{st['admit_latency_s_p50'] * 1e3:.2f} / {st['admit_latency_s_p95'] * 1e3:.2f} "
                f"ms, admissions {self.admit_groups}, eval_rows {self.pool.carry.rows}, "
                f"launches {json.dumps(self.counts)}")


def serve_paper():
    """serve-paper under both batched modes: a warm drain, then the
    continuous service and the drain-then-refill baseline, counted and
    checked; their sweep ratio against SERVE_FLOOR; solo parity; then the
    continuous drain once more under the profiler (device activity only)."""
    import torch

    cell, launches = SERVE_PAPER, {}
    for mode in ("batched", "megakernel"):
        ServeRun(cell, mode)  # warm-up
        cont = ServeRun(cell, mode)
        cont.check(f"serve-paper-{mode}")
        drain = ServeRun(cell, mode, drain_then_refill=True)
        drain.check(f"serve-paper-{mode}-drain")
        ratio = drain.sweeps / cont.sweeps
        print(cont.line(f"serve-paper-{mode} (continuous)"))
        print(drain.line(f"serve-paper-{mode} (drain_then_refill)"))
        print(f"  serve-paper-{mode}: drain/continuous sweeps {drain.sweeps} / {cont.sweeps} "
              f"= {ratio:.3f} (floor {SERVE_FLOOR}), walls {drain.wall:.4f} / {cont.wall:.4f} "
              f"s = {drain.wall / cont.wall:.3f}")
        require(ratio >= SERVE_FLOOR, f"serve-paper-{mode}: sweep ratio {ratio:.3f} under "
                f"{SERVE_FLOOR}")
        cont.check_solo(f"serve-paper-{mode}")
        prof = ServeRun(cell, mode, profile=True)
        print_profile(f"serve-paper-{mode} (continuous)", prof.prof, prof.wall * 1e6)
        launches[f"serve-paper-{mode}"] = cont.counts
        launches[f"serve-paper-{mode}-drain"] = drain.counts
        del cont, drain, prof
        torch.cuda.empty_cache()
    return launches


def serve_scale():
    """serve-scale: 64 requests of 512 starts into a 16 384-slot pool (two
    pool-widths of lanes), once to warm and once timed with the per-pump
    split; all done, the launches, and solo parity at width 16 384."""
    import torch

    cell = SERVE_SCALE
    first = ServeRun(cell, "batched")
    first.check("serve-scale (first)")
    print(first.line("serve-scale (first)"))
    del first
    torch.cuda.empty_cache()
    run = ServeRun(cell, "batched", split=True)
    run.check("serve-scale")
    print(run.line("serve-scale"))
    sp = run.split
    n_conv = sum(r.n_converged for r in run.results.values())
    print(f"  serve-scale: {sp['pumps']} pumps; host clock lane_view {sp['lane_view']:.4f} s, "
          f"harvest+admit {sp['harvest+admit']:.4f} s, segment {sp['segment']:.4f} s, "
          f"telemetry {sp['telemetry']:.4f} s of {run.wall:.4f} s; {n_conv} of "
          f"{cell['requests'] * cell['n_starts']} lanes converged")
    run.check_solo("serve-scale")
    counts = run.counts
    del run
    torch.cuda.empty_cache()
    return {"serve-scale": counts}


def serve_cli():
    """serve-cli: the launcher's main() with the system test's arguments on
    the card (its default device): four requests over two problems, every
    one converged with two lanes, on the batched path's kernels."""
    import torch
    from repro_torch.core import CONVERGED
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = serve.main(SERVE_CLI)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    require(len(results) == 4, f"serve-cli: {len(results)} requests drained")
    require(all(len(r.lanes) == 2 for r in results.values()), "serve-cli: lanes")
    require(all(r.status == CONVERGED for r in results.values()),
            f"serve-cli: statuses {[r.status for r in results.values()]}")
    for k, n in counts.items():
        if k in ("fused_value", "fused_value_grad", "guarded_update_direction", "direction"):
            require(n > 0, f"serve-cli: kernel {k} was not launched")
        else:
            require(n == 0, f"serve-cli: kernel {k} launched {n} times off its path")
    print(f"solve serve-cli: wall {wall:.4f} s, launches {json.dumps(counts)}")
    return {"serve-cli": counts}


def run_service_cells():
    """Phase 4f (module docstring)."""
    out = serve_paper()
    out.update(serve_scale())
    out.update(serve_cli())
    return out


def check_dijet(res):
    """The fit's own criteria (examples/fit_dijet.py): best_f within 1 of
    the NLL at the true parameters, at least 90% of the pulls within ±2σ;
    and at least 32 converged lanes."""
    import numpy as np
    import torch
    from repro_torch.core.objectives import dijet_rate

    fit = res.best_x.cpu()
    edges, counts, nll, _ = dijet_problem(str(fit.dtype).replace("torch.", ""))
    true_f = float(nll(torch.tensor(DIJET_TRUE, device="cuda", dtype=fit.dtype)))
    centers = 0.5 * (edges[:-1] + edges[1:])
    pred = dijet_rate(fit, torch.tensor(centers, dtype=fit.dtype)).numpy() * (
        edges[1:] - edges[:-1])
    pulls = (counts - pred) / np.sqrt(np.maximum(pred, 1.0))
    frac2 = float(np.mean(np.abs(pulls) <= 2.0))
    print(f"  dijet: fit {np.round(fit.numpy(), 4).tolist()} (true {list(DIJET_TRUE)}), "
          f"nll(fit) {float(res.best_f):.4f}, nll(true) {true_f:.4f}, pulls mean "
          f"{pulls.mean():.3f} std {pulls.std():.3f}, within 2 sigma {frac2:.1%}, "
          f"n_converged {res.n_converged}")
    require(float(res.best_f) <= true_f + 1.0, "dijet: best_f above nll(TRUE) + 1")
    require(frac2 >= 0.9, f"dijet: {frac2:.1%} of pulls within 2 sigma")
    require(res.n_converged >= 32, f"dijet: {res.n_converged} lanes converged")


def time_clustering(raw):
    """cluster_solutions on a solve's result, timed on the host clock. Its
    host loop is O(lanes × clusters), so past CLUSTER_ALL_MAX converged
    lanes it runs on the first CLUSTER_SAMPLES of them instead."""
    import torch
    from repro_torch.core import CONVERGED, cluster_solutions

    conv = torch.nonzero(raw.status == CONVERGED).flatten()
    if conv.numel() <= CLUSTER_ALL_MAX:
        inputs = [(f"all {conv.numel()}", raw)]
    else:
        inputs = [(f"first {n} of {conv.numel()}", raw._replace(
            x=raw.x[conv[:n]], fval=raw.fval[conv[:n]], status=raw.status[conv[:n]],
            grad_norm=raw.grad_norm[conv[:n]])) for n in CLUSTER_SAMPLES]
    for label, res in inputs:
        t0 = time.perf_counter()
        summary = cluster_solutions(res, radius=0.25).summary()
        print(f"  cluster_solutions on {label} converged lanes: "
              f"{time.perf_counter() - t0:.4f} s host; {summary}")


def chunk_memory():
    """Phase 4d: peak device memory of run_multistart at the scale shape
    (ackley, 16384 uniform starts, D=128, 3 sweeps) unchunked and chunked,
    over the memory held before the call. The (B, D, D) stack is 1.07 GB;
    chunking must lower the peak, and must not change the result."""
    import torch
    from repro_torch.core import BatchedDenseBFGS, EngineOptions, get_objective
    from repro_torch.core import run_multistart

    obj = get_objective("ackley")
    gen = torch.Generator(device="cuda").manual_seed(7)
    x0 = obj.lower + (obj.upper - obj.lower) * torch.rand(
        16384, 128, generator=gen, device="cuda")
    peaks, results = {}, {}
    for chunk in (None, 4096, 1024):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = run_multistart(obj.fn, x0, BatchedDenseBFGS(),
                             EngineOptions(iter_max=3, lane_chunk=chunk), device="cuda")
        torch.cuda.synchronize()
        peaks[chunk] = torch.cuda.max_memory_allocated() - base
        results[chunk] = res
        print(f"memory lane_chunk={chunk}: peak {peaks[chunk] / 2**30:.4f} GiB over "
              f"{base / 2**30:.4f} GiB held before the call")
    for chunk in (4096, 1024):
        require(peaks[chunk] < peaks[None],
                f"lane_chunk={chunk} peaks at {peaks[chunk]} B, unchunked {peaks[None]} B")
        same = all(torch.equal(getattr(results[chunk], f), getattr(results[None], f))
                   for f in ("x", "fval", "status"))
        print(f"memory lane_chunk={chunk}: result array-equal to unchunked: {same}")
    del results
    torch.cuda.empty_cache()


def profile_solves(solve_cfg):
    """Phase 4c: each solve once more under torch.profiler, for where the
    time goes: device-busy share of the wall and the top kernels by device
    time. Reported only; nothing here can fail the run but an exception."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for sname, cfg in solve_cfg.items():
        torch.cuda.synchronize()
        # device activity only: recording every host-side op as well cost
        # most of the script's time on the per-lane and sequential solves
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_solve(cfg)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        print_profile(sname, prof, wall_us)


def time_kernels(cases_by_solve, solve_cfg):
    """Phase 5: kernel, plain version and library call, timed on the card at
    the cells of KERNEL_CELLS."""
    import torch
    from repro_torch.kernels import direction, fused_obj, pso_step

    timings = {}
    for sname, case in cases_by_solve.items():
        objective, dim = solve_cfg[sname]["objective"], solve_cfg[sname]["dim"]
        pairs = {
            "fused_value": (
                lambda: fused_obj.value_grad_cuda(objective, case["ladder"], False),
                lambda: fused_obj.value_grad_plain(objective, case["ladder"], False),
                None),
            "fused_value_grad": (
                lambda: fused_obj.value_grad_cuda(objective, case["commit"]),
                lambda: fused_obj.value_grad_plain(objective, case["commit"]),
                None),
            "direction": (
                lambda: direction.direction_cuda(case["H"], case["g_new"]),
                lambda: direction.direction_plain(case["H"], case["g_new"]),
                lambda: torch.bmm(case["H"], case["g_new"][:, :, None])),
            "pso_step_update": (
                lambda: pso_step.pso_step_cuda(*case["pso"], 0.5, 1.2, 1.5),
                lambda: pso_step.pso_step_plain(*case["pso"], 0.5, 1.2, 1.5),
                None),
        }
        timings[sname] = {}
        for kname, (kern, plain, lib) in pairs.items():
            if sname not in KERNEL_CELLS[kname]:
                continue
            # plain, kernel, kernel, plain: compare within one call, in turns
            p1, k1, k2, p2 = time_ms(plain), time_ms(kern), time_ms(kern), time_ms(plain)
            lib_ms = time_ms(lib) if lib is not None else None
            bound_ms, bound_by = bounds(kname, case, dim, objective)
            timings[sname][kname] = dict(ms=min(k1, k2), plain_ms=min(p1, p2),
                                         library_ms=lib_ms, bound_ms=bound_ms,
                                         bound_by=bound_by)
            print(f"time {sname} {kname}: kernel {k1:.4f}/{k2:.4f} ms, plain "
                  f"{p1:.4f}/{p2:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})"
                  + (f", torch.bmm {lib_ms:.4f} ms" if lib_ms is not None else ""))
    return timings


def time_b3_against_bmm(case):
    """Phase 5, B3 against torch.bmm at the paper shape, where both are
    bound by their launch: B3_PAIRS samples of each, taken in turns (B3,
    bmm, B3, bmm, …), each the mean of a ~50 ms run. Prints both medians
    and their ratio."""
    import statistics

    import torch
    from repro_torch.kernels import direction

    H, g = case["H"], case["g_new"]
    b3, bmm = [], []
    for _ in range(B3_PAIRS):
        b3.append(time_ms(lambda: direction.direction_cuda(H, g), 50.0))
        bmm.append(time_ms(lambda: torch.bmm(H, g[:, :, None]), 50.0))
    m3, mb = statistics.median(b3), statistics.median(bmm)
    print(f"time paper direction against torch.bmm, {B3_PAIRS} pairs in turns, B={H.shape[0]} "
          f"D={H.shape[1]}: median {m3:.4f} ms against {mb:.4f} ms, ratio {m3 / mb:.3f}")


def time_fused_dims(gen):
    """Phase 5, B1a and B1b (rastrigin) at the FUSED_TIMED shapes: kernel and
    plain version in turns, beside the bound."""
    import torch
    from repro_torch.core import get_objective
    from repro_torch.kernels import fused_obj

    obj = get_objective("rastrigin")
    for rows, D in FUSED_TIMED:
        x = obj.lower + (obj.upper - obj.lower) * torch.rand(rows, D, generator=gen,
                                                             device="cuda")
        for kname, with_grad in (("fused_value", False), ("fused_value_grad", True)):
            kern = lambda: fused_obj.value_grad_cuda("rastrigin", x, with_grad)  # noqa: E731
            plain = lambda: fused_obj.value_grad_plain("rastrigin", x, with_grad)  # noqa: E731
            p1, k1, k2, p2 = time_ms(plain), time_ms(kern), time_ms(kern), time_ms(plain)
            bound_ms, bound_by = bounds(kname, {"ladder": x, "commit": x}, D, "rastrigin")
            print(f"time B1 {kname} rastrigin N={rows} D={D} ({fused_layout(D)}): kernel "
                  f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by})")


def device_ms(fn, calls=200, key="fused_obj"):
    """Device time of one launch of the kernels named `key` that `fn`
    enqueues, from torch.profiler over `calls` calls (device activity only):
    at a shape whose kernel is shorter than its host enqueue, back-to-back
    CUDA events time the host, the profiler the kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and key in e.key]
    n = sum(c for _, c in rows)
    return sum(t for t, _ in rows) / n / 1e3 if n else float("nan")


def time_fused_d128(gen):
    """Phase 5, B1a and B1b (ackley) at D = 128 at each of FUSED_D128_ROWS
    rows: kernel and plain version in turns, warm (one input, back to back)
    and cold (cycling through copies of FUSED_COLD_BYTES in all, so that
    each launch finds its input out of the L2), and the kernel's device time
    a launch, cold, from the profiler (device_ms), beside the bound. Returns
    {(kname, rows): (warm ms, cold ms, bound ms, bound_by)}."""
    import itertools

    from repro_torch.kernels import fused_obj

    D, out = 128, {}
    for rows in FUSED_D128_ROWS:
        copies = max(1, -(-FUSED_COLD_BYTES // (rows * D * 4)))
        xs = [fused_inputs("ackley", rows, D, 0, gen) for _ in range(copies)]
        for kname, with_grad in (("fused_value", False), ("fused_value_grad", True)):
            ring = itertools.cycle(xs)
            kern = lambda: fused_obj.value_grad_cuda("ackley", xs[0], with_grad)  # noqa: E731
            cold = lambda: fused_obj.value_grad_cuda("ackley", next(ring), with_grad)  # noqa: E731
            plain = lambda: fused_obj.value_grad_plain("ackley", xs[0], with_grad)  # noqa: E731
            p1, k1, c1, k2, c2, p2 = (time_ms(plain), time_ms(kern), time_ms(cold),
                                      time_ms(kern), time_ms(cold), time_ms(plain))
            dev = device_ms(cold)
            bound_ms, bound_by = bounds(kname, {"ladder": xs[0], "commit": xs[0]}, D,
                                        "ackley")
            out[kname, rows] = (min(k1, k2), min(c1, c2), bound_ms, bound_by)
            print(f"time B1 {kname} ackley N={rows} D={D} ({fused_layout(D)}): kernel warm "
                  f"{k1:.4f}/{k2:.4f} ms, cold {c1:.4f}/{c2:.4f} ms ({copies} copies, "
                  f"{copies * rows * D * 4 / 2**20:.0f} MiB), device {dev:.4f} ms a launch "
                  f"(profiler, cold), plain {p1:.4f}/{p2:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by})")
        del xs
    return out


def sass_blocks(stem, kernel):
    """For each instantiation of `kernel` in csrc/<stem>.cu's library, from
    `cuobjdump -sass`: (instructions, LDS) of the branch-free stretch of code
    that holds the most shared-memory loads, the element loop's body:
    {(OBJ, WITH_GRAD): (instructions, LDS)}; None when the toolkit has no
    cuobjdump."""
    import re
    import shutil

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    text = subprocess.run([tool, "-sass", str(_build._library_path(stem))],
                          capture_output=True, text=True, check=True).stdout
    found = {}
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        head = chunk.splitlines()[0]  # the name, mangled or not
        m = (re.search(kernel + r"ILi(\d+)ELb([01])E", head)
             or re.search(kernel + r"<(\d+), *(true|false|1|0)>", head))
        if not m:
            continue
        insts, starts = [], set()  # (address, text); addresses that begin a block
        for line in chunk.splitlines():
            if re.match(r"\s*\.L_x_\d+:", line):
                starts.add(len(insts))
                continue
            im = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if im:
                insts.append((int(im.group(1), 16), im.group(2)))
        targets = {int(h, 16) for _, ins in insts
                   for h in re.findall(r"\bBRA\S*\s+(?:\S+,\s*)?0x([0-9a-f]+)", ins)}
        blocks, n, lds = [], 0, 0  # (LDS, instructions) of each stretch
        for i, (addr, ins) in enumerate(insts):
            if (i in starts or addr in targets) and n:
                blocks.append((lds, n))
                n, lds = 0, 0
            n += 1
            lds += bool(re.match(r"(@!?U?P\w+\s+)?LDS\b", ins))
            if re.search(r"\b(BRA|EXIT|RET|CALL|BSYNC|WARPSYNC)\b", ins):
                blocks.append((lds, n))
                n, lds = 0, 0
        lds, n = max(blocks + [(lds, n)], key=lambda b: (b[0], -b[1]))
        found[int(m.group(1)), m.group(2) in ("1", "true")] = (n, lds)
    return found


def max_sm_clock() -> int:
    """The card's largest SM clock, MHz, as nvidia-smi reads it."""
    return int(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])


def issue_bound_d128(sms, clock_mhz):
    """Phase 5: the staged B1a/B1b kernel's element-loop body from its SASS,
    and the issue bound of that body alone at the scale cell's ladder
    (ackley, 327,680 × 128): one warp instruction a clock on each of an
    SM's four schedulers at the card's largest SM clock, the instructions
    an element taken as the body's instructions over its loads (LDS). The
    rest of a row's instructions (butterflies, the ring's bookkeeping) is
    not counted, so the bound is low. Returns (bound ms, instructions an
    element) or None."""
    blocks = sass_blocks("fused_obj", "fused_obj_staged_kernel")
    if blocks is None:
        print("sass: no cuobjdump in the toolkit; issue bound not measured")
        return None
    from repro_torch.kernels import fused_obj

    out = None
    for (obj_id, with_grad), (n, lds) in sorted(blocks.items()):
        obj = fused_obj.FUSED_OBJECTIVES[obj_id]
        grad = "value+grad" if with_grad else "value"
        print(f"sass fused_obj_staged_kernel {obj} {grad}: element-loop body {n} "
              f"instructions for {lds} LDS ({n / max(lds, 1):.2f} an element)")
        if obj == "ackley" and not with_grad and lds:
            per_elem = n / lds
            warp_insts = 327_680 * 128 / 32 * per_elem
            bound = warp_insts / (sms * 4 * clock_mhz * 1e6) * 1e3
            out = (bound, per_elem)
            print(f"issue bound, B1a ackley 327680 x 128, element loop alone: {per_elem:.2f} "
                  f"instructions an element, {warp_insts:.4g} warp instructions over {sms} "
                  f"SMs x 4 schedulers at {clock_mhz} MHz = {bound:.4f} ms (byte bound "
                  f"{327_680 * 129 * 4 / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    return out


def time_enqueue(cases, upd_cases, mk_cases, gen):
    """Phase 5, the host's cost of one call of each kernel wrapper and of
    torch.bmm at the paper shapes (B6 on the paper swarm, 2048 × 5; B8 on a
    small bf16 case): ENQUEUE_CALLS calls back to back after a warm-up, with
    no synchronise, on the host clock, in two rounds. Each call's device
    work there is a few µs, so the launch queue does not fill and the clock
    reads the host's enqueue. Returns µs a call, the lower of the rounds."""
    import torch
    from repro_torch.kernels import (direction, flash_attention, fused_obj, meanfield_step,
                                     pso_step, sweep_megakernel)

    c, u = cases["paper"], upd_cases["paper"]
    m = mk_cases["megakernel-paper", "rastrigin"]
    mk = (m["objective"], m["X"], m["P"], m["G"], m["H"], m["active"])
    alpha = m["alphas"][2].expand(m["X"].shape[0]).contiguous()
    x, v, _, xbar, xi, _ = c["pso"]
    q, k, vv = (torch.randn(1, 128, 2, 64, generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(3))
    calls = {
        "fused_value": lambda: fused_obj.value_grad_cuda("rastrigin", c["ladder"], False),
        "fused_value_grad": lambda: fused_obj.value_grad_cuda("rastrigin", c["commit"]),
        "direction": lambda: direction.direction_cuda(c["H"], c["g_new"]),
        "torch.bmm": lambda: torch.bmm(c["H"], c["g_new"][:, :, None]),
        "pso_step_update": lambda: pso_step.pso_step_cuda(*c["pso"], 0.5, 1.2, 1.5),
        **{kname: (lambda f=f, a=a: f(*a)) for kname, (f, _, a) in update_calls(u).items()},
        "meanfield_step_update": lambda: meanfield_step.meanfield_step_cuda(
            x, v, xbar, xi, 0.5, 1.2, 0.3),
        "sweep_megakernel_full": lambda: sweep_megakernel.sweep_megakernel_full_cuda(
            *mk, m["rhs"], m["alphas"], m["exhaust"]),
        "sweep_megakernel_commit": lambda: sweep_megakernel.sweep_megakernel_commit_cuda(
            *mk, alpha),
        "flash_attention": lambda: flash_attention.flash_attention_cuda(q, k, vv),
    }
    rounds = {name: [] for name in calls}
    for _ in range(2):
        for name, fn in calls.items():
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ENQUEUE_CALLS):
                fn()
            rounds[name].append((time.perf_counter() - t0) / ENQUEUE_CALLS * 1e6)
            torch.cuda.synchronize()
    for name, us in rounds.items():
        print(f"enqueue {name}: {us[0]:.2f} / {us[1]:.2f} µs a call over {ENQUEUE_CALLS} calls, "
              "no synchronise (host clock)")
    return {name: min(us) for name, us in rounds.items()}


def launch_path():
    """`--launch-path`: the host enqueue costs and B3 against torch.bmm at
    the paper shapes, for the repro_torch beside the script."""
    import torch
    from repro_torch.kernels import _build

    _build.build_all()
    solve_cfg = solves()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    cases = {"paper": kernel_cases(solve_cfg["paper"], "rastrigin", 5, gen)}
    upd = update_cases(torch.Generator(device="cuda").manual_seed(19),
                       shapes=[s for s in UPDATE_SHAPES if s[0] == "paper"])
    mk = megakernel_cases(solve_cfg, gen, cells=("megakernel-paper",), streaming=False)
    print(json.dumps({"enqueue_us": time_enqueue(cases, upd, mk, gen)}))
    time_b3_against_bmm(cases["paper"])


def fused_path():
    """`--fused`: phase 3's and phase 5's B1a/B1b parts (check_fused_dims,
    check_trig, time_fused_dims, time_fused_d128 and the staged kernel's
    element-loop body), for the repro_torch beside the script."""
    import torch
    from repro_torch.kernels import _build, fused_obj

    _build.build_all()
    print_ptxas({k: v for k, v in _build.BUILD_LOG.items() if k == "fused_obj"})
    gen = torch.Generator(device="cuda").manual_seed(1234)
    check_fused_dims(gen)
    if hasattr(fused_obj, "trig_check_cuda"):  # not in a tree from before it
        check_trig()
    time_fused_dims(gen)
    time_fused_d128(gen)
    issue_bound_d128(torch.cuda.get_device_properties(0).multi_processor_count,
                     max_sm_clock())


def check_stream_handle(case):
    """Phase 5: the stream a wrapper launches on (kernels/_build.stream, the
    raw handle of the current stream) is torch.cuda.current_stream()'s,
    also inside torch.cuda.stream(side), where B1b launched on the side
    stream must match its plain version."""
    import torch
    from repro_torch.kernels import _build, fused_obj

    x = case["commit"]
    main = (_build.stream(x), torch.cuda.current_stream().cuda_stream)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        inside = (_build.stream(x), torch.cuda.current_stream().cuda_stream)
        fk, gk = fused_obj.value_grad_cuda("rastrigin", x)
    torch.cuda.current_stream().wait_stream(side)
    fp, gp = fused_obj.value_grad_plain("rastrigin", x)
    ea, eb = compare(fk, fp), compare(gk, gp)
    require(main[0] == main[1], f"stream: _build.stream {main[0]:#x} != current stream "
            f"{main[1]:#x}")
    require(inside[0] == inside[1] == side.cuda_stream and inside[0] != main[0],
            f"stream: inside torch.cuda.stream(side) _build.stream {inside[0]:#x}, current "
            f"{inside[1]:#x}, side {side.cuda_stream:#x}")
    require(ea[2] and eb[2], f"stream: B1b on the side stream disagrees (f {ea[:2]}, "
            f"g {eb[:2]})")
    print(f"stream: _build.stream {main[0]:#x} == torch.cuda.current_stream().cuda_stream "
          f"{main[1]:#x}; inside torch.cuda.stream(side) {inside[0]:#x} == {inside[1]:#x} "
          f"(the side stream); B1b launched there: max_abs_err f {ea[0]:.3g} g {eb[0]:.3g}")


def time_updates(cases):
    """Phase 5, B2, B7a and B7b at every update shape: kernel and plain
    version in turns; no single PyTorch call computes any of them. Beside
    them, as a yardstick of the rate the card reaches on these bytes, one
    H.clone() (H read and written once, no arithmetic)."""
    from repro_torch.kernels import ops

    timings = {}
    for label, c in cases.items():
        B, D = c["g_new"].shape
        print(f"time update {label} H.clone() B={B} D={D}: {time_ms(c['H'].clone):.4f} ms")
        for kname, (kern, plain, args) in update_calls(c).items():
            p1, k1, k2, p2 = (time_ms(lambda f=f: f(*args))
                              for f in (plain, kern, kern, plain))
            bound_ms, bound_by = update_bounds(kname, B, D)
            timings[kname, label] = dict(ms=min(k1, k2), plain_ms=min(p1, p2),
                                         library_ms=None, bound_ms=bound_ms,
                                         bound_by=bound_by)
            print(f"time update {label} {kname} B={B} D={D} ({ops.update_variant(D)}): "
                  f"kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by})")
    return timings


def time_meanfield_step(cases):
    """Phase 5, B6 (anisotropic, the solve's envelope) at the mean-field
    shape: kernel and plain version in turns; no single PyTorch call
    computes it."""
    from repro_torch.kernels import meanfield_step

    c = cases["meanfield"]
    args = (c["x"], c["v"], c["xbar"], c["xi"], 0.5, 1.2, 0.3, "anisotropic")
    kern, plain = meanfield_step.meanfield_step_cuda, meanfield_step.meanfield_step_plain
    p1, k1, k2, p2 = (time_ms(lambda f=f: f(*args)) for f in (plain, kern, kern, plain))
    bound_ms, bound_by = meanfield_bounds(c)
    print(f"time meanfield meanfield_step_update: kernel {k1:.4f}/{k2:.4f} ms, plain "
          f"{p1:.4f}/{p2:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return {("meanfield_step_update", "meanfield"): dict(
        ms=min(k1, k2), plain_ms=min(p1, p2), library_ms=None, bound_ms=bound_ms,
        bound_by=bound_by)}


def megakernel_bounds(kname, c):
    """bounds() for B5 and B5b, from the case's shapes: read x, p, g, H and
    the active mask (and rhs and the ladder, or α), write x', f', g', H', p'
    (and α and the rung); the trial fan's objective terms (B5), the value
    and gradient at x', the step, the pairs, δxᵀδg, and the update's
    12·D² + p's 2·D² per lane."""
    C, D = c["X"].shape
    K = c["rhs"].shape[0]
    f4 = 4
    value = {"sphere": 2, "rastrigin": 6, "rosenbrock": 8, "ackley": 5}[c["objective"]]
    grad = {"sphere": 1, "rastrigin": 5, "rosenbrock": 9, "ackley": 6}[c["objective"]]
    nbytes = 2 * C * D * D * f4 + 6 * C * D * f4 + C * f4 + C
    ops = C * (D * (value + grad) + 8 * D + 14 * D * D)
    if kname == "sweep_megakernel_full":
        nbytes += K * C * f4 + K * f4 + 2 * C * f4
        ops += K * C * D * (2 + value)
    else:
        nbytes += C * f4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_megakernels(cases):
    """Phase 5, B5 and B5b at the cells of KERNEL_CELLS: kernel and plain
    version in turns; no single PyTorch call computes either."""
    from repro_torch.kernels import sweep_megakernel

    timings = {}
    for kname in ("sweep_megakernel_full", "sweep_megakernel_commit"):
        for cell in KERNEL_CELLS[kname]:
            c = next(c for (cc, _), c in cases.items()
                     if cc == MEGAKERNEL_CASE[cell] and c["timed"])
            args = (c["objective"], c["X"], c["P"], c["G"], c["H"], c["active"])
            if kname == "sweep_megakernel_full":
                extra = (c["rhs"], c["alphas"], c["exhaust"])
                kern = sweep_megakernel.sweep_megakernel_full_cuda
                plain = sweep_megakernel.sweep_megakernel_full_plain
            else:
                extra = (sweep_megakernel.sweep_megakernel_full_plain(
                    *args, c["rhs"], c["alphas"], c["exhaust"])[5],)
                kern = sweep_megakernel.sweep_megakernel_commit_cuda
                plain = sweep_megakernel.sweep_megakernel_commit_plain
            p1, k1, k2, p2 = (time_ms(lambda f=f: f(*args, *extra))
                              for f in (plain, kern, kern, plain))
            bound_ms, bound_by = megakernel_bounds(kname, c)
            timings[kname, cell] = dict(ms=min(k1, k2), plain_ms=min(p1, p2),
                                        library_ms=None, bound_ms=bound_ms,
                                        bound_by=bound_by)
            print(f"time {cell} {kname} C={c['X'].shape[0]} D={c['X'].shape[1]}: kernel "
                  f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by})")
    return timings

# ---------------------------------------------------------------------------
# the LM serving path: B8 and the phi3-mini runs
# ---------------------------------------------------------------------------
def flash_inputs(gen):
    """Unit-normal q, k, v on the card at each FLASH_CASES shape."""
    import torch

    cases = {}
    for name, B, Sq, Sk, H, KV, hd, dtype, causal in FLASH_CASES:
        dt = getattr(torch, dtype)

        def normal(*shape, dt=dt):
            return torch.randn(shape, generator=gen, device="cuda").to(dt)

        cases[name] = dict(q=normal(B, Sq, H, hd), k=normal(B, Sk, KV, hd),
                           v=normal(B, Sk, KV, hd), causal=causal, dtype=dtype,
                           scale=hd ** -0.5)
    return cases


def check_flash(cases):
    """Phase 3, B8: the kernel against its plain version on the same
    inputs, |k − p| <= tol + tol·|p| with FLASH_TOL by dtype. Returns the
    max abs error of each case."""
    import torch
    from repro_torch.kernels import flash_attention

    errors = {}
    for name, c in cases.items():
        args = (c["q"], c["k"], c["v"])
        o = flash_attention.flash_attention_cuda(*args, causal=c["causal"], scale=c["scale"])
        p = flash_attention.flash_attention_plain(*args, causal=c["causal"], scale=c["scale"])
        tol = FLASH_TOL[c["dtype"]]
        err = (o.double() - p.double()).abs()
        worst = float((err / (tol + tol * p.double().abs())).max())
        require(bool(torch.isfinite(o).all()) and worst <= 1.0,
                f"B8 {name}: kernel disagrees with plain (max abs err {float(err.max()):.3g}, "
                f"{worst:.3g} of the tolerance)")
        errors[name] = float(err.max())
        B, Sq, H, hd = c["q"].shape
        print(f"check B8 {name} B={B} Sq={Sq} Sk={c['k'].shape[1]} H={H} KV={c['k'].shape[2]}"
              f" hd={hd} {c['dtype']} causal={c['causal']}: max_abs_err {errors[name]:.3g} "
              f"({worst:.3g} of tol {tol:g} + {tol:g}·|p|)")
    torch.cuda.synchronize()
    return errors


def lm_model(seed, num_layers=None, dtype="bfloat16"):
    """LM_ARCH at full width (num_layers, if given, cut the depth), weights
    drawn on the card from a seeded generator in `dtype`, which is also
    the compute dtype."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(LM_ARCH)
    cfg = dataclasses.replace(cfg, num_layers=num_layers or cfg.num_layers, dtype=dtype)
    model = build_model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(seed), getattr(torch, dtype),
                        device="cuda")
    return model, params


def token_ids(vocab, shape, seed):
    import torch

    return torch.randint(0, vocab, shape, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(seed))


def check_lm_launches(run, counts, flash):
    """B8 launched exactly `flash` times and no ZEUS kernel at all."""
    for k, n in counts.items():
        want = flash if k == "flash_attention" else 0
        require(n == want, f"{run}: kernel {k} launched {n} times, expected {want}")


def decode_logits(model, params, tokens):
    """The decode path's logits at every position of `tokens` (B, S): one
    decode_step a token into a float32 cache of length S. (B, S, V) fp32."""
    import torch
    from repro_torch.models.transformer import materialize_cache

    B, S = tokens.shape
    cache = materialize_cache(model.cache_specs(B, S, torch.float32), tokens.device)
    out = []
    for i in range(S):
        logits, cache = model.decode_step(params, cache, tokens[:, i:i + 1], i)
        out.append(logits[:, 0].float())
    return torch.stack(out, dim=1)


def reference_logits(model, params, tokens, dtype, device):
    """`model`'s logits at every position evaluated in `dtype` on `device`
    ("highest" matmul precision), from its parameters cast there: the same
    function with finer rounding, the yardstick of both serving paths. On
    the CPU, attention takes B8's plain version."""
    import torch
    from repro_torch.models import layers, transformer
    from repro_torch.models.common import tree_map

    cfg = model.cfg
    p = tree_map(lambda t: t.to(device=device, dtype=dtype), params, is_leaf=torch.is_tensor)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        x = model._embed_in(p, {"tokens": tokens.to(device)}, dtype)
        pos = torch.arange(x.shape[1], dtype=torch.int32, device=device)
        for pl in model._layers(p["blocks"]):
            x = transformer.attn_block_forward(pl, x, pos, cfg)
        x = layers.apply_norm(p["final_norm"], x, cfg.norm_kind)
        return layers.unembed(p["embed"], x, cfg)
    finally:
        torch.set_float32_matmul_precision(prev)


def timed(fn, run, flash):
    """(result, wall s, launch counts) of fn(), counters set to 0 just
    before and read just after, the launches checked."""
    import torch
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    check_lm_launches(run, counts, flash)
    return out, wall, counts


def run_lm():
    """Phase 4, the LM serving path: lm-prefill, lm-generate and lm-parity
    (and lm-prefill's phase 4c profile). Returns each run's launch counts."""
    import torch
    from repro_torch.serve.decode import greedy_generate, make_prefill_step

    t0 = time.perf_counter()
    model, params = lm_model(seed=0)
    torch.cuda.synchronize()
    cfg = model.cfg
    L, V = cfg.num_layers, cfg.vocab_size
    print(f"lm {LM_ARCH}: {model.n_params()} parameters in bf16, {L} layers, drawn in "
          f"{time.perf_counter() - t0:.2f} s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          "allocated")
    launches = {}

    prefill = make_prefill_step(model, last_only=True)
    batch = {"tokens": token_ids(V, (PREFILL_B, PREFILL_S), 1)}
    _, cold, _ = timed(lambda: prefill(params, batch), "lm-prefill (cold)", L)
    logits, warm, launches["lm-prefill"] = timed(lambda: prefill(params, batch),
                                                 "lm-prefill", L)
    require(tuple(logits.shape) == (PREFILL_B, 1, V) and bool(torch.isfinite(logits).all()),
            f"lm-prefill: logits {tuple(logits.shape)} not ({PREFILL_B}, 1, {V}) and finite")
    print(f"lm lm-prefill: B={PREFILL_B} S={PREFILL_S}: wall {cold:.4f} s cold, {warm:.4f} s "
          f"warm ({PREFILL_B * PREFILL_S / warm:.0f} prompt tokens/s); logits "
          f"{tuple(logits.shape)} finite; launches {json.dumps(launches['lm-prefill'])}")

    prompt = token_ids(V, (GEN_B, GEN_PROMPT), 2)
    gen = lambda: greedy_generate(model, params, prompt, GEN_NEW, GEN_MAX_SEQ)  # noqa: E731
    _, cold, _ = timed(gen, "lm-generate (cold)", 0)
    toks, warm, launches["lm-generate"] = timed(gen, "lm-generate", 0)
    require(tuple(toks.shape) == (GEN_B, GEN_NEW) and bool(((toks >= 0) & (toks < V)).all()),
            f"lm-generate: tokens {tuple(toks.shape)} not ({GEN_B}, {GEN_NEW}) ids")
    steps = GEN_PROMPT + GEN_NEW - 1
    print(f"lm lm-generate: B={GEN_B}, prompt {GEN_PROMPT}, {GEN_NEW} new, max_seq "
          f"{GEN_MAX_SEQ}: {steps} decode steps, wall {cold:.4f} s cold, {warm:.4f} s warm "
          f"({GEN_B * GEN_NEW / warm:.1f} new tokens/s, {warm / steps * 1e3:.2f} ms a step); "
          f"launches {json.dumps(launches['lm-generate'])}")

    # bf16, full depth: the prefill's last logits (through B8) and the decode
    # path's, each against a float32 evaluation of the same weights
    last, _, counts = timed(lambda: prefill(params, {"tokens": prompt}), "lm-parity bf16", L)
    last = last[:, 0].float()
    dec = decode_logits(model, params, prompt)[:, -1]
    ref, _, ref_counts = timed(
        lambda: reference_logits(model, params, prompt, torch.float32, "cuda")[:, -1],
        "lm-parity bf16 (float32 evaluation)", L)
    std = float(last.std())
    rel = float((last - dec).abs().max()) / std
    top2 = torch.topk(last, 2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]) / std
    decided = margin > ARGMAX_MARGIN
    agree = last.argmax(-1) == dec.argmax(-1)
    ref_std = float(ref.std())
    d_pre = float((last - ref).abs().mean()) / ref_std
    d_dec = float((dec - ref).abs().mean()) / ref_std
    print(f"lm lm-parity bf16, {L} layers, prompt {GEN_PROMPT}, B={GEN_B}: prefill vs decode "
          f"last logits max|Δ|/std {rel:.4g}, mean|Δ|/std "
          f"{float((last - dec).abs().mean()) / std:.4g}; argmax equal on "
          f"{int(agree.sum())} of {GEN_B} rows, on {int(agree[decided].sum())} of the "
          f"{int(decided.sum())} whose top-2 margin exceeds {ARGMAX_MARGIN}·std (margins/std "
          f"{[round(m, 4) for m in margin.tolist()]}); against the float32 evaluation: "
          f"mean|Δ|/std prefill {d_pre:.4g}, decode {d_dec:.4g}, argmax equal on "
          f"{int((last.argmax(-1) == ref.argmax(-1)).sum())} and "
          f"{int((dec.argmax(-1) == ref.argmax(-1)).sum())} of {GEN_B} rows; launches "
          f"{json.dumps(counts)}, float32 evaluation {json.dumps(ref_counts)}")
    require(math.isfinite(d_pre) and d_pre <= BF16_REF_RATIO * d_dec,
            f"lm-parity bf16: the prefill's last logits stand {d_pre:.4g} of std from the "
            f"float32 evaluation, more than {BF16_REF_RATIO}× the decode path's {d_dec:.4g}")
    del ref

    profile_lm_prefill(prefill, params, batch)  # phase 4c
    del model, params, prefill, logits
    torch.cuda.empty_cache()

    # float32, 4 layers: the prefill's logits at every position against the
    # decode path's, and each against a float64 evaluation on the host
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        model, params = lm_model(seed=4, num_layers=PARITY_LAYERS, dtype="float32")
        tokens = token_ids(V, (PARITY_B, PARITY_S), 5)
        full, _, launches["lm-parity"] = timed(
            lambda: make_prefill_step(model, last_only=False)(params, {"tokens": tokens}),
            "lm-parity float32", PARITY_LAYERS)
        dec = decode_logits(model, params, tokens)
    finally:
        torch.set_float32_matmul_precision(prev)
    t0 = time.perf_counter()
    ref = reference_logits(model, params, tokens, torch.float64, "cpu")
    ref_s = time.perf_counter() - t0
    std = float(ref.std())
    gap = float((full - dec).abs().max()) / std
    d_pre, d_dec = ((x.cpu().double() - ref).abs() / std for x in (full, dec))
    print(f"lm lm-parity float32, {PARITY_LAYERS} layers, B={PARITY_B} S={PARITY_S}: "
          f"prefill vs decode logits at every position max|Δ|/std {gap:.4g} ("
          f"{'<' if gap < PARITY_TOL else '>='} {PARITY_TOL}); against a float64 evaluation "
          f"on the host ({ref_s:.1f} s), mean|Δ|/std prefill {float(d_pre.mean()):.4g}, decode "
          f"{float(d_dec.mean()):.4g}, max|Δ|/std prefill {float(d_pre.max()):.4g}, decode "
          f"{float(d_dec.max()):.4g}; launches {json.dumps(launches['lm-parity'])}")
    require(bool(torch.isfinite(d_pre).all())
            and float(d_pre.mean()) <= F32_REF_RATIO * float(d_dec.mean()),
            f"lm-parity float32: the prefill's logits stand {float(d_pre.mean()):.4g} of std "
            f"from the float64 evaluation on average, more than {F32_REF_RATIO}× the decode "
            f"path's {float(d_dec.mean()):.4g}")
    del model, params, full, dec
    torch.cuda.empty_cache()
    return launches


def print_profile(label, prof, wall_us):
    """Device-busy share of the wall and the top kernels by device time."""
    import torch

    rows = [(e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    if not rows:
        print(f"profile {label}: the profiler recorded no device time")
        return
    busy = sum(r[0] for r in rows)
    print(f"profile {label}: wall {wall_us / 1e3:.1f} ms under the profiler, device "
          f"busy {busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%)")
    for t, key, n in rows[:8]:
        print(f"  {t / 1e3:9.3f} ms {100 * t / busy:5.1f}%  x{n:<6d} {key[:90]}")


def profile_lm_prefill(prefill, params, batch):
    """Phase 4c for lm-prefill: one warm call under torch.profiler, device
    activity only."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    print_profile("lm-prefill", prof, wall_us)


def bf16_peak(card: str) -> float:
    return next((peak for name, peak in BF16_PEAK if name in card), BF16_PEAK_DEFAULT)


def flash_bound(c, card):
    """(bound_ms, bound_by) of B8 on case c: q, k, v read once and o written
    once over 3.35 TB/s, against 4·hd FLOPs for each (q, k) pair the mask
    keeps over the card's dense peak for the dtype (bf16 tensor cores; fp32
    outside them)."""
    B, Sq, H, hd = c["q"].shape
    Sk, KV = c["k"].shape[1], c["k"].shape[2]
    nbytes = (2 * B * Sq * H * hd + 2 * B * Sk * KV * hd) * c["q"].element_size()
    pairs = sum(min(i + 1, Sk) for i in range(Sq)) if c["causal"] else Sq * Sk
    ops = 4 * hd * B * H * pairs
    peak = bf16_peak(card) if c["dtype"] == "bfloat16" else FP32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_flash(cases, card):
    """Phase 5, B8 at the phi3-mini prefill shape (the lm-prefill cell) and
    the starcoder2 GQA shape: kernel and plain version in turns, and
    scaled_dot_product_attention on the same inputs as the library time
    (with enable_gqa where KV < H), its largest difference from the plain
    version printed."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention

    timings = {}
    for name, cell in (("phi3-mini prefill", "lm-prefill"), ("starcoder2-15b GQA", None)):
        c = cases[name]
        q, k, v, scale = c["q"], c["k"], c["v"], c["scale"]
        H, KV = q.shape[2], k.shape[2]
        kern = lambda: flash_attention.flash_attention_cuda(q, k, v, causal=True,  # noqa: E731
                                                            scale=scale)
        plain = lambda: flash_attention.flash_attention_plain(q, k, v, causal=True,  # noqa: E731
                                                              scale=scale)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
            scale=scale, enable_gqa=KV < H).transpose(1, 2)
        lib_err = float((lib().double() - plain().double()).abs().max())
        p1, k1, k2, p2 = time_ms(plain), time_ms(kern), time_ms(kern), time_ms(plain)
        lib_ms = time_ms(lib)
        bound_ms, bound_by = flash_bound(c, card)
        print(f"time B8 {name}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}), scaled_dot_product_attention "
              f"{lib_ms:.4f} ms (max abs diff from plain {lib_err:.3g})")
        if cell:
            timings["flash_attention", cell] = dict(
                ms=min(k1, k2), plain_ms=min(p1, p2), library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by)
    return timings


def print_ptxas(build_log):
    """Each kernel's registers, spills and static shared memory from the
    build's `-Xptxas=-v` output, by entry function."""
    for stem, log in build_log.items():
        entry = "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line.strip()
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {stem} {entry}: {line.split(':', 1)[-1].strip()}")


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU host",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import _build, ops

    if sys.argv[1:] == ["--chunk-memory"]:
        chunk_memory()
        return 0
    if sys.argv[1:] == ["--launch-path"]:
        launch_path()
        return 0
    if sys.argv[1:] == ["--fused"]:
        fused_path()
        return 0
    if sys.argv[1:] == ["--serve"]:
        _build.build_all()
        print(json.dumps({"launch_counts": run_service_cells()}))
        return 0
    if sys.argv[1:] == ["--f64"]:
        _build.build_all()
        print_ptxas(_build.BUILD_LOG)
        entries, launches = float64_phases(torch.Generator(device="cuda").manual_seed(64))
        print(json.dumps({"launch_counts": launches}))
        print(json.dumps({"kernels": entries}))
        return 0
    if sys.argv[1:] == ["--tiny"]:
        _build.build_all()
        gen = torch.Generator(device="cuda").manual_seed(22)
        check_tiny_buckets(gen)
        check_tiny_solves(gen)
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # phase 2
    t0 = time.perf_counter()
    _build.build_all()
    for stem in _build.SOURCES:
        _build.library(stem)
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(_build.SOURCES)} "
          "kernel sources (parallel nvcc)")
    print_ptxas(_build.BUILD_LOG)

    # phase 3
    solve_cfg = solves()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    cases = {s: kernel_cases(solve_cfg[s], solve_cfg[s]["objective"], solve_cfg[s]["dim"],
                             gen) for s in ("paper", "scale", "meanfield")}
    errors = check_kernels(cases, solve_cfg)
    errors = {(k, s): e for s, per in errors.items() for k, e in per.items()}
    check_fused_dims(gen)
    check_trig()
    sw_cases = swarm_cases(gen)
    errors.update(check_meanfield_step(sw_cases))
    # the update shapes draw from a generator of their own
    upd_cases = update_cases(torch.Generator(device="cuda").manual_seed(19))
    upd_errors = check_updates(upd_cases)
    errors.update({(k, cell): upd_errors[k, shape] for cell, shape in UPDATE_SHAPE_OF.items()
                   for k in UPDATE_KERNELS if cell in KERNEL_CELLS[k]})
    mk_cases = megakernel_cases(solve_cfg, gen)
    errors.update(check_megakernels(mk_cases))
    tiny_gen = torch.Generator(device="cuda").manual_seed(22)
    check_tiny_buckets(tiny_gen)
    check_tiny_solves(tiny_gen)
    fl_cases = flash_inputs(gen)
    errors["flash_attention", "lm-prefill"] = (
        check_flash(fl_cases)["phi3-mini prefill"], 0.0, True)

    print(f"[{time.perf_counter() - t_start:.1f} s] kernels checked")
    launches, kept, warms = run_solves(solve_cfg)  # phase 4
    print(f"[{time.perf_counter() - t_start:.1f} s] solves done")
    launches.update(run_fault_solves(solve_cfg, launches, kept, warms))  # phase 4e
    del kept
    print(f"[{time.perf_counter() - t_start:.1f} s] fault-tolerance solves done")
    launches.update(run_service_cells())  # phase 4f
    print(f"[{time.perf_counter() - t_start:.1f} s] service cells done")
    launches.update(run_lm())  # phase 4, the LM serving path (with its 4c profile)
    print(f"[{time.perf_counter() - t_start:.1f} s] LM runs done")
    # phases 3, 4, 4c and 5 of the float64 path, on a generator of their own
    f64_entries_, f64_launches = float64_phases(torch.Generator(device="cuda").manual_seed(64))
    launches.update(f64_launches)
    print(f"[{time.perf_counter() - t_start:.1f} s] float64 kernels and cells done")
    chunk_memory()  # phase 4d
    profile_solves(solve_cfg)  # phase 4c
    print(f"[{time.perf_counter() - t_start:.1f} s] solves profiled")
    timings = {(k, s): t for s, per in time_kernels(cases, solve_cfg).items()
               for k, t in per.items()}  # phase 5
    time_b3_against_bmm(cases["paper"])
    time_fused_dims(gen)
    time_fused_d128(gen)
    issue_bound_d128(torch.cuda.get_device_properties(0).multi_processor_count,
                     max_sm_clock())
    enqueue_us = time_enqueue(cases, upd_cases, mk_cases, gen)
    check_stream_handle(cases["paper"])
    timings.update(time_meanfield_step(sw_cases))
    upd_timings = time_updates(upd_cases)
    timings.update({(k, cell): upd_timings[k, shape] for cell, shape in UPDATE_SHAPE_OF.items()
                    for k in UPDATE_KERNELS if cell in KERNEL_CELLS[k]})
    timings.update(time_megakernels(mk_cases))
    timings.update(time_flash(fl_cases, smi))
    print(f"[{time.perf_counter() - t_start:.1f} s] kernels timed")

    entries = []
    for kname, cells in KERNEL_CELLS.items():
        source, replaces = SOURCES[kname]
        for cell in cells:
            t = timings[kname, cell]
            entries.append(dict(
                name=f"{kname}/{cell}", route="cuda", source=source,
                replaces=replaces, launches=launches[cell][kname],
                max_abs_err=errors[kname, cell][0], ms=t["ms"],
                plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], library_ms=t["library_ms"],
                enqueue_us=enqueue_us[kname]))
            if kname in ("fused_value", "fused_value_grad"):
                dim = solve_cfg[cell]["dim"]
                entries[-1]["variant"] = ops.fused_obj_variant(dim)
                entries[-1]["layout"] = f"{fused_layout(dim)} at D = {dim}"
    entries += f64_entries_
    print(json.dumps({"launch_counts": launches}))
    print(json.dumps({"enqueue_us": enqueue_us}))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
