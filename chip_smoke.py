#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of ZEUS on one NVIDIA GPU (Hopper).

    python3 chip_smoke.py        # from the repository root, on a GPU host

Phases (any failure exits non-zero):
  1. the card's name and power limit, and torch's CUDA version;
  2. build the five kernel sources from src/repro_torch/kernels/csrc (one
     nvcc each, in parallel);
  3. hold each kernel against its plain PyTorch version on the card at the
     shapes its solves give it: B1-B4 at the paper and scale shapes, plus
     the two bitwise contracts (value-only f == value+grad f; H' == H where
     ρ = 0) and ackley's NaN gradient at the origin; B7a/B7b at the per-lane
     shapes with a lane on the engine's stand-in pair (1, …, 1); B6 at the
     mean-field shape in both noise modes, with non-finite rows, and at a
     row count that is no multiple of the block (anisotropic bitwise);
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
     then, for paper and scale, the first 3 batched sweeps and, for the two
     per-lane pallas solves, the first 3 per-lane sweeps, each from the
     kernel path's state, through the kernels and through the plain
     versions: rung (or trial count) and status must agree except at
     certified knife edges, and the state within tolerance; time
     cluster_solutions on paper and scale (at scale, on the first 1024 and
     2048 converged lanes: its host loop is O(lanes × clusters)); and
     profile each solve once more (device-busy share, top kernels);
  4d. peak device memory of run_multistart at the scale shape (3 sweeps),
     unchunked and with lane_chunk 4096 and 1024: chunking must lower it;
  5. time each kernel with CUDA events beside its plain version, its bound
     and (direction only) torch.bmm;
  6. print one JSON line {"kernels": [...]} with the measurements, the
     card's name and power limit, and last {"ok": true, "device": {...}}.

`python3 chip_smoke.py --chunk-memory` runs phase 4d alone, against the
repro_torch beside the script (to compare two trees on one card).

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
}
# the batched dense-BFGS path's kernels (the PR-12 cells paper and scale)
BATCHED_KERNELS = ("fused_value", "fused_value_grad", "guarded_update_direction",
                   "direction", "pso_step_update")
# the cells at which each kernel is timed, in the kernels line
KERNEL_CELLS = {
    **{k: ("paper", "scale") for k in BATCHED_KERNELS},
    "bfgs_update": ("per_lane-paper", "per_lane-scale"),
    "bfgs_update_direction": ("per_lane-scale",),
    "meanfield_step_update": ("meanfield",),
}
MEANFIELD_RAGGED_N = 100_003  # no multiple of the kernels' 256-thread blocks


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
    }


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------
def time_ms(fn) -> float:
    """Mean ms per call over a CUDA-event-timed run of back-to-back calls
    (after warm-up), sized to about 0.2 s."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    reps = max(5, min(500, int(200.0 / max(start.elapsed_time(end), 1e-3))))
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


def kernel_cases(solve, name, dim, gen):
    """The kernels' inputs at the shapes this solve gives them: the Armijo
    ladder (K·C rows), the commit value+grad (C rows), the BFGS update and
    first direction (C lanes) and the PSO step (N particles), C being the
    lane chunk."""
    import torch
    from repro_torch.core import get_objective

    obj = get_objective(name)
    n = solve["opts"].pso.n_particles
    C = solve["opts"].lane_chunk or n

    def box(*shape):
        return obj.lower + (obj.upper - obj.lower) * torch.rand(
            shape, generator=gen, device="cuda")

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    ladder = box(K_LADDER * C, dim)
    ladder[0].zero_()  # ackley's origin row: f finite, gradient NaN
    A = 0.1 * normal(C, dim, dim) / math.sqrt(dim)
    H = torch.eye(dim, device="cuda") + 0.5 * (A + A.transpose(1, 2))
    dx = normal(C, dim)
    dg = dx * (1.0 + torch.rand(C, dim, generator=gen, device="cuda"))
    rho = 1.0 / torch.sum(dx * dg, dim=-1)
    frozen = torch.arange(C, device="cuda") % 7 == 0  # the guard's ρ = 0 lanes
    rho = torch.where(frozen, 0.0, rho)
    dx = torch.where(frozen[:, None], 0.0, dx)
    dg = torch.where(frozen[:, None], 0.0, dg)
    return dict(
        ladder=ladder, commit=box(C, dim).contiguous(),
        H=H.contiguous(), dx=dx, dg=dg, g_new=normal(C, dim), rho=rho.contiguous(),
        frozen=frozen,
        pso=[box(n, dim), normal(n, dim), box(n, dim), box(dim),
             torch.rand(n, dim, generator=gen, device="cuda"),
             torch.rand(n, dim, generator=gen, device="cuda")],
    )


def bounds(kname, case, dim, objective):
    """(bound_ms, bound_by): the larger of bytes over 3.35 TB/s and fp32
    operations over 67 TFLOP/s, each input read once and each output
    written once; a transcendental counts as one operation."""
    f4 = 4
    if kname in ("fused_value", "fused_value_grad"):
        N = case["ladder" if kname == "fused_value" else "commit"].shape[0]
        nbytes = N * dim * f4 + N * f4
        per_elem = {"sphere": 2, "rastrigin": 6, "rosenbrock": 8, "ackley": 5}[objective]
        ops = N * dim * per_elem
        if kname == "fused_value_grad":
            nbytes += N * dim * f4
            ops += N * dim * {"sphere": 1, "rastrigin": 5, "rosenbrock": 9,
                              "ackley": 6}[objective]
    elif kname == "guarded_update_direction":
        B = case["H"].shape[0]
        nbytes = 2 * B * dim * dim * f4 + 4 * B * dim * f4 + B * f4
        ops = B * (2 * dim * dim + 2 * dim + 8 * dim * dim + 2 * dim * dim)
    elif kname == "direction":
        B = case["H"].shape[0]
        nbytes = B * dim * dim * f4 + 2 * B * dim * f4
        ops = 2 * B * dim * dim
    else:  # pso_step_update
        N = case["pso"][0].shape[0]
        nbytes = 7 * N * dim * f4 + dim * f4
        ops = 11 * N * dim
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def new_kernel_cases(gen):
    """Inputs of B7a/B7b at the per-lane solves' shapes (C = 512 lanes of
    D = 5, and 16384 lanes of D = 128), lane 0 on the engine's stand-in pair
    (1, …, 1); and of B6 at the mean-field solve's shape (2^20 × 8) and at a
    ragged row count, with an inf in row 3 and a NaN in row 7."""
    import torch

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def update(B, D):
        A = 0.1 * normal(B, D, D) / math.sqrt(D)
        H = torch.eye(D, device="cuda") + 0.5 * (A + A.transpose(1, 2))
        dx = normal(B, D)
        dg = dx * (1.0 + torch.rand(B, D, generator=gen, device="cuda"))
        dx[0] = 1.0
        dg[0] = 1.0
        return dict(H=H.contiguous(), dx=dx, dg=dg, g_new=normal(B, D))

    def swarm(N, D):
        x = 5.12 * (2.0 * torch.rand(N, D, generator=gen, device="cuda") - 1.0)
        x[3, 1] = float("inf")
        x[7, 0] = float("nan")
        return dict(x=x, v=normal(N, D), xbar=normal(D), xi=normal(N, D))

    return {"per_lane-paper": update(512, 5), "per_lane-scale": update(16384, 128),
            "meanfield": swarm(2**20, 8), "meanfield-ragged": swarm(MEANFIELD_RAGGED_N, 8)}


def new_bounds(kname, case):
    """bounds() for B7a, B7b and B6, from the case's shapes."""
    f4 = 4
    if kname == "meanfield_step_update":
        N, D = case["x"].shape
        nbytes = 5 * N * D * f4 + D * f4
        ops = 8 * N * D  # d, w·v, λ·d, σ·d, ·ξ, two adds, x + v'
    else:
        B, D, _ = case["H"].shape
        # read H, δx, δg; write H'. u = Hδg, s, δxᵀδg, and 8 ops an entry
        nbytes = 2 * B * D * D * f4 + 2 * B * D * f4
        ops = B * (10 * D * D + 4 * D)
        if kname == "bfgs_update_direction":
            nbytes += 2 * B * D * f4  # read g', write p'
            ops += 2 * B * D * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def check_kernels(cases_by_solve, solve_cfg):
    """Phase 3: every kernel against its plain version on the card."""
    import torch
    from repro_torch.kernels import bfgs_update, direction, fused_obj, pso_step

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

        args = (case["H"], case["dx"], case["dg"], case["g_new"], case["rho"])
        Hk, pk = bfgs_update.guarded_update_direction_cuda(*args)
        Hp, pp = bfgs_update.guarded_update_direction_plain(*args)
        frozen = case["frozen"]
        require(torch.equal(Hk[frozen], case["H"][frozen]),
                f"{sname}: H' != H bitwise on rho = 0 lanes")
        eh, ep = compare(Hk, Hp), compare(pk, pp)
        require(eh[2] and ep[2], f"{sname}: guarded_update_direction disagrees "
                f"(H {eh[:2]}, p {ep[:2]})")
        results["guarded_update_direction"] = (max(eh[0], ep[0]), max(eh[1], ep[1]), True)

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


def check_new_kernels(cases):
    """Phase 3, B7a/B7b and B6: each kernel against its plain version."""
    import torch
    from repro_torch.kernels import bfgs_update, meanfield_step

    errors = {}
    for cell in ("per_lane-paper", "per_lane-scale"):
        c = cases[cell]
        args = (c["H"], c["dx"], c["dg"])
        Hk, Hp = bfgs_update.bfgs_update_cuda(*args), bfgs_update.bfgs_update_plain(*args)
        e = compare(Hk, Hp)
        require(e[2], f"{cell}: bfgs_update disagrees with plain {e[:2]}")
        require(bool(torch.isfinite(Hk[0]).all()), f"{cell}: stand-in lane not finite")
        errors["bfgs_update", cell] = e
        Hk2, pk = bfgs_update.update_direction_cuda(*args, c["g_new"])
        Hp2, pp = bfgs_update.update_direction_plain(*args, c["g_new"])
        require(torch.equal(Hk2, Hk), f"{cell}: update_direction H' != bfgs_update H'")
        eh, ep = compare(Hk2, Hp2), compare(pk, pp)
        require(eh[2] and ep[2], f"{cell}: update_direction disagrees (H {eh[:2]}, "
                f"p {ep[:2]})")
        errors["bfgs_update_direction", cell] = (max(eh[0], ep[0]), max(eh[1], ep[1]), True)
        print(f"check {cell} bfgs_update B={Hk.shape[0]} D={Hk.shape[1]}: max_abs_err "
              f"{e[0]:.3g}; bfgs_update_direction: {errors['bfgs_update_direction', cell][0]:.3g}"
              ", same H' bitwise; stand-in lane finite")
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
    g, r = got.reshape(B, -1).double(), ref.reshape(B, -1).double()
    scale = r.abs().amax(dim=1).clamp_min(1.0)
    worst = float(((g - r).abs().amax(dim=1) / scale).max()) if B else 0.0
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
    path's exact state through the kernels and through the plain versions."""
    import torch
    from repro_torch.core import (BatchedDenseBFGS, as_batched, batch_lanes_init,
                                  batch_lanes_step, get_objective, phase2_setup,
                                  run_pso)
    from repro_torch.core.linesearch import armijo_thresholds, ladder_alphas

    obj = get_objective(cfg["objective"])
    opts = cfg["opts"]
    gen = torch.Generator(device="cuda").manual_seed(cfg["seed"])
    starts = run_pso(obj.fn, cfg["dim"], obj.lower, obj.upper, opts.pso,
                     device="cuda", generator=gen).x
    _, eopts = phase2_setup(opts)
    k_bobj, k_strat = as_batched(obj.fn), BatchedDenseBFGS()
    p_bobj, p_strat = _plain_path(cfg["objective"])
    kl = batch_lanes_init(k_bobj, k_strat, starts, eopts.theta)
    B = starts.shape[0]
    alphas = torch.as_tensor(ladder_alphas(eopts.ls_iters, "float32"), device="cuda")
    knife = ill = 0
    worst = {}
    for sweep in range(SWEEPS_COMPARED):
        pre = kl
        kl, _, k_rung = batch_lanes_step(k_bobj, k_strat, eopts, pre)
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
                    f"{int(k_rung[i])} (kernels) vs {int(p_rung[i])} (plain), "
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
          f"path's state, kernels vs plain: {knife} knife-edge lane-sweeps, rung and "
          f"status equal on the rest; {ill} lane-sweeps with an ill-conditioned "
          "update not held on H'/p'; max error over lane scale "
          + ", ".join(f"{k}={v:.3g}" for k, v in worst.items()))


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


def run_solve(cfg):
    """One solve of cfg on the card, from its seed."""
    import torch
    from repro_torch.core import get_objective, sequential_zeus, zeus

    obj = get_objective(cfg["objective"])
    if cfg.get("sequential"):
        return sequential_zeus(obj.fn, cfg["seed"], cfg["dim"], obj.lower, obj.upper,
                               cfg["opts"], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(cfg["seed"])
    return zeus(obj.fn, cfg["dim"], obj.lower, obj.upper, cfg["opts"], device="cuda",
                generator=gen)


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
        else:
            require(n == 0, f"{sname}: kernel {k} launched {n} times off its path")


def run_solves(solve_cfg):
    """Phase 4: the main paths, one solve at a time, counters read around it."""
    import torch
    from repro_torch.core import CONVERGED
    from repro_torch.kernels import ops

    launches = {}
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
                  f"{res.raw.iterations}, chunk-steps {res.raw.map_trips}, n_converged "
                  f"{res.n_converged}, best_f {best_f:.6g}, pso_best_f "
                  f"{float(res.pso_best_f):.6g}, launches {json.dumps(launches[sname])}")
            if cfg.get("cluster"):
                time_clustering(res.raw)
        del res
        if cfg.get("compare") == "batched":
            compare_sweeps(sname, cfg)
        elif cfg.get("compare") == "per_lane":
            compare_per_lane_sweeps(sname, cfg)
        torch.cuda.empty_cache()
    return launches


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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_solve(cfg)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # device-side events only (kernels, memcpy/memset): the aten:: ops
        # that launched them carry the same device time again
        rows = [(e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        rows = sorted((r for r in rows if r[0] > 0), reverse=True)
        busy = sum(r[0] for r in rows)
        if not rows:
            print(f"profile {sname}: the profiler recorded no device time")
            continue
        print(f"profile {sname}: wall {wall_us / 1e3:.1f} ms under the profiler, device "
              f"busy {busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%)")
        for t, key, n in rows[:8]:
            print(f"  {t / 1e3:9.3f} ms {100 * t / busy:5.1f}%  x{n:<6d} {key[:90]}")


def time_kernels(cases_by_solve, solve_cfg):
    """Phase 5: kernel, plain version and library call, timed on the card."""
    import torch
    from repro_torch.kernels import bfgs_update, direction, fused_obj, pso_step

    timings = {}
    for sname, case in cases_by_solve.items():
        objective, dim = solve_cfg[sname]["objective"], solve_cfg[sname]["dim"]
        upd = (case["H"], case["dx"], case["dg"], case["g_new"], case["rho"])
        pairs = {
            "fused_value": (
                lambda: fused_obj.value_grad_cuda(objective, case["ladder"], False),
                lambda: fused_obj.value_grad_plain(objective, case["ladder"], False),
                None),
            "fused_value_grad": (
                lambda: fused_obj.value_grad_cuda(objective, case["commit"]),
                lambda: fused_obj.value_grad_plain(objective, case["commit"]),
                None),
            "guarded_update_direction": (
                lambda: bfgs_update.guarded_update_direction_cuda(*upd),
                lambda: bfgs_update.guarded_update_direction_plain(*upd),
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


def time_new_kernels(cases):
    """Phase 5, B7a/B7b and B6 (anisotropic, the solve's envelope): kernel
    and plain version in turns; no single PyTorch call computes any of
    them."""
    from repro_torch.kernels import bfgs_update, meanfield_step

    timings = {}
    for kname, cell in (("bfgs_update", "per_lane-paper"), ("bfgs_update", "per_lane-scale"),
                        ("bfgs_update_direction", "per_lane-scale"),
                        ("meanfield_step_update", "meanfield")):
        c = cases[cell]
        if kname == "meanfield_step_update":
            args = (c["x"], c["v"], c["xbar"], c["xi"], 0.5, 1.2, 0.3, "anisotropic")
            kern, plain = meanfield_step.meanfield_step_cuda, meanfield_step.meanfield_step_plain
        elif kname == "bfgs_update":
            args = (c["H"], c["dx"], c["dg"])
            kern, plain = bfgs_update.bfgs_update_cuda, bfgs_update.bfgs_update_plain
        else:
            args = (c["H"], c["dx"], c["dg"], c["g_new"])
            kern, plain = bfgs_update.update_direction_cuda, bfgs_update.update_direction_plain
        p1, k1, k2, p2 = (time_ms(lambda f=f: f(*args))
                          for f in (plain, kern, kern, plain))
        bound_ms, bound_by = new_bounds(kname, c)
        timings[kname, cell] = dict(ms=min(k1, k2), plain_ms=min(p1, p2), library_ms=None,
                                    bound_ms=bound_ms, bound_by=bound_by)
        print(f"time {cell} {kname}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms,"
              f" bound {bound_ms:.4f} ms ({bound_by})")
    return timings


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU host",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import _build

    if sys.argv[1:] == ["--chunk-memory"]:
        chunk_memory()
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
    for stem, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {stem}: {line.strip()}")

    # phase 3
    solve_cfg = solves()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    cases = {s: kernel_cases(solve_cfg[s], solve_cfg[s]["objective"], solve_cfg[s]["dim"],
                             gen) for s in ("paper", "scale")}
    errors = check_kernels(cases, solve_cfg)
    errors = {(k, s): e for s, per in errors.items() for k, e in per.items()}
    new_cases = new_kernel_cases(gen)
    errors.update(check_new_kernels(new_cases))

    print(f"[{time.perf_counter() - t_start:.1f} s] kernels checked")
    launches = run_solves(solve_cfg)  # phase 4
    print(f"[{time.perf_counter() - t_start:.1f} s] solves done")
    chunk_memory()  # phase 4d
    profile_solves(solve_cfg)  # phase 4c
    print(f"[{time.perf_counter() - t_start:.1f} s] solves profiled")
    timings = {(k, s): t for s, per in time_kernels(cases, solve_cfg).items()
               for k, t in per.items()}  # phase 5
    timings.update(time_new_kernels(new_cases))
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
                bound_by=t["bound_by"], library_ms=t["library_ms"]))
    print(json.dumps({"launch_counts": launches}))
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
