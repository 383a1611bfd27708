#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of ZEUS on one NVIDIA GPU (Hopper).

    python3 chip_smoke.py        # from the repository root, on a GPU host

Phases (any failure exits non-zero):
  1. the card's name and power limit, and torch's CUDA version;
  2. build the four kernels from src/repro_torch/kernels/csrc (nvcc);
  3. hold each kernel against its plain PyTorch version on the card at the
     shapes of both solves below, plus the two bitwise contracts (value-only
     f == value+grad f; H' == H where ρ = 0) and ackley's NaN gradient at
     the origin;
  4. drive the main path, `repro_torch.core.zeus.zeus` on "cuda" with
     default options, for two solves:
       paper — the README example: rastrigin, D=5, 2048 particles,
               iter_pso=8, iter_bfgs=100, theta=1e-4, required_c=400,
               lane_chunk=512;
       scale — ackley, D=128, 16384 starts, iter_pso=5, iter_bfgs=100,
               unchunked (a 1.07 GB inverse-Hessian stack);
     with every launch counter set to 0 just before each solve and read
     just after; then take the first 3 sweeps from the same starts, each
     from the kernel path's state, through the kernels and through the
     plain versions, and compare rung, status and state;
     time cluster_solutions on the result (at scale, on the first 1024 and
     2048 converged lanes: its host loop is O(lanes × clusters));
     and profile each solve once more (device-busy share, top kernels);
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
}


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def solves():
    from repro_torch.core import BFGSOptions, PSOOptions, ZeusOptions

    return {
        "paper": dict(objective="rastrigin", dim=5, seed=0, opts=ZeusOptions(
            pso=PSOOptions(n_particles=2048, iter_pso=8),
            bfgs=BFGSOptions(iter_bfgs=100, theta=1e-4, required_c=400,
                             ad_mode="forward"),
            lane_chunk=512, sweep_mode="batched")),
        "scale": dict(objective="ackley", dim=128, seed=1, opts=ZeusOptions(
            pso=PSOOptions(n_particles=16384, iter_pso=5),
            bfgs=BFGSOptions(iter_bfgs=100),
            sweep_mode="batched")),
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
        # H' and p' hang on the secant pair. The two paths' own rounding of
        # g' moves ρ = 1/δxᵀδg by η = |δx|·|Δg'| / |δxᵀδg| (relative), and
        # one D-term sum in another order moves u = Hδg by D·2⁻²⁴ of
        # |H||δg|; H' then moves by about that relative perturbation times
        # the update's terms 2|ρ||u||δx| + (2ρ²|s| + |ρ|)|δx|², |u| and |s|
        # taken at their absolute-value bounds. Where that alone exceeds a
        # tenth of the tolerance, the update is too ill-conditioned to hold
        # either path to the other on H' and p'.
        dX, dG = kl.x - pre.x, kl.g - pre.g
        curv = torch.sum(dX * dG, dim=-1)
        updated = ~(pre.converged | pre.failed) & torch.isfinite(curv) & (curv > 1e-10)
        eta = torch.where(updated, torch.linalg.vector_norm(dX, dim=-1)
                          * torch.linalg.vector_norm(kl.g - pl.g, dim=-1) / curv, 0.0)
        pert = torch.clamp(eta, min=cfg["dim"] * 2.0 ** -24)
        u_abs = torch.sum(pre.direction_state.abs() * dG.abs()[:, None, :], dim=-1)
        s_abs = torch.sum(dG.abs() * u_abs, dim=-1)
        rho = torch.where(updated, 1.0 / curv, 0.0).abs()
        dxm = dX.abs().amax(dim=-1)
        terms = 2 * rho * u_abs.amax(dim=-1) * dxm + (2 * rho * rho * s_abs + rho) * dxm * dxm
        scale = kl.direction_state.abs().amax(dim=(1, 2)).clamp_min(1.0)
        well = keep & ~(pert * terms / scale > 0.1 * STATE_TOL)
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


def run_solves(solve_cfg):
    """Phase 4: the main path, one solve at a time, counters read around it."""
    import torch
    from repro_torch.core import cluster_solutions, get_objective, zeus
    from repro_torch.kernels import ops

    launches = {}
    for sname, cfg in solve_cfg.items():
        obj = get_objective(cfg["objective"])
        gen = torch.Generator(device="cuda").manual_seed(cfg["seed"])
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = zeus(obj.fn, cfg["dim"], obj.lower, obj.upper, cfg["opts"],
                   device="cuda", generator=gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[sname] = ops.launch_counts()
        # the same solve again, warm (the first call pays one-time set-up)
        t1 = time.perf_counter()
        zeus(obj.fn, cfg["dim"], obj.lower, obj.upper, cfg["opts"], device="cuda",
             generator=torch.Generator(device="cuda").manual_seed(cfg["seed"]))
        torch.cuda.synchronize()
        warm = time.perf_counter() - t1
        best_f = float(res.best_f)
        require(math.isfinite(best_f), f"{sname}: best_f is not finite")
        require(tuple(res.best_x.shape) == (cfg["dim"],), f"{sname}: best_x shape")
        require(bool(torch.isfinite(res.raw.fval[res.raw.status == 1]).all()),
                f"{sname}: a converged lane has a non-finite value")
        if sname == "paper":
            require(res.n_converged > 0, "paper: no lane converged")
        for k, n in launches[sname].items():
            require(n > 0, f"{sname}: kernel {k} was not launched on the main path")
        print(f"solve {sname}: wall {wall:.4f} s (warm {warm:.4f} s), sweeps {res.raw.iterations}, "
              f"n_converged {res.n_converged}, best_f {best_f:.6g}, "
              f"pso_best_f {float(res.pso_best_f):.6g}, "
              f"launches {json.dumps(launches[sname])}")
        time_clustering(res.raw)
        del res
        compare_sweeps(sname, cfg)
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
    from repro_torch.core import get_objective, zeus

    for sname, cfg in solve_cfg.items():
        obj = get_objective(cfg["objective"])
        gen = torch.Generator(device="cuda").manual_seed(cfg["seed"])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            zeus(obj.fn, cfg["dim"], obj.lower, obj.upper, cfg["opts"],
                 device="cuda", generator=gen)
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
    cases = {s: kernel_cases(c, c["objective"], c["dim"], gen)
             for s, c in solve_cfg.items()}
    errors = check_kernels(cases, solve_cfg)

    print(f"[{time.perf_counter() - t_start:.1f} s] kernels checked")
    launches = run_solves(solve_cfg)  # phase 4
    print(f"[{time.perf_counter() - t_start:.1f} s] solves done")
    chunk_memory()  # phase 4d
    profile_solves(solve_cfg)  # phase 4c
    timings = time_kernels(cases, solve_cfg)  # phase 5
    print(f"[{time.perf_counter() - t_start:.1f} s] kernels timed")

    entries = []
    for sname in solve_cfg:
        for kname, (source, replaces) in SOURCES.items():
            t = timings[sname][kname]
            entries.append(dict(
                name=f"{kname}/{sname}", route="cuda", source=source,
                replaces=replaces, launches=launches[sname][kname],
                max_abs_err=errors[sname][kname][0], ms=t["ms"],
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
