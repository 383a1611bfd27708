"""The ZEUS entry points (paper Alg. 1 sequential / Alg. 7 parallel).

Port of src/repro/core/zeus.py for a single host. Phase 1 is the paper's
PSO (core/pso.py), the mean-field consensus swarm (phase1="meanfield",
core/meanfield.py), or uniform starts with use_pso=False; phase 2 runs the
engine (core/engine.py) with the solver chosen by name ("bfgs" or
"lbfgs"); the finale picks the best converged lane, and
core/clustering.py groups the lanes into basins. `sequential_zeus` is the
paper's Alg. 1 baseline: sequential PSO, then one serial BFGS solve per
start on the host, until required_c have converged.

Randomness comes from a `draws` hook (core/pso.py) instead of a JAX key:
by default a torch.Generator on the device; `sequential_zeus` takes the
integer its reference folds the key into. Phase 2's retry stream (the
engine's quarantine re-seeds) is a second generator on the device, seeded
from phase 1's and `_RETRY_FOLD`, so that retries never shift phase 1's
draws. `zeus(resume=root)` replays phase 1 from the same generator or
draws and restores phase 2 from its newest snapshot under `root`.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch._device import check_dtype, refuse_float64, resolve_device
from repro_torch.core import engine as engine_mod
from repro_torch.core.bfgs import BFGSOptions, BFGSResult, serial_bfgs
from repro_torch.core.engine import CONVERGED, get_solver, run_multistart
from repro_torch.core.lbfgs import LBFGSOptions
from repro_torch.core.meanfield import MeanFieldPSOOptions, run_meanfield_pso
from repro_torch.core.pso import Draws, PSOOptions, TorchDraws, run_pso, sequential_pso

PHASE1_STRATEGIES = ("pso", "meanfield")


@dataclasses.dataclass(frozen=True)
class ZeusOptions:
    pso: PSOOptions = PSOOptions()
    bfgs: BFGSOptions = BFGSOptions()
    lbfgs: Optional[LBFGSOptions] = None  # set => solver="lbfgs"
    use_pso: bool = True
    # phase-1 strategy: "pso" (paper, per-particle bests) or "meanfield"
    # (softmax-consensus swarm, configured by `meanfield`); use_pso=False
    # skips phase 1 whichever is chosen
    phase1: str = "pso"
    meanfield: MeanFieldPSOOptions = MeanFieldPSOOptions()
    # "float32" or "float64" (phase 1 and phase 2 in that dtype; float64 runs
    # PSO and dense BFGS on the batched sweep, the rest is ROADMAP A19b)
    dtype: str = "float32"
    solver: str = "bfgs"  # phase-2 strategy name in the engine registry
    lane_chunk: Optional[int] = None  # overrides the solver opts' lane_chunk
    # overrides of the solver opts' engine knobs (None keeps the solver's)
    sweep_mode: Optional[str] = None
    compact_every: Optional[int] = None
    repack_every: Optional[int] = None
    ladder_len: Optional[int] = None
    schedule: Optional[str] = None
    schedule_every: Optional[int] = None
    schedule_plans: Optional[tuple] = None  # replayed plans (schedule="replay")
    # the engine's cost model, quarantine and retry, checkpointing and fault
    # injection (core/engine.py EngineOptions); retry_bounds default to the
    # solve's own box
    auto_cost_model: Optional[bool] = None
    telemetry_costs: Optional[tuple] = None
    telemetry_ema: Optional[float] = None
    retry_budget: Optional[int] = None
    retry_mode: Optional[str] = None  # "perturb" | "uniform"
    retry_sigma: Optional[float] = None
    checkpoint_every: Optional[int] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_keep: Optional[int] = None
    fault_plan: Optional[Any] = None  # a launch.faults.FaultPlan


# the retry stream's seed is derived from phase 1's (the reference folds this
# tag into its key), so that existing seeds keep their swarm and starts
_RETRY_FOLD = 0x7E05


class ZeusResult(NamedTuple):
    best_x: torch.Tensor  # (D,) estimated global minimizer
    best_f: torch.Tensor  # ()
    raw: BFGSResult  # all lanes (for clustering / diagnostics)
    n_converged: int
    pso_best_f: torch.Tensor  # global best after phase 1 (inf if PSO skipped)
    n_failed: Optional[int] = None  # lanes failed at solve end
    n_restarts: Optional[torch.Tensor] = None  # (B,) quarantine re-seeds


def uniform_starts(draws: Draws, n: int, dim: int, lower: float, upper: float,
                   device, dtype=torch.float32):
    """use_pso=False: n uniform starts in the box, in `dtype`; inf stands in
    for the absent PSO global best. (The reference splits its key and draws
    from the second half, so that the starts differ from a swarm init's
    x₀.)"""
    starts = draws((n, dim), lower, upper).to(device, dtype)
    return starts, torch.tensor(float("inf"), dtype=starts.dtype,
                                device=starts.device)


def phase1_particles(opts: ZeusOptions) -> int:
    """Lane count phase 2 receives: the active phase-1 strategy's swarm size
    (use_pso=False draws the same count uniformly)."""
    if opts.phase1 == "meanfield":
        return opts.meanfield.n_particles
    return opts.pso.n_particles


def run_phase1(f, dim, lower, upper, opts: ZeusOptions, draws: Draws, device):
    """Phase 1: returns (starts, best_f_seen) for phase 2, in opts.dtype."""
    if opts.phase1 not in PHASE1_STRATEGIES:
        raise ValueError(
            f"unknown phase1 strategy {opts.phase1!r}; expected one of "
            f"{PHASE1_STRATEGIES}")
    dtype = check_dtype(opts.dtype)
    if not opts.use_pso:
        return uniform_starts(draws, phase1_particles(opts), dim, lower, upper,
                              device, dtype)
    if opts.phase1 == "meanfield":
        mf = run_meanfield_pso(f, dim, lower, upper, opts.meanfield,
                               device=device, draws=draws)
        return mf.x, mf.gf
    swarm = run_pso(f, dim, lower, upper, opts.pso, device=device, draws=draws,
                    dtype=dtype)
    return swarm.x, swarm.gf


def _solver_name(opts: ZeusOptions) -> str:
    # setting opts.lbfgs selects L-BFGS, as in the reference
    if opts.lbfgs is not None and opts.solver == "bfgs":
        return "lbfgs"
    return opts.solver


def _lbfgs_from_bfgs(b: BFGSOptions) -> LBFGSOptions:
    """solver="lbfgs" by name alone: the shared engine knobs come from the
    BFGS options; memory, ls_c1 and ad_mode keep their L-BFGS defaults."""
    return LBFGSOptions(
        iter_max=b.iter_bfgs, theta=b.theta, required_c=b.required_c,
        ls_iters=b.ls_iters, linesearch=b.linesearch, lane_chunk=b.lane_chunk,
        sweep_mode=b.sweep_mode, compact_every=b.compact_every,
        repack_every=b.repack_every, ladder_len=b.ladder_len, schedule=b.schedule,
        schedule_every=b.schedule_every, schedule_plans=b.schedule_plans,
        auto_ladders=b.auto_ladders, auto_active_frac=b.auto_active_frac,
        auto_cost_model=b.auto_cost_model, telemetry_costs=b.telemetry_costs,
        telemetry_ema=b.telemetry_ema, retry_budget=b.retry_budget,
        retry_mode=b.retry_mode, retry_sigma=b.retry_sigma,
        retry_bounds=b.retry_bounds, checkpoint_every=b.checkpoint_every,
        checkpoint_dir=b.checkpoint_dir, checkpoint_keep=b.checkpoint_keep,
        fault_plan=b.fault_plan)


def phase2_setup(opts: ZeusOptions):
    """Resolve the phase-2 (strategy, EngineOptions) pair: registry lookup
    plus the ZeusOptions-level overrides."""
    name = _solver_name(opts)
    factory = get_solver(name)
    if name == "lbfgs":
        solver_opts = opts.lbfgs if opts.lbfgs is not None else _lbfgs_from_bfgs(opts.bfgs)
    elif name == "bfgs":
        solver_opts = opts.bfgs
    else:
        solver_opts = None  # third-party registrations use their defaults
    strategy, eopts = factory(solver_opts, lane_chunk=opts.lane_chunk)
    for field in ("sweep_mode", "compact_every", "repack_every", "ladder_len",
                  "schedule", "schedule_every", "schedule_plans", "auto_cost_model",
                  "telemetry_costs", "telemetry_ema", "retry_budget", "retry_mode",
                  "retry_sigma", "checkpoint_every", "checkpoint_dir",
                  "checkpoint_keep", "fault_plan"):
        value = getattr(opts, field)
        if value is not None:
            eopts = dataclasses.replace(eopts, **{field: value})
    return strategy, eopts


def solve_phase2(f, x0, opts: ZeusOptions, device="cuda", retry_draws=None,
                 bounds=None, resume_from: Optional[str] = None) -> BFGSResult:
    """Phase 2 through the engine: registry lookup -> run_multistart.

    `bounds=(lower, upper)` backstops the engine's retry_bounds (the
    re-seed box) when the solver options leave them unset, so that
    retry_mode="uniform" works as it is."""
    strategy, eopts = phase2_setup(opts)
    if bounds is not None and eopts.retry_bounds is None:
        eopts = dataclasses.replace(
            eopts, retry_bounds=(float(bounds[0]), float(bounds[1])))
    return run_multistart(f, x0, strategy, eopts, device=device,
                          retry_draws=retry_draws, resume_from=resume_from)


def _select_best(res: BFGSResult):
    """Best *converged* lane; fall back to the best lane overall."""
    inf = torch.tensor(float("inf"), dtype=res.fval.dtype, device=res.fval.device)
    fv = torch.where(res.status == engine_mod.CONVERGED, res.fval, inf)
    any_conv = torch.any(torch.isfinite(fv))
    fv = torch.where(any_conv, fv, res.fval)
    i = torch.argmin(fv)
    return res.x[i], fv[i]


def zeus(
    f: Callable,
    dim: int,
    lower: float,
    upper: float,
    opts: ZeusOptions = ZeusOptions(),
    *,
    device="cuda",
    generator: Optional[torch.Generator] = None,
    draws: Optional[Draws] = None,
    resume: Optional[str] = None,
    retry_draws: Optional[Draws] = None,
) -> ZeusResult:
    """Single-host ZEUS (Alg. 7).

    f:         objective in torch; a named paper objective (`obj.fn`) takes
               the fused kernels in phase 2.
    device:    "cuda" (default) or "cpu"; no silent CPU fallback.
    generator: torch.Generator on `device` for the default draws (seed 0
               when None).
    draws:     the random-draw hook (core/pso.py), overriding `generator`.
    resume:    a checkpoint root: replay phase 1 (pass the same generator
               seed or draws as the interrupted call) and restore phase 2
               from its newest committed snapshot; the result is
               array-equal to the uninterrupted call's.
    retry_draws: phase 2's retry stream; None is a second generator on
               `device`, seeded from phase 1's generator (seed 0 without
               one) and `_RETRY_FOLD`."""
    dtype = check_dtype(opts.dtype)
    refuse_float64(dtype, phase2_setup(opts)[1], solver=_solver_name(opts),
                   phase1=opts.phase1 if opts.use_pso else "pso", resume=resume)
    dev = resolve_device(device)
    if draws is None:
        draws = TorchDraws(dev, generator, dtype=dtype)
    if retry_draws is None:
        base = getattr(draws, "generator", None)
        seed = base.initial_seed() if base is not None else 0
        retry_draws = TorchDraws(dev, seed=(seed ^ _RETRY_FOLD) & (2**63 - 1),
                                 dtype=dtype)
    starts, pso_best_f = run_phase1(f, dim, lower, upper, opts, draws, dev)
    res = solve_phase2(f, starts, opts, device=dev, retry_draws=retry_draws,
                       bounds=(lower, upper), resume_from=resume)
    best_x, best_f = _select_best(res)
    _warn_if_all_lanes_failed(res, starts.shape[0])
    return ZeusResult(
        best_x=best_x,
        best_f=best_f,
        raw=res,
        n_converged=res.n_converged,
        pso_best_f=pso_best_f,
        n_failed=res.n_failed,
        n_restarts=res.n_restarts,
    )


def zeus_jit(f: Callable, dim: int, lower: float, upper: float,
             opts: ZeusOptions = ZeusOptions(), *, device="cuda"):
    """A `(generator=None, draws=None) -> ZeusResult` closure over one
    configuration, the counterpart of the reference's jitted `key ->
    ZeusResult`. Eager torch compiles nothing, so the closure only fixes
    the arguments: each call runs `zeus` as it is (its kernels build once,
    at their first launch)."""

    def run(generator: Optional[torch.Generator] = None,
            draws: Optional[Draws] = None) -> ZeusResult:
        return zeus(f, dim, lower, upper, opts, device=device, generator=generator,
                    draws=draws)

    return run


def _warn_if_all_lanes_failed(res: BFGSResult, n_lanes: int):
    """RuntimeWarning when the solve ends with EVERY lane failed: best_x is
    then the least-bad failed iterate, and the retry budget (if any) is
    spent on all of them."""
    if res.n_failed is not None and res.n_failed >= n_lanes:
        budget = int(torch.max(res.n_restarts)) if res.n_restarts is not None else 0
        warnings.warn(
            f"all {n_lanes} lanes ended failed (non-finite escape); quarantine "
            f"retries used per lane: up to {budget}. best_x is the least-bad "
            "failed iterate — consider retry_budget/retry_mode='uniform' or a "
            "different search box", RuntimeWarning, stacklevel=3)


# ---------------------------------------------------------------------------
# Sequential ZEUS (Alg. 1), the Fig. 2 baseline: serial BFGS lane by lane on
# the host, stopping after required_c convergences (Alg. 1 lines 9-20).
# ---------------------------------------------------------------------------
class SequentialZeusResult(NamedTuple):
    best_x: np.ndarray
    best_f: float
    n_converged: int
    n_started: int
    wall_time_s: float
    n_failed: int = 0  # lanes that ended with a non-finite fval


def sequential_zeus(f: Callable, seed: int, dim: int, lower: float, upper: float,
                    opts: ZeusOptions = ZeusOptions(), *,
                    device="cuda") -> SequentialZeusResult:
    """seed is the integer the reference folds its key into
    (`int(jax.random.randint(key, (), 0, 2**31 - 1))`): the swarm and the
    starts are then the reference's. Each start is solved by serial_bfgs
    with `opts.bfgs` (the ZeusOptions-level engine overrides do not apply,
    as in the reference)."""
    if opts.phase1 != "pso":
        raise ValueError(
            "sequential_zeus is the paper's Alg. 1 baseline and only runs "
            f"phase1='pso'; use zeus() for phase1={opts.phase1!r}")
    refuse_float64(opts.dtype, entry="sequential_zeus")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    if opts.use_pso and opts.pso.iter_pso > 0:
        swarm = sequential_pso(f, seed, dim, lower, upper, opts.pso, device=dev)
        starts = swarm.x.cpu().numpy()
    else:
        rng = np.random.default_rng(seed)
        starts = rng.uniform(lower, upper, (opts.pso.n_particles, dim))

    required_c = opts.bfgs.required_c or len(starts)
    # the incumbent is seeded from the first lane, so a caller always gets
    # an array back, even when every lane ends non-finite
    best_x, best_f, c = None, np.inf, 0
    n_started = n_failed = 0
    for x0 in starts:
        n_started += 1
        r = serial_bfgs(f, np.asarray(x0, np.float32), opts.bfgs, device=dev)
        fv = float(r.fval)
        if not np.isfinite(fv):
            n_failed += 1
        # NaN compares false both ways, so a finite lane must explicitly
        # displace a non-finite incumbent
        if (best_x is None or fv < best_f
                or (np.isfinite(fv) and not np.isfinite(best_f))):
            best_x, best_f = r.x.cpu().numpy(), fv
        if r.status == CONVERGED:
            c += 1
            if c >= required_c:
                break  # Alg. 1 line 17: stop once enough runs converged
    return SequentialZeusResult(best_x=best_x, best_f=best_f, n_converged=c,
                                n_started=n_started,
                                wall_time_s=time.perf_counter() - t0,
                                n_failed=n_failed)
