"""The ZEUS entry point (paper Alg. 7): PSO, then multistart BFGS, then the
best converged lane.

Port of src/repro/core/zeus.py for a single host. Phase 1 is the paper's
PSO (core/pso.py), or uniform starts with use_pso=False; phase 2 runs the
engine's batched sweep (core/engine.py) with the solver chosen by name;
the finale picks the best converged lane, and core/clustering.py groups
the lanes into basins.

Randomness comes from a `draws` hook (core/pso.py) instead of a JAX key:
by default a torch.Generator on the device. Not ported yet: phase1=
"meanfield" (A10), solver="lbfgs" (A7), `resume` (A11), and the sequential
Alg. 1 baseline `sequential_zeus` (A7).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch._device import check_dtype, resolve_device
from repro_torch.core import engine as engine_mod
from repro_torch.core.bfgs import BFGSOptions, BFGSResult
from repro_torch.core.engine import get_solver, run_multistart
from repro_torch.core.pso import Draws, PSOOptions, TorchDraws, run_pso

PHASE1_STRATEGIES = ("pso", "meanfield")


@dataclasses.dataclass(frozen=True)
class ZeusOptions:
    pso: PSOOptions = PSOOptions()
    bfgs: BFGSOptions = BFGSOptions()
    use_pso: bool = True
    phase1: str = "pso"  # "meanfield" is not ported yet (A10)
    dtype: str = "float32"  # the only dtype the port supports
    solver: str = "bfgs"  # phase-2 strategy name in the engine registry
    lane_chunk: Optional[int] = None  # overrides the solver opts' lane_chunk
    # overrides of the solver opts' engine knobs (None keeps the solver's)
    sweep_mode: Optional[str] = None
    compact_every: Optional[int] = None
    repack_every: Optional[int] = None
    ladder_len: Optional[int] = None
    schedule: Optional[str] = None
    auto_cost_model: Optional[bool] = None
    retry_budget: Optional[int] = None
    checkpoint_every: Optional[int] = None
    checkpoint_dir: Optional[str] = None
    fault_plan: Optional[Any] = None


class ZeusResult(NamedTuple):
    best_x: torch.Tensor  # (D,) estimated global minimizer
    best_f: torch.Tensor  # ()
    raw: BFGSResult  # all lanes (for clustering / diagnostics)
    n_converged: int
    pso_best_f: torch.Tensor  # global best after phase 1 (inf if PSO skipped)
    n_failed: Optional[int] = None  # lanes failed at solve end
    n_restarts: Optional[torch.Tensor] = None  # (B,) re-seeds (zeros: no retry)


def uniform_starts(draws: Draws, n: int, dim: int, lower: float, upper: float,
                   device):
    """use_pso=False: n uniform starts in the box; inf stands in for the
    absent PSO global best. (The reference splits its key and draws from
    the second half, so that the starts differ from a swarm init's x₀.)"""
    starts = draws((n, dim), lower, upper).to(device)
    return starts, torch.tensor(float("inf"), dtype=starts.dtype,
                                device=starts.device)


def run_phase1(f, dim, lower, upper, opts: ZeusOptions, draws: Draws, device):
    """Phase 1: returns (starts, best_f_seen) for phase 2."""
    if opts.phase1 not in PHASE1_STRATEGIES:
        raise ValueError(
            f"unknown phase1 strategy {opts.phase1!r}; expected one of "
            f"{PHASE1_STRATEGIES}")
    if opts.phase1 == "meanfield":
        raise NotImplementedError(
            "phase1='meanfield' is not ported yet (ROADMAP A10)")
    if not opts.use_pso:
        return uniform_starts(draws, opts.pso.n_particles, dim, lower, upper,
                              device)
    swarm = run_pso(f, dim, lower, upper, opts.pso, device=device, draws=draws)
    return swarm.x, swarm.gf


def phase2_setup(opts: ZeusOptions):
    """Resolve the phase-2 (strategy, EngineOptions) pair: registry lookup
    plus the ZeusOptions-level overrides."""
    factory = get_solver(opts.solver)
    solver_opts = opts.bfgs if opts.solver == "bfgs" else None
    strategy, eopts = factory(solver_opts, lane_chunk=opts.lane_chunk)
    for field in ("sweep_mode", "compact_every", "repack_every", "ladder_len",
                  "schedule", "auto_cost_model", "retry_budget",
                  "checkpoint_every", "checkpoint_dir", "fault_plan"):
        value = getattr(opts, field)
        if value is not None:
            eopts = dataclasses.replace(eopts, **{field: value})
    return strategy, eopts


def solve_phase2(f, x0, opts: ZeusOptions, device="cuda") -> BFGSResult:
    """Phase 2 through the engine: registry lookup -> run_multistart."""
    strategy, eopts = phase2_setup(opts)
    return run_multistart(f, x0, strategy, eopts, device=device)


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
) -> ZeusResult:
    """Single-host ZEUS (Alg. 7).

    f:         objective in torch; a named paper objective (`obj.fn`) takes
               the fused kernels in phase 2.
    device:    "cuda" (default) or "cpu"; no silent CPU fallback.
    generator: torch.Generator on `device` for the default draws (seed 0
               when None).
    draws:     the random-draw hook (core/pso.py), overriding `generator`.
    resume:    not ported yet (A11)."""
    if resume is not None:
        raise NotImplementedError("resume is not ported yet (ROADMAP A11)")
    check_dtype(opts.dtype)
    dev = resolve_device(device)
    if draws is None:
        draws = TorchDraws(dev, generator)
    starts, pso_best_f = run_phase1(f, dim, lower, upper, opts, draws, dev)
    res = solve_phase2(f, starts, opts, device=dev)
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


def _warn_if_all_lanes_failed(res: BFGSResult, n_lanes: int):
    """RuntimeWarning when the solve ends with EVERY lane failed: best_x is
    then the least-bad failed iterate."""
    if res.n_failed is not None and res.n_failed >= n_lanes:
        warnings.warn(
            f"all {n_lanes} lanes ended failed (non-finite escape); best_x is "
            "the least-bad failed iterate — consider a different search box",
            RuntimeWarning, stacklevel=3)
