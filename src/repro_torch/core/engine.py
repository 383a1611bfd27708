"""Multistart quasi-Newton engine (paper Alg. 10).

Port of src/repro/core/engine.py for a single host. Phase 2 is B
independent quasi-Newton solves sharing one stop protocol: sweep while
k < iter_max AND n_converged < required_c AND any lane active. Converged
and failed lanes are frozen by masking.

What varies between solvers is a `DirectionStrategy` (dense BFGS in
core/bfgs.py, L-BFGS in core/lbfgs.py). The reference writes it for one
lane and vmaps it; here `jax.vmap` is written out, so every strategy works
on a lane stack: its state is a tensor, or a NamedTuple of tensors, with a
leading lane axis B.

`EngineOptions.sweep_mode` selects how a sweep runs:
  "per_lane" — the reference's vmapped scalar step (`lane_step`) over the
      stack: p from the strategy, the sequential Armijo or Wolfe search
      (each lane keeps its own backtracking depth), value and gradient by
      automatic differentiation (`value_and_grad_fn`, never the fused
      kernels), and the guarded state update, where guarded lanes take the
      stand-in pair (1, …, 1) and keep their old state;
  "batched" — whole (B, D) / (B, D, D) passes (`batch_lanes_step`):
      1. the descent safeguard (p ← −g where pᵀg ≥ 0);
      2. one speculative K-rung Armijo ladder as a single (K·B, D) value
         call;
      3. one batched value+grad at the accepted points (the fused kernels
         for a named objective);
      4. the curvature guard (δxᵀδg finite and > 1e-10, lane active);
      5. one fused guarded state update that also yields the next
         direction. A per-lane strategy runs here through
         `as_batched_strategy`: dense BFGS has its own batch-level
         strategy, any other gets `VmappedStrategy`.
      With `ladder_len = L` (0 < L < K) step 2 is the adaptive ladder: L
      rungs in one call, then one call per further rung while any lane
      still searches;
  "megakernel" — the batched sweep with steps 2-5 in one launch of the
      sweep megakernel (kernel B5, `megakernel_lanes_step`), or, with
      0 < ladder_len < K, the adaptive ladder as above and steps 3-5 in one
      launch of the commit kernel (B5b). Its results are the batched
      sweep's: array-equal on the CPU, where both run the plain versions.
      It serves dense BFGS on the four objectives with a fused body, up to
      the kernel's shared-memory cap on D; `megakernel_unsupported_reason`
      sends every other solve to the batched sweep with a RuntimeWarning.

`run_multistart` is a host loop: `lax.while_loop` and `lax.map` become
Python loops, and the stop counts are read back to the host in one
transfer per sweep. With `lane_chunk=C` the lanes are held as ceil(B/C)
chunks (the last padded with frozen lanes) from start to finish, and each
sweep steps them one after another, replacing each chunk's state as it
goes: the (B, D, D) stack is persistent, and a sweep's transient memory is
O(C·D²) on top of it, while the stop counts stay sweep-synchronised across
chunks. Every evaluator on the path is row-independent, so a chunked solve
is array-equal to the unchunked one (under retry_budget when C divides B:
the retry draws cover the flat lane axis, padding included, as the
reference's do).

The batched modes take the reference's sweep schedules ("Sweep schedules"
below), each array-equal to the static sweep:
  compact_every=n — every n sweeps, stably partition each chunk's lanes
      (active first) and step only the smallest power-of-two prefix that
      holds the active ones;
  repack_every=n (with lane_chunk) — every n sweeps, gather the active
      lanes of all chunks into the smallest power-of-two number of full
      chunks, and step only those (compacted inside with compact_every);
  schedule="auto" — a controller picks a plan per window of
      schedule_every sweeps from {static, dynamic} × candidate ladder
      lengths (`auto_plan_lattice`), recorded in BFGSResult.schedule_trace;
      with auto_cost_model=True it scores the candidates in measured
      seconds (launch/telemetry.py) from each window's wall on the host
      clock, returned in BFGSResult.telemetry; schedule="replay" forces a
      recorded plan sequence (`schedule_trace_plans`).

Fault tolerance (launch/faults.py, checkpoint/manager.py; the solve's state
is one `EngineCarry`, which `_Sweeper` advances a sweep at a time):
  retry_budget=k (batched modes) — a lane that fails (NaN/Inf) is
      re-seeded at the start of the next sweep, up to k times, from a
      perturbed copy of its last iterate or a uniform draw in retry_bounds;
      only its rows are re-initialised. The lanes to heal are counted in
      the sweep's one readback (a heal sweep under a schedule reads the
      active counts once more, for its plans);
  fault_plan — deterministic NaN and kill injections keyed on the sweep
      counter, and a preemption at a sweep boundary (`Preempted`);
  checkpoint_every=n — the solve's whole carry (`EngineCarry`) is
      snapshotted through checkpoint/manager.py every n sweeps, on a
      background thread; `run_multistart(resume_from=root)` restores the
      newest snapshot, and the resumed solve is array-equal to the
      uninterrupted one, as a checkpointed solve is to an uncheckpointed
      one.

Held open (the solve service, serve/service.py): `open_multistart` returns
a `HostedSolve` over the same carry, sweeps and host loop (`_drive`), which
the caller advances segment by segment, harvesting lanes between segments
(`lane_view`) and admitting fresh ones into chosen slots (`admit`, the
heal's write path: the admitted rows alone). With lane_deadlines=True each
flat lane carries a sweep deadline; a sweep first freezes the lanes whose
deadline has come, counted in the readback before it, so the plans see the
active set after the freeze.
"""
from __future__ import annotations

import bisect
import dataclasses
import logging
import threading
import time
import warnings
from typing import Any, Callable, Dict, NamedTuple, Optional, Protocol, Tuple

import numpy as np
import torch

from repro_torch._device import check_dtype, refuse_float64, resolve_device
from repro_torch.checkpoint import manager as ckpt_manager
from repro_torch.core.dual import grad_eval_cost
from repro_torch.core.linesearch import (
    armijo_backtracking,
    armijo_backtracking_batch,
    exhaustion_alpha,
    ladder_thresholds,
    wolfe_linesearch,
)
from repro_torch.core.objectives import (
    BatchedObjective,
    Objective,
    analytic_fused_name,
    as_batched,
)
from repro_torch.core.pso import TorchDraws
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch import faults, telemetry

# snapshot timings go to this logger at DEBUG level (step, bytes, host-copy
# and write seconds)
log = logging.getLogger(__name__)

# status codes, matching the paper's result.status
DIVERGED = 0  # hit iter_max without |g| < theta (or NaN/Inf escape)
CONVERGED = 1
STOPPED = 2  # stop-flag: other lanes filled required_c first

_CURV_EPS = 1e-10

# sweep modes that run whole-batch sweeps (vs the per-lane step); every
# batched-only option accepts both
_BATCHED_MODES = ("batched", "megakernel")


class BFGSResult(NamedTuple):
    """Result of one multistart solve (name kept from the reference API)."""

    x: torch.Tensor  # (B, D) final iterates
    fval: torch.Tensor  # (B,)
    grad_norm: torch.Tensor  # (B,)
    status: torch.Tensor  # (B,) int32 in {DIVERGED, CONVERGED, STOPPED}
    iterations: int  # sweeps taken
    n_converged: int
    n_evals: Optional[torch.Tensor] = None  # (B,) int32 per-lane objective evals
    # physical objective rows the sweeps evaluated (ladder trials + value+
    # grad rows, padding lanes included)
    eval_rows: Optional[int] = None
    # chunk steps issued: ceil(B / lane_chunk) per sweep, 1 unchunked, the
    # repacked chunk count under repack_every
    map_trips: Optional[int] = None
    # (n_windows, n_plans) int32: the plan each window of schedule_every
    # sweeps ran (schedule="auto"/"replay", else None); one-hot rows for the
    # windows run, zero rows after the stop
    schedule_trace: Optional[torch.Tensor] = None
    n_restarts: Optional[torch.Tensor] = None  # (B,) int32 re-seeds per lane
    n_failed: Optional[int] = None  # lanes that ended failed
    # launch.telemetry.TelemetryCarry of the window measurements
    # (auto_cost_model=True, else None)
    telemetry: Optional[Any] = None


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """Solver-independent knobs of the multistart engine."""

    iter_max: int = 100
    theta: float = 1e-5  # gradient-norm convergence threshold Θ
    required_c: Optional[int] = None  # stop once this many lanes converged
    ls_iters: int = 20
    ls_c1: float = 0.3
    linesearch: str = "armijo"  # "armijo" (paper) | "wolfe" (per_lane only)
    ad_mode: str = "forward"  # "forward" (paper) | "reverse" (beyond-paper)
    lane_chunk: Optional[int] = None  # None = one monolithic batch
    # "batched" | "megakernel" | "per_lane". The JAX package defaults to
    # "per_lane"; the port keeps "batched", its kernels' path.
    sweep_mode: str = "batched"
    # active-lane compaction cadence in sweeps, batched modes (0 = off)
    compact_every: int = 0
    # cross-chunk repacking cadence in sweeps, batched modes with lane_chunk
    # (0 = off)
    repack_every: int = 0
    # adaptive Armijo ladder length on the batched modes (0 = full ladder)
    ladder_len: int = 0
    # "static" (the three knobs above), "auto" (the controller picks a plan
    # per window) or "replay" (schedule_plans forced); batched modes
    schedule: str = "static"
    schedule_every: int = 4  # the controller's window, in sweeps
    # one plan index per window (schedule="replay"); schedule_trace_plans()
    # decodes them from a schedule_trace
    schedule_plans: Optional[Tuple[int, ...]] = None
    # the controller's candidate ladder lengths (0 = the full ladder); None
    # is {0} and the powers of two below ls_iters
    auto_ladders: Optional[Tuple[int, ...]] = None
    # the dynamic plan latches once fewer than this share of the lanes is
    # active
    auto_active_frac: float = 0.5
    # schedule="auto" only: score the plan lattice in measured seconds,
    # (L + E[fb])·active·c_row + E[fb]·c_launch, with c_row and c_launch
    # fitted by an EMA (weight telemetry_ema) over the windows' walls, or
    # fixed by telemetry_costs=(c_row, c_launch)
    auto_cost_model: bool = False
    telemetry_costs: Optional[Tuple[float, float]] = None
    telemetry_ema: float = 0.5
    # quarantine and retry (batched modes): a failed lane is re-seeded up to
    # retry_budget times, "perturb" (its last iterate, non-finite entries at
    # the middle of retry_bounds or 0, plus retry_sigma·N(0, I)) or
    # "uniform" (a draw in retry_bounds, required there)
    retry_budget: int = 0
    retry_mode: str = "perturb"
    retry_sigma: float = 0.1
    retry_bounds: Optional[Tuple[float, float]] = None
    # snapshot the carry every checkpoint_every sweeps (0 = off) into
    # checkpoint_dir, keeping the newest checkpoint_keep (0 = all)
    checkpoint_every: int = 0
    checkpoint_dir: Optional[str] = None
    checkpoint_keep: int = 3
    # a launch.faults.FaultPlan: NaN and kill injections, and a preemption
    fault_plan: Optional[Any] = None
    # per-lane sweep deadlines (the solve service, serve/service.py): the
    # carry holds a (n·width,) int32 deadline per flat lane, 0 = none, and
    # a sweep first freezes as failed every active lane whose deadline is
    # <= its counter, so a lane admitted at sweep k0 with deadline k0 + m
    # runs exactly m sweeps, as a solo solve with iter_max = m does.
    # HostedSolve.admit sets them; incompatible with retry_budget > 0
    lane_deadlines: bool = False


def check_engine_options(opts: EngineOptions, hosted: bool = False) -> None:
    """Raise ValueError on what the reference rejects; `hosted` for a solve
    held open under host control (open_multistart)."""
    if opts.sweep_mode not in _BATCHED_MODES + ("per_lane",):
        raise ValueError(
            f"unknown sweep_mode {opts.sweep_mode!r}; expected 'per_lane', "
            "'batched' or 'megakernel'")
    if opts.linesearch not in ("armijo", "wolfe"):
        raise ValueError(f"unknown linesearch {opts.linesearch!r}")
    batched = opts.sweep_mode in _BATCHED_MODES
    if batched and opts.linesearch != "armijo":
        raise ValueError(
            f"sweep_mode={opts.sweep_mode!r} supports linesearch='armijo' only "
            f"(got {opts.linesearch!r}); use sweep_mode='per_lane'")
    for field in ("compact_every", "repack_every"):
        value = getattr(opts, field)
        if value < 0:
            raise ValueError(f"{field} must be >= 0 (got {value})")
        if value > 0 and not batched:
            raise ValueError(
                f"{field} > 0 requires sweep_mode='batched'/'megakernel' (got "
                f"{opts.sweep_mode!r})")
    if opts.repack_every > 0 and opts.lane_chunk is None:
        raise ValueError(
            "repack_every > 0 repacks lanes across chunks and needs lane_chunk "
            "set (got lane_chunk=None)")
    if opts.ladder_len < 0:
        raise ValueError(f"ladder_len must be >= 0 (got {opts.ladder_len})")
    if opts.ladder_len > 0 and not batched:
        raise ValueError(
            "ladder_len > 0 shortens the speculative batched ladder and requires "
            f"sweep_mode='batched'/'megakernel' (got {opts.sweep_mode!r}); the "
            "per-lane sequential search is already adaptive")
    if opts.schedule not in ("static", "auto", "replay"):
        raise ValueError(
            f"unknown schedule {opts.schedule!r}; expected 'static', 'auto' or "
            "'replay'")
    if opts.schedule != "static":
        if not batched:
            raise ValueError(
                f"schedule={opts.schedule!r} requires sweep_mode='batched'/"
                f"'megakernel' (got {opts.sweep_mode!r})")
        if opts.compact_every or opts.repack_every or opts.ladder_len:
            raise ValueError(
                f"schedule={opts.schedule!r} owns the cadence/ladder plan; leave "
                "repack_every/compact_every/ladder_len at 0 (got repack_every="
                f"{opts.repack_every}, compact_every={opts.compact_every}, "
                f"ladder_len={opts.ladder_len})")
        if opts.schedule_every <= 0:
            raise ValueError(
                f"schedule_every must be >= 1 (got {opts.schedule_every})")
        n_plans = 2 * len(_auto_ladders(opts))  # raises on bad auto_ladders
        if opts.schedule == "replay":
            if opts.schedule_plans is None:
                raise ValueError(
                    "schedule='replay' needs schedule_plans (one plan index per "
                    "window; see schedule_trace_plans())")
            plans = tuple(int(p) for p in opts.schedule_plans)
            n_windows = max(1, -(-opts.iter_max // opts.schedule_every))
            if len(plans) < n_windows:
                raise ValueError(
                    f"schedule_plans has {len(plans)} entries; iter_max="
                    f"{opts.iter_max} at schedule_every={opts.schedule_every} "
                    f"needs {n_windows}")
            if any(p < 0 or p >= n_plans for p in plans):
                raise ValueError(
                    f"schedule_plans entries must be in [0, {n_plans}) for this "
                    f"plan lattice (got {plans})")
    if opts.auto_cost_model and opts.schedule != "auto":
        raise ValueError(
            "auto_cost_model=True re-scores the schedule='auto' plan lattice "
            f"and requires schedule='auto' (got {opts.schedule!r})")
    if opts.telemetry_costs is not None:
        if not opts.auto_cost_model:
            raise ValueError(
                "telemetry_costs feeds the cost model fixed (c_row, c_launch) "
                "constants and requires auto_cost_model=True")
        if len(opts.telemetry_costs) != 2:
            raise ValueError(
                f"telemetry_costs must be (c_row, c_launch) (got "
                f"{opts.telemetry_costs!r})")
    if opts.auto_cost_model and opts.lane_deadlines:
        raise ValueError(
            "auto_cost_model=True drives its own host-segmented loop and is "
            "incompatible with lane_deadlines=True (the solve service drives "
            "segments itself; it records pool telemetry instead)")
    if opts.auto_cost_model and hosted:
        raise ValueError(
            "auto_cost_model=True needs the host in the sweep loop (the boundary "
            "plan decision reads measured window costs) and is unavailable "
            "through the program/hosted-pool drivers (distributed_zeus, "
            "open_multistart)")
    if opts.retry_budget < 0:
        raise ValueError(f"retry_budget must be >= 0 (got {opts.retry_budget})")
    if opts.retry_budget > 0 and not batched:
        raise ValueError(
            "retry_budget > 0 re-seeds lanes through the batched init/eval stack "
            f"and requires sweep_mode='batched'/'megakernel' (got {opts.sweep_mode!r})")
    if opts.retry_mode not in ("perturb", "uniform"):
        raise ValueError(
            f"unknown retry_mode {opts.retry_mode!r}; expected 'perturb' or "
            "'uniform'")
    if opts.retry_budget > 0 and opts.retry_mode == "uniform" and opts.retry_bounds is None:
        raise ValueError(
            "retry_mode='uniform' draws fresh points uniformly and needs "
            "retry_bounds=(lower, upper)")
    if opts.lane_deadlines and opts.retry_budget > 0:
        raise ValueError(
            "lane_deadlines=True is incompatible with retry_budget > 0: a "
            "quarantine retry would resurrect a deadline-expired lane past its "
            "per-request budget")
    if opts.checkpoint_every < 0:
        raise ValueError(
            f"checkpoint_every must be >= 0 (got {opts.checkpoint_every})")
    if opts.checkpoint_every > 0 and not opts.checkpoint_dir:
        raise ValueError(
            "checkpoint_every > 0 needs checkpoint_dir to write snapshots to")
    if opts.ad_mode not in ("forward", "reverse"):
        raise ValueError(f"unknown AD mode: {opts.ad_mode}")


def _tree_where(mask: torch.Tensor, new, old):
    """torch.where(mask, new, old) leaf by leaf over a tensor or a
    NamedTuple of lane stacks, mask (B,) broadcast over trailing axes. A
    select, never a multiply by the mask: failed lanes carry inf and NaN."""
    if isinstance(new, torch.Tensor):
        return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)),
                           new, old)
    return type(new)(*(_tree_where(mask, n, o) for n, o in zip(new, old)))


# ---------------------------------------------------------------------------
# Per-lane sweep path (sweep_mode="per_lane").
# ---------------------------------------------------------------------------
class DirectionStrategy(Protocol):
    """How a solver produces search directions, on a lane stack: the state
    is a tensor or a NamedTuple of tensors with a leading lane axis B (the
    reference's per-lane pytree, stacked)."""

    def init_state(self, X0: torch.Tensor) -> Any:
        """Direction state stack for fresh starts X0 (B, D)."""
        ...

    def direction(self, state: Any, G: torch.Tensor) -> torch.Tensor:
        """Directions P (B, D) from the state stack and gradients G."""
        ...

    def update_state(self, state: Any, dX: torch.Tensor, dG: torch.Tensor) -> Any:
        """Absorb the secant pairs. The engine passes curvature-safe pairs or
        the stand-in pair (1, …, 1), and discards the lanes it guarded."""
        ...


class Lane(NamedTuple):
    """The per-lane path's lane stack: shared fields + the strategy's state."""

    x: torch.Tensor  # (B, D)
    f: torch.Tensor  # (B,)
    g: torch.Tensor  # (B, D)
    converged: torch.Tensor  # (B,) bool
    failed: torch.Tensor  # (B,) bool (NaN/Inf escape)
    n_evals: torch.Tensor  # (B,) int32 objective-eval counter
    direction_state: Any


def per_lane_objective(f, ad_mode: str = "forward") -> BatchedObjective:
    """The per-lane path's evaluators: vmap(f) and vmap(value_and_grad_fn(f))
    by automatic differentiation, never the fused kernels, as the
    reference's per-lane path takes them."""
    if isinstance(f, (Objective, BatchedObjective)):
        f = f.fn
    return BatchedObjective(f, name=None, ad_mode=ad_mode)


def lane_init(vg_batch: Callable, strategy: DirectionStrategy, X0: torch.Tensor,
              theta: float, ad_mode: str = "forward") -> Lane:
    F, G = vg_batch(X0)
    return Lane(
        x=X0,
        f=F,
        g=G,
        converged=torch.linalg.vector_norm(G, dim=-1) < theta,
        failed=torch.logical_not(torch.isfinite(F)),
        n_evals=torch.full(X0.shape[:1], grad_eval_cost(X0.shape[-1], ad_mode),
                           dtype=torch.int32, device=X0.device),
        direction_state=strategy.init_state(X0),
    )


def _update_where(strategy: DirectionStrategy, ds, dX, dG, ok: torch.Tensor):
    """The strategy's update where `ok` (B,) holds, the old state elsewhere.
    Lanes not ok get the stand-in pair (1, …, 1), so the update never
    divides by zero or multiplies inf by 0 even where its result is
    discarded."""
    safe_dX = torch.where(ok[:, None], dX, torch.ones_like(dX))
    safe_dG = torch.where(ok[:, None], dG, torch.ones_like(dG))
    return _tree_where(ok, strategy.update_state(ds, safe_dX, safe_dG), ds)


def _guarded_update(strategy: DirectionStrategy, ds, dX, dG, keep: torch.Tensor):
    """Skip the update on curvature breakdown (δxᵀδg ≈ 0) to avoid NaNs.

    The state advances only where the curvature is safe AND `keep` (B,)
    holds: lane_step passes its active mask, which the reference applies in
    a second select over the same state (one pass over a dense H stack
    saved)."""
    curv = torch.sum(dX * dG, dim=-1)
    ok = torch.isfinite(curv) & (curv > _CURV_EPS)
    return _update_where(strategy, ds, dX, dG, ok & keep)


def lane_step(value_batch: Callable, vg_batch: Callable, strategy: DirectionStrategy,
              opts: EngineOptions, lane: Lane) -> Lane:
    """One quasi-Newton step of every lane (Alg. 4 lines 10-16), masked: a
    converged or failed lane computes but keeps its old state."""
    X, F, G = lane.x, lane.f, lane.g
    active = torch.logical_not(torch.logical_or(lane.converged, lane.failed))

    P = strategy.direction(lane.direction_state, G)
    # descent safeguard: restart from steepest descent where p is not one
    descent = torch.sum(P * G, dim=-1) < 0
    P = torch.where(descent[:, None], P, -G)

    if opts.linesearch == "armijo":
        ls = armijo_backtracking(value_batch, X, P, F, G, c1=opts.ls_c1,
                                 max_iters=opts.ls_iters)
    else:
        ls = wolfe_linesearch(vg_batch, X, P, F, G, max_iters=opts.ls_iters)

    X_new = X + ls.alpha[:, None] * P
    F_new, G_new = vg_batch(X_new)
    state = _guarded_update(strategy, lane.direction_state, X_new - X, G_new - G,
                            active)

    now_converged = torch.linalg.vector_norm(G_new, dim=-1) < opts.theta
    now_failed = torch.logical_not(
        torch.isfinite(F_new) & torch.all(torch.isfinite(G_new), dim=-1))
    return Lane(
        x=_tree_where(active, X_new, X),
        f=torch.where(active, F_new, F),
        g=_tree_where(active, G_new, G),
        converged=torch.where(active, now_converged, lane.converged),
        failed=torch.where(active, now_failed, lane.failed),
        n_evals=lane.n_evals + torch.where(
            active, ls.n_evals + grad_eval_cost(X.shape[-1], opts.ad_mode),
            0).to(torch.int32),
        direction_state=state,
    )


# ---------------------------------------------------------------------------
# Batched sweep path (sweep_mode="batched").
# ---------------------------------------------------------------------------
class BatchedDirectionStrategy(Protocol):
    """How a solver produces search directions for the batched sweep. The
    state is a tensor or a NamedTuple of tensors with a leading lane axis B
    (lane_chunk splits it along that axis)."""

    def init_state_batch(self, X0: torch.Tensor) -> Any:
        ...

    def direction_batch(self, state: Any, G: torch.Tensor) -> torch.Tensor:
        ...

    def update_and_direction_batch(
        self, state: Any, dX: torch.Tensor, dG: torch.Tensor,
        ok: torch.Tensor, G_new: torch.Tensor,
    ) -> Tuple[Any, torch.Tensor]:
        """Absorb the secant pairs and produce the next directions in one
        pass. Where `ok` (B,) is False the returned state equals the input
        state (the pair may be garbage: implementations sanitise it)."""
        ...


class VmappedStrategy:
    """Runs a per-lane DirectionStrategy in the batched sweep (the
    reference vmaps the scalar strategy; the port's strategies already take
    lane stacks): the update where `ok` holds, then the next directions
    from the updated state."""

    def __init__(self, strategy: DirectionStrategy):
        self.strategy = strategy

    def init_state_batch(self, X0):
        return self.strategy.init_state(X0)

    def direction_batch(self, state, G):
        return self.strategy.direction(state, G)

    def update_and_direction_batch(self, state, dX, dG, ok, G_new):
        state = _update_where(self.strategy, state, dX, dG, ok)
        return state, self.direction_batch(state, G_new)


def as_batched_strategy(strategy) -> BatchedDirectionStrategy:
    """The batch-level variant of a strategy: the strategy itself when it is
    one already, its own `as_batched()` when it has one (dense BFGS), the
    generic VmappedStrategy otherwise."""
    if hasattr(strategy, "update_and_direction_batch"):
        return strategy
    factory = getattr(strategy, "as_batched", None)
    if factory is not None:
        return factory()
    return VmappedStrategy(strategy)


class BatchLanes(NamedTuple):
    """Whole-swarm state of the batched sweep. The next search direction P
    is carried across sweeps: the fused update emits (state', P') at once."""

    x: torch.Tensor  # (B, D)
    f: torch.Tensor  # (B,)
    g: torch.Tensor  # (B, D)
    p: torch.Tensor  # (B, D) next search direction
    converged: torch.Tensor  # (B,) bool
    failed: torch.Tensor  # (B,) bool
    n_evals: torch.Tensor  # (B,) int32
    direction_state: Any  # e.g. the (B, D, D) inverse-Hessian stack


def batch_lanes_init(bobj, bstrategy: BatchedDirectionStrategy,
                     X0: torch.Tensor, theta: float) -> BatchLanes:
    F, G = bobj.value_and_grad_batch(X0)
    gn = torch.linalg.vector_norm(G, dim=-1)
    state = bstrategy.init_state_batch(X0)
    return BatchLanes(
        x=X0,
        f=F,
        g=G,
        p=bstrategy.direction_batch(state, G),
        converged=gn < theta,
        failed=torch.logical_not(torch.isfinite(F)),
        n_evals=torch.full(X0.shape[:1], bobj.vg_cost(X0.shape[-1]),
                           dtype=torch.int32, device=X0.device),
        direction_state=state,
    )


def batch_lanes_step(bobj, bstrategy: BatchedDirectionStrategy,
                     opts: EngineOptions, lanes: BatchLanes
                     ) -> Tuple[BatchLanes, int, torch.Tensor]:
    """One sweep over the whole stack (Alg. 4 lines 10-16, batch level).

    Returns (lanes', rows, rung): rows is the number of physical objective
    rows this step evaluated ((ladder trials + 1) per lane in the stack,
    frozen lanes included) and rung the (B,) int32 accepted Armijo rung per
    lane (K when exhausted). The reference returns the histogram of `rung`
    over the active lanes instead; here the sweep schedule folds `rung` into
    the window's histogram itself (run_multistart, schedule="auto")."""
    X, F, G, P = lanes.x, lanes.f, lanes.g, lanes.p
    active = torch.logical_not(torch.logical_or(lanes.converged, lanes.failed))

    # descent safeguard, rowwise
    descent = torch.sum(P * G, dim=-1) < 0
    P = torch.where(descent[:, None], P, -G)

    ls = armijo_backtracking_batch(
        bobj.value_batch, X, P, F, G, c1=opts.ls_c1, max_iters=opts.ls_iters,
        ladder_len=opts.ladder_len)
    X_new = X + ls.alpha[:, None] * P
    F_new, G_new = bobj.value_and_grad_batch(X_new)

    dX, dG = X_new - X, G_new - G
    curv = torch.sum(dX * dG, dim=-1)
    # curvature guard + frozen-lane freeze: one ok mask decides which lanes'
    # state advances
    ok = active & torch.isfinite(curv) & (curv > _CURV_EPS)
    state, P_next = bstrategy.update_and_direction_batch(
        lanes.direction_state, dX, dG, ok, G_new)
    return _sweep_epilogue(bobj, opts, lanes, active, X_new, F_new, G_new, state,
                           P_next, ls.n_evals, ls.rung)


def _sweep_epilogue(bobj, opts: EngineOptions, lanes: BatchLanes,
                    active: torch.Tensor, X_new, F_new, G_new, state, P_next,
                    n_evals: int, rung: torch.Tensor
                    ) -> Tuple[BatchLanes, int, torch.Tensor]:
    """The end of a batched sweep, one code for both batched modes: the
    convergence and failure flags, the active lanes' new state (the frozen
    ones keep theirs), the eval counters and the row count."""
    X = lanes.x
    gn = torch.linalg.vector_norm(G_new, dim=-1)
    now_converged = gn < opts.theta
    now_failed = torch.logical_not(
        torch.isfinite(F_new) & torch.all(torch.isfinite(G_new), dim=-1))

    def keep(new, old):
        mask = active.reshape(active.shape + (1,) * (new.dim() - 1))
        return torch.where(mask, new, old)

    stepped = BatchLanes(
        x=keep(X_new, X),
        f=keep(F_new, lanes.f),
        g=keep(G_new, lanes.g),
        p=keep(P_next, lanes.p),
        converged=torch.where(active, now_converged, lanes.converged),
        failed=torch.where(active, now_failed, lanes.failed),
        n_evals=lanes.n_evals + torch.where(
            active, n_evals + bobj.vg_cost(X.shape[-1]), 0).to(torch.int32),
        direction_state=state,
    )
    rows = (n_evals + 1) * X.shape[0]
    return stepped, rows, rung


# ---------------------------------------------------------------------------
# Megakernel sweep path (sweep_mode="megakernel"): the batched sweep's
# semantics behind batch_lanes_step's (lanes', rows, rung) contract, with
# the staged launches fused into the sweep megakernel (kernels B5/B5b). On
# the CPU both kernels' plain versions compose the staged path's own plain
# functions, so the two sweeps are array-equal there.
# ---------------------------------------------------------------------------
def megakernel_unsupported_reason(bobj, bstrategy, dim: int,
                                  opts: EngineOptions) -> Optional[str]:
    """Why sweep_mode='megakernel' cannot serve this solve, or None if it
    can. A reason sends run_multistart to the batched sweep, whose results
    the megakernel's equal. Unlike the reference's gate there is no
    rosenbrock rule: the port pads nothing."""
    if analytic_fused_name(bobj) is None:
        return (
            f"objective {getattr(bobj, 'name', None)!r} has no analytic fused "
            "kernel body to inline (registered evaluators are opaque callables)")
    if not getattr(bstrategy, "megakernel_dense_h", False):
        return (
            f"direction strategy {type(bstrategy).__name__} does not advertise a "
            "dense-H megakernel form (megakernel_dense_h)")
    if opts.ls_iters < 1:
        return "ls_iters < 1 leaves no ladder to fuse"
    cap = kernel_ops.megakernel_max_dim(opts.ls_iters)
    if dim > cap:
        return (
            f"dim {dim} exceeds the cap of {cap} that the kernel's shared memory "
            f"allows with a {opts.ls_iters}-rung ladder")
    return None


def megakernel_lanes_step(bobj, bstrategy: BatchedDirectionStrategy,
                          opts: EngineOptions, lanes: BatchLanes
                          ) -> Tuple[BatchLanes, int, torch.Tensor]:
    """One sweep with batch_lanes_step's contract in one launch (the full
    ladder, B5) or two and more (the adaptive ladder's value calls, then
    the commit, B5b). Only for solves megakernel_unsupported_reason
    accepts; the strategy's state is the (B, D, D) H stack."""
    name = analytic_fused_name(bobj)
    X, F, G, H = lanes.x, lanes.f, lanes.g, lanes.direction_state
    active = torch.logical_not(torch.logical_or(lanes.converged, lanes.failed))

    # descent safeguard, rowwise, outside the kernel as in the staged path
    descent = torch.sum(lanes.p * G, dim=-1) < 0
    P = torch.where(descent[:, None], lanes.p, -G)

    K = opts.ls_iters
    L = K if opts.ladder_len <= 0 else min(opts.ladder_len, K)
    if L == K:
        # the staged ladder's own thresholds: the kernel makes its accepts
        alphas, rhs = ladder_thresholds(F, G, P, opts.ls_c1, K)
        X_new, F_new, G_new, state, P_next, _, rung = kernel_ops.sweep_megakernel_full(
            name, X, P, G, H, active, rhs, alphas, exhaustion_alpha(K))
        n_evals = K
    else:
        ls = armijo_backtracking_batch(
            bobj.value_batch, X, P, F, G, c1=opts.ls_c1, max_iters=K,
            ladder_len=opts.ladder_len)
        X_new, F_new, G_new, state, P_next = kernel_ops.sweep_megakernel_commit(
            name, X, P, G, H, active, ls.alpha)
        n_evals, rung = ls.n_evals, ls.rung
    return _sweep_epilogue(bobj, opts, lanes, active, X_new, F_new, G_new, state,
                           P_next, n_evals, rung)


# ---------------------------------------------------------------------------
# Sweep schedules of the batched modes: active-lane compaction
# (compact_every), cross-chunk repacking (repack_every), and the plan
# controller (schedule="auto") with its replay (schedule="replay").
#
# The reference compiles each schedule as lax.switch branches over
# power-of-two buckets inside its while loop. Here the loop is on the host,
# which reads the stop counts back once per sweep; that one transfer also
# carries each group's active count (and, under "auto", the window's
# accepted-rung histogram), so every bucket and plan is chosen on the host
# from numbers it already has. The partitions themselves (a stable argsort)
# stay on the device. A compacted or repacked step gathers the rows it runs
# with index_select, steps them, and writes them back with index_copy_ into
# the solve's own stacks; rows outside the bucket are not touched. Every
# evaluator on the path is row-independent, so a lane computes the same bits
# at any bucket size, and the schedules are array-equal to the static sweep.
# The buckets are the reference's, and so are eval_rows and map_trips.
# ---------------------------------------------------------------------------
def _active_mask(lanes) -> torch.Tensor:
    return torch.logical_not(torch.logical_or(lanes.converged, lanes.failed))


def _compaction_buckets(n: int) -> Tuple[int, ...]:
    """Power-of-two prefix sizes up to n; the top bucket is always n itself
    (so a mostly-active group runs exactly the uncompacted sweep)."""
    sizes = []
    s = 1
    while s < n:
        sizes.append(s)
        s *= 2
    sizes.append(n)
    return tuple(sizes)


def _bucket_index(buckets: Tuple[int, ...], count: int) -> int:
    """Index of the smallest bucket holding `count` (the top one if none
    does): the reference's searchsorted(side="left") and clip."""
    return min(bisect.bisect_left(buckets, count), len(buckets) - 1)


def _partition(active: torch.Tensor) -> torch.Tensor:
    """The stable partition of the last axis, active lanes first, as int64
    indices: an argsort on an integer key, so the active lanes keep their
    relative order and so do the frozen ones."""
    return torch.argsort(torch.logical_not(active).to(torch.uint8), dim=-1,
                         stable=True)


def _compaction_plan(active: torch.Tensor, buckets: Tuple[int, ...],
                     n_active: Optional[int] = None) -> Tuple[torch.Tensor, int]:
    """(perm, bucket_idx) for the current active set: the stable partition
    and the smallest bucket covering the active count. The engine passes the
    count it read back with the stop counts; without it, it is read here."""
    if n_active is None:
        n_active = int(torch.sum(active))
    return _partition(active), _bucket_index(buckets, n_active)


def _repack_plan(active_flat: torch.Tensor, chunk: int, cbuckets: Tuple[int, ...],
                 n_active: Optional[int] = None) -> Tuple[torch.Tensor, int]:
    """(gperm, gcidx) over the flat lane axis: the stable partition and the
    smallest chunk-count bucket covering ceil(active / chunk) full chunks
    (bucket 1 when nothing is active)."""
    if n_active is None:
        n_active = int(torch.sum(active_flat))
    return _partition(active_flat), _bucket_index(cbuckets, -(-n_active // chunk))


def _tree_map(fn, tree, *rest):
    """fn over the leaves of a tensor or NamedTuple of lane stacks (and of
    trees of the same structure in `rest`)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    return type(tree)(*(_tree_map(fn, *parts) for parts in zip(tree, *rest)))


def _take(lanes, idx: torch.Tensor):
    return _tree_map(lambda a: a.index_select(0, idx), lanes)


def _put(lanes, idx: torch.Tensor, sub) -> None:
    """Write the rows of `sub` back to rows `idx` of `lanes`, in place."""
    _tree_map(lambda a, s: a.index_copy_(0, idx, s), lanes, sub)


def _owned(lanes, foreign=()):
    """`lanes` with every leaf a contiguous tensor of storage of its own: a
    leaf that shares storage with an earlier leaf or with `foreign` (the
    caller's starts) is cloned, so that writing rows in place changes no
    other leaf and no caller's tensor."""
    seen = set(foreign)

    def own(a):
        if a.untyped_storage().data_ptr() in seen or not a.is_contiguous():
            a = a.clone(memory_format=torch.contiguous_format)
        seen.add(a.untyped_storage().data_ptr())
        return a

    return _tree_map(own, lanes)


def _auto_ladders(opts: EngineOptions) -> Tuple[int, ...]:
    """Candidate ladder lengths of the controller, sorted by effective
    length (0 = the full ls_iters ladder) with the full ladder last: index
    n_ladders - 1 is the startup and most conservative plan."""
    K = opts.ls_iters
    if opts.auto_ladders is not None:
        cand = {int(L) for L in opts.auto_ladders}
        for L in cand:
            if L < 0 or L > K:
                raise ValueError(
                    f"auto_ladders entries must be in [0, ls_iters={K}] (got {L})")
    else:
        cand = {0}
        L = 1
        while L < K:
            cand.add(L)
            L *= 2
    cand.discard(K)  # ladder_len == K is the full ladder; canonical spelling
    cand.add(0)
    return tuple(sorted(cand - {0})) + (0,)


def auto_plan_lattice(opts: EngineOptions) -> Tuple[Tuple[int, int], ...]:
    """The (dynamic, ladder_len) plans schedule="auto" can pick, in plan
    index order (p = dynamic · n_ladders + ladder index). dynamic = 1 is
    repack + compact when chunked, prefix compaction when not. Decode
    schedule_trace rows against this."""
    ladders = _auto_ladders(opts)
    return tuple((dyn, L) for dyn in (0, 1) for L in ladders)


def schedule_trace_plans(trace) -> Tuple[int, ...]:
    """Decode a schedule_trace into per-window plan indices, for
    EngineOptions(schedule="replay", schedule_plans=...). All-zero rows
    (windows after an early stop) decode to plan 0; a replay never runs
    them either."""
    t = trace.cpu().numpy() if isinstance(trace, torch.Tensor) else np.asarray(trace)
    return tuple(int(np.argmax(row)) if row.any() else 0 for row in t)


class _AutoState(NamedTuple):
    """The controller's state between windows: the current plan index,
    whether the dynamic plan has latched, and the last window's ladder
    candidate (-1 until a window had a histogram)."""

    plan: int
    dyn_on: bool
    prev_lidx: int


def _auto_controller(state: _AutoState, n_active: int, hist, eff: Tuple[int, ...],
                     act_thresh: float) -> _AutoState:
    """The next window's plan, from the active count at the window boundary
    and the last window's accepted-rung histogram `hist` (ls_iters + 1 ints,
    bin ls_iters = exhausted), all plain ints; `eff` are the candidates'
    effective ladder lengths, ascending (the full ladder last).

    The reference's in-carry controller, rule for rule: the dynamic plan
    latches once the active count drops below act_thresh; the ladder target
    is the smallest candidate covering p90 + 1 rungs (p90 the first rung at
    which the cumulative count reaches ceil(0.9 · total)); a shorter
    candidate is adopted at once, a longer one only when the previous
    window mapped to the same candidate; an empty window keeps the plan and
    the previous candidate."""
    n_ladders = len(eff)
    dyn_on = state.dyn_on or n_active < act_thresh
    total = sum(hist)
    need = (9 * total + 9) // 10  # ceil(0.9 · total)
    r90, csum = 0, 0
    for r, h in enumerate(hist):
        csum += h
        if csum >= need:
            r90 = r
            break
    lidx = min(bisect.bisect_left(eff, r90 + 1), n_ladders - 1)
    cur = state.plan % n_ladders
    stable_up = lidx > cur and lidx == state.prev_lidx
    adopt = total > 0 and (lidx < cur or stable_up)
    new_lidx = lidx if adopt else cur
    return _AutoState(plan=(n_ladders if dyn_on else 0) + new_lidx, dyn_on=dyn_on,
                      prev_lidx=lidx if total > 0 else state.prev_lidx)


class _Counts(NamedTuple):
    """What the host reads back after a sweep, in one transfer."""

    n_conv: int
    n_act: int  # active lanes, and the failed ones a retry heals next
    act: Tuple[int, ...]  # active lanes per group
    elig: Tuple[int, ...]  # failed lanes with retry budget left, per group
    extra: Tuple[Tuple[int, ...], ...]  # the extra device counts, in order
    # active lanes per group whose deadline freezes them at the next sweep
    expiring: Tuple[int, ...] = ()


def _stop_counts(groups, extras=(), eligible=None, expiring=None) -> _Counts:
    """Each group's converged and active counts (and, given `eligible`, the
    groups' heal masks, the lanes the next sweep heals; given `expiring`,
    the masks of the lanes whose deadline the next sweep enforces), and the
    extra device counts the next sweep plans from, read back in one
    transfer."""
    cols = [[torch.sum(g.converged), torch.sum(_active_mask(g))] for g in groups]
    for masks in (eligible, expiring):
        if masks is not None:
            for col, m in zip(cols, masks):
                col.append(torch.sum(m))
    w, n = len(cols[0]), len(groups)
    per = torch.stack([torch.stack(col) for col in cols])
    parts = [per.flatten()] + [e.flatten().to(torch.int64) for e in extras]
    vals = torch.cat(parts).tolist() if len(parts) > 1 else parts[0].tolist()
    conv, act = vals[0:w * n:w], tuple(vals[1:w * n:w])
    col = 2
    elig = exp = (0,) * n
    if eligible is not None:
        elig, col = tuple(vals[col:w * n:w]), col + 1
    if expiring is not None:
        exp = tuple(vals[col:w * n:w])
    extra, at = [], w * n
    for e in extras:
        extra.append(tuple(vals[at:at + e.numel()]))
        at += e.numel()
    return _Counts(n_conv=sum(conv), n_act=sum(act) + sum(elig), act=act, elig=elig,
                   extra=tuple(extra), expiring=exp)


@dataclasses.dataclass
class EngineCarry:
    """Every datum a sweep reads, in one object, so that a snapshot of it
    is the solve (checkpoint/manager.py saves and restores it). Fields a
    configuration does not use are None; the others are there from sweep
    0 on, so the configuration fixes the carry's structure, and a snapshot
    restores only into a solve of the same structure."""

    k: int  # sweeps completed
    groups: list  # the n lane groups of `width` lanes: the chunks, or all lanes
    rows: int  # physical objective rows evaluated so far (eval_rows)
    trips: int  # chunk-steps issued so far (map_trips)
    n_restarts: torch.Tensor  # (n·width,) int32 re-seeds per flat lane
    replan: bool  # refresh the gather plans at the next sweep
    # lane_deadlines: each flat lane's sweep deadline, 0 = none
    deadline: Optional[torch.Tensor] = None  # (n·width,) int32
    # compaction (compact_every, or the dynamic plan unchunked): each group's
    # stable partition, active lanes first, and its bucket size
    perm: Optional[torch.Tensor] = None  # (n, width) int64
    sizes: Optional[Tuple[int, ...]] = None
    # repacking (repack_every, or the dynamic plan chunked): the flat
    # partition, the repacked chunk count m, and each repacked chunk's own
    # partition and bucket size (width where it is not compacted)
    gperm: Optional[torch.Tensor] = None  # (n·width,) int64
    m: Optional[int] = None
    cperm: Optional[torch.Tensor] = None  # (n, width) int64
    csizes: Optional[Tuple[int, ...]] = None
    # the controller (schedule="auto"/"replay"): its state, the window's
    # accepted-rung histogram (auto) and the plan trace
    auto: Optional[_AutoState] = None
    hist: Optional[torch.Tensor] = None  # (ls_iters + 1,) int64
    trace: Optional[np.ndarray] = None  # (n_windows, n_plans) int32
    # the retry stream's state (its draws hook's get_state()), taken at each
    # snapshot and handed back to the hook at resume
    retry_state: Optional[Any] = None
    telem: Optional[telemetry.TelemetryCarry] = None  # auto_cost_model


_STALE = object()  # a derived plan to recompute from the carry


class _Sweeper:
    """Runs the sweeps of one solve on its carry `c`: the deadline freeze,
    the heal of failed lanes, the schedule's plans, the step, the injections
    and the counters; and, between sweeps, the admission of fresh lanes into
    chosen slots (HostedSolve).
    `flat` is the groups' concatenation, made when a repacked sweep first
    needs it, with the groups then views of it, until a whole-group step
    replaces them again; `rows_of` (the rows each repacked chunk steps) is
    derived from the carry's repack plan.

    `step_for(L)` is the sweep step at ladder length L (opts.ladder_len for
    the static schedules): lanes -> (lanes', rows, rung); `init_rows(X)`
    makes fresh lanes at the starts X (a heal or an admission);
    `retry_draws` is the retry stream's draws hook. `counts_now` holds the
    counts read back after the carry's last sweep, None once the carry
    changed between sweeps (an admission) or was loaded."""

    def __init__(self, opts: EngineOptions, width: int, n: int, n_lanes: int,
                 step_for: Callable[[int], Callable], init_rows: Callable,
                 retry_draws, device):
        self.opts = opts
        self.width = width
        self.n = n
        self.step_for = step_for
        self.init_rows = init_rows
        self.retry_draws = retry_draws
        self.c: Optional[EngineCarry] = None
        self.flat = None
        self.rows_of = _STALE
        self.counts_now: Optional[_Counts] = None
        self.chunked = n > 1
        self.compacting = opts.compact_every > 0
        self.repacking = opts.repack_every > 0 and self.chunked
        self.scheduling = opts.schedule != "static"
        self.retrying = opts.retry_budget > 0
        self.injecting = opts.fault_plan is not None and opts.fault_plan.has_injections
        self.deadlining = opts.lane_deadlines
        self.buckets = _compaction_buckets(width)
        self.cbuckets = _compaction_buckets(n)
        # padding lanes (the tail of the last chunk) are never healed, hit or
        # admitted
        self.pad_host = (np.arange(n * width) >= n_lanes).reshape(n, width)
        self.pad = torch.from_numpy(self.pad_host).to(device)
        if self.scheduling:
            self.ladders = _auto_ladders(opts)
            self.eff = tuple(L if L > 0 else opts.ls_iters for L in self.ladders)
            self.n_windows = max(1, -(-opts.iter_max // opts.schedule_every))
            self.act_thresh = opts.auto_active_frac * n_lanes

    def carry0(self, groups, rows: int) -> EngineCarry:
        """The carry of sweep 0 over `groups` (on the meta device, the
        structure a snapshot restores into), with every field this
        configuration uses."""
        opts, n, C = self.opts, self.n, self.width
        dev = groups[0].x.device
        c = EngineCarry(k=0, groups=list(groups), rows=rows, trips=0,
                        n_restarts=torch.zeros((n * C,), dtype=torch.int32, device=dev),
                        replan=False)
        ident = torch.arange(C, device=dev).expand(n, C).contiguous()
        if self.scheduling and not self.chunked or self.compacting and not self.repacking:
            c.perm, c.sizes = ident, (C,) * n
        if self.scheduling and self.chunked or self.repacking:
            c.gperm, c.m = torch.arange(n * C, device=dev), n
            c.cperm, c.csizes = ident.clone(), (C,) * n
        if self.scheduling:
            c.auto = _AutoState(plan=len(self.ladders) - 1, dyn_on=False, prev_lidx=-1)
            c.trace = np.zeros((self.n_windows, 2 * len(self.ladders)), np.int32)
        if opts.schedule == "auto":
            c.hist = torch.zeros((opts.ls_iters + 1,), dtype=torch.int64, device=dev)
        if opts.auto_cost_model:
            c.telem = telemetry.telemetry_init(self.n_windows, opts.telemetry_costs)
        if self.deadlining:
            c.deadline = torch.zeros((n * C,), dtype=torch.int32, device=dev)
        return c

    def load(self, c: EngineCarry) -> None:
        self.c = c
        self.flat = None
        self.rows_of = _STALE
        self.counts_now = None

    # -- counts ------------------------------------------------------------
    def _masks(self):
        return torch.cat([_active_mask(g) for g in self.c.groups])

    def _expiring(self, i: int) -> torch.Tensor:
        """Group i's active lanes whose deadline the sweep k = c.k enforces
        (0 < deadline <= k)."""
        dl = self.c.deadline.view(self.n, self.width)[i]
        return _active_mask(self.c.groups[i]) & (dl > 0) & (dl <= self.c.k)

    def _live(self):
        """The flat active mask as sweep c.k plans from it: after its
        deadline freeze."""
        if not self.deadlining:
            return self._masks()
        return torch.cat([_active_mask(g) & ~self._expiring(i)
                          for i, g in enumerate(self.c.groups)])

    def _eligible(self, i: int) -> torch.Tensor:
        """Group i's lanes the next sweep heals: failed, not padding, with
        retry budget left."""
        restarts = self.c.n_restarts.view(self.n, self.width)[i]
        return (self.c.groups[i].failed & ~self.pad[i]
                & (restarts < self.opts.retry_budget))

    def extras(self):
        """Device counts the host needs before sweep k = c.k plans, read back
        with the stop counts after sweep k - 1."""
        opts, c = self.opts, self.c
        k = c.k
        if self.scheduling:
            if c.hist is not None and k > 0 and k % opts.schedule_every == 0:
                return (c.hist,)
            return ()
        if (self.repacking and self.compacting and k > 0 and k % opts.compact_every == 0
                and k % opts.repack_every != 0):
            # a compaction refresh inside the standing repack plan needs the
            # active count of each repacked chunk
            act = self._live()[c.gperm].view(self.n, self.width)[:c.m]
            return (torch.sum(act, dim=1),)
        return ()

    def counts(self) -> _Counts:
        """The stop counts and the next sweep's plan inputs: one readback."""
        elig = [self._eligible(i) for i in range(self.n)] if self.retrying else None
        exp = [self._expiring(i) for i in range(self.n)] if self.deadlining else None
        return _stop_counts(self.c.groups, self.extras(), elig, exp)

    def _recount(self, counts: _Counts) -> _Counts:
        """Each group's active count after a heal: a healed lane can start
        converged or failed, so the plans read them again."""
        act = torch.stack([torch.sum(_active_mask(g)) for g in self.c.groups])
        return counts._replace(act=tuple(act.tolist()))

    # -- plans -------------------------------------------------------------
    def _full_ladder(self, L: int) -> bool:
        return L <= 0 or L >= self.opts.ls_iters

    def _compaction_refresh(self, act) -> None:
        """Each group's (partition, bucket) from its active count."""
        plans = [_compaction_plan(_active_mask(g), self.buckets, a)
                 for g, a in zip(self.c.groups, act)]
        self.c.perm = torch.stack([perm for perm, _ in plans])
        self.c.sizes = tuple(self.buckets[bidx] for _, bidx in plans)

    def _inner_sizes(self, active_per_chunk):
        return [self.buckets[_bucket_index(self.buckets, a)] for a in active_per_chunk]

    def _repack_refresh(self, n_active: int) -> None:
        """The repack plan: the flat stable partition and m, the smallest
        chunk-count bucket covering the active lanes; its chunks are stepped
        whole until an inner refresh compacts them."""
        c = self.c
        c.gperm, gcidx = _repack_plan(self._masks(), self.width, self.cbuckets, n_active)
        c.m = self.cbuckets[gcidx]
        c.csizes = (self.width,) * self.n
        self.rows_of = _STALE

    def _inner_refresh(self, active_per_chunk) -> None:
        """Compaction inside the standing repack plan: each repacked chunk's
        stable partition of its own active flags, and its bucket."""
        c = self.c
        c.cperm = _partition(self._masks()[c.gperm].view(self.n, self.width))
        sizes = self._inner_sizes(active_per_chunk)
        c.csizes = tuple(sizes) + (self.width,) * (self.n - len(sizes))
        self.rows_of = _STALE

    def _actives_after_repack(self, n_active: int):
        """Active lanes of each repacked chunk right after a repack refresh:
        the partition puts them first, so they fill the chunks in order."""
        C = self.width
        return [min(C, max(0, n_active - j * C)) for j in range(self.c.m)]

    def _repacked_rows(self, L: int):
        """The flat rows each of the first m repacked chunks steps: chunk j
        is rows gperm[jC:(j+1)C], compacted to its first csizes[j] rows by
        its own partition. None when the plan covers every row once at the
        full ladder: the static sweep then steps the same lanes, to the same
        bits and counters, without a gather."""
        c, C = self.c, self.width
        sizes = c.csizes[:c.m]
        if c.m == self.n and self._full_ladder(L) and all(s == C for s in sizes):
            return None
        chunks = c.gperm.view(self.n, C)[:c.m]
        return [rows if s == C else rows.index_select(0, c.cperm[j, :s])
                for j, (rows, s) in enumerate(zip(chunks, sizes))]

    # -- executors ---------------------------------------------------------
    def _step(self, step, lanes):
        new, rows, rung = step(lanes)
        if self.c.hist is not None:
            # the window's accepted-rung histogram over the active lanes
            # (bin ls_iters = exhausted), read by the controller
            self.c.hist.scatter_add_(0, rung.long(), _active_mask(lanes).long())
        return new, rows

    def _static(self, step):
        groups, rows = self.c.groups, 0
        for i, lanes in enumerate(groups):
            groups[i], r = self._step(step, lanes)
            rows += r
        self.flat = None
        return rows, self.n

    def _compacted(self, step):
        c, rows = self.c, 0
        for i, size in enumerate(c.sizes):
            if size == self.width:
                # the bucket is the whole group: the same lanes, in place
                c.groups[i], r = self._step(step, c.groups[i])
                self.flat = None
            else:
                idx = c.perm[i, :size]
                sub, r = self._step(step, _take(c.groups[i], idx))
                _put(c.groups[i], idx, sub)
            rows += r
        return rows, self.n

    def _repacked(self, step, L: int):
        if self.rows_of is _STALE:
            self.rows_of = self._repacked_rows(L)
        if self.rows_of is None:
            return self._static(step)
        groups = self.c.groups
        if self.flat is None:
            self.flat = _tree_map(lambda *parts: torch.cat(parts), *groups)
            C = self.width
            groups[:] = [_tree_map(lambda a: a[i * C:(i + 1) * C], self.flat)
                         for i in range(self.n)]
        rows = 0
        for idx in self.rows_of:
            sub, r = self._step(step, _take(self.flat, idx))
            _put(self.flat, idx, sub)
            rows += r
        return rows, self.c.m

    # -- fresh lanes -------------------------------------------------------
    def _reseed(self, i: int, idx: torch.Tensor, X: torch.Tensor,
                carry_evals: bool) -> None:
        """Re-initialise rows `idx` of group i at the starts X alone, in
        place (the heal's and the admission's one write path): fresh flags
        and direction state, the eval counter fresh or, with `carry_evals`,
        carried on across the lane's lives. A group that is a view of the
        repacked `flat` stack writes through to it."""
        group = self.c.groups[i]
        fresh = self.init_rows(X)
        if carry_evals:
            fresh = fresh._replace(n_evals=group.n_evals.index_select(0, idx) + fresh.n_evals)
        _put(group, idx, fresh)

    def admit(self, mask: np.ndarray, X: torch.Tensor, deadlines: torch.Tensor) -> None:
        """Seed fresh lanes at rows of X (B, D) into the flat slots `mask`
        (n·width,) holds (padding never), between sweeps: each a new solve,
        with fresh n_evals and n_restarts and its deadline from `deadlines`
        (n·width,). The next sweep refreshes its gather plans (an admission
        breaks the rule that the active set only shrinks) and the counts
        are read again. eval_rows counts the admitted rows."""
        c, C = self.c, self.width
        m = np.asarray(mask, bool).reshape(self.n, C) & ~self.pad_host
        dev = self.pad.device
        for i in range(self.n):
            rows = np.flatnonzero(m[i])
            if rows.size:
                idx = torch.from_numpy(rows).to(dev)
                self._reseed(i, idx, X.index_select(0, idx + i * C), carry_evals=False)
        flat_idx = np.flatnonzero(m)
        if flat_idx.size:
            idx = torch.from_numpy(flat_idx).to(dev)
            c.n_restarts.index_fill_(0, idx, 0)
            if c.deadline is not None:
                c.deadline.index_copy_(0, idx, deadlines.index_select(0, idx))
            c.rows += int(flat_idx.size)
            c.replan = True
            self.counts_now = None

    def vacate(self) -> None:
        """Freeze every slot (failed, not converged): an empty pool, whose
        slots admissions light up one by one."""
        for g in self.c.groups:
            g.converged.fill_(False)
            g.failed.fill_(True)
        self.counts_now = None

    def _expire(self) -> None:
        """The deadline freeze at the start of sweep c.k: every active lane
        with 0 < deadline <= k is failed from now on."""
        for i, g in enumerate(self.c.groups):
            g.failed.logical_or_(self._expiring(i))

    # -- faults ------------------------------------------------------------
    def _heal(self, elig) -> None:
        """Re-seed the failed lanes with budget left (`elig`, their count per
        group) and re-initialise those rows alone: a fresh start, identity
        direction state and flags, n_evals carried on across the lane's
        lives. One draw covers the whole flat lane axis, whichever lanes
        heal."""
        opts, c, C = self.opts, self.c, self.width
        masks = [self._eligible(i) for i in range(self.n)]
        x = torch.cat([g.x for g in c.groups])
        if opts.retry_mode == "uniform":
            lo, hi = opts.retry_bounds
            starts = faults.reseed_lost_lanes(self.retry_draws, x, torch.cat(masks), lo, hi)
        else:
            noise = self.retry_draws.normal(tuple(x.shape)).to(x.device, x.dtype)
            # a non-finite iterate restarts from the box's middle, else 0
            mid = (0.5 * (opts.retry_bounds[0] + opts.retry_bounds[1])
                   if opts.retry_bounds is not None else 0.0)
        restarts = c.n_restarts.view(self.n, C)
        for i, e in enumerate(elig):
            if not e:
                continue
            idx = _partition(masks[i])[:e]
            flat_idx = idx + i * C
            if opts.retry_mode == "uniform":
                X = starts.index_select(0, flat_idx)
            else:
                xi = x.index_select(0, flat_idx)
                X = (torch.where(torch.isfinite(xi), xi, mid)
                     + opts.retry_sigma * noise.index_select(0, flat_idx))
            self._reseed(i, idx, X, carry_evals=True)
            restarts[i].index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
        # the port evaluates the healed rows alone (the reference: every lane)
        c.rows += sum(elig)

    def _inject(self, k: int) -> None:
        """The fault plan's events at sweep k, after the sweep: NaN into a
        lane's gradient, marking it failed; a kill freezes the lane as
        failed with its state intact. Padding lanes are never hit."""
        plan = self.opts.fault_plan
        if not any(faults.injection_lanes(plan, k)):
            return
        nan_m, kill_m = faults.injection_masks(plan, k, self.n * self.width,
                                               self.pad.device)
        nan_m = nan_m.view(self.n, self.width) & ~self.pad
        kill_m = kill_m.view(self.n, self.width) & ~self.pad
        for i, g in enumerate(self.c.groups):
            g.g.masked_fill_(nan_m[i][:, None], float("nan"))
            g.failed.logical_or_(nan_m[i] | kill_m[i])

    # -- one sweep ---------------------------------------------------------
    def sweep(self, counts: _Counts) -> None:
        """Sweep k = c.k: freeze the lanes past their deadline, heal, plan,
        step and inject, then advance k and the row and chunk-step counters.
        The freeze takes the lanes `counts` found expiring: the plans count
        the active lanes after it, as the reference plans from the lanes its
        prologue froze (no plan refresh: the active set only shrinks)."""
        c = self.c
        k = c.k
        self.counts_now = None
        force, c.replan = c.replan, False
        if any(counts.expiring):
            self._expire()
            counts = counts._replace(
                act=tuple(a - e for a, e in zip(counts.act, counts.expiring)))
        n_before = sum(counts.act)  # active lanes before any heal
        if any(counts.elig):
            self._heal(counts.elig)
            # a re-admission breaks the rule that the active set only
            # shrinks, on which the standing gather plans rely
            force = True
            if self.compacting or self.repacking or self.scheduling:
                counts = self._recount(counts)
        if self.scheduling:
            rows, trips = self._scheduled(k, counts, force, n_before)
        else:
            rows, trips = self._planned(k, counts, force)
        c.rows += rows
        c.trips += trips
        if self.injecting:
            self._inject(k)
        c.k = k + 1

    def _planned(self, k: int, counts: _Counts, force: bool):
        """A sweep of the static schedules (compact_every, repack_every)."""
        opts = self.opts
        L = opts.ladder_len
        step = self.step_for(L)
        n_active = sum(counts.act)
        if self.repacking:
            renew_g = force or k % opts.repack_every == 0
            if renew_g:
                self._repack_refresh(n_active)
            if self.compacting and (renew_g or k % opts.compact_every == 0):
                self._inner_refresh(self._actives_after_repack(n_active) if renew_g
                                    else counts.extra[0])
            return self._repacked(step, L)
        if self.compacting:
            if force or k % opts.compact_every == 0:
                self._compaction_refresh(counts.act)
            return self._compacted(step)
        return self._static(step)

    def _scheduled(self, k: int, counts: _Counts, force: bool, n_before: int):
        """A sweep of schedule="auto"/"replay": a window boundary decides the
        plan (the p90 controller, the cost model, or the replayed plan) and
        counts it in the trace; a dynamic plan refreshes its gather plans
        there, and mid-window after a heal."""
        opts, c = self.opts, self.c
        n_ladders = len(self.ladders)
        n_active = sum(counts.act)
        boundary = k % opts.schedule_every == 0
        if boundary:
            w = k // opts.schedule_every
            if opts.schedule == "replay":
                c.auto = c.auto._replace(plan=int(opts.schedule_plans[w]))
            else:
                hist = counts.extra[0] if counts.extra else (0,) * (opts.ls_iters + 1)
                if opts.auto_cost_model:
                    # the reference reads the active count before the
                    # sweep's heal here, the p90 controller after it
                    plan, prev_lidx, dyn_on = telemetry.cost_model_decision(
                        hist, n_before, self.eff, c.auto.plan, c.auto.prev_lidx,
                        c.auto.dyn_on, act_thresh=self.act_thresh,
                        c_row=float(c.telem.c_row), c_launch=float(c.telem.c_launch))
                    c.auto = _AutoState(plan=plan, dyn_on=dyn_on, prev_lidx=prev_lidx)
                else:
                    c.auto = _auto_controller(c.auto, n_active, hist, self.eff,
                                              self.act_thresh)
                c.hist.zero_()
            c.trace[w, c.auto.plan] += 1
        plan = c.auto.plan
        L = self.ladders[plan % n_ladders]
        dynamic = plan >= n_ladders
        if dynamic and (boundary or force):
            if self.chunked:
                self._repack_refresh(n_active)
                self._inner_refresh(self._actives_after_repack(n_active))
            else:
                self._compaction_refresh(counts.act)
        step = self.step_for(L)
        if not dynamic:
            return self._static(step)
        if self.chunked:
            return self._repacked(step, L)
        return self._compacted(step)


def _lanes_like(strategy_init: Callable, C: int, D: int, batched: bool,
                dtype: torch.dtype = torch.float32):
    """A lane group's structure, shapes and dtypes on the meta device (no
    memory, no objective evaluation): what a snapshot restores into."""
    X = torch.empty((C, D), dtype=dtype, device="meta")
    vec = torch.empty((C,), dtype=dtype, device="meta")
    flag = torch.empty((C,), dtype=torch.bool, device="meta")
    cnt = torch.empty((C,), dtype=torch.int32, device="meta")
    state = strategy_init(X)
    if batched:
        return BatchLanes(x=X, f=vec, g=X, p=X, converged=flag, failed=flag,
                          n_evals=cnt, direction_state=state)
    return Lane(x=X, f=vec, g=X, converged=flag, failed=flag, n_evals=cnt,
                direction_state=state)


def _host_copy(x):
    """A leaf of the carry as a host copy of its own (a snapshot is written
    while the next sweeps change the carry in place)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    if isinstance(x, np.ndarray):
        return x.copy()
    return x


class _SnapshotWriter:
    """Writes snapshots of a carry on one background thread, after the
    copy to the host. At most one write is in flight: the writer is joined
    before the next save, before a Preempted raise and before the solve
    returns, so the newest committed step is known at every boundary a
    caller can observe. A write's error is raised at that join."""

    def __init__(self, opts: EngineOptions, retry_draws):
        self.opts = opts
        self.retry_draws = retry_draws
        self.pending = None  # (thread, errors) of the write in flight

    def join(self) -> None:
        if self.pending is not None:
            thread, err = self.pending
            self.pending = None
            thread.join()
            if err:
                raise err[0]

    def save(self, c: EngineCarry) -> None:
        self.join()
        if self.opts.retry_budget > 0:
            c.retry_state = self.retry_draws.get_state()
        t0 = time.perf_counter()
        host = ckpt_manager.tree_map(_host_copy, c)
        copy_s = time.perf_counter() - t0
        nbytes = sum(np.asarray(a).nbytes for a in ckpt_manager.tree_flatten(host)[0])
        opts, err = self.opts, []

        def write():
            try:
                t1 = time.perf_counter()
                ckpt_manager.save(opts.checkpoint_dir, host.k, host,
                                  keep=opts.checkpoint_keep)
                log.debug("snapshot step %d: %d bytes, host copy %.6f s, write %.6f s",
                          host.k, nbytes, copy_s, time.perf_counter() - t1)
            except Exception as e:  # raised at the next join
                err.append(e)

        thread = threading.Thread(target=write, daemon=True)
        thread.start()
        self.pending = (thread, err)


class _Opened(NamedTuple):
    """What run_multistart and open_multistart share, built by `_open`."""

    sweeper: _Sweeper
    x0: torch.Tensor  # (B, D) the starts on the device
    start: Callable  # (X, owned) -> the carry of sweep 0 at starts X (B, D)
    like: Callable  # () -> the carry's structure on the meta device
    n_chunks: int
    device: torch.device


def _open(f, x0, strategy, opts: EngineOptions, device, retry_draws,
          resume=None, entry: Optional[str] = None) -> _Opened:
    """The starts on the device, the sweep mode's init and step, and a
    _Sweeper over ceil(B / C) lane groups of C = lane_chunk lanes (the last
    padded with frozen lanes). A tensor x0 keeps its dtype, float32 or
    float64 (the latter on the paths refuse_float64 lets through); anything
    else becomes float32."""
    dev = resolve_device(device)
    dtype = check_dtype(x0.dtype) if isinstance(x0, torch.Tensor) else torch.float32
    if dtype is torch.float64:
        dense = getattr(as_batched_strategy(strategy), "megakernel_dense_h", False)
        refuse_float64(dtype, opts, solver="bfgs" if dense else type(strategy).__name__,
                       resume=resume, entry=entry)
    x0 = torch.as_tensor(x0, dtype=dtype, device=dev).contiguous()
    B, D = x0.shape
    if retry_draws is None:
        retry_draws = TorchDraws(dev, seed=0)

    C = opts.lane_chunk if opts.lane_chunk is not None and 0 < opts.lane_chunk < B else B
    n_chunks = -(-B // C)
    pad = n_chunks * C - B
    batched = opts.sweep_mode in _BATCHED_MODES

    if batched:
        bobj = as_batched(f, ad_mode=opts.ad_mode)
        bstrategy = as_batched_strategy(strategy)
        step_impl = batch_lanes_step
        if opts.sweep_mode == "megakernel":
            reason = megakernel_unsupported_reason(bobj, bstrategy, D, opts)
            if reason is None:
                step_impl = megakernel_lanes_step
            else:
                warnings.warn(
                    f"sweep_mode='megakernel': {reason}; running the batched "
                    "sweep instead (the same results)", RuntimeWarning, stacklevel=3)

        def init_chunk(X):
            return batch_lanes_init(bobj, bstrategy, X, opts.theta)

        def step_for(L):
            sopts = opts if L == opts.ladder_len else dataclasses.replace(opts, ladder_len=L)
            return lambda lanes: step_impl(bobj, bstrategy, sopts, lanes)

        state_init = bstrategy.init_state_batch
        rows0 = n_chunks * C  # init: one value+grad row per lane
    else:
        if hasattr(strategy, "update_and_direction_batch"):
            raise ValueError(
                "sweep_mode='per_lane' needs a per-lane DirectionStrategy "
                f"(got the batch-level {type(strategy).__name__})")
        obj = per_lane_objective(f, opts.ad_mode)

        def init_chunk(X):
            return lane_init(obj.value_and_grad_batch, strategy, X, opts.theta,
                             opts.ad_mode)

        def step_for(L):
            # rows and rungs are not instrumented on the per-lane path (as in
            # the reference, eval_rows stays 0)
            return lambda lanes: (lane_step(obj.value_batch, obj.value_and_grad_batch,
                                            strategy, opts, lanes), 0, None)

        state_init = strategy.init_state
        rows0 = 0

    sweeper = _Sweeper(opts, C, n_chunks, B, step_for, init_chunk, retry_draws, dev)

    def start(X, owned: bool) -> EngineCarry:
        Xp = torch.cat([X, X[:1].expand(pad, D)]) if pad else X
        chunks = [init_chunk(Xp[i * C:(i + 1) * C]) for i in range(n_chunks)]
        if pad:
            # padding lanes (the tail of the last chunk) are frozen from
            # birth: never active, never counted, never retried
            last = chunks[-1]
            chunks[-1] = last._replace(converged=last.converged & ~sweeper.pad[-1],
                                       failed=last.failed | sweeper.pad[-1])
        if owned:
            # rows are written in place: no leaf may share storage with
            # another or with the caller's starts
            chunks = [_owned(ls, {X.untyped_storage().data_ptr()}) for ls in chunks]
        return sweeper.carry0(chunks, rows0)

    def like() -> EngineCarry:
        return sweeper.carry0([_lanes_like(state_init, C, D, batched, dtype)] * n_chunks,
                              rows0)

    return _Opened(sweeper=sweeper, x0=x0, start=start, like=like, n_chunks=n_chunks,
                   device=dev)


def _drive(sweeper: _Sweeper, counts: _Counts, k_end: int, required_c: int,
           writer: Optional[_SnapshotWriter] = None, probe=None,
           preempt_at: Optional[int] = None) -> _Counts:
    """The host loop, one for both drivers: run_multistart runs it to the
    stop, HostedSolve.segment to a boundary. Sweeps while k < k_end, fewer
    than required_c lanes converged and any lane active, reading the stop
    counts back once a sweep; with `writer`, snapshots every
    checkpoint_every sweeps and at the stop; with `probe`, records the cost
    model's windows; raises Preempted at `preempt_at`. Returns the counts
    after the last sweep."""
    opts, c = sweeper.opts, sweeper.c
    every_ck = opts.checkpoint_every if writer is not None else 0
    every = opts.schedule_every
    window = None  # (k, rows, trips, energy, host clock) where the window's segment began

    def running(counts):
        return c.k < k_end and counts.n_conv < required_c and counts.n_act > 0

    try:
        while running(counts):
            if preempt_at is not None and c.k >= preempt_at:
                # a death at a sweep boundary: nothing past the last snapshot
                # is saved, so a resume replays the lost sweeps
                if writer is not None:
                    writer.join()
                raise faults.Preempted(c.k, opts.checkpoint_dir)
            if probe is not None and window is None:
                window = (c.k, c.rows, c.trips, probe.read_j(), time.perf_counter())
            sweeper.sweep(counts)
            counts = sweeper.counts()  # the readback synchronises with the device
            k, go_on = c.k, running(counts)
            if window is not None and (
                    k % every == 0 or not go_on or (every_ck and k % every_ck == 0)
                    or (preempt_at is not None and k >= preempt_at)):
                # a segment of the window ends: at its boundary, at a
                # snapshot, at a preemption or at the stop
                k0, rows0_w, trips0_w, e0, t0 = window
                wall = time.perf_counter() - t0
                e1 = probe.read_j()
                c.telem = telemetry.record_window(
                    c.telem, k0 // every, wall, c.rows - rows0_w, c.trips - trips0_w,
                    energy_j=e1 - e0 if e0 is not None and e1 is not None else None,
                    ema=opts.telemetry_ema, fixed=opts.telemetry_costs is not None,
                    refit=k % every == 0 or not go_on)
                window = None
            if every_ck and (k % every_ck == 0 or not go_on):
                writer.save(c)
    except BaseException:
        if writer is not None and writer.pending is not None:
            writer.pending[0].join()  # let the write in flight finish
        raise
    if writer is not None:
        writer.join()
    sweeper.counts_now = counts
    return counts


def _flat_field(c: EngineCarry, field: str) -> torch.Tensor:
    """A per-lane field over the flat lane axis (padding included)."""
    parts = [getattr(ls, field) for ls in c.groups]
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def _result(c: EngineCarry, B: int, opts: EngineOptions, dev) -> BFGSResult:
    """The BFGSResult of a carry's first B lanes; the direction state is
    dropped, never copied into one stack."""
    def joined(field):
        return _flat_field(c, field)[:B]

    converged, failed = joined("converged"), joined("failed")
    status = torch.where(
        converged,
        CONVERGED,
        torch.where(failed | (c.k >= opts.iter_max), DIVERGED, STOPPED),
    ).to(torch.int32)
    return BFGSResult(
        x=joined("x"),
        fval=joined("f"),
        grad_norm=torch.linalg.vector_norm(joined("g"), dim=-1),
        status=status,
        iterations=c.k,
        n_converged=int(torch.sum(converged)),
        n_evals=joined("n_evals"),
        eval_rows=c.rows,
        map_trips=c.trips,
        schedule_trace=(torch.as_tensor(c.trace, device=dev)
                        if c.trace is not None else None),
        n_restarts=c.n_restarts[:B],
        n_failed=int(torch.sum(failed)),
        telemetry=c.telem,
    )


def run_multistart(
    f: Callable,
    x0,  # (B, D) starting points (the post-PSO swarm)
    strategy,
    opts: EngineOptions = EngineOptions(),
    *,
    device="cuda",
    retry_draws=None,
    resume_from: Optional[str] = None,
) -> BFGSResult:
    """Run B independent quasi-Newton solves until required_c converge.

    f:           objective (a named one routes through the fused kernels on
                 the batched sweep).
    x0:          (B, D) starts, a float32 or float64 tensor (the solve runs
                 in its dtype; float64 on the paths _device.refuse_float64
                 lets through) or an array (float32); moved to `device`.
    strategy:    a per-lane DirectionStrategy (core/bfgs.DenseBFGS,
                 core/lbfgs.LBFGS) or, for the batched modes only, a
                 batch-level one (core/bfgs.BatchedDenseBFGS).
    device:      "cuda" (default) or "cpu"; no silent CPU fallback.
    retry_draws: the retry stream (retry_budget > 0), a draws hook
                 (core/pso.py); None is TorchDraws(device, seed=0). Under
                 checkpointing it needs get_state()/set_state().
    resume_from: a checkpoint root: restore its newest committed snapshot
                 of this solve and run on from there.

    On the batched modes, `compact_every`, `repack_every` and `schedule`
    choose the sweep schedule (see "Sweep schedules" above); every schedule
    is array-equal to the static sweep."""
    check_engine_options(opts)
    retrying = opts.retry_budget > 0
    plan = opts.fault_plan
    injecting = plan is not None and plan.has_injections
    preempt_at = None if plan is None else plan.preempt_at_sweep
    if (retrying and (opts.checkpoint_every or resume_from is not None)
            and retry_draws is not None
            and not (hasattr(retry_draws, "get_state")
                     and hasattr(retry_draws, "set_state"))):
        raise ValueError(
            "checkpoint_every/resume_from with retry_budget > 0 snapshot the "
            "retry stream: its draws hook needs get_state() and set_state()")
    opened = _open(f, x0, strategy, opts, device, retry_draws, resume=resume_from)
    sweeper, x0 = opened.sweeper, opened.x0
    B = x0.shape[0]
    required_c = opts.required_c if opts.required_c is not None else B
    if resume_from is None:
        sweeper.load(opened.start(x0, owned=bool(
            opts.compact_every or opts.repack_every or opts.schedule != "static"
            or retrying or injecting or opts.lane_deadlines)))
    else:
        like = opened.like()
        if retrying:
            like.retry_state = sweeper.retry_draws.get_state()
        carry = ckpt_manager.restore(resume_from, like, device=opened.device)
        if retrying:
            sweeper.retry_draws.set_state(carry.retry_state)
        sweeper.load(carry)

    writer = (_SnapshotWriter(opts, sweeper.retry_draws) if opts.checkpoint_every
              else None)
    probe = telemetry.probe_energy() if opts.auto_cost_model else None
    _drive(sweeper, sweeper.counts(), opts.iter_max, required_c, writer, probe, preempt_at)
    return _result(sweeper.c, B, opts, opened.device)


# ---------------------------------------------------------------------------
# A solve held open under host control (the solve service's engine half,
# serve/service.py): the same carry, sweeps and host loop as run_multistart,
# advanced to boundaries the caller chooses, with lanes admitted into chosen
# slots between them.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class HostedSolve:
    """A multistart solve held open under host control.

    Where `run_multistart` drives a carry from its start to its stop itself,
    a HostedSolve hands the loop to the caller: `segment()` sweeps to the
    next host boundary, `lane_view()` reads each slot's result there (the
    harvest), `admit()` seeds fresh lanes into chosen slots, and
    `empty_carry()` starts a pool with every slot vacant. A lane's sweeps
    read only its own row and an admission writes only the admitted rows,
    so a lane's trajectory in a busy pool is the one it has alone in a
    fresh batch of the same width.

    The carry is advanced in place: `segment` and `admit` return the carry
    they were given. The retry stream is the draws hook open_multistart
    took (the reference's retry key)."""

    _sweeper: _Sweeper
    _start: Callable  # (X, owned) -> the carry of sweep 0
    _x0: torch.Tensor  # (B, dim) placeholder starts of empty_carry
    opts: EngineOptions
    B: int  # admittable slots (flat indices >= B are chunk padding)
    B_flat: int  # the flat lane axis with padding (mask and deadline length)
    dim: int
    required_c: int

    def _load(self, carry: EngineCarry) -> _Sweeper:
        sw = self._sweeper
        if sw.c is not carry:
            sw.load(carry)
        return sw

    def _counts(self, carry: EngineCarry) -> _Counts:
        sw = self._load(carry)
        if sw.counts_now is None:
            sw.counts_now = sw.counts()
        return sw.counts_now

    def init_carry(self, X0=None, retry_draws=None) -> EngineCarry:
        """The carry of sweep 0 at the starts X0 (B, dim), the placeholder
        starts when None; `retry_draws` replaces the retry stream."""
        if retry_draws is not None:
            self._sweeper.retry_draws = retry_draws
        X = self._x0 if X0 is None else torch.as_tensor(
            X0, dtype=torch.float32, device=self._x0.device).contiguous()
        carry = self._start(X, owned=True)
        self._sweeper.load(carry)
        return carry

    def empty_carry(self, retry_draws=None) -> EngineCarry:
        """A pool with every slot vacant (frozen, harvested as nothing): the
        service's starting state."""
        carry = self.init_carry(retry_draws=retry_draws)
        self._sweeper.vacate()
        return carry

    def segment(self, carry: EngineCarry, k_end) -> EngineCarry:
        """Sweep until k reaches k_end, every lane is frozen, or required_c
        lanes converged, whichever comes first."""
        counts = self._counts(carry)
        _drive(self._sweeper, counts, min(int(k_end), self.opts.iter_max),
               self.required_c)
        return carry

    def running(self, carry: EngineCarry) -> bool:
        counts = self._counts(carry)
        return (carry.k < self.opts.iter_max and counts.n_conv < self.required_c
                and counts.n_act > 0)

    def admit(self, carry: EngineCarry, mask, X, deadlines) -> EngineCarry:
        """Seed fresh lanes into the mask'd flat slots of a live carry. mask
        is (B_flat,) bool; X is (B, dim) start points (only mask'd rows are
        read); deadlines is (B_flat,) int32 absolute sweep deadlines (0 =
        none; kept only under lane_deadlines)."""
        sw = self._load(carry)
        dev = self._x0.device
        X = torch.as_tensor(X, dtype=torch.float32, device=dev).contiguous()
        deadlines = torch.as_tensor(np.asarray(deadlines, np.int32), device=dev)
        sw.admit(np.asarray(mask, bool).reshape(-1), X, deadlines)
        return carry

    def lane_view(self, carry: EngineCarry) -> dict:
        """Host copy of each flat slot's harvest view, in one transfer: k,
        x, f, grad_norm (computed as run_multistart's result computes it),
        converged, failed, n_evals and deadline, as numpy arrays."""
        parts = {
            "x": _flat_field(carry, "x"),
            "f": _flat_field(carry, "f"),
            "grad_norm": torch.linalg.vector_norm(_flat_field(carry, "g"), dim=-1),
            "converged": _flat_field(carry, "converged"),
            "failed": _flat_field(carry, "failed"),
            "n_evals": _flat_field(carry, "n_evals"),
            "deadline": (carry.deadline if carry.deadline is not None
                         else torch.zeros((self.B_flat,), dtype=torch.int32,
                                          device=self._x0.device)),
        }
        raw = torch.cat([t.contiguous().view(-1).view(torch.uint8)
                         for t in parts.values()]).cpu().numpy()
        view, at = {"k": np.asarray(carry.k, np.int32)}, 0
        for name, t in parts.items():
            dtype = np.dtype(str(t.dtype).replace("torch.", ""))
            n = t.numel() * dtype.itemsize
            view[name] = raw[at:at + n].view(dtype).reshape(tuple(t.shape))
            at += n
        return view

    def finalize(self, carry: EngineCarry) -> BFGSResult:
        return _result(carry, self.B, self.opts, self._x0.device)


def open_multistart(f: Callable, x0, strategy, opts: EngineOptions = EngineOptions(),
                    *, device="cuda", retry_draws=None) -> HostedSolve:
    """Open a multistart solve under host control instead of running it.

    x0 (B, D) fixes the pool's width; its values are the placeholder starts
    empty_carry initialises the vacant slots from. Returns a HostedSolve
    whose segment/admit/lane_view let a caller (the solve service) drive
    the same sweeps and host loop run_multistart runs, harvesting retired
    lanes and seeding queued work into freed slots between segments. The
    same validation as run_multistart, and the cost model is refused: it
    needs the loop to itself."""
    check_engine_options(opts, hosted=True)
    opened = _open(f, x0, strategy, opts, device, retry_draws, entry="open_multistart")
    B, D = opened.x0.shape
    return HostedSolve(
        _sweeper=opened.sweeper, _start=opened.start, _x0=opened.x0, opts=opts, B=B,
        B_flat=opened.n_chunks * opened.sweeper.width, dim=D,
        required_c=opts.required_c if opts.required_c is not None else B)


# ---------------------------------------------------------------------------
# Solver registry. A solver factory maps its own options object (or None for
# defaults) + a lane_chunk override to a ready (strategy, EngineOptions)
# pair, so callers select solvers by name.
# ---------------------------------------------------------------------------
SolverFactory = Callable[..., Tuple[DirectionStrategy, EngineOptions]]

_SOLVERS: Dict[str, SolverFactory] = {}


def register_solver(name: str):
    """Decorator: `@register_solver("bfgs")` on a factory
    `(solver_opts=None, lane_chunk=None) -> (strategy, EngineOptions)`."""

    def deco(factory: SolverFactory) -> SolverFactory:
        _SOLVERS[name] = factory
        return factory

    return deco


def _ensure_builtin_solvers():
    # importing the strategy modules registers their factories
    from repro_torch.core import bfgs, lbfgs  # noqa: F401


def solver_names() -> Tuple[str, ...]:
    _ensure_builtin_solvers()
    return tuple(sorted(_SOLVERS))


def get_solver(name: str) -> SolverFactory:
    if name not in _SOLVERS:
        _ensure_builtin_solvers()
    if name not in _SOLVERS:
        raise ValueError(
            f"unknown solver {name!r}; registered: {', '.join(sorted(_SOLVERS))}")
    return _SOLVERS[name]
