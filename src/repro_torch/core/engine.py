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

`run_multistart` is a host loop: `lax.while_loop` and `lax.map` become
Python loops, and the two stop counts are read back to the host in one
transfer per sweep. With `lane_chunk=C` the lanes are held as ceil(B/C)
chunks (the last padded with frozen lanes) from start to finish, and each
sweep steps them one after another, replacing each chunk's state as it
goes: the (B, D, D) stack is persistent, and a sweep's transient memory is
O(C·D²) on top of it, while the stop counts stay sweep-synchronised across
chunks. Every evaluator on the path is row-independent, so a chunked solve
is array-equal to the unchunked one.

Not ported yet (each raises NotImplementedError naming its ROADMAP item):
sweep_mode "megakernel" (A9); compact_every, repack_every, ladder_len > 0
and schedule != "static" (A8); retry_budget, checkpoint_every/
checkpoint_dir and fault_plan (A11); auto_cost_model (A12).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Protocol, Tuple

import torch

from repro_torch._device import check_dtype, resolve_device
from repro_torch.core.dual import grad_eval_cost
from repro_torch.core.linesearch import (
    armijo_backtracking,
    armijo_backtracking_batch,
    wolfe_linesearch,
)
from repro_torch.core.objectives import (
    BatchedObjective,
    Objective,
    as_batched,
)

# status codes, matching the paper's result.status
DIVERGED = 0  # hit iter_max without |g| < theta (or NaN/Inf escape)
CONVERGED = 1
STOPPED = 2  # stop-flag: other lanes filled required_c first

_CURV_EPS = 1e-10


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
    # chunk steps issued: ceil(B / lane_chunk) per sweep, 1 unchunked
    map_trips: Optional[int] = None
    n_restarts: Optional[torch.Tensor] = None  # (B,) int32; zeros (no retry yet)
    n_failed: Optional[int] = None  # lanes that ended failed


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
    # "batched" | "per_lane" ("megakernel" is A9). The JAX package
    # defaults to "per_lane"; the port keeps "batched", its kernels' path.
    sweep_mode: str = "batched"
    # not ported yet; any other than the default raises (ROADMAP item)
    compact_every: int = 0  # A8
    repack_every: int = 0  # A8
    ladder_len: int = 0  # A8
    schedule: str = "static"  # A8
    auto_cost_model: bool = False  # A12
    retry_budget: int = 0  # A11
    checkpoint_every: int = 0  # A11
    checkpoint_dir: Optional[str] = None  # A11
    fault_plan: Optional[Any] = None  # A11


_SCHEDULE_KNOBS = ("compact_every", "repack_every", "ladder_len")


def check_engine_options(opts: EngineOptions) -> None:
    """Raise on options this port does not run yet, naming their ROADMAP
    item, and on values the reference rejects too."""
    if opts.sweep_mode == "megakernel":
        raise NotImplementedError(
            "sweep_mode='megakernel' is not ported yet (ROADMAP A9); the port "
            "runs sweep_mode='batched' or 'per_lane'")
    if opts.sweep_mode not in ("batched", "per_lane"):
        raise ValueError(
            f"unknown sweep_mode {opts.sweep_mode!r}; expected 'per_lane', "
            "'batched' or 'megakernel'")
    if opts.linesearch not in ("armijo", "wolfe"):
        raise ValueError(f"unknown linesearch {opts.linesearch!r}")
    if opts.sweep_mode == "batched" and opts.linesearch != "armijo":
        raise ValueError(
            "sweep_mode='batched' supports linesearch='armijo' only (got "
            f"{opts.linesearch!r}); use sweep_mode='per_lane'")
    for field in _SCHEDULE_KNOBS:
        value = getattr(opts, field)
        if value < 0:
            raise ValueError(f"{field} must be >= 0 (got {value})")
        if value > 0 and opts.sweep_mode == "per_lane":
            raise ValueError(
                f"{field} > 0 requires sweep_mode='batched' (got 'per_lane')")
        if value > 0:
            raise NotImplementedError(
                f"{field}={value} is not ported yet (ROADMAP A8)")
    if opts.schedule != "static":
        if opts.sweep_mode == "per_lane":
            raise ValueError(
                f"schedule={opts.schedule!r} requires sweep_mode='batched' "
                "(got 'per_lane')")
        raise NotImplementedError(
            f"schedule={opts.schedule!r} is not ported yet (ROADMAP A8)")
    if opts.auto_cost_model:
        raise NotImplementedError(
            "auto_cost_model is not ported yet (ROADMAP A12)")
    if (opts.retry_budget or opts.checkpoint_every or opts.checkpoint_dir
            or opts.fault_plan is not None):
        raise NotImplementedError(
            "retry_budget, checkpoint_every/checkpoint_dir and fault_plan are "
            "not ported yet (ROADMAP A11)")
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
    rows this step evaluated ((K + 1) per lane in the stack, frozen lanes
    included) and rung the (B,) int32 accepted Armijo rung per lane (K when
    exhausted). The reference returns the histogram of `rung` over the
    active lanes instead, which only its sweep scheduler reads."""
    X, F, G, P = lanes.x, lanes.f, lanes.g, lanes.p
    active = torch.logical_not(torch.logical_or(lanes.converged, lanes.failed))

    # descent safeguard, rowwise
    descent = torch.sum(P * G, dim=-1) < 0
    P = torch.where(descent[:, None], P, -G)

    ls = armijo_backtracking_batch(
        bobj.value_batch, X, P, F, G, c1=opts.ls_c1, max_iters=opts.ls_iters)
    X_new = X + ls.alpha[:, None] * P
    F_new, G_new = bobj.value_and_grad_batch(X_new)

    dX, dG = X_new - X, G_new - G
    curv = torch.sum(dX * dG, dim=-1)
    # curvature guard + frozen-lane freeze: one ok mask decides which lanes'
    # state advances
    ok = active & torch.isfinite(curv) & (curv > _CURV_EPS)
    state, P_next = bstrategy.update_and_direction_batch(
        lanes.direction_state, dX, dG, ok, G_new)

    gn = torch.linalg.vector_norm(G_new, dim=-1)
    now_converged = gn < opts.theta
    now_failed = torch.logical_not(
        torch.isfinite(F_new) & torch.all(torch.isfinite(G_new), dim=-1))

    def keep(new, old):
        mask = active.reshape(active.shape + (1,) * (new.dim() - 1))
        return torch.where(mask, new, old)

    stepped = BatchLanes(
        x=keep(X_new, X),
        f=keep(F_new, F),
        g=keep(G_new, G),
        p=keep(P_next, lanes.p),
        converged=torch.where(active, now_converged, lanes.converged),
        failed=torch.where(active, now_failed, lanes.failed),
        n_evals=lanes.n_evals + torch.where(
            active, ls.n_evals + bobj.vg_cost(X.shape[-1]), 0).to(torch.int32),
        direction_state=state,
    )
    rows = (ls.n_evals + 1) * X.shape[0]
    return stepped, rows, ls.rung


def _stop_counts(chunks) -> Tuple[int, int]:
    """(n_converged, n_active) over all chunks, read back in one transfer."""
    per_chunk = [torch.stack([torch.sum(ls.converged),
                              torch.sum(~(ls.converged | ls.failed))])
                 for ls in chunks]
    n_conv, n_act = torch.stack(per_chunk).sum(dim=0).tolist()
    return n_conv, n_act


def run_multistart(
    f: Callable,
    x0,  # (B, D) starting points (the post-PSO swarm)
    strategy,
    opts: EngineOptions = EngineOptions(),
    *,
    device="cuda",
) -> BFGSResult:
    """Run B independent quasi-Newton solves until required_c converge.

    f:        objective (a named one routes through the fused kernels on
              the batched sweep).
    x0:       (B, D) float32 starts, a tensor or array; moved to `device`.
    strategy: a per-lane DirectionStrategy (core/bfgs.DenseBFGS,
              core/lbfgs.LBFGS) or, for sweep_mode="batched" only, a
              batch-level one (core/bfgs.BatchedDenseBFGS).
    device:   "cuda" (default) or "cpu"; no silent CPU fallback."""
    check_engine_options(opts)
    dev = resolve_device(device)
    if isinstance(x0, torch.Tensor):
        check_dtype(x0.dtype)
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=dev).contiguous()
    B, D = x0.shape
    required_c = opts.required_c if opts.required_c is not None else B

    C = opts.lane_chunk if opts.lane_chunk is not None and 0 < opts.lane_chunk < B else B
    n_chunks = -(-B // C)
    pad = n_chunks * C - B

    if opts.sweep_mode == "batched":
        bobj = as_batched(f, ad_mode=opts.ad_mode)
        bstrategy = as_batched_strategy(strategy)

        def init_chunk(X):
            return batch_lanes_init(bobj, bstrategy, X, opts.theta)

        def step_chunk(lanes):
            lanes, rows, _ = batch_lanes_step(bobj, bstrategy, opts, lanes)
            return lanes, rows

        eval_rows = n_chunks * C  # init: one value+grad row per lane
    else:
        if hasattr(strategy, "update_and_direction_batch"):
            raise ValueError(
                "sweep_mode='per_lane' needs a per-lane DirectionStrategy "
                f"(got the batch-level {type(strategy).__name__})")
        obj = per_lane_objective(f, opts.ad_mode)

        def init_chunk(X):
            return lane_init(obj.value_and_grad_batch, strategy, X, opts.theta,
                             opts.ad_mode)

        def step_chunk(lanes):
            # rows are not instrumented on the per-lane path (as in the
            # reference, eval_rows stays 0)
            return lane_step(obj.value_batch, obj.value_and_grad_batch, strategy,
                             opts, lanes), 0

        eval_rows = 0

    X = torch.cat([x0, x0[:1].expand(pad, D)]) if pad else x0
    chunks = [init_chunk(X[i * C:(i + 1) * C]) for i in range(n_chunks)]
    if pad:
        # padding lanes (the tail of the last chunk) are frozen from birth:
        # never active, never counted
        last = chunks[-1]
        is_pad = torch.arange(C, device=dev) >= C - pad
        chunks[-1] = last._replace(converged=last.converged & ~is_pad,
                                   failed=last.failed | is_pad)

    k = 0
    n_conv, n_act = _stop_counts(chunks)
    while k < opts.iter_max and n_conv < required_c and n_act > 0:
        for i in range(n_chunks):
            chunks[i], rows = step_chunk(chunks[i])
            eval_rows += rows
        k += 1
        n_conv, n_act = _stop_counts(chunks)

    # join the per-lane fields the result reports; the direction state is
    # dropped, never copied into one stack
    def joined(field):
        parts = [getattr(ls, field) for ls in chunks]
        return (torch.cat(parts) if n_chunks > 1 else parts[0])[:B]

    converged, failed = joined("converged"), joined("failed")
    status = torch.where(
        converged,
        CONVERGED,
        torch.where(failed | (k >= opts.iter_max), DIVERGED, STOPPED),
    ).to(torch.int32)
    return BFGSResult(
        x=joined("x"),
        fval=joined("f"),
        grad_norm=torch.linalg.vector_norm(joined("g"), dim=-1),
        status=status,
        iterations=k,
        n_converged=int(torch.sum(converged)),
        n_evals=joined("n_evals"),
        eval_rows=eval_rows,
        map_trips=n_chunks * k,
        n_restarts=torch.zeros((B,), dtype=torch.int32, device=dev),
        n_failed=int(torch.sum(failed)),
    )


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


def get_solver(name: str) -> SolverFactory:
    if name not in _SOLVERS:
        _ensure_builtin_solvers()
    if name not in _SOLVERS:
        raise ValueError(
            f"unknown solver {name!r}; registered: {', '.join(sorted(_SOLVERS))}")
    return _SOLVERS[name]
