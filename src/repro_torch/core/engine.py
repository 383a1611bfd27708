"""Multistart quasi-Newton engine, batched sweep (paper Alg. 10).

Port of the batched-sweep subset of src/repro/core/engine.py. Phase 2 is B
independent quasi-Newton solves sharing one stop protocol: sweep while
k < iter_max AND n_converged < required_c AND any lane active. Converged
and failed lanes are frozen by masking.

Each sweep works on whole (B, D) / (B, D, D) stacks (`batch_lanes_step`):
  1. the descent safeguard (p ← −g where pᵀg ≥ 0);
  2. one speculative K-rung Armijo ladder as a single (K·B, D) value call;
  3. one batched value+grad at the accepted points;
  4. the curvature guard (δxᵀδg finite and > 1e-10, lane active);
  5. one fused guarded state update that also yields the next direction.

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
sweep_mode "per_lane" and "megakernel" (A7/A9); compact_every,
repack_every, ladder_len > 0 and schedule != "static" (A8); linesearch
"wolfe" (A7); retry_budget, checkpoint_every/checkpoint_dir and fault_plan
(A11); auto_cost_model (A12).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Protocol, Tuple

import torch

from repro_torch._device import check_dtype, resolve_device
from repro_torch.core.linesearch import armijo_backtracking_batch
from repro_torch.core.objectives import as_batched

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
    linesearch: str = "armijo"  # "wolfe" is not ported yet (A7)
    ad_mode: str = "forward"  # "forward" (paper) | "reverse" (beyond-paper)
    lane_chunk: Optional[int] = None  # None = one monolithic batch
    # "batched" only in this port ("per_lane" A7, "megakernel" A9). The JAX
    # package defaults to "per_lane".
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


def check_engine_options(opts: EngineOptions) -> None:
    """Raise on options this port does not run yet, naming their ROADMAP
    item, and on values the reference rejects too."""
    if opts.sweep_mode in ("per_lane", "megakernel"):
        item = "A7" if opts.sweep_mode == "per_lane" else "A9"
        raise NotImplementedError(
            f"sweep_mode={opts.sweep_mode!r} is not ported yet (ROADMAP "
            f"{item}); the port runs sweep_mode='batched'")
    if opts.sweep_mode != "batched":
        raise ValueError(f"unknown sweep_mode {opts.sweep_mode!r}")
    if opts.linesearch == "wolfe":
        raise NotImplementedError(
            "linesearch='wolfe' is not ported yet (ROADMAP A7)")
    if opts.linesearch != "armijo":
        raise ValueError(f"unknown linesearch {opts.linesearch!r}")
    for field in ("compact_every", "repack_every", "ladder_len"):
        value = getattr(opts, field)
        if value < 0:
            raise ValueError(f"{field} must be >= 0 (got {value})")
        if value > 0:
            raise NotImplementedError(
                f"{field}={value} is not ported yet (ROADMAP A8)")
    if opts.schedule != "static":
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


class BatchedDirectionStrategy(Protocol):
    """How a solver produces search directions for a whole lane stack. The
    state is one tensor with a leading lane axis B (lane_chunk splits it
    along that axis)."""

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
    direction_state: Any  # (B, D, D) inverse-Hessian stack for dense BFGS


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
    strategy: BatchedDirectionStrategy,
    opts: EngineOptions = EngineOptions(),
    *,
    device="cuda",
) -> BFGSResult:
    """Run B independent quasi-Newton solves until required_c converge.

    f:        objective (a named one routes through the fused kernels).
    x0:       (B, D) float32 starts, a tensor or array; moved to `device`.
    strategy: a batched direction strategy (core/bfgs.BatchedDenseBFGS).
    device:   "cuda" (default) or "cpu"; no silent CPU fallback."""
    check_engine_options(opts)
    dev = resolve_device(device)
    if isinstance(x0, torch.Tensor):
        check_dtype(x0.dtype)
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=dev).contiguous()
    B, D = x0.shape
    required_c = opts.required_c if opts.required_c is not None else B

    bobj = as_batched(f, ad_mode=opts.ad_mode)

    C = opts.lane_chunk if opts.lane_chunk is not None and 0 < opts.lane_chunk < B else B
    n_chunks = -(-B // C)
    pad = n_chunks * C - B
    X = torch.cat([x0, x0[:1].expand(pad, D)]) if pad else x0
    chunks = [batch_lanes_init(bobj, strategy, X[i * C:(i + 1) * C], opts.theta)
              for i in range(n_chunks)]
    if pad:
        # padding lanes (the tail of the last chunk) are frozen from birth:
        # never active, never counted
        last = chunks[-1]
        is_pad = torch.arange(C, device=dev) >= C - pad
        chunks[-1] = last._replace(converged=last.converged & ~is_pad,
                                   failed=last.failed | is_pad)
    eval_rows = n_chunks * C  # init: one value+grad row per lane

    k = 0
    n_conv, n_act = _stop_counts(chunks)
    while k < opts.iter_max and n_conv < required_c and n_act > 0:
        for i in range(n_chunks):
            chunks[i], rows, _ = batch_lanes_step(bobj, strategy, opts, chunks[i])
            eval_rows += rows
        k += 1
        n_conv, n_act = _stop_counts(chunks)

    # join the per-lane fields the result reports; the (B, D, D) direction
    # state is dropped, never copied into one stack
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
SolverFactory = Callable[..., Tuple[BatchedDirectionStrategy, EngineOptions]]

_SOLVERS: Dict[str, SolverFactory] = {}


def register_solver(name: str):
    """Decorator: `@register_solver("bfgs")` on a factory
    `(solver_opts=None, lane_chunk=None) -> (strategy, EngineOptions)`."""

    def deco(factory: SolverFactory) -> SolverFactory:
        _SOLVERS[name] = factory
        return factory

    return deco


def _ensure_builtin_solvers():
    # importing the strategy module registers its factory
    from repro_torch.core import bfgs  # noqa: F401


def get_solver(name: str) -> SolverFactory:
    if name == "lbfgs":
        raise NotImplementedError("solver='lbfgs' is not ported yet (ROADMAP A7)")
    if name not in _SOLVERS:
        _ensure_builtin_solvers()
    if name not in _SOLVERS:
        raise ValueError(
            f"unknown solver {name!r}; registered: {', '.join(sorted(_SOLVERS))}")
    return _SOLVERS[name]
