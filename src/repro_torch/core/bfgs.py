"""Dense BFGS (paper §III-B, Alg. 4) as a direction strategy for the engine.

Port of src/repro/core/bfgs.py:
- `DenseBFGS`: the per-lane strategy, a dense inverse Hessian H per lane
  (held as a (B, D, D) stack), with the H update in three implementations
  named as in the reference:
    "reference" — the literal triple product of Alg. 4, V H Vᵀ + ρ δx δxᵀ;
    "fast"      — the algebraically equal ρ-form with one matvec, O(D²);
    "pallas"    — `ops.bfgs_update`: the unguarded ρ-form kernel
                  (csrc/bfgs_update.cu, the TPU's bfgs_update_pallas) on the
                  card, its plain version on the CPU.
- `BatchedDenseBFGS`: the batched sweep's strategy, which runs the (B, D, D)
  stack through the kernels — `ops.direction` for the initial p₀ = −H₀g₀
  and `ops.guarded_update_direction` for the per-sweep H' + p' = −H'g'.
  `hessian_impl` is a per-lane knob: the batched sweep always runs the
  guarded kernel, as in the reference.
- `batched_bfgs`, and `serial_bfgs` (Alg. 4 verbatim: one lane through the
  same engine).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core import engine as E
from repro_torch.core.engine import (  # re-exported reference API  # noqa: F401
    CONVERGED,
    DIVERGED,
    STOPPED,
    BFGSResult,
)
from repro_torch.kernels import ops as kernel_ops

HESSIAN_IMPLS = ("reference", "fast", "pallas")


@dataclasses.dataclass(frozen=True)
class BFGSOptions:
    iter_bfgs: int = 100
    theta: float = 1e-5  # gradient-norm convergence threshold Θ
    required_c: Optional[int] = None  # stop once this many lanes converged
    ls_iters: int = 20
    ls_c1: float = 0.3
    linesearch: str = "armijo"  # "armijo" (paper) | "wolfe" (per_lane only)
    ad_mode: str = "forward"  # "forward" (paper) | "reverse" (beyond-paper)
    # per-lane H-update implementation (HESSIAN_IMPLS); the batched sweep
    # always runs the guarded kernel
    hessian_impl: str = "fast"
    lane_chunk: Optional[int] = None  # chunked lane execution (engine)
    # "batched" | "megakernel" | "per_lane"; the JAX package defaults to
    # "per_lane", the port keeps "batched", its kernels' path
    sweep_mode: str = "batched"
    # sweep schedules of the batched modes (core/engine.py "Sweep
    # schedules"): active-lane compaction and cross-chunk repacking cadences
    # (0 = off; repacking needs lane_chunk), the adaptive Armijo ladder
    # length (0 = full ladder), and "static" | "auto" | "replay" with the
    # controller's window, replayed plans and plan lattice knobs
    compact_every: int = 0
    repack_every: int = 0
    ladder_len: int = 0
    schedule: str = "static"
    schedule_every: int = 4
    schedule_plans: Optional[tuple] = None
    auto_ladders: Optional[tuple] = None
    auto_active_frac: float = 0.5
    # the engine's cost model (schedule="auto"), quarantine and retry,
    # checkpointing and fault injection (core/engine.py EngineOptions)
    auto_cost_model: bool = False
    telemetry_costs: Optional[tuple] = None
    telemetry_ema: float = 0.5
    retry_budget: int = 0
    retry_mode: str = "perturb"  # "perturb" | "uniform"
    retry_sigma: float = 0.1
    retry_bounds: Optional[tuple] = None
    checkpoint_every: int = 0
    checkpoint_dir: Optional[str] = None
    checkpoint_keep: int = 3
    fault_plan: Optional[Any] = None  # a launch.faults.FaultPlan


# ---------------------------------------------------------------------------
# Inverse-Hessian update implementations, each H (B, D, D), dX/dG (B, D)
# ---------------------------------------------------------------------------
def _outer(a, b):
    return a[:, :, None] * b[:, None, :]


def hessian_update_reference(H, dX, dG):
    """Literal Alg. 4 line 15: (I − ρ δx δgᵀ) H (I − ρ δg δxᵀ) + ρ δx δxᵀ."""
    rho = (1.0 / torch.sum(dX * dG, dim=-1))[:, None, None]
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    V = eye - rho * _outer(dX, dG)
    return V @ H @ V.transpose(1, 2) + rho * _outer(dX, dX)


def hessian_update_fast(H, dX, dG):
    """Expanded form: H − ρ(u δxᵀ + δx uᵀ) + (ρ²s + ρ) δx δxᵀ, u = Hδg:
    O(D²) with one matvec, against the reference form's two D×D products."""
    rho = 1.0 / torch.sum(dX * dG, dim=-1)
    u = (H @ dG[:, :, None])[:, :, 0]  # H symmetric => also δgᵀH
    s = torch.sum(dG * u, dim=-1)
    r = rho[:, None, None]
    return (H - r * (_outer(u, dX) + _outer(dX, u))
            + (rho * rho * s + rho)[:, None, None] * _outer(dX, dX))


def _get_hessian_update(impl: str) -> Callable:
    if impl == "reference":
        return hessian_update_reference
    if impl == "fast":
        return hessian_update_fast
    if impl == "pallas":
        return kernel_ops.bfgs_update
    raise ValueError(f"unknown hessian impl: {impl}; expected one of {HESSIAN_IMPLS}")


# ---------------------------------------------------------------------------
# The strategies
# ---------------------------------------------------------------------------
class DenseBFGS:
    """Per-lane DirectionStrategy with a dense inverse Hessian (O(D²) state
    per lane)."""

    def __init__(self, hessian_impl: str = "fast"):
        self.hessian_impl = hessian_impl
        self._update = _get_hessian_update(hessian_impl)

    def init_state(self, X0):
        B, D = X0.shape
        return torch.eye(D, dtype=X0.dtype, device=X0.device).expand(B, D, D).contiguous()

    def direction(self, H, G):
        return kernel_ops.direction(H, G)

    def update_state(self, H, dX, dG):
        return self._update(H, dX, dG)

    def as_batched(self):
        # the batched sweep has ONE update implementation, the fused guarded
        # kernel, so hessian_impl deliberately does not carry over
        return BatchedDenseBFGS()


class BatchedDenseBFGS:
    """Batch-level dense BFGS for the engine's batched sweep.

    The curvature guard arrives as the engine's ok mask and becomes ρ = 0
    with zeroed pairs: every update term vanishes, so a guarded or frozen
    lane keeps H' = H exactly. `direction_op` and `update_op` are the kernel
    ops; a subclass may swap in other implementations of the same
    functions (chip_smoke.py holds the kernels against the plain versions
    this way).

    The state is the dense (B, D, D) H stack and the update the guarded
    ρ-form, which is what the sweep megakernel computes in its own launch:
    `megakernel_dense_h` lets sweep_mode="megakernel" take this strategy's
    update into that launch (engine.megakernel_unsupported_reason)."""

    megakernel_dense_h = True
    direction_op = staticmethod(kernel_ops.direction)
    update_op = staticmethod(kernel_ops.guarded_update_direction)

    def init_state_batch(self, X0: torch.Tensor) -> torch.Tensor:
        B, D = X0.shape
        eye = torch.eye(D, dtype=X0.dtype, device=X0.device)
        return eye.expand(B, D, D).contiguous()

    def direction_batch(self, H, G):
        return self.direction_op(H, G)

    def update_and_direction_batch(self, H, dX, dG, ok, G_new):
        curv = torch.sum(dX * dG, dim=-1)
        rho = torch.where(ok, 1.0 / torch.where(ok, curv, 1.0), 0.0)
        dXs = torch.where(ok[:, None], dX, 0.0)
        dGs = torch.where(ok[:, None], dG, 0.0)
        return self.update_op(H, dXs, dGs, G_new, rho)


def _engine_opts(opts, lane_chunk: Optional[int] = None,
                 iter_max: Optional[int] = None) -> E.EngineOptions:
    """EngineOptions from a solver's options (BFGSOptions or LBFGSOptions,
    which share every engine field but the sweep budget's name)."""
    return E.EngineOptions(
        iter_max=opts.iter_bfgs if iter_max is None else iter_max,
        theta=opts.theta,
        required_c=opts.required_c,
        ls_iters=opts.ls_iters,
        ls_c1=opts.ls_c1,
        linesearch=opts.linesearch,
        ad_mode=opts.ad_mode,
        lane_chunk=lane_chunk if lane_chunk is not None else opts.lane_chunk,
        sweep_mode=opts.sweep_mode,
        compact_every=opts.compact_every,
        repack_every=opts.repack_every,
        ladder_len=opts.ladder_len,
        schedule=opts.schedule,
        schedule_every=opts.schedule_every,
        schedule_plans=opts.schedule_plans,
        auto_ladders=opts.auto_ladders,
        auto_active_frac=opts.auto_active_frac,
        auto_cost_model=opts.auto_cost_model,
        telemetry_costs=opts.telemetry_costs,
        telemetry_ema=opts.telemetry_ema,
        retry_budget=opts.retry_budget,
        retry_mode=opts.retry_mode,
        retry_sigma=opts.retry_sigma,
        retry_bounds=opts.retry_bounds,
        checkpoint_every=opts.checkpoint_every,
        checkpoint_dir=opts.checkpoint_dir,
        checkpoint_keep=opts.checkpoint_keep,
        fault_plan=opts.fault_plan,
    )


@E.register_solver("bfgs")
def make_bfgs_solver(opts: Optional[BFGSOptions] = None,
                     lane_chunk: Optional[int] = None):
    opts = opts if opts is not None else BFGSOptions()
    return DenseBFGS(opts.hessian_impl), _engine_opts(opts, lane_chunk)


# ---------------------------------------------------------------------------
# Lane API of the reference (its benchmarks lower a single sweep through it)
# ---------------------------------------------------------------------------
class LaneState(NamedTuple):
    x: torch.Tensor  # (B, D)
    f: torch.Tensor  # (B,)
    g: torch.Tensor  # (B, D)
    H: torch.Tensor  # (B, D, D)
    converged: torch.Tensor  # (B,) bool
    failed: torch.Tensor  # (B,) bool (NaN/Inf escape)
    n_evals: torch.Tensor  # (B,) int32 objective-eval counter


def _to_engine_lane(s: LaneState) -> E.Lane:
    return E.Lane(x=s.x, f=s.f, g=s.g, converged=s.converged, failed=s.failed,
                  n_evals=s.n_evals, direction_state=s.H)


def _from_engine_lane(lane: E.Lane) -> LaneState:
    return LaneState(x=lane.x, f=lane.f, g=lane.g, H=lane.direction_state,
                     converged=lane.converged, failed=lane.failed,
                     n_evals=lane.n_evals)


def _lane_step(f, opts: BFGSOptions, state: LaneState) -> LaneState:
    """One quasi-Newton step of every lane (Alg. 4 lines 10-16)."""
    obj = E.per_lane_objective(f, opts.ad_mode)
    lane = E.lane_step(obj.value_batch, obj.value_and_grad_batch,
                       DenseBFGS(opts.hessian_impl), _engine_opts(opts),
                       _to_engine_lane(state))
    return _from_engine_lane(lane)


# ---------------------------------------------------------------------------
# Batched multistart BFGS (Alg. 10) and serial BFGS (Alg. 4)
# ---------------------------------------------------------------------------
def batched_bfgs(f: Callable, x0, opts: BFGSOptions = BFGSOptions(), *,
                 device="cuda", retry_draws=None,
                 resume_from: Optional[str] = None) -> BFGSResult:
    """Run B independent BFGS solves until required_c of them converge
    (retry_draws and resume_from as in engine.run_multistart)."""
    strategy, eopts = make_bfgs_solver(opts)
    return E.run_multistart(f, x0, strategy, eopts, device=device,
                            retry_draws=retry_draws, resume_from=resume_from)


class SerialResult(NamedTuple):
    x: torch.Tensor  # (D,)
    fval: torch.Tensor  # ()
    grad_norm: torch.Tensor  # ()
    status: int
    iterations: int


def serial_bfgs(f: Callable, x0, opts: BFGSOptions = BFGSOptions(), *,
                device="cuda") -> SerialResult:
    """One lane through the engine (the sequential ZEUS baseline, Fig. 2):
    required_c=1 makes the stop protocol "loop while this lane is active".
    A tensor x0 keeps its dtype, float32 or float64; anything else becomes
    float32."""
    eopts = dataclasses.replace(_engine_opts(opts), required_c=1, lane_chunk=None)
    x0 = torch.as_tensor(x0, dtype=x0.dtype if isinstance(x0, torch.Tensor)
                         else torch.float32)
    res = E.run_multistart(f, x0[None, :], DenseBFGS(opts.hessian_impl), eopts,
                           device=device)
    # a single lane either converges or diverges: no one else to stop it
    status = CONVERGED if int(res.status[0]) == CONVERGED else DIVERGED
    return SerialResult(x=res.x[0], fval=res.fval[0], grad_norm=res.grad_norm[0],
                        status=status, iterations=res.iterations)
