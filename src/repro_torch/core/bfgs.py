"""Dense BFGS (paper §III-B, Alg. 4) as a batched direction strategy.

Port of src/repro/core/bfgs.py for the batched sweep: `BatchedDenseBFGS`
keeps the dense (B, D, D) inverse-Hessian stack and runs it through the
kernels — `ops.direction` for the initial p₀ = −H₀g₀ and
`ops.guarded_update_direction` for the per-sweep H' + p' = −H'g' pass.
The per-lane `DenseBFGS`, its `hessian_impl` variants, `batched_bfgs` and
`serial_bfgs` belong to the per-lane path and are not ported yet (A7).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import engine as E
from repro_torch.core.engine import (  # re-exported reference API  # noqa: F401
    CONVERGED,
    DIVERGED,
    STOPPED,
    BFGSResult,
)
from repro_torch.kernels import ops as kernel_ops


@dataclasses.dataclass(frozen=True)
class BFGSOptions:
    iter_bfgs: int = 100
    theta: float = 1e-5  # gradient-norm convergence threshold Θ
    required_c: Optional[int] = None  # stop once this many lanes converged
    ls_iters: int = 20
    ls_c1: float = 0.3
    linesearch: str = "armijo"  # "wolfe" not ported yet (A7)
    ad_mode: str = "forward"  # "forward" (paper) | "reverse" (beyond-paper)
    lane_chunk: Optional[int] = None  # chunked lane execution (engine)
    # "batched" in this port; the JAX package defaults to "per_lane"
    sweep_mode: str = "batched"
    # not ported yet; any other than the default raises in the engine
    compact_every: int = 0  # A8
    repack_every: int = 0  # A8
    ladder_len: int = 0  # A8
    schedule: str = "static"  # A8
    auto_cost_model: bool = False  # A12
    retry_budget: int = 0  # A11
    checkpoint_every: int = 0  # A11
    checkpoint_dir: Optional[str] = None  # A11
    fault_plan: Optional[Any] = None  # A11


class BatchedDenseBFGS:
    """Batch-level dense BFGS for the engine's batched sweep.

    The curvature guard arrives as the engine's ok mask and becomes ρ = 0
    with zeroed pairs: every update term vanishes, so a guarded or frozen
    lane keeps H' = H exactly. `direction_op` and `update_op` are the kernel
    ops; a subclass may swap in other implementations of the same
    functions (chip_smoke.py holds the kernels against the plain versions
    this way)."""

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


def _engine_opts(opts: BFGSOptions, lane_chunk: Optional[int] = None
                 ) -> E.EngineOptions:
    return E.EngineOptions(
        iter_max=opts.iter_bfgs,
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
        auto_cost_model=opts.auto_cost_model,
        retry_budget=opts.retry_budget,
        checkpoint_every=opts.checkpoint_every,
        checkpoint_dir=opts.checkpoint_dir,
        fault_plan=opts.fault_plan,
    )


@E.register_solver("bfgs")
def make_bfgs_solver(opts: Optional[BFGSOptions] = None,
                     lane_chunk: Optional[int] = None):
    opts = opts if opts is not None else BFGSOptions()
    return BatchedDenseBFGS(), _engine_opts(opts, lane_chunk)
