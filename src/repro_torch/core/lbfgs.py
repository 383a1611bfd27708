"""L-BFGS (the paper's §VII-B future work; beyond-paper).

Port of src/repro/core/lbfgs.py. Limited-memory BFGS keeps only the last
`m` secant pairs (δx, δg) in circular buffers: O(mD) state and work per
lane instead of the dense O(D²) inverse Hessian. The `LBFGS` strategy runs
in both sweep modes: per lane, and in the batched sweep through the
engine's VmappedStrategy.

Guarded lanes do not advance, so every lane has its own `head` and
`n_pairs`: the two-loop recursion gathers each lane's slot from its own
buffers. `rho_buf == 0` marks an empty slot.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core import engine as E
from repro_torch.core.bfgs import _engine_opts
from repro_torch.core.engine import (  # noqa: F401 — reference API re-export
    CONVERGED,
    DIVERGED,
    STOPPED,
    BFGSResult,
)


@dataclasses.dataclass(frozen=True)
class LBFGSOptions:
    iter_max: int = 100
    memory: int = 10
    theta: float = 1e-5
    required_c: Optional[int] = None
    ls_iters: int = 20
    ls_c1: float = 1e-4
    linesearch: str = "armijo"  # "armijo" | "wolfe" (per_lane only)
    ad_mode: str = "reverse"  # reverse is the right default at high D
    lane_chunk: Optional[int] = None  # chunked lane execution (engine)
    # "batched" | "megakernel" | "per_lane"; the JAX package defaults to
    # "per_lane", the port keeps "batched" as for BFGSOptions
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


class LBFGSMemory(NamedTuple):
    """Direction state of a lane stack: circular secant-pair buffers."""

    s_buf: torch.Tensor  # (B, m, D) δx history
    y_buf: torch.Tensor  # (B, m, D) δg history
    rho_buf: torch.Tensor  # (B, m) 1/(sᵀy); 0 marks an empty slot
    head: torch.Tensor  # (B,) int32, next write slot
    n_pairs: torch.Tensor  # (B,) int32, valid pairs stored


def two_loop_direction(mem: LBFGSMemory, G: torch.Tensor) -> torch.Tensor:
    """Standard two-loop recursion over each lane's circular buffers,
    G (B, D) -> P (B, D)."""
    B, m, _ = mem.s_buf.shape
    lanes = torch.arange(B, device=G.device)

    def slot(i):
        """Each lane's buffers at its i-th newest pair, and whether it is
        valid."""
        idx = (mem.head - 1 - i) % m
        return (mem.s_buf[lanes, idx], mem.y_buf[lanes, idx],
                mem.rho_buf[lanes, idx], i < mem.n_pairs)

    q = G
    alphas = []
    for i in range(m):  # newest to oldest
        s, y, rho, valid = slot(i)
        alpha = torch.where(valid, rho * torch.sum(s * q, dim=-1), 0.0)
        q = q - alpha[:, None] * y
        alphas.append(alpha)

    # initial Hessian scaling γ = sᵀy / yᵀy of the newest pair
    s, y, _, _ = slot(0)
    gamma = torch.where(
        mem.n_pairs > 0,
        torch.sum(s * y, dim=-1) / torch.clamp(torch.sum(y * y, dim=-1), min=1e-30),
        1.0)
    r = gamma[:, None] * q

    for j in range(m - 1, -1, -1):  # oldest valid first
        s, y, rho, valid = slot(j)
        beta = torch.where(valid, rho * torch.sum(y * r, dim=-1), 0.0)
        r = r + (alphas[j] - beta)[:, None] * s
    return -r


class LBFGS:
    """Per-lane DirectionStrategy with O(mD) circular-buffer state."""

    def __init__(self, memory: int = 10):
        self.memory = memory

    def init_state(self, X0):
        (B, D), m = X0.shape, self.memory
        count = torch.zeros((B,), dtype=torch.int32, device=X0.device)
        return LBFGSMemory(
            s_buf=X0.new_zeros((B, m, D)), y_buf=X0.new_zeros((B, m, D)),
            rho_buf=X0.new_zeros((B, m)), head=count, n_pairs=count)

    def direction(self, mem: LBFGSMemory, G):
        return two_loop_direction(mem, G)

    def update_state(self, mem: LBFGSMemory, dX, dG):
        # the engine's curvature guard (or its stand-in pair) keeps δxᵀδg > 0
        m = mem.s_buf.shape[1]
        at = torch.arange(m, device=dX.device)[None, :] == (mem.head % m)[:, None]
        return LBFGSMemory(
            s_buf=torch.where(at[:, :, None], dX[:, None, :], mem.s_buf),
            y_buf=torch.where(at[:, :, None], dG[:, None, :], mem.y_buf),
            rho_buf=torch.where(at, (1.0 / torch.sum(dX * dG, dim=-1))[:, None],
                                mem.rho_buf),
            head=(mem.head + 1) % m,
            n_pairs=torch.clamp(mem.n_pairs + 1, max=m),
        )


@E.register_solver("lbfgs")
def make_lbfgs_solver(opts: Optional[LBFGSOptions] = None,
                      lane_chunk: Optional[int] = None):
    opts = opts if opts is not None else LBFGSOptions()
    return LBFGS(opts.memory), _engine_opts(opts, lane_chunk, iter_max=opts.iter_max)


def batched_lbfgs(f: Callable, x0, opts: LBFGSOptions = LBFGSOptions(), *,
                  device="cuda", retry_draws=None,
                  resume_from: Optional[str] = None) -> BFGSResult:
    """B independent L-BFGS solves through the engine (retry_draws and
    resume_from as in engine.run_multistart)."""
    strategy, eopts = make_lbfgs_solver(opts)
    return E.run_multistart(f, x0, strategy, eopts, device=device,
                            retry_draws=retry_draws, resume_from=resume_from)
