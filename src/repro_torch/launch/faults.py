"""Fault tolerance for solves: fault plans, preemption, lane re-seeding.

Port of src/repro/launch/faults.py. Everything here is wired into the
engine's sweep loop (core/engine.py, run_multistart):

  * **Preemption / crash mid-solve** — `EngineOptions(checkpoint_every=n,
    checkpoint_dir=...)` snapshots the solve's carry through
    checkpoint/manager.py every n sweeps; `run_multistart(resume_from=...)`
    and `zeus(resume=...)` restore the newest committed snapshot, and the
    resumed solve is array-equal to the uninterrupted one. `Preempted` is
    what the loop raises when a `FaultPlan` asks it to die at a sweep
    boundary.
  * **Numeric blow-ups (NaN/Inf escapes)** — `EngineOptions(retry_budget=k)`
    quarantines a failed lane and re-seeds it (a perturbed restart from its
    last finite iterate, or a fresh uniform draw by `reseed_lost_lanes`) up
    to k times, counted in `BFGSResult.n_restarts`.
  * **Deterministic fault injection** — `FaultPlan` is a seeded, hashable
    schedule of {NaN into a lane's gradient, kill a lane, preempt at a
    sweep}, keyed on the sweep counter k, so the same plan gives the same
    faults at the same sweeps, across resume too.
  * **Stragglers** — `StepGuard` wraps host-level steps with a deadline:
    warn (default), skip the next step (`on_breach="skip"`, one skip per
    breach), or abort (`on_breach="abort"`).

Randomness comes from the port's `draws` hook (core/pso.py) in place of a
JAX key; masks are bool tensors on the caller's device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class StepGuard:
    deadline_s: float = 0.0  # 0 = disabled
    on_breach: str = "warn"  # warn | skip | abort
    breaches: int = 0  # cumulative breach count (never reset)
    last_duration: float = 0.0
    # one-shot flag: armed by a breach, consumed by should_skip_next(), so a
    # single slow step skips at most ONE later step
    pending_skip: bool = False

    @contextlib.contextmanager
    def step(self, step_idx: int):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.last_duration = time.perf_counter() - t0
            if self.deadline_s and self.last_duration > self.deadline_s:
                self.breaches += 1
                self.pending_skip = True
                msg = (f"[faults] step {step_idx} took "
                       f"{self.last_duration:.2f}s > deadline "
                       f"{self.deadline_s:.2f}s (breach #{self.breaches})")
                if self.on_breach == "abort":
                    raise TimeoutError(msg)
                print(msg, flush=True)

    def should_skip_next(self) -> bool:
        """Consume the pending skip: True at most once per breach."""
        if self.on_breach == "skip" and self.pending_skip:
            self.pending_skip = False
            return True
        return False


class Preempted(RuntimeError):
    """A FaultPlan preempted the solve at a sweep boundary.

    The newest committed checkpoint (if checkpointing was on) survives;
    resume with run_multistart(resume_from=...) / zeus(resume=...)."""

    def __init__(self, sweep: int, checkpoint_dir: Optional[str] = None):
        self.sweep = int(sweep)
        self.checkpoint_dir = checkpoint_dir
        where = (f"; resume from checkpoints under {checkpoint_dir!r}"
                 if checkpoint_dir else " (no checkpointing configured)")
        super().__init__(f"solve preempted at sweep boundary {sweep}{where}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Deterministic schedule of injected faults, keyed on the sweep counter.

    Hashable (tuples of ints only), so it can live inside the frozen
    EngineOptions. Events fire when the engine's sweep counter k equals the
    event's sweep, so a plan replays identically across runs and across
    checkpoint resume (k is in the snapshot).

      nan_grads:  ((sweep, lane), ...) — overwrite the lane's gradient with
                  NaN after sweep `sweep` runs, marking it failed.
      kill_lanes: ((sweep, lane), ...) — freeze the lane as failed, its
                  state intact.
      preempt_at_sweep: raise Preempted when the loop reaches this sweep
                  boundary, saving nothing past the last snapshot.

    Lane indices address the engine's flattened lane axis (0..B-1; padding
    lanes of a chunked solve are never hit).
    """

    nan_grads: Tuple[Tuple[int, int], ...] = ()
    kill_lanes: Tuple[Tuple[int, int], ...] = ()
    preempt_at_sweep: Optional[int] = None

    def __post_init__(self):
        for field in ("nan_grads", "kill_lanes"):
            events = tuple(
                (int(s), int(l)) for s, l in getattr(self, field))
            for s, l in events:
                if s < 0 or l < 0:
                    raise ValueError(
                        f"{field} entries must be (sweep >= 0, lane >= 0) "
                        f"pairs (got ({s}, {l}))")
            object.__setattr__(self, field, events)
        if self.preempt_at_sweep is not None:
            if int(self.preempt_at_sweep) < 0:
                raise ValueError(
                    f"preempt_at_sweep must be >= 0 "
                    f"(got {self.preempt_at_sweep})")
            object.__setattr__(
                self, "preempt_at_sweep", int(self.preempt_at_sweep))

    @property
    def has_injections(self) -> bool:
        return bool(self.nan_grads or self.kill_lanes)

    @staticmethod
    def random(seed: int, n_sweeps: int, n_lanes: int, n_nan: int = 0,
               n_kill: int = 0,
               preempt_at_sweep: Optional[int] = None) -> "FaultPlan":
        """Seeded plan generator: same (seed, shape) args => same plan (the
        reference's numpy draws, in its order)."""
        rng = np.random.default_rng(seed)

        def draw(n):
            return tuple(
                (int(rng.integers(0, max(1, n_sweeps))),
                 int(rng.integers(0, max(1, n_lanes))))
                for _ in range(n))

        return FaultPlan(nan_grads=draw(n_nan), kill_lanes=draw(n_kill),
                         preempt_at_sweep=preempt_at_sweep)


def injection_lanes(plan: FaultPlan, k: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The lanes the plan's NaN and kill events hit at sweep k, as host
    tuples (empty when nothing fires: the engine then does no device
    work)."""
    return (tuple(l for s, l in plan.nan_grads if s == k),
            tuple(l for s, l in plan.kill_lanes if s == k))


def injection_masks(plan: FaultPlan, k: int, n_lanes: int, device="cpu"):
    """(nan_mask, kill_mask): (n_lanes,) bool tensors of the plan's events
    firing at sweep k. An event on a lane >= n_lanes addresses nothing, as
    an out-of-range scatter does in the reference."""

    def mask(lanes):
        m = np.zeros((n_lanes,), bool)
        m[[l for l in lanes if l < n_lanes]] = True
        return torch.from_numpy(m).to(device)

    nan_l, kill_l = injection_lanes(plan, int(k))
    return mask(nan_l), mask(kill_l)


def seed_lanes(swarm_x: torch.Tensor, mask: torch.Tensor,
               fresh: torch.Tensor) -> torch.Tensor:
    """Merge `fresh` start points into the mask'd rows of `swarm_x`: the one
    primitive under every way a lane slot gets a new life."""
    return torch.where(mask[:, None], fresh, swarm_x)


def reseed_lost_lanes(draws, swarm_x: torch.Tensor, lost_mask: torch.Tensor,
                      lower: float, upper: float) -> torch.Tensor:
    """Replace lost or quarantined lanes with fresh uniform draws in
    [lower, upper). The draw covers the whole (B, D) whatever the mask
    says, as the reference's does, so the stream does not depend on which
    lanes heal. `draws` is the port's draws hook (core/pso.py)."""
    fresh = draws(tuple(swarm_x.shape), lower, upper).to(swarm_x.device,
                                                          swarm_x.dtype)
    return seed_lanes(swarm_x, lost_mask, fresh)
