"""Multi-tenant solve service: continuous lane batching for multistart
optimization.

Port of src/repro/serve/service.py. The engine's phase 2 is a batch of
independent quasi-Newton lanes sharing one device, the shape of a request
stream. This module keeps one always-running `HostedSolve` pool per named
problem and admits queued requests into freed lane slots at segment
boundaries, mid-flight:

- a `ProblemRegistry` of named problems (objective, dimension, solver
  options; a name resolves through core/objectives.py, so a named
  objective keeps its fused kernels);
- a `SolveService` that submits, admits, sweeps and harvests.

Event model (one sweep = one step of every running lane):

    submit --> [queue] --admit--> running --retire--> done
       |
       +-> reject (QueueFull) when the wait queue is at max_queue

Admission and retirement both happen at segment boundaries (every
`admit_every` sweeps): retired lanes (converged, failed or past their
request's deadline) are harvested into per-request results and freed;
waiting lanes are seeded into the freed slots through `HostedSolve.admit`,
which shares the quarantine heal's write path (the admitted rows alone are
initialised and written back) and forces the same gather-plan refresh.

Why per-request parity holds: a lane's sweep reads only its own row (every
kernel and row reduction on the path is row-count-stable), a gather-plan
change computes the same bits per lane, and an admission writes only the
admitted rows. So a request's trajectory in a busy pool equals its
trajectory alone in a fresh batch of the same width (`solo_reference`),
and the deadline freeze gives the same iterates, n_evals and DIVERGED
status as a solo run's own iter_max stop. Under schedule="auto" the
controller picks its plan from pool-wide accepted-rung statistics, so a
busy pool may run other ladders than the solo run: n_evals then depends on
the traffic, and the exact statement is determinism (the same arrivals
give the same lanes, bit for bit).

A seeded request's starts are the port's own draws (a CPU torch.Generator
seeded with the request's seed), not the reference's.
"""
from __future__ import annotations

import dataclasses
import heapq
import json
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import refuse_float64, resolve_device
from repro_torch.core.bfgs import BFGSResult
from repro_torch.core.engine import (
    CONVERGED,
    DIVERGED,
    HostedSolve,
    open_multistart,
    run_multistart,
)
from repro_torch.core.objectives import Objective, get_objective
from repro_torch.core.pso import TorchDraws
from repro_torch.core.zeus import ZeusOptions, phase2_setup
from repro_torch.launch.faults import seed_lanes
from repro_torch.launch.telemetry import WindowTelemetry


class QueueFull(RuntimeError):
    """Backpressure: the problem's wait queue is at max_queue; the caller
    should retry later (or against another replica)."""


class PoolHorizonExhausted(RuntimeError):
    """The pool's sweep counter cannot fit another request's budget before
    opts.iter_max (the pool horizon); open a fresh service."""


# ---------------------------------------------------------------------------
# Problem registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Problem:
    """A named solve target: objective + dimension + solver config.

    `opts` is the ZeusOptions a solo `zeus()` call would take; the service
    resolves it through `phase2_setup`, so a problem's pool runs the solver
    configuration its solo solves do. `horizon` is the pool's total sweep
    budget (engine iter_max), the service's lifetime; requests carry their
    own iteration budgets."""

    name: str
    objective: Objective
    dim: int
    opts: ZeusOptions = ZeusOptions()
    horizon: int = 100_000

    @property
    def default_iter_max(self) -> int:
        return self.opts.bfgs.iter_bfgs


class ProblemRegistry:
    """Named problems the service accepts requests against."""

    def __init__(self):
        self._problems: Dict[str, Problem] = {}

    def register(self, name: str, objective, dim: int,
                 opts: Optional[ZeusOptions] = None,
                 horizon: int = 100_000) -> Problem:
        """`objective` is a registry name (resolved through
        core.objectives.get_objective, which keeps the fused kernels) or an
        Objective instance."""
        if name in self._problems:
            raise ValueError(f"problem {name!r} already registered")
        if opts is not None:
            refuse_float64(opts.dtype, entry="the solve service")
        obj = get_objective(objective) if isinstance(objective, str) else objective
        if dim <= 0:
            raise ValueError(f"dim must be >= 1 (got {dim})")
        if obj.minimizer is not None:
            star = np.asarray(obj.minimizer(dim))
            if star.shape != (dim,):
                raise ValueError(
                    f"objective {obj.name!r} is fixed-dimensional "
                    f"(minimizer is {star.shape[0]}D); got dim={dim}")
        p = Problem(name=name, objective=obj, dim=dim,
                    opts=opts if opts is not None else ZeusOptions(),
                    horizon=horizon)
        self._problems[name] = p
        return p

    def get(self, name: str) -> Problem:
        if name not in self._problems:
            raise KeyError(
                f"unknown problem {name!r}; registered: "
                f"{', '.join(sorted(self._problems)) or '(none)'}")
        return self._problems[name]

    def names(self) -> Tuple[str, ...]:
        return tuple(sorted(self._problems))

    def __contains__(self, name) -> bool:
        return name in self._problems

    def __len__(self) -> int:
        return len(self._problems)


# ---------------------------------------------------------------------------
# Requests / results
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SolveRequest:
    """One solve against a registered problem.

    `seed` draws `n_starts` uniform start points inside the problem's box
    (or pass explicit `x0` rows); `iter_max` is the per-lane sweep budget
    (None = the problem's solver default). Every start runs as its own
    lane; the result aggregates the best."""

    problem: str
    seed: int = 0
    n_starts: int = 1
    iter_max: Optional[int] = None
    x0: Optional[Any] = None  # (n_starts, dim) explicit start points


def request_starts(problem: Problem, req: SolveRequest) -> np.ndarray:
    """The request's (n_starts, dim) float32 start matrix, the same function
    for service admission and the solo reference. Explicit `x0` as given;
    else uniform draws in the objective's box from a CPU torch.Generator
    seeded with req.seed (the port's own draws, not the reference's)."""
    if req.x0 is not None:
        X = np.asarray(req.x0, np.float32)
        if X.shape != (req.n_starts, problem.dim):
            raise ValueError(
                f"x0 shape {X.shape} != (n_starts, dim) = "
                f"({req.n_starts}, {problem.dim})")
        return X
    obj = problem.objective
    gen = torch.Generator().manual_seed(req.seed)
    u = torch.rand((req.n_starts, problem.dim), generator=gen, dtype=torch.float32)
    return (obj.lower + (obj.upper - obj.lower) * u).numpy()


@dataclasses.dataclass
class LaneOutcome:
    """One start (= one lane life) of a request, as harvested."""

    x: np.ndarray
    fval: float
    grad_norm: float
    status: int  # core CONVERGED / DIVERGED
    n_evals: int
    slot: int  # flat lane slot the life ran in (diagnostic)
    admit_sweep: int  # pool sweep counter at admission
    retire_sweep: int  # pool sweep counter at harvest
    t_submit: float
    t_admit: float
    t_retire: float


@dataclasses.dataclass
class SolveResult:
    """A drained request: best lane + all lane outcomes + latency."""

    rid: int
    problem: str
    best_x: np.ndarray
    best_f: float
    status: int  # CONVERGED if any lane converged, else DIVERGED
    n_converged: int
    lanes: List[LaneOutcome]

    @property
    def admit_latency_s(self) -> float:
        return min(l.t_admit for l in self.lanes) - self.lanes[0].t_submit

    @property
    def total_latency_s(self) -> float:
        return max(l.t_retire for l in self.lanes) - self.lanes[0].t_submit


@dataclasses.dataclass
class _Ticket:
    request: SolveRequest
    state: str  # "queued" | "running" | "done"
    budget: int
    starts: np.ndarray  # (n_starts, dim)
    t_submit: float
    submit_sweep: int
    pending: int  # lanes not yet retired
    lanes: Dict[int, LaneOutcome] = dataclasses.field(default_factory=dict)
    result: Optional[SolveResult] = None


# ---------------------------------------------------------------------------
# The service
# ---------------------------------------------------------------------------


class _Pool:
    """One problem's always-running lane pool: a HostedSolve + host-side
    slot bookkeeping. Slots are flat lane indices < slots (chunk padding
    lanes are never admittable)."""

    def __init__(self, problem: Problem, slots: int, retry_seed: int, device):
        strategy, eopts = phase2_setup(problem.opts)
        if eopts.schedule == "replay":
            raise ValueError(
                "schedule='replay' pins a finite plan sequence and cannot "
                "drive a service pool; use 'static' or 'auto'")
        # the pool is the solo configuration with the driver's knobs pointed
        # at service semantics: it runs to its horizon, stops only when
        # every slot froze (required_c = B), bounds each request by lane
        # deadlines, and retries nothing (a retry would resurrect a lane
        # past its budget). The cost model needs the loop to itself and is
        # off; the pool records its own window timings instead.
        eopts = dataclasses.replace(
            eopts, iter_max=problem.horizon, required_c=None,
            lane_deadlines=True, retry_budget=0,
            auto_cost_model=False, telemetry_costs=None,
            checkpoint_every=0, checkpoint_dir=None, fault_plan=None)
        obj = problem.objective
        dev = resolve_device(device)
        self.problem = problem
        self.base_X = np.full((slots, problem.dim),
                              0.5 * (obj.lower + obj.upper), np.float32)
        self.host: HostedSolve = open_multistart(
            obj.fn, torch.from_numpy(self.base_X), strategy, eopts, device=dev,
            retry_draws=TorchDraws(dev, seed=retry_seed))
        self.carry = self.host.empty_carry()
        self.slots = slots
        self.free: List[int] = list(range(slots))  # a heap: the lowest slot first
        self.occupied: Dict[int, Tuple[int, int]] = {}  # slot -> (rid, lane)
        # the occupied slots as arrays, for the harvest: busy, and each
        # slot's admission number (the order `occupied` holds them in)
        self.busy = np.zeros(slots, bool)
        self.seq = np.zeros(slots, np.int64)
        self.n_admitted = 0
        self.queue: deque = deque()  # (rid, lane_idx) waiting for a slot
        self.k_now = 0
        # per-pool window timings (stats() "pool_windows"): one host clock
        # pair (and energy read) a pump
        self.telem = WindowTelemetry()

    def has_work(self) -> bool:
        return bool(self.occupied or self.queue)


class SolveService:
    """Continuous-batching solve service over a ProblemRegistry.

    submit() -> rid enqueues a request (or raises QueueFull); pump()
    advances every pool by one segment boundary (harvest retirements,
    admit from the queue, sweep `admit_every` sweeps); drain() pumps until
    every submitted request is done and returns {rid: SolveResult}.

    `drain_then_refill=True` degrades admission to the batch-restart
    baseline (only admit when the pool is completely empty): the same
    machinery, another admission policy. `device` is where every pool runs
    ("cuda" by default; no CPU fallback)."""

    def __init__(self, registry: ProblemRegistry, slots: int = 8,
                 max_queue: int = 64, admit_every: int = 1,
                 drain_then_refill: bool = False, retry_seed: int = 0,
                 device="cuda"):
        if slots <= 0:
            raise ValueError(f"slots must be >= 1 (got {slots})")
        if admit_every <= 0:
            raise ValueError(f"admit_every must be >= 1 (got {admit_every})")
        self.registry = registry
        self.slots = slots
        self.max_queue = max_queue
        self.admit_every = admit_every
        self.drain_then_refill = drain_then_refill
        self.device = device
        self._retry_seed = retry_seed
        self._pools: Dict[str, _Pool] = {}
        self._tickets: Dict[int, _Ticket] = {}
        self._next_rid = 0
        self.ledger: List[dict] = []  # submit/reject/admit/retire/done events

    # -- bookkeeping -------------------------------------------------------

    def _event(self, event: str, **fields):
        self.ledger.append({"event": event, "t": time.perf_counter(), **fields})

    def _pool(self, name: str) -> _Pool:
        if name not in self._pools:
            self._pools[name] = _Pool(self.registry.get(name), self.slots,
                                      self._retry_seed, self.device)
        return self._pools[name]

    def state(self, rid: int) -> str:
        return self._tickets[rid].state

    def request(self, rid: int) -> SolveRequest:
        return self._tickets[rid].request

    def result(self, rid: int) -> SolveResult:
        t = self._tickets[rid]
        if t.result is None:
            raise KeyError(f"request {rid} not done (state={t.state!r})")
        return t.result

    def results(self) -> Dict[int, SolveResult]:
        return {rid: t.result for rid, t in self._tickets.items()
                if t.result is not None}

    # -- the request path --------------------------------------------------

    def submit(self, req: SolveRequest) -> int:
        problem = self.registry.get(req.problem)
        if req.n_starts <= 0:
            raise ValueError(f"n_starts must be >= 1 (got {req.n_starts})")
        budget = (req.iter_max if req.iter_max is not None
                  else problem.default_iter_max)
        if budget <= 0:
            raise ValueError(f"iter_max must be >= 1 (got {budget})")
        if budget > problem.horizon:
            raise ValueError(
                f"iter_max={budget} exceeds the pool horizon {problem.horizon}")
        pool = self._pool(req.problem)
        waiting = sum(1 for t in self._tickets.values()
                      if t.state == "queued" and t.request.problem == req.problem)
        if waiting >= self.max_queue:
            self._event("reject", problem=req.problem, queued=waiting)
            raise QueueFull(
                f"problem {req.problem!r} wait queue at max_queue={self.max_queue}")
        rid = self._next_rid
        self._next_rid += 1
        self._tickets[rid] = _Ticket(
            request=req, state="queued", budget=budget,
            starts=request_starts(problem, req),
            t_submit=time.perf_counter(), submit_sweep=pool.k_now,
            pending=req.n_starts)
        for lane in range(req.n_starts):
            pool.queue.append((rid, lane))
        self._event("submit", rid=rid, problem=req.problem,
                    n_starts=req.n_starts, iter_max=budget,
                    sweep=pool.k_now, queued=waiting + 1)
        return rid

    # -- segment boundaries ------------------------------------------------

    def _harvest(self, pool: _Pool, view: dict):
        """Retire every occupied slot whose lane is done. The done mask is
        computed once over the view, and only the retired slots are
        visited, in the order they were admitted."""
        k = int(view["k"])
        pool.k_now = k
        dl = view["deadline"][:pool.slots]
        done = (view["converged"][:pool.slots] | view["failed"][:pool.slots]
                | ((dl > 0) & (k >= dl)))
        slots = np.flatnonzero(pool.busy & done)
        slots = slots[np.argsort(pool.seq[slots], kind="stable")]
        retired = []
        for slot in slots.tolist():
            rid, lane = pool.occupied[slot]
            t = self._tickets[rid]
            out = t.lanes[lane]
            out.x = view["x"][slot].copy()
            out.fval = float(view["f"][slot])
            out.grad_norm = float(view["grad_norm"][slot])
            out.n_evals = int(view["n_evals"][slot])
            # a lane past its deadline without converging is the solo run's
            # k >= iter_max stop: DIVERGED either way
            out.status = CONVERGED if bool(view["converged"][slot]) else DIVERGED
            out.retire_sweep = k
            out.t_retire = time.perf_counter()
            del pool.occupied[slot]
            pool.busy[slot] = False
            heapq.heappush(pool.free, slot)
            t.pending -= 1
            retired.append((rid, lane, slot))
            self._event("retire", rid=rid, lane=lane, slot=slot, sweep=k,
                        status=out.status)
            if t.pending == 0:
                self._finish(rid, t)
        return retired

    def _finish(self, rid: int, t: _Ticket):
        lanes = [t.lanes[i] for i in sorted(t.lanes)]
        fv = np.asarray([l.fval for l in lanes])
        conv = np.asarray([l.status == CONVERGED for l in lanes])
        # the best lane prefers converged ones (zeus._select_best's rule):
        # the lowest f among them, else the lowest finite f overall
        fsel = np.where(conv, fv, np.inf) if conv.any() else \
            np.where(np.isfinite(fv), fv, np.inf)
        best = int(np.argmin(fsel))
        t.result = SolveResult(
            rid=rid, problem=t.request.problem, best_x=lanes[best].x,
            best_f=lanes[best].fval,
            status=CONVERGED if conv.any() else DIVERGED,
            n_converged=int(conv.sum()), lanes=lanes)
        t.state = "done"
        self._event("done", rid=rid, problem=t.request.problem,
                    status=t.result.status,
                    sweep=max(l.retire_sweep for l in lanes))

    def _admit(self, pool: _Pool, k: int):
        if not pool.queue or not pool.free:
            return
        if self.drain_then_refill and pool.occupied:
            return  # batch-restart baseline: wait for a full drain
        B, B_flat = pool.host.B, pool.host.B_flat
        mask = np.zeros(B_flat, bool)
        deadlines = np.zeros(B_flat, np.int32)
        fresh = pool.base_X.copy()
        admitted = []
        while pool.queue and pool.free:
            rid, lane = pool.queue[0]
            t = self._tickets[rid]
            if k + t.budget > pool.problem.horizon:
                raise PoolHorizonExhausted(
                    f"pool {pool.problem.name!r} at sweep {k} cannot fit "
                    f"iter_max={t.budget} before horizon {pool.problem.horizon}")
            pool.queue.popleft()
            slot = heapq.heappop(pool.free)
            mask[slot] = True
            deadlines[slot] = k + t.budget
            fresh[slot] = t.starts[lane]
            pool.occupied[slot] = (rid, lane)
            pool.busy[slot] = True
            pool.seq[slot] = pool.n_admitted
            pool.n_admitted += 1
            now = time.perf_counter()
            t.lanes[lane] = LaneOutcome(
                x=None, fval=np.nan, grad_norm=np.nan, status=-1,
                n_evals=0, slot=slot, admit_sweep=k, retire_sweep=-1,
                t_submit=t.t_submit, t_admit=now, t_retire=np.nan)
            if t.state == "queued":
                t.state = "running"
            admitted.append((rid, lane, slot))
            self._event("admit", rid=rid, lane=lane, slot=slot, sweep=k,
                        wait_sweeps=k - t.submit_sweep)
        if admitted:
            # the admission start matrix is the quarantine re-seeder's merge
            # with request starts in place of uniform draws
            X = seed_lanes(torch.from_numpy(pool.base_X),
                           torch.from_numpy(mask[:B]), torch.from_numpy(fresh))
            pool.carry = pool.host.admit(pool.carry, mask, X, deadlines)

    def pump(self) -> bool:
        """One segment boundary on every pool with work: harvest retired
        lanes, admit from the queue, sweep admit_every sweeps. Returns
        True while any request is not done."""
        for pool in self._pools.values():
            if not pool.has_work():
                continue
            view = pool.host.lane_view(pool.carry)
            self._harvest(pool, view)
            self._admit(pool, pool.k_now)
            if pool.occupied:
                # rows, trips and k are host ints of the carry; the segment
                # ends on a readback, so the window's wall covers its sweeps
                rows0, trips0 = pool.carry.rows, pool.carry.trips
                pool.telem.begin()
                pool.carry = pool.host.segment(pool.carry,
                                               pool.k_now + self.admit_every)
                pool.telem.end(rows=pool.carry.rows - rows0,
                               launches=pool.carry.trips - trips0)
                pool.k_now = pool.carry.k
        return any(p.has_work() for p in self._pools.values())

    def drain(self) -> Dict[int, SolveResult]:
        while self.pump():
            pass
        return self.results()

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        """Request-level latency/throughput summary (done requests)."""
        done = [t for t in self._tickets.values() if t.result is not None]
        out = {
            "n_done": len(done),
            "n_queued": sum(t.state == "queued" for t in self._tickets.values()),
            "n_running": sum(t.state == "running" for t in self._tickets.values()),
            "pool_sweeps": {name: p.k_now for name, p in self._pools.items()},
            "pool_windows": {name: p.telem.summary()
                             for name, p in self._pools.items()},
        }
        # a request retired with no lane outcomes has nothing to take
        # min/max over: skip it rather than raise
        timed = [t for t in done if t.result.lanes]
        if timed:
            adm_s = np.asarray([t.result.admit_latency_s for t in timed])
            tot_s = np.asarray([t.result.total_latency_s for t in timed])
            adm_k = np.asarray(
                [min(l.admit_sweep for l in t.result.lanes) - t.submit_sweep
                 for t in timed])
            t0 = min(t.t_submit for t in timed)
            t1 = max(l.t_retire for t in timed for l in t.result.lanes)
            out.update(
                admit_latency_s_p50=float(np.percentile(adm_s, 50)),
                admit_latency_s_p95=float(np.percentile(adm_s, 95)),
                admit_latency_sweeps_p50=float(np.percentile(adm_k, 50)),
                admit_latency_sweeps_p95=float(np.percentile(adm_k, 95)),
                total_latency_s_p50=float(np.percentile(tot_s, 50)),
                total_latency_s_p95=float(np.percentile(tot_s, 95)),
                # None (JSON null), not inf: a span under the clock's
                # resolution would otherwise emit Infinity
                solves_per_sec=(len(timed) / (t1 - t0) if t1 > t0 else None),
            )
        return out

    def dump_ledger(self, path: str):
        """The request ledger as JSON."""
        with open(path, "w") as fh:
            json.dump(self.ledger, fh, indent=1)


def solo_reference(problem: Problem, req: SolveRequest,
                   slots: Optional[int] = None, device="cuda") -> BFGSResult:
    """The request run alone in a fresh batch: the parity oracle for tests
    and the smoke run, independent of the service machinery (no deadlines,
    no admission: a plain run_multistart whose iter_max is the request's
    budget).

    `slots` pads the batch to the pool's width with box-midpoint rows; rows
    [:n_starts] are the request. At a fixed width a lane's trajectory does
    not depend on what the other rows hold, which is the continuous-
    batching contract (busy pool == alone in the pool)."""
    strategy, eopts = phase2_setup(problem.opts)
    budget = req.iter_max if req.iter_max is not None else problem.default_iter_max
    eopts = dataclasses.replace(
        eopts, iter_max=budget, required_c=None, lane_deadlines=False,
        retry_budget=0, auto_cost_model=False, telemetry_costs=None,
        checkpoint_every=0, checkpoint_dir=None, fault_plan=None)
    starts = request_starts(problem, req)
    width = max(slots or req.n_starts, req.n_starts)
    obj = problem.objective
    X = np.full((width, problem.dim), 0.5 * (obj.lower + obj.upper), np.float32)
    X[:req.n_starts] = starts
    return run_multistart(obj.fn, X, strategy, eopts, device=device)
