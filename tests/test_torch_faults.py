"""The port's fault tolerance (launch/faults.py, engine retry_budget and
fault_plan) against the JAX package.

- launch/faults.py: FaultPlan.random and injection_masks equal the
  reference's; StepGuard gives the reference's skip, warn and abort
  sequences; reseed_lost_lanes with the reference's draws replayed equals
  the reference's.
- Quarantine and retry held against the reference: an injected NaN, a
  killed lane (chunked and repacked), an organic NaN (ackley at the
  origin, whose gradient is 0/0) and retry_mode="uniform". The reference
  solve runs to the heal sweep + 2 with its retry key; the port starts
  from the same inputs with the reference's retry draws replayed. Statuses,
  n_restarts, n_failed and n_evals are equal, x, f and |g| within 1e-3 of
  max(1, |reference|), and eval_rows is the reference's net of C8: the
  reference evaluates every lane of the flat axis on a heal sweep, the port
  the healed rows alone.
- The port's own contracts: a killed lane re-enters the active set and
  converges with the sweeps it needs (the reference's own test gives it 40
  and fails under jax 0.9.0; its lane converges at sweep 52 of
  200, ROADMAP "Reference-side facts"), injected faults heal within the
  budget, retries are deterministic given the stream, zeus surfaces the
  counters and warns when every lane failed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bfgs as jbfgs  # noqa: E402
from repro.core import objectives as jobj  # noqa: E402
from repro.kernels.ops import reference_kernels_off_tpu  # noqa: E402
from repro.launch import faults as jfaults  # noqa: E402
from repro_torch.core import (  # noqa: E402
    CONVERGED,
    DIVERGED,
    BFGSOptions,
    PSOOptions,
    TorchDraws,
    ZeusOptions,
    batched_bfgs,
    get_objective,
    zeus,
)
from repro_torch.launch import faults  # noqa: E402
from repro_torch.launch.faults import FaultPlan, StepGuard  # noqa: E402

STATE_TOL = 1e-3  # |Δ| <= STATE_TOL · max(1, |reference|), ROADMAP C3


@pytest.fixture(autouse=True, scope="module")
def _strict_fp32():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


# ---------------------------------------------------------------------------
# launch/faults.py against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,n_sweeps,n_lanes,n_nan,n_kill", [
    (0, 8, 2048, 64, 16), (7, 20, 8, 3, 2), (3, 1, 1, 2, 0)])
def test_fault_plan_random_matches_reference(seed, n_sweeps, n_lanes, n_nan, n_kill):
    p = FaultPlan.random(seed, n_sweeps=n_sweeps, n_lanes=n_lanes, n_nan=n_nan,
                         n_kill=n_kill, preempt_at_sweep=5)
    r = jfaults.FaultPlan.random(seed, n_sweeps=n_sweeps, n_lanes=n_lanes, n_nan=n_nan,
                                 n_kill=n_kill, preempt_at_sweep=5)
    assert (p.nan_grads, p.kill_lanes, p.preempt_at_sweep) == (
        r.nan_grads, r.kill_lanes, r.preempt_at_sweep)
    same = FaultPlan(nan_grads=p.nan_grads, kill_lanes=p.kill_lanes, preempt_at_sweep=5)
    assert p == same and hash(p) == hash(same)


@pytest.mark.parametrize("bad", [dict(nan_grads=((-1, 0),)), dict(kill_lanes=((0, -2),)),
                                 dict(preempt_at_sweep=-1)])
def test_fault_plan_validation(bad):
    with pytest.raises(ValueError):
        FaultPlan(**bad)


def test_injection_masks_match_reference():
    plan = FaultPlan.random(11, n_sweeps=6, n_lanes=12, n_nan=9, n_kill=5)
    jplan = jfaults.FaultPlan(nan_grads=plan.nan_grads, kill_lanes=plan.kill_lanes)
    for k in range(7):
        for got, want in zip(faults.injection_masks(plan, k, 12),
                             jfaults.injection_masks(jplan, jnp.asarray(k), 12)):
            assert got.dtype == torch.bool
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    nan, kill = faults.injection_masks(FaultPlan(), 0, 4)
    assert not nan.any() and not kill.any()


@pytest.mark.parametrize("policy,deadline", [("skip", 1e-9), ("warn", 1e-9), ("skip", 0.0)])
def test_step_guard_matches_reference(policy, deadline):
    """Two breaches (or none without a deadline): the skip decisions after
    each, and the breach counts, step for step."""
    seqs = []
    for cls in (StepGuard, jfaults.StepGuard):
        g, seq = cls(deadline_s=deadline, on_breach=policy), []
        for i in range(2):
            with g.step(i):
                pass
            seq += [g.should_skip_next(), g.should_skip_next(), g.breaches]
        seqs.append(seq)
    assert seqs[0] == seqs[1]


def test_step_guard_abort_raises():
    for cls in (StepGuard, jfaults.StepGuard):
        with pytest.raises(TimeoutError):
            with cls(deadline_s=1e-9, on_breach="abort").step(0):
                pass


class ReplayDraws:
    """A draws hook that hands out the reference's draws in order (uniform
    and normal alike), checking each request's shape."""

    def __init__(self, arrays):
        self.arrays = list(arrays)

    def _next(self, shape):
        a = self.arrays.pop(0)
        assert a.shape == tuple(shape)
        return torch.from_numpy(np.array(a))

    def __call__(self, shape, low, high):
        return self._next(shape)

    def normal(self, shape):
        return self._next(shape)


def test_reseed_lost_lanes_matches_reference():
    key = jax.random.key(4)
    x = np.random.default_rng(0).normal(size=(6, 3)).astype(np.float32)
    mask = np.array([True, False, False, True, False, True])
    want = jfaults.reseed_lost_lanes(key, jnp.asarray(x), jnp.asarray(mask), -2.0, 3.0)
    fresh = np.asarray(jax.random.uniform(key, (6, 3), jnp.float32, minval=-2.0, maxval=3.0))
    got = faults.reseed_lost_lanes(ReplayDraws([fresh]), torch.from_numpy(x),
                                   torch.from_numpy(mask), -2.0, 3.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# quarantine and retry, held against the reference
# ---------------------------------------------------------------------------
def reference_retry_draws(key, n, shape, mode, bounds=None):
    """The reference engine's re-seed draws for its first n heal sweeps: each
    splits the carried key into (key, sub) and draws over the whole flat
    lane axis from sub."""
    rk, out = jax.random.key_data(key), []
    for _ in range(n):
        k, sub = jax.random.split(jax.random.wrap_key_data(rk))
        if mode == "uniform":
            out.append(np.asarray(jax.random.uniform(sub, shape, jnp.float32,
                                                     minval=bounds[0], maxval=bounds[1])))
        else:
            out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
        rk = jax.random.key_data(k)
    return out


def _starts(seed, lo, hi, origin_lane=None):
    x = np.random.default_rng(seed).uniform(lo, hi, (8, 3)).astype(np.float32)
    if origin_lane is not None:
        x[origin_lane] = 0.0  # ackley: f(0) = 0 is finite, its gradient 0/0
    return x


# (objective, starts, fault plan, sweeps = the heal sweep + 2, heal sweeps,
# engine options)
RETRY_CASES = {
    "injected-nan": ("rosenbrock", _starts(3, -2, 2), dict(nan_grads=((1, 1), (1, 5))), 4, 1,
                     dict(retry_budget=1)),
    "kill-chunked": ("rosenbrock", _starts(3, -2, 2), dict(kill_lanes=((1, 2),)), 4, 1,
                     dict(retry_budget=1, lane_chunk=4, repack_every=2)),
    "organic-nan": ("ackley", _starts(4, -20, 20, origin_lane=0), None, 3, 1,
                    dict(retry_budget=2, retry_sigma=0.05)),
    "uniform": ("ackley", _starts(4, -20, 20, origin_lane=0), None, 3, 1,
                dict(retry_budget=1, retry_mode="uniform", retry_bounds=(-20.0, 20.0))),
}


@pytest.mark.parametrize("case", list(RETRY_CASES))
def test_retry_matches_reference(case):
    name, x0, plan, sweeps, heals, extra = RETRY_CASES[case]
    key = jax.random.key(5)
    common = dict(iter_bfgs=sweeps, theta=1e-5, sweep_mode="batched", **extra)
    with reference_kernels_off_tpu():
        ref = jax.device_get(jbfgs.batched_bfgs(
            jobj.get_objective(name), jnp.asarray(x0), jbfgs.BFGSOptions(
                fault_plan=None if plan is None else jfaults.FaultPlan(**plan), **common),
            retry_key=key))
    B, D = x0.shape
    C = extra.get("lane_chunk") or B
    B_flat = -(-B // C) * C
    draws = ReplayDraws(reference_retry_draws(
        key, heals, (B_flat, D), extra.get("retry_mode", "perturb"), extra.get("retry_bounds")))
    res = batched_bfgs(get_objective(name).fn, x0, BFGSOptions(
        fault_plan=None if plan is None else FaultPlan(**plan), **common), device="cpu",
        retry_draws=draws)
    assert not draws.arrays  # every heal sweep drew once
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(res.n_restarts.numpy(), np.asarray(ref.n_restarts))
    np.testing.assert_array_equal(res.n_evals.numpy(), np.asarray(ref.n_evals))
    assert res.n_failed == int(ref.n_failed)
    assert int(res.n_restarts.sum()) > 0
    for got, want in ((res.x, ref.x), (res.fval, ref.fval), (res.grad_norm, ref.grad_norm)):
        want = np.asarray(want)
        assert np.all(np.abs(got.numpy() - want) <= STATE_TOL * np.maximum(1.0, np.abs(want)))
    # C8: the reference charges B_flat rows a heal sweep, the port the healed
    # rows
    assert res.eval_rows == (int(ref.eval_rows) - heals * B_flat
                             + int(res.n_restarts.sum()))
    assert res.map_trips == int(ref.map_trips)


# ---------------------------------------------------------------------------
# the port's own retry contracts
# ---------------------------------------------------------------------------
rosenbrock = get_objective("rosenbrock").fn
ackley = get_objective("ackley").fn


def _x0(seed, n=8, d=3, lo=-2.0, hi=2.0):
    return np.random.default_rng(seed).uniform(lo, hi, (n, d)).astype(np.float32)


def test_kill_lane_reenters_active_set():
    """The reference's kill-lane case (lane 2 killed at sweep 3, chunks of 4
    repacked every 2 sweeps, budget 1), with the sweeps the healed lane
    needs."""
    res = batched_bfgs(rosenbrock, _x0(5), BFGSOptions(
        iter_bfgs=80, theta=1e-5, sweep_mode="batched", lane_chunk=4, repack_every=2,
        fault_plan=FaultPlan(kill_lanes=((3, 2),)), retry_budget=1), device="cpu",
        retry_draws=TorchDraws("cpu", seed=6))
    assert int(res.n_restarts[2]) == 1 and int(res.n_restarts.sum()) == 1
    assert int(res.status[2]) == CONVERGED
    assert res.n_failed == 0


def test_injected_nan_heals_and_budget_caps():
    plan = FaultPlan(nan_grads=((2, 1), (2, 5), (4, 1)))
    base = dict(iter_bfgs=60, theta=1e-5, sweep_mode="batched", fault_plan=plan)
    broken = batched_bfgs(rosenbrock, _x0(4), BFGSOptions(**base), device="cpu")
    assert broken.n_failed == 2 and int(broken.n_restarts.sum()) == 0
    healed = batched_bfgs(rosenbrock, _x0(4), BFGSOptions(retry_budget=1, **base),
                          device="cpu")
    # lane 1 is hit twice: its second failure is past the budget
    assert healed.n_restarts.tolist() == [0, 1, 0, 0, 0, 1, 0, 0]
    assert healed.n_failed == 1 and int(healed.status[1]) == DIVERGED
    assert healed.n_converged > broken.n_converged


def test_organic_nan_recovers_and_retry_is_deterministic():
    x0 = _x0(3, lo=-20.0, hi=20.0)
    x0[0] = 0.0
    base = dict(iter_bfgs=60, theta=1e-4, sweep_mode="batched")
    plain = batched_bfgs(ackley, x0, BFGSOptions(**base), device="cpu")
    assert plain.n_failed >= 1 and int(plain.status[0]) == DIVERGED
    opts = BFGSOptions(retry_budget=2, retry_sigma=0.05, **base)
    a = batched_bfgs(ackley, x0, opts, device="cpu", retry_draws=TorchDraws("cpu", seed=9))
    b = batched_bfgs(ackley, x0, opts, device="cpu", retry_draws=TorchDraws("cpu", seed=9))
    assert int(a.n_restarts[0]) >= 1 and a.n_failed < plain.n_failed
    for fld in ("x", "fval", "grad_norm", "status", "n_evals", "n_restarts"):
        assert torch.equal(getattr(a, fld), getattr(b, fld)), fld
    assert (a.iterations, a.eval_rows, a.map_trips) == (b.iterations, b.eval_rows, b.map_trips)
    uni = batched_bfgs(ackley, x0, BFGSOptions(
        retry_budget=1, retry_mode="uniform", retry_bounds=(-20.0, 20.0), **base),
        device="cpu")
    assert int(uni.n_restarts[0]) == 1


@pytest.mark.parametrize("schedule", [
    dict(compact_every=2), dict(lane_chunk=4, repack_every=3, compact_every=2),
    dict(sweep_mode="megakernel", lane_chunk=4, compact_every=1),
    dict(lane_chunk=4, schedule="auto", schedule_every=2, auto_active_frac=0.95)],
    ids=["compact", "repack-compact", "megakernel-compact", "auto-chunk"])
def test_schedules_with_retry_equal_static(schedule):
    """A heal re-admits lanes mid-plan: the schedules refresh their gather
    plans then, and stay array-equal to the static sweep of the same lane
    layout (the retry draws cover the flat lane axis, padding included, so
    the layout is part of the stream, as in the reference)."""
    plan = FaultPlan(nan_grads=((1, 1), (4, 7), (6, 12)), kill_lanes=((3, 2), (3, 11)))
    x0 = _x0(0, n=13)

    def run(**kw):
        return batched_bfgs(rosenbrock, x0, BFGSOptions(
            iter_bfgs=20, theta=1e-6, fault_plan=plan, retry_budget=2, **kw), device="cpu",
            retry_draws=TorchDraws("cpu", seed=3))

    static = run(lane_chunk=schedule.get("lane_chunk"))
    res = run(**schedule)
    assert int(res.n_restarts.sum()) == 5
    for fld in ("x", "fval", "grad_norm", "status", "n_restarts"):
        assert torch.equal(getattr(res, fld), getattr(static, fld)), fld
    assert res.iterations == static.iterations


@pytest.mark.parametrize("kw,match", [
    (dict(sweep_mode="per_lane", retry_budget=1), "retry_budget"),
    (dict(retry_budget=1, retry_mode="uniform"), "retry_bounds"),
    (dict(retry_budget=1, retry_mode="jitter"), "retry_mode"),
    (dict(retry_budget=-1), "retry_budget"),
    (dict(checkpoint_every=2), "checkpoint_dir"),
    (dict(checkpoint_every=-1, checkpoint_dir="x"), "checkpoint_every"),
])
def test_invalid_fault_options_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        batched_bfgs(rosenbrock, _x0(0, n=4, d=2), BFGSOptions(iter_bfgs=5, **kw),
                     device="cpu")


def test_injection_runs_on_the_per_lane_sweep():
    res = batched_bfgs(rosenbrock, _x0(1, n=7), BFGSOptions(
        iter_bfgs=4, sweep_mode="per_lane",
        fault_plan=FaultPlan(nan_grads=((1, 3),), kill_lanes=((2, 6),))), device="cpu")
    assert res.n_failed == 2 and int(res.status[3]) == int(res.status[6]) == DIVERGED
    assert bool(torch.isnan(res.grad_norm[3]))


ZEUS_BASE = dict(use_pso=False, pso=PSOOptions(n_particles=12, iter_pso=0),
                 bfgs=BFGSOptions(iter_bfgs=30, theta=1e-4), sweep_mode="batched")


def test_zeus_surfaces_retry_counters():
    obj = get_objective("ackley")
    plan = FaultPlan(nan_grads=((1, 3),))
    res = zeus(obj.fn, 3, -20.0, 20.0, ZeusOptions(retry_budget=1, fault_plan=plan,
                                                    **ZEUS_BASE), device="cpu")
    assert res.n_restarts.shape == (12,) and int(res.n_restarts[3]) == 1
    assert res.n_failed == 0


def test_warns_when_every_lane_failed():
    def poison(x):
        return torch.sum(x) * float("nan")  # every lane fails at init

    with pytest.warns(RuntimeWarning, match="retries used per lane: up to 1"):
        zeus(poison, 2, -1.0, 1.0, ZeusOptions(retry_budget=1, **ZEUS_BASE), device="cpu")
