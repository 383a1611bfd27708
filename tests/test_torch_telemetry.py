"""The port's telemetry and cost-model schedule controller
(launch/telemetry.py, engine auto_cost_model) against the JAX package.

- The host functions against the reference's on a table of inputs:
  fit_costs, record_window, cost_model_decision (every branch: row- and
  launch-dominant scores, the hysteresis, an empty window, the dynamic
  latch) and telemetry_summary.
- Cost-model solves in the port: with fixed costs on a swarm whose
  accepted rungs concentrate below every candidate, the cost model and the
  p90 rule pick the same plan each window, so the run is array-equal to the
  p90 auto run; two fixed-cost runs are array-equal, their telemetry counts
  too; a measured (EMA) run replays array-equal from its trace; telemetry
  is attached only under the cost model; the energy probe is a capability,
  never a dependency.

No reference solve runs here (its auto solves are not oracles for the
port): 16 lanes of D = 2, 20 sweeps.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import telemetry as JT  # noqa: E402
from repro_torch.core import BFGSOptions, batched_bfgs, get_objective  # noqa: E402
from repro_torch.core import schedule_trace_plans  # noqa: E402
from repro_torch.launch import telemetry as T  # noqa: E402

rosenbrock = get_objective("rosenbrock").fn
LADDERS = (2, 0)
HARD_START = [-1.2, 1.0]


@pytest.fixture(autouse=True, scope="module")
def _strict_fp32():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


# ---------------------------------------------------------------------------
# the host functions against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("args", [
    (0.0, 0.0, 10.0, 100, 1, 0, 0.5), (0.1, 0.0, 30.0, 100, 1, 1, 0.5),
    (2e-6, 3e-4, 0.0123, 5000, 7, 3, 0.25), (1e-3, 1.0, 0.5, 0, 0, 2, 0.9)])
def test_fit_costs_matches_reference(args):
    c_row, c_launch, wall, rows, launches, n, ema = args
    assert T.fit_costs(c_row, c_launch, wall, rows, launches, n=n, ema=ema) == \
        JT.fit_costs(c_row, c_launch, wall, rows, launches, n=n, ema=ema)


def test_record_window_and_summary_match_reference():
    """A run of segments, some splitting a window (refit only where it
    completes), in fixed and EMA mode, with and without energy."""
    for fixed, costs in ((False, None), (True, (2.0, 0.5))):
        p, r = T.telemetry_init(4, costs), JT.telemetry_init(4, costs)
        for w, wall, rows, launches, energy, refit in (
                (0, 0.01, 120, 4, None, True), (1, 0.004, 60, 4, 1.5, False),
                (1, 0.003, 40, 2, 0.5, True), (2, 0.02, 300, 9, None, True)):
            p = T.record_window(p, w, wall, rows, launches, energy, ema=0.3, fixed=fixed,
                                refit=refit)
            r = JT.record_window(r, w, wall, rows, launches, energy, ema=0.3, fixed=fixed,
                                 refit=refit)
            for a, b in zip(p, r):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert T.telemetry_summary(p) == JT.telemetry_summary(r)
        json.dumps(T.telemetry_summary(p), allow_nan=False)
    empty = T.telemetry_summary(T.telemetry_init(3))
    assert empty == JT.telemetry_summary(JT.telemetry_init(3))
    assert "energy_j_total" not in empty


def _hist(*bins, K=10):
    h = np.zeros(K + 1, int)
    for b in bins:
        h[b] += 1
    return h


@pytest.mark.parametrize("hist,n_act,plan,prev,dyn,thresh,c_row,c_launch", [
    (_hist(*[0] * 8), 8, 1, -1, False, 4.0, 1.0, 1.0),  # rows decide: shortest
    (_hist(0, 3, 5, 7, 9), 5, 0, 1, False, 1.0, 1e-6, 1.0),  # launches decide: full
    (_hist(0, 3, 5, 7, 9), 5, 0, -1, False, 1.0, 1e-6, 1.0),  # up needs two windows
    (_hist(), 8, 1, -1, False, 4.0, 1.0, 1.0),  # empty window: no change
    (_hist(*[0] * 8), 3, 1, -1, False, 4.0, 1.0, 1.0),  # latches dynamic
    (_hist(1, 2, 10, 10), 20, 3, 0, True, 4.0, 2e-6, 5e-5),  # exhausted lanes
])
def test_cost_model_decision_matches_reference(hist, n_act, plan, prev, dyn, thresh,
                                               c_row, c_launch):
    for eff in ((2, 10), (1, 2, 4, 8, 10)):
        got = T.cost_model_decision(hist, n_act, eff, plan, prev, dyn, act_thresh=thresh,
                                    c_row=c_row, c_launch=c_launch)
        want = JT.cost_model_decision(hist, n_act, eff, plan, prev, dyn, act_thresh=thresh,
                                      c_row=c_row, c_launch=c_launch)
        assert got == want


# ---------------------------------------------------------------------------
# cost-model solves
# ---------------------------------------------------------------------------
def _frozen_mix(n_frozen=10, n_active=6):
    """Frozen lanes start at rosenbrock's exact optimum; active lanes at the
    hard valley start never converge at theta=1e-30 and settle into
    shallow accepted rungs: the concentrated histogram on which the cost
    rule and the p90 rule agree."""
    x0 = np.tile(np.asarray([HARD_START], np.float32), (n_frozen + n_active, 1))
    x0[:n_frozen] = 1.0
    return x0


def _opts(**kw):
    return BFGSOptions(iter_bfgs=20, theta=1e-30, ls_iters=10, lane_chunk=4,
                       sweep_mode="batched", schedule="auto", schedule_every=2,
                       auto_ladders=LADDERS, **kw)


def _assert_same_solve(a, b):
    for fld in ("x", "fval", "grad_norm", "status", "n_evals", "schedule_trace",
                "n_restarts"):
        assert torch.equal(getattr(a, fld), getattr(b, fld)), fld
    assert (a.iterations, a.eval_rows, a.map_trips, a.n_converged) == (
        b.iterations, b.eval_rows, b.map_trips, b.n_converged)


def test_fixed_cost_run_equals_p90_on_concentrated_swarm():
    p90 = batched_bfgs(rosenbrock, _frozen_mix(), _opts(), device="cpu")
    cm = batched_bfgs(rosenbrock, _frozen_mix(), _opts(
        auto_cost_model=True, telemetry_costs=(1.0, 1.0)), device="cpu")
    assert len(set(schedule_trace_plans(cm.schedule_trace))) > 1  # the plan moved
    _assert_same_solve(p90, cm)
    assert p90.telemetry is None
    t = cm.telemetry
    wall = np.asarray(t.wall_s)
    assert int(t.windows) == wall.shape[0] == 10
    assert (wall > 0).all() and (t.rows > 0).all() and (t.launches > 0).all()
    s = T.telemetry_summary(t)
    json.dumps(s, allow_nan=False)
    assert s["rows_total"] == cm.eval_rows - 16  # init rows are no window's
    assert s["launches_total"] == cm.map_trips


def test_fixed_cost_run_is_reproducible():
    opts = _opts(auto_cost_model=True, telemetry_costs=(2.0, 0.5))
    a = batched_bfgs(rosenbrock, _frozen_mix(), opts, device="cpu")
    b = batched_bfgs(rosenbrock, _frozen_mix(), opts, device="cpu")
    _assert_same_solve(a, b)
    np.testing.assert_array_equal(a.telemetry.rows, b.telemetry.rows)
    np.testing.assert_array_equal(a.telemetry.launches, b.telemetry.launches)
    assert float(a.telemetry.c_row) == 2.0 and float(a.telemetry.c_launch) == 0.5


def test_measured_run_replays_array_equal():
    """The EMA fit makes the plans depend on the wall clock, but each is a
    lattice member decided at a window boundary: its trace replays the run
    exactly."""
    cm = batched_bfgs(rosenbrock, _frozen_mix(), _opts(auto_cost_model=True),
                      device="cpu")
    assert float(cm.telemetry.c_row) > 0.0
    rep = batched_bfgs(rosenbrock, _frozen_mix(), dataclasses.replace(
        _opts(), schedule="replay", schedule_plans=schedule_trace_plans(cm.schedule_trace)),
        device="cpu")
    _assert_same_solve(cm, rep)
    assert rep.telemetry is None


def _no_energy(monkeypatch, tmp_path):
    monkeypatch.setattr(T, "_probe_nvml", lambda: None)
    monkeypatch.setattr(T, "_RAPL_GLOB", str(tmp_path / "powercap-none:*/energy_uj"))


def test_absent_energy_probe_never_raises(monkeypatch, tmp_path):
    _no_energy(monkeypatch, tmp_path)
    probe = T.probe_energy()
    assert not probe.available and probe.source is None and probe.read_j() is None
    cm = batched_bfgs(rosenbrock, _frozen_mix(), _opts(
        auto_cost_model=True, telemetry_costs=(1.0, 1.0)), device="cpu")
    assert np.isnan(cm.telemetry.energy_j).all()
    assert "energy_j_total" not in T.telemetry_summary(cm.telemetry)
    rec = T.WindowTelemetry()
    assert rec.end(rows=1, launches=1) == 0.0 and rec.summary() == {"n_windows": 0}
    rec.begin()
    assert rec.end(rows=10, launches=1) >= 0.0
    s = rec.summary()
    assert s["n_windows"] == 1 and "energy_j_total" not in s and "energy_source" not in s
    json.dumps(s, allow_nan=False)


def test_failing_energy_reader_degrades_to_absent():
    def boom():
        raise OSError("energy counter gone")

    probe = T.EnergyProbe("nvml", boom)
    assert probe.available and probe.read_j() is None
    assert not probe.available and probe.source is None


@pytest.mark.parametrize("kw,match", [
    (dict(schedule="static", auto_cost_model=True), "schedule='auto'"),
    (dict(telemetry_costs=(1.0, 1.0)), "auto_cost_model"),
    (dict(auto_cost_model=True, telemetry_costs=(1.0,)), "c_row"),
])
def test_cost_model_validation(kw, match):
    base = dict(iter_bfgs=4, sweep_mode="batched", schedule="auto")
    base.update(kw)
    with pytest.raises(ValueError, match=match):
        batched_bfgs(rosenbrock, np.full((4, 2), 0.5, np.float32), BFGSOptions(**base),
                     device="cpu")
