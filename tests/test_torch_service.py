"""The port's solve service (serve/service.py over HostedSolve) on the CPU,
and against the JAX package's service.

- The registry, backpressure, horizon, budget, slot and stats cases of the
  reference's own suite (tests/test_service.py), on the port.
- `lane_deadlines` validation: the reference's ValueErrors, message for
  message (its checks run before anything is traced).
- Continuous batching: every request of a busy pool array-equal (x, f,
  |g|, status, n_evals) to the port's `solo_reference` at the pool's width,
  over the reference's parity grid, the megakernel sweep and the static
  schedules with compaction and repacking; under schedule="auto",
  determinism array-equal and the solo run to tolerance.
- Against the JAX service on identical explicit starts with θ = 1e-30 (no
  lane converges, so every lane retires at its deadline): the ledger's
  fields but the clock, event for event, and the pools' sweep counts, at
  admit_every 1 and 3 (two reference drains, jnp kernels).

Sizes stay small: slots <= 4, D <= 4, iter_bfgs <= 24.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    CONVERGED,
    DIVERGED,
    BFGSOptions,
    DenseBFGS,
    EngineOptions,
    ZeusOptions,
    get_objective,
    open_multistart,
    run_multistart,
)
from repro_torch.core import engine  # noqa: E402
from repro_torch.serve.service import (  # noqa: E402
    PoolHorizonExhausted,
    ProblemRegistry,
    QueueFull,
    SolveRequest,
    SolveResult,
    SolveService,
    _Ticket,
    request_starts,
    solo_reference,
)


@pytest.fixture(autouse=True, scope="module")
def _strict_fp32():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


def _zopts(sweep_mode="batched", chunk=None, schedule="static", iter_bfgs=24,
           theta=1e-4):
    # "static+compact" / "static+repack": the static schedule with compaction
    # (and, chunked, cross-chunk repacking) every sweep
    every = int(schedule.startswith("static+"))
    return ZeusOptions(bfgs=BFGSOptions(
        iter_bfgs=iter_bfgs, theta=theta, ad_mode="reverse", ls_iters=12,
        sweep_mode=sweep_mode, lane_chunk=chunk, schedule=schedule.split("+")[0],
        schedule_every=2, compact_every=every,
        repack_every=int(schedule == "static+repack")))


def _registry(name="ras", objective="rastrigin", dim=3, **kw):
    reg = ProblemRegistry()
    reg.register(name, objective, dim, opts=_zopts(**kw))
    return reg


def _service(reg, **kw):
    return SolveService(reg, device="cpu", **kw)


def _assert_request_parity(svc, reg, rid, exact=True):
    """Every lane of a drained request against the request alone in a fresh
    batch of the pool's width: array-equal (exact), or statuses equal and
    x, f close (schedule="auto", whose n_evals follows the traffic)."""
    res = svc.result(rid)
    ref = solo_reference(reg.get(res.problem), svc.request(rid), slots=svc.slots,
                         device="cpu")
    for i, lane in enumerate(res.lanes):
        msg = f"rid={rid} lane={i}"
        assert lane.status == int(ref.status[i]), msg
        if exact:
            np.testing.assert_array_equal(lane.x, ref.x[i].numpy(), err_msg=msg)
            assert lane.fval == float(ref.fval[i]), msg
            assert lane.grad_norm == float(ref.grad_norm[i]), msg
            assert lane.n_evals == int(ref.n_evals[i]), msg
        else:
            np.testing.assert_allclose(lane.x, ref.x[i].numpy(), rtol=1e-3, atol=1e-3,
                                       err_msg=msg)
            np.testing.assert_allclose(lane.fval, float(ref.fval[i]), rtol=1e-3,
                                       atol=1e-5, err_msg=msg)


def _assert_results_identical(res_a, res_b):
    assert len(res_a.lanes) == len(res_b.lanes)
    for i, (la, lb) in enumerate(zip(res_a.lanes, res_b.lanes)):
        np.testing.assert_array_equal(la.x, lb.x, err_msg=f"lane={i} x")
        assert (la.fval, la.grad_norm, la.status, la.n_evals, la.admit_sweep,
                la.retire_sweep) == (lb.fval, lb.grad_norm, lb.status, lb.n_evals,
                                     lb.admit_sweep, lb.retire_sweep), f"lane={i}"


# ---------------------------------------------------------------------------
# Problem registry
# ---------------------------------------------------------------------------
class TestRegistry:
    def test_register_and_lookup(self):
        reg = ProblemRegistry()
        p = reg.register("ras4", "rastrigin", 4)
        assert reg.get("ras4") is p
        assert p.objective.name == "rastrigin"
        assert reg.names() == ("ras4",)
        assert "ras4" in reg and len(reg) == 1

    def test_duplicate_name_rejected(self):
        reg = _registry()
        with pytest.raises(ValueError, match="already registered"):
            reg.register("ras", "ackley", 2)

    def test_unknown_problem(self):
        with pytest.raises(KeyError, match="unknown problem"):
            ProblemRegistry().get("nope")

    def test_fixed_dim_objective_checked(self):
        reg = ProblemRegistry()
        with pytest.raises(ValueError, match="fixed-dimensional"):
            reg.register("gp", "goldstein_price", 5)
        reg.register("gp", "goldstein_price", 2)

    def test_named_objective_keeps_identity(self):
        # a name resolves through get_objective, so the pool's batched path
        # finds the fused kernels by the function's identity
        reg = _registry()
        assert reg.get("ras").objective.fn is get_objective("rastrigin").fn


# ---------------------------------------------------------------------------
# Backpressure + request lifecycle
# ---------------------------------------------------------------------------
class TestBackpressure:
    def test_queue_full_rejects(self):
        svc = _service(_registry(), slots=2, max_queue=2)
        svc.submit(SolveRequest("ras", seed=0))
        svc.submit(SolveRequest("ras", seed=1))
        with pytest.raises(QueueFull):
            svc.submit(SolveRequest("ras", seed=2))
        assert svc.ledger[-1]["event"] == "reject"
        svc.drain()  # the accepted two still complete

    def test_states_progress(self):
        svc = _service(_registry(), slots=2)
        rid = svc.submit(SolveRequest("ras", seed=0, iter_max=10))
        assert svc.state(rid) == "queued"
        svc.pump()
        assert svc.state(rid) == "running"
        svc.drain()
        assert svc.state(rid) == "done"
        assert svc.result(rid).rid == rid

    def test_result_before_done_raises(self):
        svc = _service(_registry(), slots=2)
        rid = svc.submit(SolveRequest("ras", seed=0))
        with pytest.raises(KeyError, match="not done"):
            svc.result(rid)

    def test_budget_validation(self):
        svc = _service(_registry(), slots=2)
        with pytest.raises(ValueError, match="n_starts"):
            svc.submit(SolveRequest("ras", n_starts=0))
        with pytest.raises(ValueError, match="exceeds the pool horizon"):
            svc.submit(SolveRequest("ras", iter_max=10**9))

    def test_horizon_exhaustion_raises(self):
        reg = ProblemRegistry()
        reg.register("ras", "rastrigin", 3, opts=_zopts(theta=1e-30), horizon=25)
        svc = _service(reg, slots=1)
        svc.submit(SolveRequest("ras", seed=0, iter_max=20))
        svc.submit(SolveRequest("ras", seed=1, iter_max=20))
        with pytest.raises(PoolHorizonExhausted):
            svc.drain()

    def test_replay_schedule_refused(self):
        reg = ProblemRegistry()
        reg.register("ras", "rastrigin", 3, opts=ZeusOptions(bfgs=BFGSOptions(
            schedule="replay", schedule_plans=(0,) * 50)))
        with pytest.raises(ValueError, match="schedule='replay'"):
            _service(reg).submit(SolveRequest("ras"))

    def test_pool_needs_a_card_by_default(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        svc = SolveService(_registry(), slots=2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            svc.submit(SolveRequest("ras"))


# ---------------------------------------------------------------------------
# Slot harvest/seed bookkeeping
# ---------------------------------------------------------------------------
class TestSlotBookkeeping:
    def test_slots_recycle_and_ledger_balances(self):
        svc = _service(_registry(theta=1e-30), slots=2)
        rids = [svc.submit(SolveRequest("ras", seed=s, iter_max=6)) for s in range(5)]
        svc.drain()
        pool = svc._pools["ras"]
        assert not pool.occupied and not pool.queue and not pool.busy.any()
        assert sorted(pool.free) == [0, 1]
        events = [e["event"] for e in svc.ledger]
        for ev in ("submit", "admit", "retire", "done"):
            assert events.count(ev) == 5, ev
        # 5 single-lane requests through 2 slots: reuse was required
        assert {e["slot"] for e in svc.ledger if e["event"] == "admit"} == {0, 1}
        for rid in rids:
            assert svc.state(rid) == "done"

    def test_deadline_budget_is_exact(self):
        # theta=1e-30 never converges: every lane retires DIVERGED after
        # exactly its budget of sweeps, whenever it was admitted
        svc = _service(_registry(theta=1e-30), slots=2)
        rids = [svc.submit(SolveRequest("ras", seed=s, iter_max=4 + s)) for s in range(4)]
        svc.drain()
        for rid in rids:
            res = svc.result(rid)
            assert res.status == DIVERGED
            (lane,) = res.lanes
            assert lane.retire_sweep - lane.admit_sweep == 4 + rid

    def test_mid_flight_admission_happens(self):
        svc = _service(_registry(theta=1e-30), slots=2)
        svc.submit(SolveRequest("ras", seed=0, iter_max=20))
        svc.submit(SolveRequest("ras", seed=1, iter_max=4))
        svc.submit(SolveRequest("ras", seed=2, iter_max=4))
        svc.drain()
        admits = {e["rid"]: e["sweep"] for e in svc.ledger if e["event"] == "admit"}
        # request 2 took request 1's freed slot before request 0 retired
        assert 0 < admits[2] < 20

    def test_drain_then_refill_mode_waits(self):
        svc = _service(_registry(theta=1e-30), slots=2, drain_then_refill=True)
        for s in range(4):
            svc.submit(SolveRequest("ras", seed=s, iter_max=6))
        svc.drain()
        admits = sorted(e["sweep"] for e in svc.ledger if e["event"] == "admit")
        assert admits[0] == admits[1] == 0
        assert admits[2] == admits[3] == 6

    def test_n_starts_aggregation(self):
        svc = _service(_registry(iter_bfgs=24), slots=4)
        rid = svc.submit(SolveRequest("ras", seed=3, n_starts=4))
        svc.drain()
        res = svc.result(rid)
        assert len(res.lanes) == 4
        conv = [l for l in res.lanes if l.status == CONVERGED]
        assert res.n_converged == len(conv)
        if conv:
            assert res.status == CONVERGED
            best = min(conv, key=lambda l: l.fval)
            assert res.best_f == best.fval
            np.testing.assert_array_equal(res.best_x, best.x)

    def test_request_starts_deterministic(self):
        p = _registry().get("ras")
        a = request_starts(p, SolveRequest("ras", seed=9, n_starts=3))
        b = request_starts(p, SolveRequest("ras", seed=9, n_starts=3))
        c = request_starts(p, SolveRequest("ras", seed=10, n_starts=3))
        np.testing.assert_array_equal(a, b)
        assert a.shape == (3, 3) and a.dtype == np.float32 and not np.array_equal(a, c)
        assert (a >= p.objective.lower).all() and (a <= p.objective.upper).all()

    def test_explicit_starts_checked(self):
        p = _registry().get("ras")
        x0 = np.arange(6, dtype=np.float32).reshape(2, 3)
        np.testing.assert_array_equal(
            request_starts(p, SolveRequest("ras", n_starts=2, x0=x0)), x0)
        with pytest.raises(ValueError, match="x0 shape"):
            request_starts(p, SolveRequest("ras", n_starts=3, x0=x0))


# ---------------------------------------------------------------------------
# stats(): JSON-safe, robust to degenerate request histories
# ---------------------------------------------------------------------------
class TestStats:
    def test_stats_json_strict_safe(self):
        import json

        svc = _service(_registry(), slots=2)
        svc.submit(SolveRequest("ras", seed=0, iter_max=6))
        svc.drain()
        st = svc.stats()
        json.dumps(st, allow_nan=False)
        assert st["pool_windows"]["ras"]["n_windows"] > 0
        assert st["pool_windows"]["ras"]["wall_s_total"] > 0.0

    def test_solves_per_sec_none_on_zero_span(self):
        import json

        svc = _service(_registry(theta=1e-30), slots=2)
        rid = svc.submit(SolveRequest("ras", seed=0, iter_max=4))
        svc.drain()
        t = svc._tickets[rid]
        for lane in t.result.lanes:
            lane.t_retire = t.t_submit
        st = svc.stats()
        assert st["solves_per_sec"] is None
        json.dumps(st, allow_nan=False)

    def test_stats_survives_request_with_no_lane_outcomes(self):
        import json

        svc = _service(_registry(theta=1e-30), slots=2)
        rid = svc.submit(SolveRequest("ras", seed=0, iter_max=4))
        svc.drain()
        good = svc._tickets[rid]
        svc._tickets[rid + 1] = _Ticket(
            request=good.request, state="done", budget=4, starts=good.starts,
            t_submit=good.t_submit, submit_sweep=0, pending=0, lanes={},
            result=SolveResult(rid=rid + 1, problem="ras", best_x=None,
                               best_f=float("nan"), status=DIVERGED, n_converged=0,
                               lanes=[]))
        st = svc.stats()
        assert st["n_done"] == 2 and "solves_per_sec" in st
        json.dumps(st, allow_nan=False)


# ---------------------------------------------------------------------------
# lane_deadlines: the reference's validation, message for message
# ---------------------------------------------------------------------------
def _reference_message(kw, hosted):
    """The ValueError message the reference raises for these options (its
    checks run before anything is traced)."""
    import jax.numpy as jnp

    from repro.core import bfgs as jbfgs
    from repro.core import engine as jengine

    entry = jengine.open_multistart if hosted else jengine.run_multistart
    with pytest.raises(ValueError) as err:
        entry(get_objective("sphere").fn, jnp.zeros((2, 2), jnp.float32),
              jbfgs.DenseBFGS(), jengine.EngineOptions(sweep_mode="batched", **kw))
    return str(err.value)


@pytest.mark.parametrize("kw,hosted,match", [
    (dict(lane_deadlines=True, retry_budget=1), False, "incompatible with retry_budget"),
    (dict(lane_deadlines=True, schedule="auto", auto_cost_model=True), False,
     "incompatible with lane_deadlines"),
    (dict(schedule="auto", auto_cost_model=True), True, "open_multistart"),
], ids=["retry", "cost-model", "cost-model-hosted"])
def test_lane_deadline_validation_matches_reference(kw, hosted, match):
    ref = _reference_message(kw, hosted)
    opts = EngineOptions(**kw)
    x0 = torch.zeros((2, 2))
    with pytest.raises(ValueError, match=match) as err:
        if hosted:
            open_multistart(get_objective("sphere").fn, x0, DenseBFGS(), opts, device="cpu")
        else:
            run_multistart(get_objective("sphere").fn, x0, DenseBFGS(), opts, device="cpu")
    assert str(err.value) == ref
    engine.check_engine_options(EngineOptions(lane_deadlines=True))


# ---------------------------------------------------------------------------
# Continuous batching: busy pool == solo solve
# ---------------------------------------------------------------------------
PARITY_GRID = [
    ("batched", None, "static"),
    ("batched", 2, "static"),
    ("batched", None, "auto"),
    ("batched", 2, "auto"),
    ("per_lane", None, "static"),
    ("per_lane", 2, "static"),
    ("megakernel", None, "static"),
    ("batched", None, "static+compact"),
    ("megakernel", 2, "static+repack"),
]


def _run_mixed_scenario(reg):
    """Staggered mixed traffic: seeds, budgets and lane counts differ, the
    second wave arrives mid-flight."""
    svc = _service(reg, slots=4)
    rids = [svc.submit(SolveRequest("ras", seed=0, n_starts=2, iter_max=18)),
            svc.submit(SolveRequest("ras", seed=1, n_starts=1, iter_max=6))]
    svc.pump()
    svc.pump()
    rids += [svc.submit(SolveRequest("ras", seed=2, n_starts=3, iter_max=12)),
             svc.submit(SolveRequest("ras", seed=3, n_starts=1, iter_max=18))]
    svc.drain()
    return svc, rids


@pytest.mark.parametrize("sweep_mode,chunk,schedule", PARITY_GRID)
def test_busy_pool_matches_solo(sweep_mode, chunk, schedule):
    reg = _registry(sweep_mode=sweep_mode, chunk=chunk, schedule=schedule, theta=1e-3)
    svc, rids = _run_mixed_scenario(reg)
    assert any(e["event"] == "admit" and e["sweep"] > 0 for e in svc.ledger)
    for rid in rids:
        _assert_request_parity(svc, reg, rid, exact=schedule != "auto")
    if schedule == "auto":
        svc2, rids2 = _run_mixed_scenario(reg)
        for rid, rid2 in zip(rids, rids2):
            _assert_results_identical(svc.result(rid), svc2.result(rid2))


def test_busy_pool_equals_fresh_service():
    req = SolveRequest("ras", seed=5, n_starts=2, iter_max=10)
    reg = _registry(theta=1e-3)
    busy = _service(reg, slots=4)
    busy.submit(SolveRequest("ras", seed=0, n_starts=2, iter_max=20))
    rid_busy = busy.submit(req)
    busy.drain()
    alone = _service(reg, slots=4)
    rid_alone = alone.submit(req)
    alone.drain()
    for lb, la in zip(busy.result(rid_busy).lanes, alone.result(rid_alone).lanes):
        np.testing.assert_array_equal(lb.x, la.x)
        assert (lb.fval, lb.grad_norm, lb.status, lb.n_evals) == (
            la.fval, la.grad_norm, la.status, la.n_evals)


def test_mixed_problem_pools_are_independent(tmp_path):
    import json

    reg = ProblemRegistry()
    reg.register("ras4", "rastrigin", 4, opts=_zopts(iter_bfgs=20))
    reg.register("ack2", "ackley", 2, opts=_zopts(iter_bfgs=20))
    reg.register("ros3", "rosenbrock", 3, opts=_zopts(iter_bfgs=24, chunk=2))
    svc = _service(reg, slots=4)
    rids = []
    for s in range(6):
        rids.append(svc.submit(SolveRequest(["ras4", "ack2", "ros3"][s % 3], seed=s,
                                            n_starts=2, iter_max=14 + 5 * (s % 2))))
        svc.pump()
    svc.drain()
    svc.dump_ledger(str(tmp_path / "ledger.json"))
    assert len(json.loads((tmp_path / "ledger.json").read_text())) == len(svc.ledger)
    assert len(svc.results()) == 6
    for rid in rids:
        _assert_request_parity(svc, reg, rid)


# ---------------------------------------------------------------------------
# Against the JAX service: the ledger event for event
# ---------------------------------------------------------------------------
# (n_starts, iter_max) of the first wave, submitted at sweep 0, and of the
# second, submitted after two pumps
WAVES = (((2, 7), (1, 4), (1, 9)), ((2, 4), (1, 4), (1, 3)))


def _stream(reg, request, admit_every=1, drain_then_refill=False, service=None, **kw):
    """The same arrivals into a port or reference service, explicit starts
    from a numpy seed."""
    rng = np.random.default_rng(17)
    svc = service(reg, slots=4, admit_every=admit_every,
                  drain_then_refill=drain_then_refill, **kw)
    dim = reg.get("p").dim
    for w, wave in enumerate(WAVES):
        if w:
            svc.pump()
            svc.pump()
        for n, budget in wave:
            svc.submit(request("p", n_starts=n, iter_max=budget,
                               x0=rng.uniform(-4.0, 4.0, (n, dim)).astype(np.float32)))
    svc.drain()
    return svc


def run_against_reference(objective, dim, theta, admit_every=1, drain_then_refill=False,
                          engine=None):
    """(port service, reference service) over the same stream, batched sweep
    (with the BFGSOptions in `engine`), the reference on its jnp kernels."""
    from repro.core import BFGSOptions as JBFGSOptions
    from repro.core import ZeusOptions as JZeusOptions
    from repro.kernels.ops import reference_kernels_off_tpu
    from repro.serve import service as jservice

    common = dict(iter_bfgs=24, theta=theta, ad_mode="reverse", ls_iters=12,
                  sweep_mode="batched", **(engine or {}))
    jreg = jservice.ProblemRegistry()
    jreg.register("p", objective, dim, opts=JZeusOptions(bfgs=JBFGSOptions(**common)))
    preg = ProblemRegistry()
    preg.register("p", objective, dim, opts=ZeusOptions(bfgs=BFGSOptions(**common)))
    with reference_kernels_off_tpu():
        ref = _stream(jreg, jservice.SolveRequest, admit_every, drain_then_refill,
                      service=jservice.SolveService)
    port = _stream(preg, SolveRequest, admit_every, drain_then_refill,
                   service=SolveService, device="cpu")
    return port, ref


def assert_ledgers_equal(port, ref):
    """Every event's fields but its clock, event for event, and the pools'
    sweep counts."""
    strip = [[{k: v for k, v in e.items() if k != "t"} for e in s.ledger]
             for s in (port, ref)]
    assert len(strip[0]) == len(strip[1])
    for i, (a, b) in enumerate(zip(*strip)):
        assert a == b, f"event {i}: port {a}, reference {b}"
    assert port.stats()["pool_sweeps"] == ref.stats()["pool_sweeps"]


@pytest.mark.parametrize("admit_every", [1, 3])
def test_ledger_matches_reference_service(admit_every):
    port, ref = run_against_reference("rastrigin", 3, 1e-30, admit_every=admit_every)
    assert_ledgers_equal(port, ref)
    assert all(r.status == DIVERGED for r in port.results().values())
    budget = {e["rid"]: e["iter_max"] for e in port.ledger if e["event"] == "submit"}
    last = max(e["sweep"] + budget[e["rid"]] for e in port.ledger if e["event"] == "admit")
    # with admit_every=3 the last lanes' deadline (13) falls inside a
    # segment: the sweep that freezes them steps nothing and still counts
    assert port.stats()["pool_sweeps"]["p"] == last + (admit_every == 3)
