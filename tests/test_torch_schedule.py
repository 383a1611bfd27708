"""The port's sweep schedules (engine compact_every, repack_every and
schedule="auto"/"replay") against the JAX package and against the port's
own static sweep.

- The pure planners against the reference's on seeded numpy inputs: the
  power-of-two buckets, the compaction and repack plans (perm and bucket
  index), the auto controller's ladders and plan lattice, and the decoding
  of a schedule trace.
- Every invalid option combination the reference rejects raises ValueError
  in the port too.
- Inside the port every schedule is array-equal to the static sweep (the
  reference's own contract): dense BFGS on the batched and megakernel
  sweeps and L-BFGS on the batched sweep, compacted, repacked, both, auto
  and replayed. Auto plans with shorter ladders consume fewer logical
  probes, so n_evals is held between an auto solve and its replay, not
  against the static one.
- The counters on starts with lanes converged at init (rosenbrock's
  optimum has an exactly zero gradient): map_trips and eval_rows as the
  reference's formulas give them (tests/test_repack.py).
- The controller, a host function of plain ints here, on a table of cases
  covering each of its branches, and the trace of a solve.

No solve of the reference runs here: the oracles are the port's static
solves and the reference's planners, since the reference's scheduled
solves cost many times a static one on the CPU. Sizes stay small: B = 32,
D = 4, C = 8, 12 sweeps.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jengine  # noqa: E402
from repro.core.bfgs import DenseBFGS as JDenseBFGS  # noqa: E402
from repro.core.objectives import sphere as jsphere  # noqa: E402
from repro_torch.core import (  # noqa: E402
    BFGSOptions,
    EngineOptions,
    LBFGSOptions,
    auto_plan_lattice,
    batched_bfgs,
    batched_lbfgs,
    get_objective,
    run_multistart,
    schedule_trace_plans,
)
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.bfgs import DenseBFGS  # noqa: E402

B, D, C, SWEEPS, K = 32, 4, 8, 12, 8
LADDERS = (2, 0)  # {2-rung, full} x {static, dynamic}: 4 plans
# the dynamic plan latches once fewer than 90% of the lanes are active:
# within the 12 sweeps of these solves (the default 0.5 would never latch)
AUTO = dict(schedule="auto", schedule_every=2, auto_ladders=LADDERS, auto_active_frac=0.9)
PATHS = ("bfgs-batched", "bfgs-megakernel", "lbfgs-batched")
HARD_START = [-1.2, 1.0]  # rosenbrock: never converges at theta = 1e-30


@pytest.fixture(autouse=True, scope="module")
def _strict_fp32():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


# ---------------------------------------------------------------------------
# planners against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lo", [1, 17, 33, 49])
def test_compaction_buckets_match_reference(lo):
    for n in range(lo, lo + 16):
        assert engine._compaction_buckets(n) == jengine._compaction_buckets(n), n


def _mask(n, seed, p):
    return np.random.default_rng(seed).random(n) < p


@pytest.mark.parametrize("n", [1, 7, 16, 33])
@pytest.mark.parametrize("chunk", [2, 4, 8])
def test_plans_match_reference(n, chunk):
    """The compaction plan of a group of n lanes and the repack plan of n
    flat lanes in chunks of `chunk`, at several active shares: the same
    perm and bucket index as the reference's."""
    buckets = jengine._compaction_buckets(n)
    cbuckets = jengine._compaction_buckets(-(-n // chunk))
    for seed, p in enumerate((0.0, 0.2, 0.5, 0.9, 1.0)):
        active = _mask(n, seed + 10 * n + chunk, p)
        jperm, jbidx = jengine._compaction_plan(jnp.asarray(active),
                                                jnp.asarray(buckets, jnp.int32))
        perm, bidx = engine._compaction_plan(torch.from_numpy(active), buckets)
        np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
        assert bidx == int(jbidx)
        # the engine passes the count it already read back; same plan
        assert engine._compaction_plan(torch.from_numpy(active), buckets,
                                       int(active.sum()))[1] == bidx
        jg, jgc = jengine._repack_plan(jnp.asarray(active), chunk,
                                       jnp.asarray(cbuckets, jnp.int32))
        g, gc = engine._repack_plan(torch.from_numpy(active), chunk, cbuckets)
        np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
        assert gc == int(jgc)


@pytest.mark.parametrize("ls_iters", [1, 5, 20])
@pytest.mark.parametrize("ladders", [None, (0,), (1, 3, 20), (2, 8)])
def test_auto_ladders_and_lattice_match_reference(ls_iters, ladders):
    kw = dict(ls_iters=ls_iters, auto_ladders=ladders)
    try:
        want = jengine._auto_ladders(jengine.EngineOptions(**kw))
    except ValueError:
        with pytest.raises(ValueError, match="auto_ladders"):
            engine._auto_ladders(EngineOptions(**kw))
        with pytest.raises(ValueError, match="auto_ladders"):
            auto_plan_lattice(EngineOptions(**kw))
        return
    assert engine._auto_ladders(EngineOptions(**kw)) == want
    assert auto_plan_lattice(EngineOptions(**kw)) == jengine.auto_plan_lattice(
        jengine.EngineOptions(**kw))


def test_schedule_trace_plans_match_reference():
    traces = [np.zeros((3, 4), np.int32), np.eye(4, dtype=np.int32)[[1, 3, 0, 2]],
              np.array([[0, 0, 1, 0], [1, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]],
                       np.int32)]
    for t in traces:
        want = jengine.schedule_trace_plans(t)
        assert schedule_trace_plans(t) == want
        assert schedule_trace_plans(torch.from_numpy(t)) == want


# ---------------------------------------------------------------------------
# what the reference rejects
# ---------------------------------------------------------------------------
INVALID = {
    "compact<0": dict(sweep_mode="batched", compact_every=-1),
    "compact-per_lane": dict(sweep_mode="per_lane", compact_every=1),
    "repack<0": dict(sweep_mode="batched", repack_every=-1, lane_chunk=4),
    "repack-per_lane": dict(sweep_mode="per_lane", repack_every=1, lane_chunk=4),
    "repack-no-chunk": dict(sweep_mode="batched", repack_every=1),
    "ladder-per_lane": dict(sweep_mode="per_lane", ladder_len=2),
    "unknown-schedule": dict(sweep_mode="batched", schedule="manual"),
    "auto-per_lane": dict(sweep_mode="per_lane", schedule="auto"),
    "auto-compact": dict(sweep_mode="batched", schedule="auto", compact_every=1),
    "auto-ladder": dict(sweep_mode="batched", schedule="auto", ladder_len=2),
    "auto-repack": dict(sweep_mode="batched", schedule="auto", repack_every=1,
                        lane_chunk=4),
    "window-0": dict(sweep_mode="batched", schedule="auto", schedule_every=0),
    "bad-ladders": dict(sweep_mode="batched", schedule="auto", ls_iters=10,
                        auto_ladders=(12,)),
    "replay-no-plans": dict(sweep_mode="batched", schedule="replay"),
    "replay-short": dict(sweep_mode="batched", schedule="replay", iter_max=40,
                         schedule_every=4, schedule_plans=(0, 0)),
    "replay-index": dict(sweep_mode="batched", schedule="replay", iter_max=8,
                         schedule_every=4, schedule_plans=(99, 0),
                         auto_ladders=LADDERS),
    "cost-model-static": dict(sweep_mode="batched", auto_cost_model=True),
}


@pytest.mark.parametrize("name", list(INVALID))
def test_invalid_combinations_raise_as_in_reference(name):
    kw = INVALID[name]
    x0 = np.zeros((8, 2), np.float32)
    with pytest.raises(ValueError):
        jengine.run_multistart(jsphere, jnp.asarray(x0), JDenseBFGS(),
                               jengine.EngineOptions(**kw))
    with pytest.raises(ValueError):
        engine.check_engine_options(EngineOptions(**kw))
    with pytest.raises(ValueError):
        run_multistart(get_objective("sphere").fn, x0, DenseBFGS(), EngineOptions(**kw),
                       device="cpu")


# ---------------------------------------------------------------------------
# every schedule array-equal to the static sweep, inside the port
# ---------------------------------------------------------------------------
X0 = np.random.default_rng(22).uniform(-5.12, 5.12, (B, D)).astype(np.float32)


def _solve(path, **kw):
    obj = get_objective("rastrigin")
    solver, mode = path.split("-")
    base = dict(theta=1e-3, ls_iters=K, sweep_mode=mode, **kw)
    if solver == "bfgs":
        return batched_bfgs(obj.fn, X0, BFGSOptions(iter_bfgs=SWEEPS, **base), device="cpu")
    return batched_lbfgs(obj.fn, X0, LBFGSOptions(iter_max=SWEEPS, ad_mode="forward",
                                                  **base), device="cpu")


@pytest.fixture(scope="module")
def static():
    return {path: _solve(path) for path in PATHS}


@pytest.fixture(scope="module")
def autos():
    return {(path, chunk): _solve(path, lane_chunk=chunk, **AUTO)
            for path in PATHS for chunk in (None, C)}


def _assert_trajectory_equal(ref, got):
    for field in ("x", "fval", "grad_norm", "status"):
        assert torch.equal(getattr(got, field), getattr(ref, field)), field
    assert got.iterations == ref.iterations
    assert got.n_converged == ref.n_converged


SCHEDULES = {
    "compact1": dict(compact_every=1),
    "compact3": dict(compact_every=3),
    "repack": dict(repack_every=1, lane_chunk=C),
    "repack-compact": dict(repack_every=1, compact_every=1, lane_chunk=C),
    "repack2-compact1": dict(repack_every=2, compact_every=1, lane_chunk=C),
}


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_static_schedules_equal_static_sweep(static, path, schedule):
    ref = static[path]
    got = _solve(path, **SCHEDULES[schedule])
    _assert_trajectory_equal(ref, got)
    assert torch.equal(got.n_evals, ref.n_evals)
    assert ref.iterations == SWEEPS and 0 < ref.n_converged < B
    # the schedules only ever skip work
    assert got.eval_rows <= ref.eval_rows
    assert got.schedule_trace is None


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("chunk", [None, C], ids=["unchunked", "chunked"])
def test_auto_equals_static_sweep_and_replay_equals_auto(static, autos, path, chunk):
    auto = autos[path, chunk]
    _assert_trajectory_equal(static[path], auto)
    n_windows, n_plans = -(-SWEEPS // 2), 2 * len(LADDERS)
    assert tuple(auto.schedule_trace.shape) == (n_windows, n_plans)
    assert auto.schedule_trace.dtype == torch.int32
    plans = schedule_trace_plans(auto.schedule_trace)
    # the controller left the startup plan (the full-ladder static one)
    # and latched the dynamic plan
    assert plans[0] == len(LADDERS) - 1 and max(plans) >= len(LADDERS)
    rep = _solve(path, schedule="replay", schedule_every=2, auto_ladders=LADDERS,
                 lane_chunk=chunk, schedule_plans=plans)
    _assert_trajectory_equal(auto, rep)
    assert torch.equal(rep.n_evals, auto.n_evals)
    assert (rep.eval_rows, rep.map_trips) == (auto.eval_rows, auto.map_trips)
    assert torch.equal(rep.schedule_trace, auto.schedule_trace)


# ---------------------------------------------------------------------------
# counters, on starts with lanes converged at init
# ---------------------------------------------------------------------------
def _frozen_mix(frozen):
    frozen = np.asarray(frozen, bool)
    x0 = np.tile(np.asarray([HARD_START], np.float32), (frozen.shape[0], 1))
    x0[frozen] = 1.0
    return x0


def _counted(x0, **kw):
    return batched_bfgs(get_objective("rosenbrock").fn, x0,
                        BFGSOptions(iter_bfgs=3, theta=1e-30, ls_iters=6,
                                    sweep_mode="batched", **kw), device="cpu")


def _bucket(n, count):
    buckets = jengine._compaction_buckets(n)
    return next((b for b in buckets if b >= count), buckets[-1])


@pytest.mark.parametrize("n_frozen", [0, 3, 9, 13, 15])
def test_counters_follow_the_reference_formulas(n_frozen):
    """16 lanes, the first n_frozen converged at init, chunks of 4, 3
    sweeps, 6 rungs: repacking pays bucket(ceil(active / 4)) chunk-steps a
    sweep, compaction a bucket of each chunk's active lanes, and both give
    the static solve's lanes."""
    nB, nC, S, nK = 16, 4, 3, 6
    x0 = _frozen_mix([True] * n_frozen + [False] * (nB - n_frozen))
    static = _counted(x0, lane_chunk=nC)
    rep = _counted(x0, lane_chunk=nC, repack_every=1)
    m = _bucket(nB // nC, -(-(nB - n_frozen) // nC))
    assert rep.map_trips == S * m
    assert rep.eval_rows == nB + S * m * nC * (nK + 1)
    assert static.map_trips == S * (nB // nC)
    assert static.eval_rows == nB + S * nB * (nK + 1)
    # per-chunk compaction: every chunk steps, each its own bucket
    com = _counted(x0, lane_chunk=nC, compact_every=1)
    active = [min(nC, max(0, (i + 1) * nC - n_frozen)) for i in range(nB // nC)]
    assert com.map_trips == S * (nB // nC)
    assert com.eval_rows == nB + S * sum(_bucket(nC, a) for a in active) * (nK + 1)
    # unchunked compaction: one bucket of the whole swarm's active lanes
    one = _counted(x0, compact_every=1)
    assert one.map_trips == S
    assert one.eval_rows == nB + S * _bucket(nB, nB - n_frozen) * (nK + 1)
    # repacked chunks compacted inside: the active lanes fill them in order
    both = _counted(x0, lane_chunk=nC, repack_every=1, compact_every=1)
    inner = [_bucket(nC, min(nC, max(0, nB - n_frozen - j * nC))) for j in range(m)]
    assert both.map_trips == S * m
    assert both.eval_rows == nB + S * sum(inner) * (nK + 1)
    for res in (rep, com, one, both):
        _assert_trajectory_equal(static, res)
        assert torch.equal(res.n_evals, static.n_evals)


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------
EFF = (2, 4, 8)  # candidates' effective ladder lengths; 8 = the full ladder


def _state(plan=2, dyn_on=False, prev=-1):
    return engine._AutoState(plan=plan, dyn_on=dyn_on, prev_lidx=prev)


def _hist(rungs, K=8):
    return tuple(int(c) for c in np.bincount(np.asarray(rungs, int), minlength=K + 1))


# (name, state, n_active, histogram, expected state); act_thresh = 10
CONTROLLER_CASES = [
    ("empty window keeps plan", _state(2, False, 1), 50, (0,) * 9, _state(2, False, 1)),
    ("empty window latches dynamic", _state(2, False, -1), 9, (0,) * 9,
     _state(5, True, -1)),
    ("latch is sticky", _state(4, True, 1), 500, (0,) * 9, _state(4, True, 1)),
    ("shorter adopted at once", _state(2, False, -1), 50, _hist([0] * 10),
     _state(0, False, 0)),
    ("p90 on rung 2 needs 3 rungs", _state(2, False, -1), 50,
     _hist([0] * 5 + [2] * 5), _state(1, False, 1)),
    ("p90 rounds up", _state(2, False, -1), 50, _hist([0] * 9 + [3] * 2),
     _state(1, False, 1)),
    ("longer waits for a second window", _state(0, False, -1), 50, _hist([5] * 4),
     _state(0, False, 2)),
    ("longer adopted when two windows agree", _state(0, False, 2), 50, _hist([5] * 4),
     _state(2, False, 2)),
    ("longer than prev candidate waits", _state(0, False, 1), 50, _hist([5] * 4),
     _state(0, False, 2)),
    ("exhausted lanes map to the full ladder", _state(3, True, -1), 50,
     _hist([8] * 3), _state(3, True, 2)),
    ("same candidate keeps plan", _state(4, True, 1), 5, _hist([1, 2, 3]),
     _state(4, True, 1)),
    ("shorter with dynamic latched", _state(5, True, 2), 5, _hist([0, 0, 1]),
     _state(3, True, 0)),
]


@pytest.mark.parametrize("case", CONTROLLER_CASES, ids=[c[0] for c in CONTROLLER_CASES])
def test_controller_table(case):
    _, state, n_active, hist, want = case
    assert engine._auto_controller(state, n_active, hist, EFF, 10.0) == want


def test_trace_counts_one_plan_per_executed_window():
    """A solve that stops early: one count in each window it ran, none
    after; the startup plan is the full-ladder static one."""
    obj = get_objective("sphere")
    x0 = np.random.default_rng(1).uniform(-5, 5, (16, 3)).astype(np.float32)
    res = batched_bfgs(obj.fn, x0, BFGSOptions(iter_bfgs=40, theta=1e-4, ls_iters=10,
                                               schedule="auto", schedule_every=2,
                                               auto_ladders=LADDERS), device="cpu")
    trace = res.schedule_trace.numpy()
    assert trace.shape == (20, 4) and res.iterations < 40
    executed = -(-res.iterations // 2)
    np.testing.assert_array_equal(trace.sum(axis=1)[:executed], 1)
    np.testing.assert_array_equal(trace.sum(axis=1)[executed:], 0)
    lattice = auto_plan_lattice(EngineOptions(ls_iters=10, auto_ladders=LADDERS))
    assert trace[0, lattice.index((0, 0))] == 1


def test_dynamic_plan_latches_on_a_frozen_tail():
    """24 of 32 lanes converged at init: the dynamic plan latches in the
    first window, and repacking steps 2 chunks of 4 a sweep instead of 8."""
    x0 = _frozen_mix([True] * 24 + [False] * 8)
    kw = dict(iter_bfgs=6, theta=1e-30, ls_iters=10, lane_chunk=4, sweep_mode="batched")
    static = batched_bfgs(get_objective("rosenbrock").fn, x0, BFGSOptions(**kw),
                          device="cpu")
    auto = batched_bfgs(get_objective("rosenbrock").fn, x0, BFGSOptions(
        schedule="auto", schedule_every=1, auto_ladders=LADDERS, **kw), device="cpu")
    _assert_trajectory_equal(static, auto)
    assert static.map_trips == 6 * 8 and auto.map_trips == 6 * 2
    trace = auto.schedule_trace.numpy()
    assert trace[:, 2:].sum() == 6 and trace[:, :2].sum() == 0


@pytest.mark.parametrize("kw", [dict(compact_every=1),
                                dict(repack_every=1, compact_every=2, lane_chunk=C),
                                AUTO, dict(AUTO, lane_chunk=C)],
                         ids=["compact", "repack", "auto", "auto-chunked"])
def test_schedules_plan_from_the_one_readback_a_sweep(monkeypatch, kw):
    """The schedules read nothing back beyond the stop counts' one transfer
    a sweep: every plan gets its active count from that transfer (the
    planners never count on the device themselves)."""
    calls = {"stop_counts": 0, "plans": 0}

    def counted(fn, key):
        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    def planner(fn):
        def wrapper(active, *args):
            assert len(args) == (2 if fn is real_repack else 1) + 1, "no host count given"
            calls["plans"] += 1
            return fn(active, *args)
        return wrapper

    real_repack = engine._repack_plan
    monkeypatch.setattr(engine, "_stop_counts", counted(engine._stop_counts, "stop_counts"))
    monkeypatch.setattr(engine, "_compaction_plan", planner(engine._compaction_plan))
    monkeypatch.setattr(engine, "_repack_plan", planner(real_repack))
    res = _solve("bfgs-batched", **kw)
    assert calls["stop_counts"] == res.iterations + 1
    assert calls["plans"] > 0
