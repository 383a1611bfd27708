"""The port's HostedSolve (open_multistart, lane_deadlines) on the CPU, and
the solve service against the JAX package's in two more configurations.

- HostedSolve: an empty pool harvests as nothing and does not sweep; a lane
  admitted at k0 with deadline k0 + m runs exactly m sweeps and retires
  with the solo run's x, f, |g|, n_evals and DIVERGED; the sweep that
  freezes the last lanes steps nothing and still counts; admission resets
  n_evals and n_restarts, skips padding and counts the admitted rows in
  eval_rows; a pool with no admission is run_multistart.
- Against the JAX service (explicit starts, jnp kernels; two reference
  drains): drain_then_refill on lane_chunk=2 with compaction and
  repacking at θ = 1e-30, the ledger but its clock event for event, the
  pools' sweeps and chunk-steps equal, eval_rows the reference's net of
  ROADMAP C8 (the reference charges every flat lane an admission, the port
  the admitted rows); and sphere at D = 4, θ = 1e-3: statuses equal, x and
  f within C3's tolerance.
- The serve CLI on --device cpu with the reference's system-test arguments.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    CONVERGED,
    DIVERGED,
    BatchedDenseBFGS,
    EngineOptions,
    get_objective,
    open_multistart,
    run_multistart,
)
from test_torch_service import assert_ledgers_equal, run_against_reference  # noqa: E402

STATE_TOL = 1e-3  # |Δ| <= STATE_TOL · max(1, |reference|), ROADMAP C3
RAS = get_objective("rastrigin")
OPTS = EngineOptions(iter_max=100, theta=1e-30, ad_mode="reverse", ls_iters=12,
                     lane_deadlines=True)


@pytest.fixture(autouse=True, scope="module")
def _strict_fp32():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


def _starts(n, dim=3, seed=4):
    return np.random.default_rng(seed).uniform(-4.0, 4.0, (n, dim)).astype(np.float32)


def _pool(slots=4, **kw):
    import dataclasses

    base = np.zeros((slots, 3), np.float32)
    return open_multistart(RAS.fn, base, BatchedDenseBFGS(),
                           dataclasses.replace(OPTS, **kw), device="cpu")


def _admit(host, carry, slots, X, deadline):
    mask = np.zeros(host.B_flat, bool)
    mask[list(slots)] = True
    Xf = np.zeros((host.B, host.dim), np.float32)
    Xf[list(slots)] = X
    dl = np.where(mask, deadline, 0).astype(np.int32)
    return host.admit(carry, mask, Xf, dl)


def _solo(X, sweeps, slots=4, row=0):
    """X alone in a fresh batch of the pool's width (rows at the pool's
    placeholder starts), iter_max = its budget."""
    Xs = np.zeros((slots, 3), np.float32)
    Xs[row:row + len(X)] = X
    return run_multistart(RAS.fn, Xs, BatchedDenseBFGS(),
                          EngineOptions(iter_max=sweeps, theta=1e-30, ad_mode="reverse",
                                        ls_iters=12), device="cpu")


def test_empty_pool_harvests_nothing_and_does_not_sweep():
    host = _pool()
    carry = host.empty_carry()
    view = host.lane_view(carry)
    assert set(view) == {"k", "x", "f", "grad_norm", "converged", "failed", "n_evals",
                         "deadline"}
    assert view["failed"].all() and not view["converged"].any()
    assert view["x"].shape == (4, 3) and view["x"].dtype == np.float32
    assert view["deadline"].dtype == np.int32 and not view["deadline"].any()
    assert not host.running(carry)
    assert host.segment(carry, 5) is carry and carry.k == 0
    assert (host.B, host.B_flat, host.dim, host.required_c) == (4, 4, 3, 4)


def test_admitted_lane_runs_exactly_its_budget():
    host = _pool()
    carry = host.empty_carry()
    X = _starts(2)
    carry = _admit(host, carry, [0], X[:1], 10)
    carry = host.segment(carry, 2)
    assert carry.k == 2 and host.running(carry)
    # a lane admitted at k0 = 2 with deadline 2 + 5
    carry = _admit(host, carry, [2], X[1:], 7)
    view = host.lane_view(carry)
    assert view["deadline"].tolist() == [10, 0, 7, 0]
    assert view["n_evals"][2] == view["n_evals"][1]  # fresh: one value+grad
    host.segment(carry, 7)
    at7 = host.lane_view(carry)
    solo = _solo(X[1:], 5, row=2)
    np.testing.assert_array_equal(at7["x"][2], solo.x[2].numpy())
    assert at7["f"][2] == float(solo.fval[2])
    assert at7["grad_norm"][2] == float(solo.grad_norm[2])
    assert at7["n_evals"][2] == int(solo.n_evals[2])
    assert int(solo.status[2]) == DIVERGED and not at7["failed"][2]
    # the sweep at its deadline freezes it before stepping: nothing moves
    host.segment(carry, 8)
    at8 = host.lane_view(carry)
    assert at8["failed"][2] and not at8["failed"][0]
    np.testing.assert_array_equal(at8["x"][2], at7["x"][2])
    assert at8["n_evals"][2] == at7["n_evals"][2]
    # lane 0's deadline is 10: sweep 10 freezes it and steps nothing, and
    # still counts
    host.segment(carry, 50)
    assert carry.k == 11 and not host.running(carry)
    end = host.lane_view(carry)
    solo0 = _solo(X[:1], 10)
    np.testing.assert_array_equal(end["x"][0], solo0.x[0].numpy())
    assert end["n_evals"][0] == int(solo0.n_evals[0])
    res = host.finalize(carry)
    assert res.iterations == 11 and (res.status == DIVERGED).all()


def test_admission_resets_counters_and_skips_padding():
    # lane_chunk=3 over 4 slots: flat slots 4 and 5 are padding
    host = _pool(lane_chunk=3)
    assert (host.B, host.B_flat) == (4, 6)
    carry = host.empty_carry()
    rows0 = carry.rows
    mask = np.zeros(6, bool)
    mask[[0, 3, 4, 5]] = True
    Xf = np.zeros((4, 3), np.float32)
    Xf[[0, 3]] = _starts(2)
    host.admit(carry, mask, Xf, np.where(mask, 9, 0).astype(np.int32))
    view = host.lane_view(carry)
    assert view["deadline"].tolist() == [9, 0, 0, 9, 0, 0]
    assert view["failed"].tolist() == [False, True, True, False, True, True]
    assert carry.rows - rows0 == 2 and carry.replan  # the admitted rows (ROADMAP C8)
    fresh = view["n_evals"][0]
    host.segment(carry, 4)
    assert carry.k == 4 and host.lane_view(carry)["n_evals"][0] > fresh
    # re-admitting slot 0 starts a new solve: its counters restart
    mask[:] = False
    mask[0] = True
    host.admit(carry, mask, Xf, np.where(mask, 20, 0).astype(np.int32))
    after = host.lane_view(carry)
    assert after["n_evals"][0] == fresh and after["deadline"].tolist()[:4] == [20, 0, 0, 9]
    assert int(carry.n_restarts[0]) == 0


def test_pool_without_admission_is_run_multistart():
    import dataclasses

    X = _starts(4, seed=9)
    opts = dataclasses.replace(OPTS, lane_deadlines=False, iter_max=12, theta=1e-3)
    host = open_multistart(RAS.fn, X, BatchedDenseBFGS(), opts, device="cpu")
    carry = host.init_carry()
    while host.running(carry):
        host.segment(carry, carry.k + 5)
    got = host.finalize(carry)
    ref = run_multistart(RAS.fn, X, BatchedDenseBFGS(), opts, device="cpu")
    for f in ("x", "fval", "grad_norm", "status", "n_evals"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert (got.iterations, got.eval_rows, got.map_trips) == (
        ref.iterations, ref.eval_rows, ref.map_trips)


def test_drain_then_refill_matches_reference_service():
    kw = dict(lane_chunk=2, compact_every=1, repack_every=1)
    port, ref = run_against_reference("rastrigin", 3, 1e-30, drain_then_refill=True,
                                      engine=kw)
    assert_ledgers_equal(port, ref)
    pc, rc = port._pools["p"].carry, ref._pools["p"].carry
    assert pc.trips == int(rc.trips)
    # the reference charges B_flat rows an admission, the port the admitted rows
    calls = {}
    for e in port.ledger:
        if e["event"] == "admit":
            calls[e["sweep"]] = calls.get(e["sweep"], 0) + 1
    B_flat = port._pools["p"].host.B_flat
    assert int(rc.rows) - pc.rows == sum(B_flat - n for n in calls.values())


def test_converging_service_matches_reference():
    port, ref = run_against_reference("sphere", 4, 1e-3)
    assert set(port.results()) == set(ref.results())
    for rid, res in port.results().items():
        jres = ref.result(rid)
        assert res.status == jres.status and res.status == CONVERGED
        for lane, jlane in zip(res.lanes, jres.lanes):
            assert lane.status == jlane.status
            scale = np.maximum(1.0, np.abs(jlane.x))
            assert (np.abs(lane.x - jlane.x) <= STATE_TOL * scale).all(), rid
            assert abs(lane.fval - jlane.fval) <= STATE_TOL * max(1.0, abs(jlane.fval))


def test_serve_cli_drains_request_stream(capsys):
    """The reference's system test's arguments on the CPU. The reference
    fails it (ROADMAP "Reference-side facts": its seed-1 ackley request ends
    with no lane converged); the port draws its own seeded starts (ROADMAP
    C9), and every request here converges."""
    from repro_torch.launch import serve as S

    results = S.main([
        "--problems", "rastrigin:3,ackley:2", "--requests", "4",
        "--n-starts", "2", "--iter-max", "30", "--slots", "4", "--device", "cpu",
    ])
    assert len(results) == 4
    assert all(r.status == CONVERGED for r in results.values())
    assert all(len(r.lanes) == 2 for r in results.values())
    out = capsys.readouterr().out
    assert "[serve] 4 requests drained" in out and "solves/s" in out
