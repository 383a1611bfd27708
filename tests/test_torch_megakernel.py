"""The port's sweep megakernel (sweep_mode="megakernel", kernels B5/B5b) and
adaptive Armijo ladder (ladder_len) against the JAX package, and against
the port's own batched sweep.

- The plain versions of B5 and B5b against the reference's Pallas
  megakernels (interpret mode) on the same inputs, with frozen lanes and an
  ackley lane at the origin: rungs equal except certified knife edges
  (ROADMAP C2), state within C3.
- The adaptive ladder against the reference's and against the port's full
  ladder, with a lane whose Armijo threshold is NaN.
- On the CPU both kernels run their plain versions, which compose the
  staged sweep's own plain functions: the megakernel sweep, step and solve
  are array-equal to the batched ones (the reference's own contract,
  re-established inside the port).
- Three sweeps of the reference's megakernel step taken from the port's
  exact state; the gate that sends other solves to the batched sweep; the
  names `repro_torch.core` exports against the reference's.

Every input comes from a numpy seed; sizes stay small (B = 16, D <= 8).
"""
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import bfgs as jbfgs  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import linesearch as jls  # noqa: E402
from repro.core import objectives as jobj  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ops import reference_kernels_off_tpu  # noqa: E402
import repro_torch.core as pcore  # noqa: E402
from repro_torch.core import (  # noqa: E402
    BatchedDenseBFGS,
    BFGSOptions,
    EngineOptions,
    LBFGS,
    PSOOptions,
    ZeusOptions,
    get_objective,
    run_multistart,
    zeus,
    zeus_jit,
)
from repro_torch.core import engine, linesearch, objectives  # noqa: E402
from repro_torch.kernels import ops, sweep_megakernel  # noqa: E402
from test_torch_zeus import ITER_LS, _assert_close_per_lane, _knife_edge_rung  # noqa: E402

B, D, K, C1 = 16, 8, ITER_LS, 0.3
BOX = {"sphere": 5.0, "rastrigin": 5.12, "rosenbrock": 2.0, "ackley": 32.768}
# names of the reference's repro.core.__all__ that the port has not yet, by
# ROADMAP item
NOT_PORTED = {"HostedSolve": "A13", "open_multistart": "A13",
              "auto_plan_lattice": "A8", "schedule_trace_plans": "A8",
              "distributed_zeus": "A14"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _sweep_inputs(name, seed, ascent=False):
    """One lane stack: starts in the box, a symmetric H near I, G = ∇f, the
    descent P = −HG (scaled up on some lanes, so that their search
    backtracks deeper), every fifth lane frozen; for ackley, lane 0 at the
    origin with P = 0 (its gradient is NaN there); with `ascent`, lane 1
    going uphill (P = G), where the ladder may run out."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-BOX[name], BOX[name], (B, D)).astype(np.float32)
    if name == "ackley":
        X[0] = 0.0
    A = (0.1 / np.sqrt(D)) * rng.standard_normal((B, D, D))
    H = (np.eye(D) + 0.5 * (A + A.transpose(0, 2, 1))).astype(np.float32)
    F, G = (t.numpy() for t in ops.fused_value_grad(name, _t(X)))
    P = -np.einsum("bij,bj->bi", H, np.nan_to_num(G)).astype(np.float32)
    P *= (2.0 ** rng.integers(0, 6, (B, 1))).astype(np.float32)
    if ascent:
        P[1] = G[1]
    if name == "ackley":
        P[0] = 0.0
    active = np.arange(B) % 5 != 4
    return dict(X=X, P=P, G=G, H=H, F=F, active=active)


def _thresholds(F, G, P):
    alphas = torch.from_numpy(linesearch.ladder_alphas(K, np.float32))
    return linesearch.armijo_thresholds(_t(F), torch.sum(_t(G) * _t(P), dim=-1),
                                        alphas, C1), alphas


def _nonfinite_equal_then_close(got, ref, msg):
    """Non-finite entries in the same places, then C3 on the rest."""
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref), err_msg=msg)
    fin = np.isfinite(ref)
    _assert_close_per_lane(np.where(fin, got, 0.0), np.where(fin, ref, 0.0), msg)


def _p_close(p, ref_p, ref_H, ref_g, msg):
    """C3 for p' = −H'g': within 1e-4 of (|H'|·|g'|)_i."""
    np.testing.assert_array_equal(np.isfinite(p), np.isfinite(ref_p), err_msg=msg)
    bound = 1e-4 * np.einsum("bij,bj->bi", np.abs(ref_H), np.abs(np.nan_to_num(ref_g)))
    fin = np.isfinite(ref_p)
    assert (np.abs(np.where(fin, p - ref_p, 0.0)) <= bound + 1e-6).all(), msg


def _odd_rungs(name, inp, rung, ref_rung):
    """Lanes whose rungs differ, each certified a knife edge (C2)."""
    odd = np.nonzero(np.asarray(rung) != np.asarray(ref_rung))[0]
    pre = types.SimpleNamespace(x=_t(inp["X"]), p=_t(inp["P"]), g=_t(inp["G"]),
                                f=_t(inp["F"]))
    pb = objectives.as_batched(get_objective(name))
    for i in odd:
        r = min(int(rung[i]), int(ref_rung[i]))
        margin = _knife_edge_rung(pb, pre, i, r, C1)
        assert margin <= 1e-5, (name, int(i), int(rung[i]), int(ref_rung[i]), margin)
    return set(odd.tolist())


@pytest.mark.parametrize("name", ["sphere", "rastrigin", "ackley"])
def test_plain_megakernels_match_reference_pallas(name):
    inp = _sweep_inputs(name, seed=11, ascent=True)
    rhs, alphas = _thresholds(inp["F"], inp["G"], inp["P"])
    args = [_t(inp[k]) for k in ("X", "P", "G", "H")] + [_t(inp["active"])]
    got = sweep_megakernel.sweep_megakernel_full_plain(
        name, *args, rhs, alphas, linesearch.exhaustion_alpha(K))
    jargs = [jnp.asarray(inp[k]) for k in ("X", "P", "G", "H", "active")]
    ref = jax.device_get(jops.sweep_megakernel_full(
        name, *jargs, jnp.asarray(rhs.numpy()), alphas.numpy()))
    x, f, g, H, p, alpha, rung = (t.numpy() for t in got)
    odd = _odd_rungs(name, inp, rung, ref[6])
    keep = np.array([i not in odd for i in range(B)])
    np.testing.assert_array_equal(alpha[keep], ref[5][keep])
    for field, a, r in (("x", x, ref[0]), ("f", f[:, None], ref[1][:, None]),
                        ("g", g, ref[2]), ("H", H, ref[3])):
        _nonfinite_equal_then_close(a[keep], r[keep], f"{name} full {field}")
    _p_close(p[keep], ref[4][keep], ref[3][keep], ref[2][keep], f"{name} full p")
    # the frozen lanes keep H exactly
    frozen = ~inp["active"]
    np.testing.assert_array_equal(H[frozen], inp["H"][frozen])

    # B5b from the accepted α: the commit of the full sweep, bit for bit
    commit = sweep_megakernel.sweep_megakernel_commit_plain(name, *args, got[5])
    for a, b in zip(commit, got[:5]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    ref_c = jax.device_get(jops.sweep_megakernel_commit(
        name, *jargs, jnp.asarray(alpha)))
    for field, a, r in (("x", x, ref_c[0]), ("f", f[:, None], ref_c[1][:, None]),
                        ("g", g, ref_c[2]), ("H", H, ref_c[3])):
        _nonfinite_equal_then_close(a, r, f"{name} commit {field}")
    _p_close(p, ref_c[4], ref_c[3], ref_c[2], f"{name} commit p")
    if name == "ackley":  # the origin lane: f finite, ∇f NaN, H kept
        assert np.isfinite(f[0]) and np.isnan(g[0]).all()
        np.testing.assert_array_equal(H[0], inp["H"][0])


@pytest.mark.parametrize("L", [1, 4])
def test_adaptive_ladder_matches_reference_and_full_ladder(L):
    name = "rastrigin"
    inp = _sweep_inputs(name, seed=12)
    F0 = inp["F"].copy()
    F0[2] = np.nan  # a NaN threshold: the lane can never accept
    args = (_t(inp["X"]), _t(inp["P"]), _t(F0), _t(inp["G"]))
    pb = objectives.as_batched(get_objective(name))
    full = linesearch.armijo_backtracking_batch(pb.value_batch, *args, c1=C1, max_iters=K)
    short = linesearch.armijo_backtracking_batch(pb.value_batch, *args, c1=C1,
                                                 max_iters=K, ladder_len=L)
    with reference_kernels_off_tpu():
        jb = jobj.as_batched(jobj.get_objective(name))
        # jitted: one compile of the unrolled fallback, not one per rung
        ladder = jax.jit(lambda *a: jls.armijo_backtracking_batch(
            jb.value_batch, *a, c1=C1, max_iters=K, ladder_len=L))
        ref = jax.device_get(ladder(*(jnp.asarray(a.numpy()) for a in args)))
    rung = short.rung.numpy()
    # against the port's full ladder: the same accepts, α and f', bit for bit
    np.testing.assert_array_equal(rung, full.rung.numpy())
    live = np.arange(B) != 2
    np.testing.assert_array_equal(short.alpha.numpy()[live], full.alpha.numpy()[live])
    np.testing.assert_array_equal(short.f_new.numpy()[live], full.f_new.numpy()[live])
    # the NaN lane starts done: it reports exhaustion and keeps α_{L−1}·shrink
    alphas = linesearch.ladder_alphas(K, np.float32)
    assert rung[2] == K and short.alpha[2] == alphas[L - 1] * np.float32(0.5)
    # n_evals is L + the fallback rungs the live lanes need, never all K
    hist = np.bincount(rung[live], minlength=K + 1)
    assert short.n_evals == L + linesearch.rung_tail_fallback_launches(hist, L) < K
    # against the reference's adaptive ladder
    odd = _odd_rungs(name, dict(inp, F=F0), rung, ref.rung)
    keep = np.array([i not in odd for i in range(B)])
    np.testing.assert_array_equal(short.alpha.numpy()[keep], ref.alpha[keep])
    np.testing.assert_allclose(short.f_new.numpy()[keep], ref.f_new[keep],
                               rtol=1e-5, atol=1e-5)
    assert short.n_evals == int(ref.n_evals)


@pytest.mark.parametrize("L", [0, 1, 3, 19, 20, 25])
def test_rung_tail_fallback_launches_matches_reference(L):
    hists = [np.bincount(r, minlength=K + 1) for r in
             ([0] * 8, [0, 1, 2, 5], [3, 3, 7, 12], [0, K], [K] * 3, [19, 0])]
    for h in hists:
        assert (linesearch.rung_tail_fallback_launches(h, L)
                == jls.rung_tail_fallback_launches(h, L)), (h.tolist(), L)


def _lanes_after(name, sweeps, seed):
    """The port's batched state after `sweeps` sweeps from seeded starts,
    with lanes 3 and 9 marked converged and lane 6 failed (frozen)."""
    rng = np.random.default_rng(seed)
    X0 = _t(rng.uniform(-BOX[name], BOX[name], (B, D)).astype(np.float32))
    pb, ps = objectives.as_batched(get_objective(name)), BatchedDenseBFGS()
    opts = EngineOptions(theta=1e-4)
    lanes = engine.batch_lanes_init(pb, ps, X0, opts.theta)
    for _ in range(sweeps):
        lanes, _, _ = engine.batch_lanes_step(pb, ps, opts, lanes)
    frozen = torch.zeros(B, dtype=torch.bool)
    frozen[[3, 9]] = True
    failed = torch.zeros(B, dtype=torch.bool)
    failed[6] = True
    return pb, ps, lanes._replace(converged=lanes.converged | frozen,
                                  failed=lanes.failed | failed)


def _assert_lanes_equal(a, b, msg):
    for field in engine.BatchLanes._fields:
        np.testing.assert_array_equal(getattr(a, field).numpy(),
                                      getattr(b, field).numpy(), err_msg=f"{msg} {field}")


@pytest.mark.parametrize("name,L", [("rastrigin", 0), ("rastrigin", 3), ("ackley", 0),
                                    ("ackley", 3)])
def test_megakernel_step_equals_batched_step(name, L):
    pb, ps, lanes = _lanes_after(name, sweeps=2, seed=13)
    opts = EngineOptions(theta=1e-4, ladder_len=L)
    assert engine.megakernel_unsupported_reason(pb, ps, D, opts) is None
    staged, rows, rung = engine.batch_lanes_step(pb, ps, opts, lanes)
    mega, mrows, mrung = engine.megakernel_lanes_step(pb, ps, opts, lanes)
    _assert_lanes_equal(mega, staged, f"{name} L={L}")
    assert mrows == rows
    np.testing.assert_array_equal(mrung.numpy(), rung.numpy())
    if L:
        assert rows < (K + 1) * B  # the short ladder ran fewer rows


@pytest.mark.parametrize("L,chunk", [(0, None), (0, 6), (3, None), (3, 6)],
                         ids=["full", "full-chunked", "ladder3", "ladder3-chunked"])
def test_zeus_megakernel_equals_batched(L, chunk):
    obj = get_objective("rastrigin")

    def solve(mode):
        opts = ZeusOptions(pso=PSOOptions(n_particles=20, iter_pso=2),
                           bfgs=BFGSOptions(iter_bfgs=25, theta=1e-4, ladder_len=L),
                           sweep_mode=mode, lane_chunk=chunk)
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)  # no fallback
            return zeus(obj.fn, 6, obj.lower, obj.upper, opts, device="cpu",
                        generator=torch.Generator().manual_seed(3))

    a, b = solve("batched"), solve("megakernel")
    for field in ("x", "fval", "grad_norm", "status", "n_evals"):
        np.testing.assert_array_equal(getattr(b.raw, field).numpy(),
                                      getattr(a.raw, field).numpy(), err_msg=field)
    for field in ("iterations", "n_converged", "eval_rows", "map_trips"):
        assert getattr(b.raw, field) == getattr(a.raw, field), field
    assert torch.equal(b.best_x, a.best_x) and torch.equal(b.best_f, a.best_f)
    assert a.raw.iterations > 3 and a.n_converged > 0


@pytest.mark.parametrize("name", ["rastrigin", "ackley"])
def test_reference_megakernel_steps_port_state(name):
    """Three sweeps: before each, the port's exact state goes to the
    reference's megakernel step as well (its Pallas kernels in interpret
    mode), and the two must accept the same rungs and reach the same status
    on every lane but certified knife edges, with the state within C3."""
    pb, ps, lanes = _lanes_after(name, sweeps=1, seed=14)
    popts = EngineOptions(theta=1e-4)
    jopts = jengine.EngineOptions(sweep_mode="megakernel", theta=1e-4)
    jb, js = jobj.as_batched(jobj.get_objective(name)), jbfgs.BatchedDenseBFGS()
    assert jengine.megakernel_unsupported_reason(jb, js, D, jopts) is None
    for sweep in range(3):
        pre = {k: getattr(lanes, k).numpy() for k in engine.BatchLanes._fields}
        state = jengine.BatchLanes(**{k: jnp.asarray(v) for k, v in pre.items()})
        lanes, _, rung = engine.megakernel_lanes_step(pb, ps, popts, lanes)
        ref, _, hist = jax.device_get(jengine.megakernel_lanes_step(jb, js, jopts, state))
        # per-lane rungs from the reference's staged ladder, whose accepts
        # its megakernel reproduces: the histograms must agree too
        P = np.where((np.sum(pre["p"] * pre["g"], -1) < 0)[:, None], pre["p"], -pre["g"])
        with reference_kernels_off_tpu():
            ref_rung = np.asarray(jls.armijo_backtracking_batch(
                jobj.as_batched(jobj.get_objective(name)).value_batch,
                state.x, jnp.asarray(P), state.f, state.g, c1=C1, max_iters=K).rung)
        active = ~(pre["converged"] | pre["failed"])
        np.testing.assert_array_equal(np.bincount(ref_rung[active], minlength=K + 1),
                                      np.asarray(hist))
        odd = _odd_rungs(name, dict(X=pre["x"], P=pre["p"], G=pre["g"], F=pre["f"]),
                         rung.numpy(), ref_rung)
        flip = np.nonzero(lanes.converged.numpy() != ref.converged)[0]
        for i in set(flip.tolist()) - odd:
            gn = float(torch.linalg.vector_norm(lanes.g[i]))
            assert abs(gn - 1e-4) <= 1e-7, (name, sweep, i, gn)
            odd.add(i)
        keep = np.array([i not in odd for i in range(B)])
        np.testing.assert_array_equal(lanes.failed.numpy()[keep], ref.failed[keep])
        for field in ("x", "f", "g", "direction_state"):
            got, want = getattr(lanes, field).numpy()[keep], getattr(ref, field)[keep]
            _nonfinite_equal_then_close(got if got.ndim > 1 else got[:, None],
                                        want if want.ndim > 1 else want[:, None],
                                        f"{name} sweep {sweep} {field}")


def _gate_case(case):
    """(objective, dim, strategy, EngineOptions overrides) of a solve the
    gate must send to the batched sweep, and the words of its reason."""
    obj = get_objective("sphere")
    if case == "registered":
        return obj, 4, BatchedDenseBFGS(), {}, "no analytic fused kernel body"
    if case == "lbfgs":
        return obj, 4, LBFGS(memory=4), {}, "megakernel_dense_h"
    if case == "ls_iters0":
        return obj, 4, BatchedDenseBFGS(), dict(ls_iters=0), "ls_iters < 1"
    # a ladder so long that the shared memory holds no D = 4 lane
    K_big = (ops.SMEM_PER_BLOCK - 64) // 4 - 16 * 3
    assert ops.megakernel_max_dim(K_big) == 3
    return obj, 4, BatchedDenseBFGS(), dict(ls_iters=K_big, iter_max=2), "exceeds the cap"


@pytest.mark.parametrize("case", ["registered", "lbfgs", "ls_iters0", "dim_cap"])
def test_gate_warns_and_runs_the_batched_sweep(case):
    obj, dim, strategy, over, reason = _gate_case(case)
    x0 = np.random.default_rng(15).uniform(-2, 2, (6, dim)).astype(np.float32)
    base = dict(dict(iter_max=10, theta=1e-4), **over)
    if case == "registered":  # shadow sphere's fused kernel for this test only
        objectives.register_batched_vg(
            "sphere", lambda X: (torch.sum(X * X, -1), 2.0 * X))
    try:
        staged = run_multistart(obj.fn, x0, strategy, EngineOptions(**base), device="cpu")
        with pytest.warns(RuntimeWarning, match=reason):
            mega = run_multistart(obj.fn, x0, strategy,
                                  EngineOptions(sweep_mode="megakernel", **base),
                                  device="cpu")
    finally:
        if case == "registered":
            objectives._BATCHED_VG.pop("sphere")
    for field in ("x", "fval", "status", "n_evals"):
        np.testing.assert_array_equal(getattr(mega, field).numpy(),
                                      getattr(staged, field).numpy(), err_msg=field)
    assert mega.eval_rows == staged.eval_rows


def test_gate_cap_and_rosenbrock(monkeypatch):
    """The cap is the kernel's shared-memory plan; rosenbrock at D = 3 (no
    multiple of the TPU's 128 lanes) runs the megakernel, without warning."""
    pb = objectives.as_batched(get_objective("ackley"))
    opts = EngineOptions()
    cap = ops.megakernel_max_dim(opts.ls_iters)
    assert cap == ops.MEGAKERNEL_MAX_DIM == 3629
    assert (16 * cap + opts.ls_iters) * 4 + 64 <= ops.SMEM_PER_BLOCK
    assert (16 * (cap + 1) + opts.ls_iters) * 4 + 64 > ops.SMEM_PER_BLOCK
    assert engine.megakernel_unsupported_reason(pb, BatchedDenseBFGS(), cap, opts) is None
    assert "exceeds" in engine.megakernel_unsupported_reason(pb, BatchedDenseBFGS(),
                                                             cap + 1, opts)
    steps = []
    step = engine.megakernel_lanes_step
    monkeypatch.setattr(engine, "megakernel_lanes_step",
                        lambda *a: steps.append(1) or step(*a))
    obj = get_objective("rosenbrock")
    x0 = np.random.default_rng(16).uniform(-2, 2, (8, 3)).astype(np.float32)
    base = dict(iter_max=15, theta=1e-4)
    staged = run_multistart(obj.fn, x0, BatchedDenseBFGS(), EngineOptions(**base),
                            device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        mega = run_multistart(obj.fn, x0, BatchedDenseBFGS(),
                              EngineOptions(sweep_mode="megakernel", **base),
                              device="cpu")
    assert len(steps) == mega.iterations > 0
    for field in ("x", "fval", "status", "n_evals"):
        np.testing.assert_array_equal(getattr(mega, field).numpy(),
                                      getattr(staged, field).numpy(), err_msg=field)


def test_core_exports_match_reference():
    """Every name of the reference's repro.core.__all__ imports from
    repro_torch.core, but those still to port (by ROADMAP item)."""
    missing = {n for n in jcore.__all__ if not hasattr(pcore, n)}
    assert missing == set(NOT_PORTED)
    from repro_torch.core import (DirectionStrategy, consensus_point,  # noqa: F401
                                  solver_names)
    assert solver_names() == tuple(sorted(jengine.solver_names()))


def test_zeus_jit_runs_zeus():
    obj = get_objective("ackley")
    opts = ZeusOptions(pso=PSOOptions(n_particles=12, iter_pso=2),
                       bfgs=BFGSOptions(iter_bfgs=10), sweep_mode="megakernel")
    run = zeus_jit(obj.fn, 3, obj.lower, obj.upper, opts, device="cpu")
    a = run(generator=torch.Generator().manual_seed(4))
    b = zeus(obj.fn, 3, obj.lower, obj.upper, opts, device="cpu",
             generator=torch.Generator().manual_seed(4))
    assert torch.equal(a.raw.x, b.raw.x) and torch.equal(a.best_f, b.best_f)
