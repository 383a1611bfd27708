"""float64 solves in the port (ROADMAP A19a) against the JAX package in x64.

Every reference result is computed inside `jax.enable_x64(True)` (the
context manager; the module never switches x64 on globally, which would
turn every later JAX test of the worker to float64), once per module. The
inputs are float64 numpy arrays from `np.random.default_rng(seed)`.

- Kernels: the plain versions of B1a/B1b (all four objectives, D = 1, 5,
  17), B2, B3 and B4 against the JAX `repro.kernels.ops` functions (Pallas
  in interpret mode), to 1e-12 of each row's largest term: both sides sum
  at most 17 terms in float64 and differ only in their order and libm.
- Sweeps: for sphere, rastrigin, rosenbrock and ackley at B = 16, D = 5,
  the reference's batched step applied to the port's state before every
  sweep gives the same accepted rung on every active lane and the same
  status on every lane, and a state
  within 1e-10 of each lane's largest entry (the analogue of ROADMAP C3,
  whose fp32 tolerance is 1e-3). A differing rung is allowed only at an
  Armijo margin <= 1e-12 of max(1, |threshold|) (none appears: ROADMAP C).
- End to end: from the same injected float64 PSO draws, the port's and the
  reference's free-running zeus on rastrigin and rosenbrock (whose float32
  solves fork, ROADMAP C1) reach the same status on every lane and a best_f
  within 1e-10 · max(1, |best_f|).
- The dijet fit: simulated counts equal, the NLL and its forward-mode
  gradient within 1e-12 of the magnitude of their summed terms, and a
  small float64 fit that meets examples/fit_dijet.py's two criteria.
- Refusals: every path float64 does not run yet (ROADMAP A19b-2) raises
  NotImplementedError naming A19b on the CPU, before anything runs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bfgs as jbfgs  # noqa: E402
from repro.core import dual as jdual  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import linesearch as jls  # noqa: E402
from repro.core import objectives as jobj  # noqa: E402
from repro.core.bfgs import BFGSOptions as JBFGSOptions  # noqa: E402
from repro.core.pso import PSOOptions as JPSOOptions  # noqa: E402
from repro.core.zeus import ZeusOptions as JZeusOptions  # noqa: E402
from repro.core.zeus import zeus as jax_zeus  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ops import reference_kernels_off_tpu  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import (  # noqa: E402
    BatchedDenseBFGS,
    BFGSOptions,
    EngineOptions,
    PSOOptions,
    ZeusOptions,
    get_objective,
    open_multistart,
    run_multistart,
    zeus,
)
from repro_torch.core import dual as pdual  # noqa: E402
from repro_torch.core import engine, objectives  # noqa: E402
from repro_torch.core.linesearch import armijo_thresholds, ladder_alphas  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import fused_obj  # noqa: E402
from repro_torch.launch.faults import FaultPlan  # noqa: E402
from repro_torch.serve.service import ProblemRegistry  # noqa: E402
from test_torch_core import ReplayDraws, jax_pso_draws  # noqa: E402

# the x64 context manager of the installed jax
_X64 = getattr(jax, "enable_x64", None)
if _X64 is None:  # older jax: only the experimental spelling
    from jax.experimental import enable_x64 as _X64

F64 = torch.float64
KERNEL_TOL = 1e-12  # of a row's (or lane's) largest term
# the reference's Pallas B2 and B3 accumulate their matvecs in float32 under
# x64 too: they agree with a float64 computation to float32's precision
FLOAT32_ACCUMULATE_TOL = 1e-6
STATE_TOL = 1e-10  # of a lane's largest entry, one sweep
BEST_F_RTOL = 1e-10  # free-running best_f, of max(1, |best_f|)
KNIFE_EDGE = 1e-12  # an Armijo margin, of max(1, |threshold|)
OBJECTIVES = ("sphere", "rastrigin", "rosenbrock", "ackley")
BOX = {"sphere": 5.0, "rastrigin": 5.12, "rosenbrock": 2.0, "ackley": 32.768}
B, D, ITER_LS, THETA = 16, 5, 20, 1e-4
N_PART, ITER_PSO, ITER_BFGS = 16, 2, 30
TRUE = np.array([-2.0, 10.0, 4.5, 0.3])  # examples/fit_dijet.py
EDGES = np.linspace(1000.0, 6000.0, 41)
LOWER, UPPER = -5.0, 15.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rng(seed):
    return np.random.default_rng(seed)


def _row_terms(name, x):
    """Each row's largest term of f (numpy, float64): what a sum's rounding
    is relative to."""
    if name == "sphere":
        t = x * x
    elif name == "rastrigin":
        t = np.abs(x * x) + 10.0
    elif name == "rosenbrock":
        t = (1.0 - x[:, :-1]) ** 2 + 100.0 * (x[:, 1:] - x[:, :-1] ** 2) ** 2
        t = t if t.shape[1] else np.zeros((x.shape[0], 1))
    else:  # ackley: -20·e1 - e2 + e + 20, each part at most 20 in size
        t = np.full(x.shape, 20.0)
    return np.maximum(1.0, np.abs(t).max(axis=1))


def _assert_rows_close(got, want, scale, tol, msg):
    """|got − want| <= tol·scale per row (scale (rows,)), non-finite entries
    equal in place."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want), err_msg=msg)
    fin = np.isfinite(want)
    err = np.where(fin, np.abs(got - np.where(fin, want, 0.0)), 0.0)
    err = err.reshape(err.shape[0], -1).max(axis=1)
    assert (err <= tol * scale).all(), (msg, float((err / scale).max()))


# ---------------------------------------------------------------------------
# Kernels: the plain versions against the Pallas ops in x64
# ---------------------------------------------------------------------------
def _x(name, n, d, seed):
    b = BOX[name]
    x = _rng(seed).uniform(-b, b, (n, d))
    x[0] = 0.0  # ackley's origin: f finite, gradient NaN
    return x


@pytest.mark.parametrize("name", OBJECTIVES)
@pytest.mark.parametrize("d", [1, 5, 17])
def test_fused_plain_matches_pallas_in_float64(name, d):
    x = _x(name, 37, d, seed=d)
    with _X64(True):
        # B1b and B1a in one program: one compilation of the two kernels
        (jf, jg), jv = jax.device_get(jax.jit(lambda a: (
            jops.fused_value_grad(name, a), jops.fused_value(name, a)))(jnp.asarray(x)))
        assert jf.dtype == np.float64 and jv.dtype == np.float64
    pf, pg = fused_obj.value_grad_plain(name, torch.from_numpy(x))
    pv = ops.fused_value(name, torch.from_numpy(x))
    assert pf.dtype == F64 and pg.dtype == F64 and pv.dtype == F64
    assert torch.equal(pv, pf)  # value-only f is value+grad f
    scale = _row_terms(name, x)
    _assert_rows_close(pf.numpy(), jf, scale, KERNEL_TOL, f"{name} D={d} f")
    _assert_rows_close(pv.numpy(), jv, scale, KERNEL_TOL, f"{name} D={d} value f")
    gscale = np.maximum(1.0, np.nan_to_num(np.abs(jg)).max(axis=1))
    _assert_rows_close(pg.numpy(), jg, gscale, KERNEL_TOL, f"{name} D={d} g")


def _update_inputs(b, d, seed):
    rng = _rng(seed)
    a = 0.1 * rng.normal(size=(b, d, d)) / np.sqrt(d)
    H = np.eye(d) + 0.5 * (a + a.transpose(0, 2, 1))
    dx = rng.normal(size=(b, d))
    dg = dx * (1.0 + rng.uniform(size=(b, d)))
    frozen = np.arange(b) % 3 == 0  # the guard's ρ = 0 lanes, pairs zeroed
    rho = np.where(frozen, 0.0, 1.0 / np.sum(dx * dg, -1))
    dx[frozen] = 0.0
    dg[frozen] = 0.0
    return H, dx, dg, rng.normal(size=(b, d)), rho, frozen


def _ops_both_ways(fn, *args):
    """A JAX ops function in x64 on numpy args, through its jnp reference
    path and through its Pallas kernel (interpret mode)."""
    with _X64(True):
        jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
        with reference_kernels_off_tpu():
            ref = jax.device_get(fn(*jargs))
        return ref, jax.device_get(fn(*jargs))


def test_guarded_update_plain_matches_reference_in_float64():
    """B2's plain version against the JAX ops function in x64: to 1e-12
    through its jnp path; its Pallas kernel accumulates u = H·δg and p' in
    float32 whatever the input dtype (preferred_element_type, ROADMAP C:
    reference-side facts), so it agrees only to float32's precision."""
    H, dx, dg, g_new, rho, frozen = _update_inputs(9, 5, seed=3)
    (jH, jp), (kH, kp) = _ops_both_ways(jops.guarded_update_direction,
                                        H, dx, dg, g_new, rho)
    assert jH.dtype == np.float64 and kH.dtype == np.float64
    pH, pp = ops.guarded_update_direction(*(torch.from_numpy(a) for a in
                                            (H, dx, dg, g_new, rho)))
    assert pH.dtype == F64 and pp.dtype == F64
    assert torch.equal(pH[frozen], torch.from_numpy(H[frozen]))  # H' = H at ρ = 0
    hscale = np.maximum(1.0, np.abs(jH).max(axis=(1, 2)))
    pscale = np.maximum(1.0, (np.abs(jH) * np.abs(g_new)[:, None]).sum(-1).max(-1))
    for (wH, wp), tol in (((jH, jp), KERNEL_TOL), ((kH, kp), FLOAT32_ACCUMULATE_TOL)):
        _assert_rows_close(pH.numpy(), wH, hscale, tol, "H'")
        _assert_rows_close(pp.numpy(), wp, pscale, tol, "p'")


def test_direction_and_pso_step_plain_match_pallas_in_float64():
    rng = _rng(4)
    H, g = rng.normal(size=(11, 6, 6)), rng.normal(size=(11, 6))
    x, v, px = (rng.uniform(-5, 5, (13, 6)) for _ in range(3))
    gx, r1, r2 = rng.uniform(-5, 5, 6), rng.uniform(size=(13, 6)), rng.uniform(size=(13, 6))
    jp, kp = _ops_both_ways(jops.direction, H, g)
    (jx, jv), pallas_xv = _ops_both_ways(jops.pso_step_update, x, v, px, gx, r1, r2,
                                         0.5, 1.2, 1.5)
    assert jx.dtype == np.float64 and kp.dtype == np.float64
    pp = ops.direction(torch.from_numpy(H), torch.from_numpy(g))
    px_, pv = ops.pso_step_update(*(torch.from_numpy(a) for a in (x, v, px, gx, r1, r2)),
                                  0.5, 1.2, 1.5)
    assert pp.dtype == F64 and px_.dtype == F64 and pv.dtype == F64
    pscale = np.maximum(1.0, (np.abs(H) * np.abs(g)[:, None]).sum(-1).max(-1))
    _assert_rows_close(pp.numpy(), jp, pscale, KERNEL_TOL, "p")
    # the Pallas B3 accumulates in float32 (as B2's matvec)
    _assert_rows_close(pp.numpy(), kp, pscale, FLOAT32_ACCUMULATE_TOL, "p (Pallas)")
    vscale = np.maximum(1.0, (np.abs(v) + 1.2 * np.abs(px - x) + 1.5 * np.abs(gx - x))
                        .max(axis=1))
    for wx, wv in ((jx, jv), pallas_xv):  # B4's Pallas kernel works in x's dtype
        _assert_rows_close(pv.numpy(), wv, vscale, KERNEL_TOL, "v'")
        _assert_rows_close(px_.numpy(), wx, vscale + np.abs(x).max(axis=1), KERNEL_TOL,
                           "x'")


def test_kernel_thresholds_and_symbols_in_float64():
    """The variant edges halve their D in float64 (16 KB tiles of 2048
    doubles; a 16-byte pad of 2 doubles; the megakernel's shared memory),
    and every ZEUS kernel's CUDA wrapper takes float32 or float64, and
    nothing else."""
    assert ops.fused_obj_staged_max_dim(F64) == 907
    assert ops.fused_obj_staged_max_dim() == 1815
    assert ops.update_smem_dim(F64) == 168 and ops.update_smem_dim() == 239
    assert [ops.fused_obj_variant(d, F64) for d in (16, 17, 907, 908)] == [
        "rows", "staged", "staged", "direct"]
    assert [ops.update_variant(d, F64) for d in (32, 33, 168, 169)] == [
        "small", "smem", "smem", "streaming"]
    for d in (17, 33, 128, 300, 907):
        rows = ops.fused_obj_tile_rows(d, F64)
        assert rows == min(64, max(16, 2048 // d // 16 * 16))
        assert ops.fused_obj_ring_bytes(d, rows, 2, F64) == 2 * (rows * d + 2) * 8 + 64
    assert ops.megakernel_max_dim(20, F64) == 1814 and ops.megakernel_max_dim(20) == 3629
    assert (ops.megakernel_smem_dim(20, True, F64), ops.megakernel_smem_dim(20, False, F64),
            ops.megakernel_smem_dim(20), ops.megakernel_smem_dim(20, False)) == (
                162, 166, 233, 237)
    for name in ("fused_obj_launch", "direction_launch", "pso_step_launch",
                 "guarded_update_direction_launch", "bfgs_update_launch",
                 "update_direction_launch", "meanfield_step_launch",
                 "sweep_megakernel_full_launch", "sweep_megakernel_commit_launch"):
        assert _build.symbol("op", name, torch.float32) == name
        assert _build.symbol("op", name, F64) == name + "_f64"
        with pytest.raises(TypeError, match="float32 or float64"):
            _build.symbol("op", name, torch.float16)
    with pytest.raises(TypeError, match="takes float32"):
        _build.symbol("flash_attention", "flash_attention_launch", F64)
    assert set(ops.launch_counts()) >= {f"{op.__name__}_f64" for op in ops.FLOAT64_OPS}
    assert ops.flash_attention not in ops.FLOAT64_OPS
    assert len(ops.FLOAT64_OPS) == len(ops.KERNEL_OPS) - 1


# ---------------------------------------------------------------------------
# Sweeps: the reference's step from the port's state, every sweep
# ---------------------------------------------------------------------------
def _knife_edge_rung(pb, pre, i, r, c1):
    """Armijo margin of lane i at rung r, relative to max(1, |threshold|)."""
    P = pre.p[i] if float(pre.p[i] @ pre.g[i]) < 0 else -pre.g[i]
    alphas = torch.as_tensor(ladder_alphas(ITER_LS, np.float64))
    rhs = armijo_thresholds(pre.f[i:i + 1], (pre.g[i] @ P)[None], alphas, c1)[r, 0]
    f_r = pb.value_batch((pre.x[i] + alphas[r] * P)[None])[0]
    return float((f_r - rhs).abs()) / max(1.0, float(rhs.abs()))


def _per_lane_scale(a):
    return np.maximum(1.0, np.abs(a).reshape(a.shape[0], -1).max(axis=1))


@pytest.mark.parametrize("name", OBJECTIVES)
def test_batched_sweeps_match_reference_in_float64(name):
    b = BOX[name]
    starts = _rng(11).uniform(-b, b, (B, D))
    pb, ps = objectives.as_batched(get_objective(name).fn), BatchedDenseBFGS()
    popts = EngineOptions(iter_max=ITER_BFGS, theta=THETA)
    jopts = jengine.EngineOptions(sweep_mode="batched", iter_max=ITER_BFGS, theta=THETA)
    jb, js = jobj.as_batched(jobj.get_objective(name)), jbfgs.BatchedDenseBFGS()
    with _X64(True), reference_kernels_off_tpu():
        jstep = jax.jit(lambda ls: jengine.batch_lanes_step(jb, js, jopts, ls))
        jrung = jax.jit(lambda x, p, f, g: jls.armijo_backtracking_batch(
            jb.value_batch, x, p, f, g, c1=jopts.ls_c1, max_iters=ITER_LS).rung)
        ref0 = jax.device_get(jengine.batch_lanes_init(jb, js, jnp.asarray(starts), THETA))
        assert ref0.x.dtype == np.float64 and ref0.direction_state.dtype == np.float64
        lanes = interop.batch_lanes_from_numpy(ref0)
        assert lanes.x.dtype == F64 and lanes.direction_state.dtype == F64
        knife, k = [], 0
        while k < ITER_BFGS and bool((~(lanes.converged | lanes.failed)).any()):
            pre = lanes
            pre_np = {f: getattr(pre, f).numpy() for f in engine.BatchLanes._fields}
            state = jengine.BatchLanes(**{f: jnp.asarray(v) for f, v in pre_np.items()})
            lanes, _, rung = engine.batch_lanes_step(pb, ps, popts, pre)
            ref = jax.device_get(jstep(state)[0])
            P = np.where((np.sum(pre_np["p"] * pre_np["g"], -1) < 0)[:, None],
                         pre_np["p"], -pre_np["g"])
            ref_rung = np.asarray(jrung(state.x, jnp.asarray(P), state.f, state.g))
            # a frozen lane's rung is discarded by both engines
            active = ~(pre_np["converged"] | pre_np["failed"])
            odd = np.nonzero((rung.numpy() != ref_rung) & active)[0]
            for i in odd:
                margin = _knife_edge_rung(pb, pre, i, min(int(rung[i]), int(ref_rung[i])),
                                          popts.ls_c1)
                assert margin <= KNIFE_EDGE, (name, k, int(i), margin)
                knife.append((k, int(i), int(rung[i]), int(ref_rung[i]), margin,
                              float(pre.f[i]), float(torch.linalg.vector_norm(pre.g[i]))))
            keep = np.ones(B, bool)
            keep[odd] = False
            for field in ("converged", "failed"):
                np.testing.assert_array_equal(getattr(lanes, field).numpy()[keep],
                                              getattr(ref, field)[keep], err_msg=field)
            for field in ("x", "f", "g", "p", "direction_state"):
                got, want = getattr(lanes, field).numpy()[keep], getattr(ref, field)[keep]
                assert got.dtype == np.float64
                err = np.abs(got - want).reshape(got.shape[0], -1).max(axis=1)
                scale = _per_lane_scale(want)
                assert (err <= STATE_TOL * scale).all(), (
                    name, k, field, float((err / scale).max()))
            k += 1
    for edge in knife:
        print(f"{name}: knife edge at sweep {edge[0]} lane {edge[1]}: rung {edge[2]} "
              f"(reference {edge[3]}), margin {edge[4]:.3g}, f {edge[5]!r}, "
              f"|g| {edge[6]:.3g}")
    assert k > 0
    assert bool((lanes.converged | lanes.failed).all()) or k == ITER_BFGS


# ---------------------------------------------------------------------------
# End to end: free-running zeus from the same float64 draws
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["rastrigin", "rosenbrock"])
def test_zeus_free_running_matches_reference_in_float64(name):
    """On the two objectives whose float32 solves fork from the reference
    at the fp32 floor (ROADMAP C1): in float64 every lane's status agrees."""
    obj, jo = get_objective(name), jobj.get_objective(name)
    with _X64(True), reference_kernels_off_tpu():
        key = jax.random.key(OBJECTIVES.index(name))
        jopts = JZeusOptions(pso=JPSOOptions(n_particles=N_PART, iter_pso=ITER_PSO),
                             bfgs=JBFGSOptions(iter_bfgs=ITER_BFGS, theta=THETA),
                             sweep_mode="batched", dtype="float64")
        ref = jax.device_get(jax_zeus(jo.fn, key, D, jo.lower, jo.upper, jopts))
        arrays = jax_pso_draws(key, N_PART, D, jo.lower, jo.upper, ITER_PSO, jnp.float64)
    assert all(a.dtype == np.float64 for a in arrays)
    draws = ReplayDraws(arrays)
    assert ref.raw.x.dtype == np.float64
    opts = ZeusOptions(pso=PSOOptions(n_particles=N_PART, iter_pso=ITER_PSO),
                       bfgs=BFGSOptions(iter_bfgs=ITER_BFGS, theta=THETA), dtype="float64")
    got = zeus(obj.fn, D, obj.lower, obj.upper, opts, device="cpu", draws=draws)
    assert got.best_x.dtype == F64 and got.best_f.dtype == F64 and got.raw.x.dtype == F64
    np.testing.assert_allclose(float(got.pso_best_f), float(ref.pso_best_f), rtol=1e-12)
    np.testing.assert_array_equal(got.raw.status.numpy(), ref.raw.status)
    assert got.n_converged == int(ref.n_converged)
    assert abs(float(got.best_f) - float(ref.best_f)) <= BEST_F_RTOL * max(
        1.0, abs(float(ref.best_f)))


def test_lane_chunk_is_array_equal_to_unchunked_in_float64():
    obj = get_objective("rastrigin")
    starts = torch.from_numpy(_rng(5).uniform(obj.lower, obj.upper, (20, D)))
    base = dict(iter_max=ITER_BFGS, theta=THETA)
    whole = run_multistart(obj.fn, starts, BatchedDenseBFGS(), EngineOptions(**base),
                           device="cpu")
    chunked = run_multistart(obj.fn, starts, BatchedDenseBFGS(),
                             EngineOptions(**base, lane_chunk=8), device="cpu")
    assert whole.x.dtype == F64
    for field in ("x", "fval", "grad_norm", "status", "n_evals"):
        assert torch.equal(getattr(whole, field), getattr(chunked, field)), field
    assert whole.iterations == chunked.iterations


# ---------------------------------------------------------------------------
# The dijet fit in float64
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def counts64():
    with _X64(True):
        return jobj.simulate_dijet_counts(TRUE, EDGES, seed=7)


def test_dijet_counts_nll_and_gradient_match_reference_in_float64(counts64):
    got = objectives.simulate_dijet_counts(TRUE, EDGES, seed=7, dtype=F64)
    np.testing.assert_array_equal(got, counts64)
    rng = _rng(22)
    pts = np.concatenate([TRUE + rng.normal(0.0, 0.5, (6, 4)),
                          rng.uniform(LOWER, UPPER, (6, 4))])
    with _X64(True):
        jnll = jobj.make_dijet_nll(EDGES, counts64)
        jf, jg = (np.asarray(a) for a in jax.jit(jax.vmap(jdual.value_and_grad_fn(
            jnll, "forward")))(jnp.asarray(pts)))
    pnll = objectives.make_dijet_nll(EDGES, counts64)
    pf, pg = (a.numpy() for a in torch.func.vmap(pdual.value_and_grad_fn(
        pnll, "forward"))(torch.from_numpy(pts)))
    assert pf.dtype == np.float64 and pg.dtype == np.float64
    fin = np.isfinite(jf)
    assert fin.sum() >= 6
    np.testing.assert_array_equal(np.isfinite(pf), fin)
    # the summed magnitudes of the bins' terms, μ − c·log μ and its gradient
    # (μ − c)·∂log μ/∂p, over the 40 bins
    centers = 0.5 * (EDGES[:-1] + EDGES[1:])
    xm = centers / objectives.SQRT_S
    dlog = np.stack([np.ones_like(xm), np.log1p(-xm), -np.log(xm), -np.log(xm) ** 2], -1)
    log_mu = (pts[:, :1] + pts[:, 1:2] * np.log1p(-xm) - (pts[:, 2:3] + pts[:, 3:4]
              * np.log(xm)) * np.log(xm) + np.log(EDGES[1:] - EDGES[:-1]))
    with np.errstate(over="ignore", invalid="ignore"):
        mu = np.exp(log_mu)
        fscale = (mu + np.abs(counts64 * log_mu)).sum(-1) / 40
        gscale = ((mu + counts64)[:, :, None] * np.abs(dlog)).sum(1) / 40
    assert np.all(np.abs(pf[fin] - jf[fin]) <= KERNEL_TOL * fscale[fin])
    assert np.all(np.abs(pg[fin] - jg[fin]) <= KERNEL_TOL * gscale[fin])


def test_dijet_fit_in_float64_meets_the_examples_criteria(counts64):
    """A small float64 fit through zeus (batched sweep, forward AD) meets
    examples/fit_dijet.py's two asserts: best_f <= nll(TRUE) + 1, and at
    least 90% of the pulls within ±2σ."""
    nll = objectives.make_dijet_nll(EDGES, counts64)
    opts = ZeusOptions(pso=PSOOptions(n_particles=64, iter_pso=5),
                       bfgs=BFGSOptions(iter_bfgs=150, theta=1e-2, required_c=4),
                       dtype="float64")
    res = zeus(nll, 4, LOWER, UPPER, opts, device="cpu",
               generator=torch.Generator().manual_seed(3))
    assert res.best_x.dtype == F64 and res.n_converged >= 4
    true_f = float(nll(torch.from_numpy(TRUE)))
    assert float(res.best_f) <= true_f + 1.0
    centers = 0.5 * (EDGES[:-1] + EDGES[1:])
    pred = objectives.dijet_rate(res.best_x, torch.from_numpy(centers)).numpy() * (
        EDGES[1:] - EDGES[:-1])
    pulls = (counts64 - pred) / np.sqrt(np.maximum(pred, 1.0))
    assert float(np.mean(np.abs(pulls) <= 2.0)) >= 0.9


# ---------------------------------------------------------------------------
# Refusals: every path float64 does not run yet (ROADMAP A19b-2)
# ---------------------------------------------------------------------------
def _zeus64(**kw):
    obj = get_objective("sphere")
    opts = ZeusOptions(pso=PSOOptions(n_particles=8, iter_pso=1), dtype="float64", **kw)
    return zeus(obj.fn, 2, obj.lower, obj.upper, opts, device="cpu")


def _engine64(**kw):
    obj = get_objective("sphere")
    return run_multistart(obj.fn, torch.zeros((4, 2), dtype=F64), BatchedDenseBFGS(),
                          EngineOptions(**kw), device="cpu")


REFUSED = {
    "lbfgs": lambda: _zeus64(solver="lbfgs"),
    "lbfgs-per_lane": lambda: _zeus64(solver="lbfgs", sweep_mode="per_lane"),
    "compact_every": lambda: _zeus64(compact_every=1),
    "repack_every": lambda: _zeus64(repack_every=1, lane_chunk=4),
    "schedule-auto": lambda: _zeus64(schedule="auto"),
    "schedule-replay": lambda: _zeus64(schedule="replay", schedule_plans=(0,)),
    "retry": lambda: _zeus64(retry_budget=1),
    "fault_plan": lambda: _zeus64(fault_plan=FaultPlan(preempt_at_sweep=3)),
    "checkpoint": lambda: _zeus64(checkpoint_every=2, checkpoint_dir="unused"),
    "resume": lambda: _zeus64_resume(),
    "engine-compact": lambda: _engine64(compact_every=1),
    "open_multistart": lambda: open_multistart(
        get_objective("sphere").fn, torch.zeros((4, 2), dtype=F64), BatchedDenseBFGS(),
        EngineOptions(lane_deadlines=True), device="cpu"),
    "service": lambda: ProblemRegistry().register(
        "s", "sphere", 2, ZeusOptions(dtype="float64")),
}


def _zeus64_resume():
    obj = get_objective("sphere")
    return zeus(obj.fn, 2, obj.lower, obj.upper,
                ZeusOptions(pso=PSOOptions(n_particles=8, iter_pso=1), dtype="float64"),
                device="cpu", resume="unused")


@pytest.mark.parametrize("path", list(REFUSED))
def test_unported_float64_paths_raise(path):
    ops.reset_launch_counts()
    with pytest.raises(NotImplementedError, match="A19b"):
        REFUSED[path]()


def test_float32_paths_are_not_refused():
    """The gate acts on float64 only: the same options in float32 solve."""
    obj = get_objective("sphere")
    out = zeus(obj.fn, 2, obj.lower, obj.upper,
               ZeusOptions(pso=PSOOptions(n_particles=8, iter_pso=1), compact_every=1),
               device="cpu")
    assert out.best_x.dtype == torch.float32 and out.n_converged == 8
