"""float64 on the port's kernel paths (ROADMAP A19b-1) against the JAX
package in x64: the per-lane sweep (B7a/B7b), the megakernel with its
adaptive ladder (B5/B5b), mean-field phase 1 (B6) and the sequential
baseline.

Every reference result is computed inside `jax.enable_x64(True)` (the
context manager, never `jax.config.update`), with inputs from
`np.random.default_rng(seed)` in float64.

- Kernels: the plain B7a/B7b (D = 1, 5, 33) against `repro.kernels.ref`'s
  bfgs_update_ref / update_direction_ref (the literal V H Vᵀ + ρ δx δxᵀ) to
  1e-12 of a lane's largest term, and against the reference's Pallas
  kernels in interpret mode to 1e-6 (their matvecs accumulate in float32
  under x64: ROADMAP C, reference-side facts); the plain B6 in both noise
  modes against `meanfield_step_pallas` in interpret mode (x's dtype
  throughout) to 1e-12 of a row's scale.
- B5/B5b sweep by sweep: the port's megakernel step (the plain B5, or the
  adaptive ladder and the plain B5b) from its own state, the reference's
  staged step (its megakernel's semantics: `reference_kernels_off_tpu`)
  from the same state. The same rung on every active lane and the same
  status on every lane, the state within 1e-10 of a lane's largest entry;
  and the port's megakernel step array-equal to its batched step.
- The per-lane sweep sweep by sweep, Armijo and Wolfe, on the four
  objectives: the port's hessian_impl="pallas" (the plain B7a, the exact
  float64 ρ-form) against the reference's "fast" (its jnp ρ-form), the
  same trial counts and statuses and the state within 1e-10.
- Free-running float64 zeus (megakernel with and without ladder_len,
  per-lane, mean-field phase 1) from the reference's draws: every status
  equal and best_f within 1e-10 · max(1, |best_f|).
- serial_bfgs, sequential_pso and sequential_zeus in float64 against the
  reference's; the megakernel gate's float64 cap (1814 at K = 20).

A differing rung or trial count is allowed only at an Armijo margin <=
1e-12 of max(1, |threshold|) (none appears at these seeds).
"""
import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bfgs as jbfgs  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import linesearch as jls  # noqa: E402
from repro.core import objectives as jobj  # noqa: E402
from repro.core import pso as jpso  # noqa: E402
from repro.core.dual import value_and_grad_fn as jvg_fn  # noqa: E402
from repro.core.meanfield import MeanFieldPSOOptions as JMeanFieldPSOOptions  # noqa: E402
from repro.core.zeus import ZeusOptions as JZeusOptions  # noqa: E402
from repro.core.zeus import sequential_zeus as jsequential_zeus  # noqa: E402
from repro.core.zeus import zeus as jax_zeus  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.meanfield_step import meanfield_step_pallas  # noqa: E402
from repro.kernels.ops import reference_kernels_off_tpu  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import (  # noqa: E402
    BatchedDenseBFGS,
    BFGSOptions,
    EngineOptions,
    MeanFieldPSOOptions,
    PSOOptions,
    ZeusOptions,
    get_objective,
    sequential_zeus,
    zeus,
)
from repro_torch.core import bfgs, engine, objectives, pso  # noqa: E402
from repro_torch.core.dual import grad_eval_cost  # noqa: E402
from repro_torch.core.linesearch import ladder_alphas  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from test_torch_core import ReplayDraws, jax_pso_draws  # noqa: E402
from test_torch_float64 import _X64, _assert_rows_close, _per_lane_scale  # noqa: E402
from test_torch_meanfield import ReplayNormalDraws  # noqa: E402
from test_torch_perlane import _folded_seed, _jax_tree  # noqa: E402

F64 = torch.float64
KERNEL_TOL = 1e-12  # of a lane's (or row's) largest term
FLOAT32_ACCUMULATE_TOL = 1e-6  # the reference's Pallas matvecs under x64
STATE_TOL = 1e-10  # of a lane's largest entry, one sweep
BEST_F_RTOL = 1e-10  # free-running best_f, of max(1, |best_f|)
KNIFE_EDGE = 1e-12  # an Armijo margin, of max(1, |threshold|)
OBJECTIVES = ("sphere", "rastrigin", "rosenbrock", "ackley")
B, D, K, THETA, C1 = 16, 5, 20, 1e-4, 0.3
N_PART, ITER_PSO, ITER_BFGS = 16, 2, 30


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _starts(name, n, d, seed):
    obj = jobj.get_objective(name)
    return _rng(seed).uniform(obj.lower, obj.upper, (n, d))


# ---------------------------------------------------------------------------
# Kernels: B7a/B7b and B6's plain versions against the reference in x64
# ---------------------------------------------------------------------------
def _unguarded_inputs(b, d, seed):
    """H = I + a small symmetric term; curvature-safe pairs (δg = δx ⊙ (1 +
    u), so δxᵀδg > 0) but lane 0 on the engine's stand-in pair (1, …, 1)."""
    rng = _rng(seed)
    a = 0.1 * rng.normal(size=(b, d, d)) / np.sqrt(d)
    H = np.eye(d) + 0.5 * (a + a.transpose(0, 2, 1))
    dx = rng.normal(size=(b, d))
    dg = dx * (1.0 + rng.uniform(size=(b, d)))
    dx[0] = dg[0] = 1.0
    return H, dx, dg, rng.normal(size=(b, d))


def _update_scale(H, dx, dg):
    """Per lane, the largest term of the ρ-form's entries: |H|,
    |ρ|(|u_i δx_j| + |δx_i u_j|) and |ρ²s + ρ| |δx_i δx_j|."""
    rho = 1.0 / np.sum(dx * dg, -1)
    u = np.einsum("bij,bj->bi", H, dg)
    coef = rho * rho * np.sum(dg * u, -1) + rho
    au, ax = np.abs(u), np.abs(dx)
    terms = (np.abs(rho)[:, None, None] * (au[:, :, None] * ax[:, None, :]
                                            + ax[:, :, None] * au[:, None, :])
             + np.abs(coef)[:, None, None] * ax[:, :, None] * ax[:, None, :])
    return np.maximum(1.0, np.maximum(np.abs(H), terms).reshape(len(H), -1).max(-1))


@pytest.mark.parametrize("d", [1, 5, 33])
def test_unguarded_updates_plain_match_reference_in_float64(d):
    """B7a (bfgs_update) and B7b (bfgs_update_direction): the port's plain
    ρ-form against the reference's literal triple product to 1e-12, and
    against its Pallas kernels (interpret mode) to float32's precision."""
    H, dx, dg, g_new = _unguarded_inputs(6, d, seed=40 + d)
    with _X64(True):
        # the four programs in one compilation
        jH, (jH2, jp), kH, (kH2, kp) = jax.device_get(jax.jit(lambda H, dx, dg, g: (
            jref.bfgs_update_ref(H, dx, dg), jref.update_direction_ref(H, dx, dg, g),
            jops.bfgs_update(H, dx, dg), jops.bfgs_update_direction(H, dx, dg, g)))(
                *(jnp.asarray(a) for a in (H, dx, dg, g_new))))
    assert jH.dtype == np.float64 and kH.dtype == np.float64 and kp.dtype == np.float64
    pH = ops.bfgs_update(_t(H), _t(dx), _t(dg))
    pH2, pp = ops.bfgs_update_direction(_t(H), _t(dx), _t(dg), _t(g_new))
    assert pH.dtype == F64 and pH2.dtype == F64 and pp.dtype == F64
    assert torch.equal(pH, pH2)  # B7b's H' is B7a's
    hscale = _update_scale(H, dx, dg)
    pscale = np.maximum(1.0, (np.abs(jH2) * np.abs(g_new)[:, None]).sum(-1).max(-1))
    for (wH, wH2, wp), tol in (((jH, jH2, jp), KERNEL_TOL),
                               ((kH, kH2, kp), FLOAT32_ACCUMULATE_TOL)):
        _assert_rows_close(pH.numpy(), wH, hscale, tol, f"B7a D={d}")
        _assert_rows_close(pH2.numpy(), wH2, hscale, tol, f"B7b H' D={d}")
        _assert_rows_close(pp.numpy(), wp, pscale, tol, f"B7b p' D={d}")


@pytest.mark.parametrize("noise", ["isotropic", "anisotropic"])
def test_meanfield_step_plain_matches_pallas_in_float64(noise):
    rng = _rng(44)
    n, d = 37, 6
    x, v, xi = rng.uniform(-5, 5, (n, d)), rng.normal(size=(n, d)), rng.normal(size=(n, d))
    xbar = rng.uniform(-1, 1, d)
    x[3, 1], x[7, 0] = np.inf, np.nan  # non-finite rows stay non-finite in place
    w, drift, sigma = 0.5, 1.2, 0.3
    with _X64(True):
        jx, jv = (np.asarray(a) for a in meanfield_step_pallas(
            *(jnp.asarray(a) for a in (x, v, xbar, xi)), w, drift, sigma,
            isotropic=noise == "isotropic", interpret=True))
    assert jx.dtype == np.float64
    px, pv = ops.meanfield_step_update(*(_t(a) for a in (x, v, xbar, xi)), w, drift,
                                       sigma, noise)
    assert px.dtype == F64 and pv.dtype == F64
    # each row's scale from its finite entries (a non-finite entry is held
    # by place alone)
    fx = np.where(np.isfinite(x), x, 0.0)
    dist = np.abs(xbar[None] - fx)
    env = (np.sqrt(np.sum(dist * dist, -1, keepdims=True)) if noise == "isotropic"
           else dist)
    vscale = np.maximum(1.0, (np.abs(v) + drift * dist + sigma * env * np.abs(xi)).max(-1))
    _assert_rows_close(pv.numpy(), jv, vscale, KERNEL_TOL, f"{noise} v'")
    _assert_rows_close(px.numpy(), jx, vscale + np.abs(fx).max(-1), KERNEL_TOL,
                       f"{noise} x'")


# ---------------------------------------------------------------------------
# Sweeps from the port's state against the reference's step
# ---------------------------------------------------------------------------
def _knife_edge(value_batch, x, p, f0, g0, alpha, c1):
    """Armijo margin of one lane at step α, of max(1, |threshold|)."""
    rhs = f0 + c1 * alpha * torch.dot(g0, p)
    f = value_batch((x + alpha * p)[None])[0]
    return float((f - rhs).abs()) / max(1.0, float(rhs.abs()))


def _assert_sweep_close(name, k, now, ref, keep, fields):
    np.testing.assert_array_equal(now.converged[keep], ref.converged[keep],
                                  err_msg=f"{name} sweep {k} converged")
    np.testing.assert_array_equal(now.failed[keep], ref.failed[keep],
                                  err_msg=f"{name} sweep {k} failed")
    for field in fields:
        got, want = getattr(now, field)[keep], np.asarray(getattr(ref, field))[keep]
        assert got.dtype == np.float64, field
        got, want = got.reshape(len(got), -1), want.reshape(len(want), -1)
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want), err_msg=field)
        err = np.nan_to_num(np.abs(got - want)).max(axis=1, initial=0.0)
        scale = _per_lane_scale(np.nan_to_num(want))
        assert (err <= STATE_TOL * scale).all(), (name, k, field, float((err / scale).max()))


@pytest.mark.parametrize("name,L", [("sphere", 0), ("rastrigin", 0), ("rosenbrock", 0),
                                    ("ackley", 0), ("ackley", 4)])
def test_megakernel_sweeps_match_reference_in_float64(name, L):
    """B5 (L = 0) and the adaptive ladder with B5b (L = 4): every sweep of
    the port's megakernel step from its own state against the reference's
    staged step from that state, and array-equal to the port's batched
    step."""
    pb, ps = objectives.as_batched(get_objective(name).fn), BatchedDenseBFGS()
    popts = EngineOptions(iter_max=ITER_BFGS, theta=THETA, ladder_len=L,
                          sweep_mode="megakernel")
    jopts = jengine.EngineOptions(sweep_mode="megakernel", iter_max=ITER_BFGS, theta=THETA,
                                  ladder_len=L)
    jb, js = jobj.as_batched(jobj.get_objective(name)), jbfgs.BatchedDenseBFGS()
    assert engine.megakernel_unsupported_reason(pb, ps, D, popts, F64) is None
    lanes = engine.batch_lanes_init(pb, ps, _t(_starts(name, B, D, seed=50)), THETA)
    assert lanes.direction_state.dtype == F64
    alphas = torch.as_tensor(ladder_alphas(K, np.float64))
    knife, k = [], 0
    with _X64(True), reference_kernels_off_tpu():
        # the step and its per-lane rungs (the step reports a histogram
        # only) in one compilation
        jstep = jax.jit(lambda ls, p: (
            jengine.megakernel_lanes_step(jb, js, jopts, ls)[0],
            jls.armijo_backtracking_batch(jb.value_batch, ls.x, p, ls.f, ls.g, c1=C1,
                                          max_iters=K, ladder_len=L).rung))
        while k < ITER_BFGS and bool((~(lanes.converged | lanes.failed)).any()):
            pre, pre_np = lanes, interop.state_to_numpy(lanes)
            P = torch.where((torch.sum(pre.p * pre.g, -1) < 0)[:, None], pre.p, -pre.g)
            ref, ref_rung = jax.device_get(jstep(_jax_tree(pre_np), jnp.asarray(P.numpy())))
            lanes, rows, rung = engine.megakernel_lanes_step(pb, ps, popts, pre)
            staged, srows, srung = engine.batch_lanes_step(pb, ps, popts, pre)
            for field in engine.BatchLanes._fields:
                assert torch.equal(getattr(lanes, field), getattr(staged, field)), field
            assert rows == srows and torch.equal(rung, srung)
            active = ~(pre_np.converged | pre_np.failed)
            odd = np.nonzero((rung.numpy() != ref_rung) & active)[0]
            for i in odd:
                r = min(int(rung[i]), int(ref_rung[i]))
                margin = _knife_edge(pb.value_batch, pre.x[i], P[i], pre.f[i], pre.g[i],
                                     alphas[r], C1)
                assert margin <= KNIFE_EDGE, (name, L, k, int(i), margin)
                knife.append((k, int(i), margin))
            keep = np.ones(B, bool)
            keep[odd] = False
            _assert_sweep_close(f"{name} L={L}", k, interop.state_to_numpy(lanes), ref, keep,
                                ("x", "f", "g", "p", "direction_state"))
            k += 1
    for edge in knife:
        print(f"{name} L={L}: knife edge at sweep {edge[0]} lane {edge[1]}, margin "
              f"{edge[2]:.3g}")
    assert k >= 1  # sphere's lanes converge in one sweep


@pytest.mark.parametrize("search", ["armijo", "wolfe"])
@pytest.mark.parametrize("name", OBJECTIVES)
def test_per_lane_sweeps_match_reference_in_float64(name, search):
    """Every per-lane sweep from the port's state: the port's B7a path
    (hessian_impl="pallas") against the reference's jnp ρ-form ("fast")."""
    jfn, pfn = jobj.get_objective(name).fn, get_objective(name).fn
    pstrat, jstrat = bfgs.DenseBFGS("pallas"), jbfgs.DenseBFGS("fast")
    popts = EngineOptions(sweep_mode="per_lane", iter_max=ITER_BFGS, theta=THETA,
                          linesearch=search)
    jopts = jengine.EngineOptions(sweep_mode="per_lane", iter_max=ITER_BFGS, theta=THETA,
                                  linesearch=search)
    obj = engine.per_lane_objective(pfn, popts.ad_mode)
    vg_cost = grad_eval_cost(D, popts.ad_mode)
    lanes = engine.lane_init(obj.value_and_grad_batch, pstrat,
                             _t(_starts(name, B, D, seed=51)), THETA, popts.ad_mode)
    assert lanes.direction_state.dtype == F64
    knife, k = [], 0
    with _X64(True), reference_kernels_off_tpu():
        jvg = jvg_fn(jfn, jopts.ad_mode)
        jstep = jax.jit(jax.vmap(functools.partial(jengine.lane_step, jfn, jvg, jstrat,
                                                   jopts)))
        while k < ITER_BFGS and bool((~(lanes.converged | lanes.failed)).any()):
            pre, pre_np = lanes, interop.state_to_numpy(lanes)
            ref = jax.device_get(jstep(_jax_tree(pre_np)))
            lanes = engine.lane_step(obj.value_batch, obj.value_and_grad_batch, pstrat,
                                     popts, pre)
            now = interop.state_to_numpy(lanes)
            active = ~(pre_np.converged | pre_np.failed)
            n_port = now.n_evals - pre_np.n_evals - vg_cost
            n_ref = ref.n_evals - pre_np.n_evals - vg_cost
            odd = np.nonzero(active & (n_port != n_ref))[0]
            P = pstrat.direction(pre.direction_state, pre.g)
            P = torch.where((torch.sum(P * pre.g, -1) < 0)[:, None], P, -pre.g)
            for i in odd:
                # Armijo: the first rung only one side accepted; Wolfe has
                # no rung ladder, so a differing count is a fault
                assert search == "armijo", (name, k, int(i), n_port[i], n_ref[i])
                alpha = float(ladder_alphas(K, np.float64)[min(n_port[i], n_ref[i]) - 1])
                margin = _knife_edge(obj.value_batch, pre.x[i], P[i], pre.f[i], pre.g[i],
                                     alpha, C1)
                assert margin <= KNIFE_EDGE, (name, k, int(i), margin)
                knife.append((k, int(i), margin))
            keep = np.ones(B, bool)
            keep[odd] = False
            _assert_sweep_close(f"{name} {search}", k, now, ref, keep,
                                ("x", "f", "g", "direction_state"))
            k += 1
    for edge in knife:
        print(f"{name} {search}: knife edge at sweep {edge[0]} lane {edge[1]}, margin "
              f"{edge[2]:.3g}")
    assert k >= 1


# ---------------------------------------------------------------------------
# Free-running float64 zeus from the reference's draws
# ---------------------------------------------------------------------------
def _meanfield_draws64(key, n, dim, lower, upper, iters):
    """repro.core.meanfield.run_meanfield_pso's draws in float64, in call
    order (x64 must be on)."""
    kx, kv, key = jax.random.split(key, 3)
    rng = upper - lower
    out = [jax.random.uniform(kx, (n, dim), jnp.float64, lower, upper),
           jax.random.uniform(kv, (n, dim), jnp.float64, -rng, rng)]
    for _ in range(iters):
        knoise, key = jax.random.split(key)
        out.append(jax.random.normal(knoise, (n, dim), jnp.float64))
    return [np.asarray(a) for a in out]


FREE_CASES = {
    "megakernel": dict(name="ackley", sweep_mode="megakernel"),
    "megakernel-ladder": dict(name="rastrigin", sweep_mode="megakernel", ladder_len=4),
    "per_lane": dict(name="ackley", sweep_mode="per_lane"),
    "meanfield": dict(name="rastrigin", sweep_mode="batched", phase1="meanfield"),
}


@pytest.mark.parametrize("case", list(FREE_CASES))
def test_zeus_free_running_matches_reference_in_float64(case):
    c = FREE_CASES[case]
    name, meanfield = c["name"], c.get("phase1") == "meanfield"
    obj, jo = get_objective(name), jobj.get_objective(name)
    mf = dict(n_particles=N_PART, iter_pso=ITER_PSO)
    per_lane = c["sweep_mode"] == "per_lane"
    common = dict(sweep_mode=c["sweep_mode"], ladder_len=c.get("ladder_len"),
                  phase1=c.get("phase1", "pso"), dtype="float64")
    with _X64(True), reference_kernels_off_tpu():
        key = jax.random.key(60 + list(FREE_CASES).index(case))
        jopts = JZeusOptions(pso=jpso.PSOOptions(n_particles=N_PART, iter_pso=ITER_PSO),
                             meanfield=JMeanFieldPSOOptions(**mf),
                             bfgs=jbfgs.BFGSOptions(iter_bfgs=ITER_BFGS, theta=THETA),
                             **common)
        # jitted end to end: one compilation, several times faster than eager
        ref = jax.device_get(jax.jit(lambda k: jax_zeus(jo.fn, k, D, jo.lower, jo.upper,
                                                        jopts))(key))
        if meanfield:
            draws = ReplayNormalDraws(_meanfield_draws64(key, N_PART, D, jo.lower,
                                                         jo.upper, ITER_PSO))
        else:
            draws = ReplayDraws(jax_pso_draws(key, N_PART, D, jo.lower, jo.upper,
                                              ITER_PSO, jnp.float64))
    assert ref.raw.x.dtype == np.float64
    opts = ZeusOptions(pso=PSOOptions(n_particles=N_PART, iter_pso=ITER_PSO),
                       meanfield=MeanFieldPSOOptions(**mf),
                       bfgs=BFGSOptions(iter_bfgs=ITER_BFGS, theta=THETA,
                                        hessian_impl="pallas" if per_lane else "fast"),
                       **common)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)  # no fallback to the batched sweep
        got = zeus(obj.fn, D, obj.lower, obj.upper, opts, device="cpu", draws=draws)
    assert not draws.arrays  # every reference draw consumed, in order
    assert got.best_x.dtype == F64 and got.raw.x.dtype == F64
    np.testing.assert_allclose(float(got.pso_best_f), float(ref.pso_best_f), rtol=1e-12)
    np.testing.assert_array_equal(got.raw.status.numpy(), ref.raw.status)
    assert got.n_converged == int(ref.n_converged) and got.n_converged > 0
    assert got.raw.iterations == int(ref.raw.iterations)
    assert abs(float(got.best_f) - float(ref.best_f)) <= BEST_F_RTOL * max(
        1.0, abs(float(ref.best_f)))


# ---------------------------------------------------------------------------
# The sequential baseline in float64
# ---------------------------------------------------------------------------
def test_serial_bfgs_matches_reference_in_float64():
    name = "rosenbrock"
    x0 = _starts(name, 1, 4, seed=52)[0]
    with _X64(True):
        ref = jax.device_get(jax.jit(functools.partial(
            jbfgs.serial_bfgs, jobj.get_objective(name).fn))(jnp.asarray(x0)))
    got = bfgs.serial_bfgs(get_objective(name).fn, _t(x0),
                           bfgs.BFGSOptions(sweep_mode="per_lane", hessian_impl="pallas"),
                           device="cpu")
    assert got.x.dtype == F64 and ref.x.dtype == np.float64
    assert got.status == int(ref.status) and got.iterations == int(ref.iterations)
    scale = max(1.0, float(np.abs(ref.x).max()))
    assert float(np.abs(got.x.numpy() - ref.x).max()) <= STATE_TOL * scale
    assert abs(float(got.fval) - float(ref.fval)) <= STATE_TOL * max(1.0, abs(float(ref.fval)))


def test_sequential_pso_matches_reference_exactly_in_float64():
    name, n, dim = "rastrigin", 10, 3
    key = jax.random.key(53)
    jo, po = jobj.get_objective(name), get_objective(name)
    with _X64(True):
        ref = jax.device_get(jpso.sequential_pso(
            jo.fn, key, dim, jo.lower, jo.upper, jpso.PSOOptions(n_particles=n, iter_pso=3)))
        seed = _folded_seed(key)  # x64 folds the key into another integer
    got = pso.sequential_pso(po.fn, seed, dim, po.lower, po.upper,
                             pso.PSOOptions(n_particles=n, iter_pso=3), device="cpu",
                             dtype=F64)
    for field in pso.SwarmState._fields:
        assert getattr(got, field).dtype == F64 and getattr(ref, field).dtype == np.float64
        np.testing.assert_array_equal(getattr(got, field).numpy(), getattr(ref, field),
                                      err_msg=field)


def test_sequential_zeus_matches_reference_in_float64():
    """Ten starts on rastrigin D = 2 solved one by one until four converge,
    at the default Θ = 1e-5, where the float32 solves fork (ROADMAP C5)."""
    name, dim = "rastrigin", 2
    key = jax.random.key(54)
    jo, po = jobj.get_objective(name), get_objective(name)
    common = dict(iter_bfgs=30, required_c=4)
    with _X64(True):
        ref = jsequential_zeus(
            jo.fn, key, dim, jo.lower, jo.upper,
            JZeusOptions(pso=jpso.PSOOptions(n_particles=10, iter_pso=2),
                         bfgs=jbfgs.BFGSOptions(**common), dtype="float64"))
        seed = _folded_seed(key)
    got = sequential_zeus(
        po.fn, seed, dim, po.lower, po.upper,
        ZeusOptions(pso=PSOOptions(n_particles=10, iter_pso=2),
                    bfgs=BFGSOptions(**common, sweep_mode="per_lane", hessian_impl="pallas"),
                    dtype="float64"),
        device="cpu")
    assert got.best_x.dtype == np.float64 and np.asarray(ref.best_x).dtype == np.float64
    assert (got.n_converged, got.n_started, got.n_failed) == (
        ref.n_converged, ref.n_started, ref.n_failed)
    assert abs(got.best_f - ref.best_f) <= STATE_TOL * max(1.0, abs(ref.best_f))
    np.testing.assert_allclose(got.best_x, np.asarray(ref.best_x), rtol=0, atol=1e-8)


# ---------------------------------------------------------------------------
# The megakernel's gate counts the element size
# ---------------------------------------------------------------------------
def test_megakernel_gate_caps_float64_at_its_shared_memory():
    pb, ps, opts = objectives.as_batched(get_objective("ackley")), BatchedDenseBFGS(), \
        EngineOptions()
    assert ops.megakernel_max_dim(opts.ls_iters, F64) == 1814
    for dim, dtype, ok in ((1814, F64, True), (1815, F64, False), (1815, torch.float32, True),
                           (3629, torch.float32, True), (3630, torch.float32, False)):
        reason = engine.megakernel_unsupported_reason(pb, ps, dim, opts, dtype)
        assert (reason is None) == ok, (dim, dtype, reason)
        if not ok:
            assert "exceeds" in reason and str(dtype) in reason
