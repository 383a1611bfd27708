"""The port's per-lane path, L-BFGS, Wolfe and sequential baseline against
the JAX package on identical inputs: the sequential Armijo and Wolfe
searches per lane, the L-BFGS two-loop direction, one `lane_step` (and one
batched L-BFGS sweep) from the reference's own state, zeus() with
sweep_mode="per_lane" and with solver="lbfgs" compared sweep by sweep, and
`sequential_pso`/`sequential_zeus` from the reference's folded seed.

The JAX side runs with its jnp reference kernels
(`reference_kernels_off_tpu`), so its hessian_impl="pallas" takes the
literal V H Vᵀ + ρδxδxᵀ oracle while the port takes the ρ-form: that case
gets the looser tolerance the kernel tests state for those two forms.
Tolerances, and why:
  - α and n_evals per lane: equal (α is α₀ times a power of two, or a
    bisection of such; a different count is a different accept);
  - f_new: 1e-5; state after one step: 1e-5 of each lane's largest entry
    (both in float32; XLA's dot and torch's sum add in other orders, XLA
    may contract x + α·p, and rosenbrock's Hessian turns a one-ulp move of
    x' into ~1e-4 of a small entry of g: ROADMAP C3);
  - state after a sweep of a whole solve: 1e-3 of the lane's largest entry
    (as in test_torch_zeus.py: g and H' round relative to the lane's
    largest terms);
  - a lane whose accept differs is a knife edge when its Armijo margin at
    the disputed step is within 1e-5 of max(1, |threshold|), and a status
    flip when |g| is within 1e-3·Θ of Θ; each is printed.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bfgs as jbfgs  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import lbfgs as jlbfgs  # noqa: E402
from repro.core import linesearch as jls  # noqa: E402
from repro.core import objectives as jobj  # noqa: E402
from repro.core import pso as jpso  # noqa: E402
from repro.core.zeus import ZeusOptions as JZeusOptions  # noqa: E402
from repro.core.zeus import sequential_zeus as jsequential_zeus  # noqa: E402
from repro.core.dual import value_and_grad_fn as jvg_fn  # noqa: E402
from repro.kernels.ops import reference_kernels_off_tpu  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import bfgs, engine, lbfgs, linesearch, pso  # noqa: E402
from repro_torch.core.zeus import (  # noqa: E402
    ZeusOptions,
    phase2_setup,
    sequential_zeus,
    zeus,
)
from repro_torch.core import get_objective  # noqa: E402
from repro_torch.core.dual import grad_eval_cost  # noqa: E402
from test_torch_core import ReplayDraws, jax_pso_draws  # noqa: E402

B, D = 24, 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _starts(name, n, d, seed):
    obj = jobj.get_objective(name)
    return np.random.default_rng(seed).uniform(
        obj.lower, obj.upper, (n, d)).astype(np.float32)


def _np(lanes):
    return interop.state_to_numpy(lanes)


def _jax_tree(state):
    """A numpy NamedTuple tree (the port's state via interop) as the
    reference's: jnp arrays, LBFGSMemory mapped to the reference class."""
    if isinstance(state, np.ndarray):
        return jnp.asarray(state)
    if isinstance(state, lbfgs.LBFGSMemory):
        return jlbfgs.LBFGSMemory(*(jnp.asarray(v) for v in state))
    cls = {"Lane": jengine.Lane, "BatchLanes": jengine.BatchLanes}[type(state).__name__]
    return cls(*(_jax_tree(v) for v in state))


def _lane_error(got, ref):
    """Per lane, max |got − ref| over max(1, the lane's largest |ref|)."""
    n = ref.shape[0]
    a, b = got.reshape(n, -1).astype(np.float64), ref.reshape(n, -1)
    scale = np.maximum(1.0, np.abs(b).max(axis=1, initial=0.0))
    return np.abs(a - b).max(axis=1, initial=0.0) / scale


def _assert_state_close(got, ref, tol, msg):
    """Field by field over a numpy state tree: int and bool fields equal,
    float fields within tol of each lane's scale (the rounding of one step
    is relative to a lane's largest terms: ROADMAP C3)."""
    if isinstance(got, np.ndarray):
        ref = np.asarray(ref)
        if got.dtype.kind in "biu":
            np.testing.assert_array_equal(got, ref, err_msg=msg)
        else:
            np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref), err_msg=msg)
            err = _lane_error(np.nan_to_num(got), np.nan_to_num(ref))
            assert (err <= tol).all(), (msg, float(err.max()))
        return
    for name, g, r in zip(got._fields, got, ref):
        _assert_state_close(g, r, tol, f"{msg}.{name}")


# ---------------------------------------------------------------------------
# line searches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("search", ["armijo", "wolfe"])
@pytest.mark.parametrize("name", ["rastrigin", "rosenbrock"])
def test_sequential_searches_match_reference(search, name):
    """α, f_new and n_evals per lane. Lanes 0, 5, 10, ... search a short
    step uphill, where every trial fails (the exhaustion branch); lanes 3,
    8, ... a short step downhill (the Wolfe expansion branch)."""
    X = _starts(name, B, D, seed=11)
    jfn = jobj.get_objective(name).fn
    jvg = jvg_fn(jfn, "forward")
    F0, G0 = (np.asarray(a) for a in jax.vmap(jvg)(jnp.asarray(X)))
    P = -G0
    P[::5] = 1e-3 * G0[::5]
    P[3::5] = -1e-3 * G0[3::5]
    if search == "armijo":
        one = lambda x, p, f0, g0: jls.armijo_backtracking(  # noqa: E731
            jfn, x, p, f0, g0, c1=0.3, max_iters=20)
    else:
        one = lambda x, p, f0, g0: jls.wolfe_linesearch(  # noqa: E731
            jfn, x, p, f0, g0, jvg, max_iters=20)
    ref = jax.device_get(jax.jit(jax.vmap(one))(*(jnp.asarray(a) for a in (X, P, F0, G0))))

    obj = engine.per_lane_objective(get_objective(name).fn, "forward")
    args = tuple(torch.from_numpy(np.array(a)) for a in (X, P, F0, G0))
    if search == "armijo":
        got = linesearch.armijo_backtracking(obj.value_batch, *args, c1=0.3, max_iters=20)
    else:
        got = linesearch.wolfe_linesearch(obj.value_and_grad_batch, *args, max_iters=20)
    np.testing.assert_array_equal(got.n_evals.numpy(), ref.n_evals)
    np.testing.assert_array_equal(got.alpha.numpy(), ref.alpha)
    np.testing.assert_allclose(got.f_new.numpy(), ref.f_new, rtol=1e-5, atol=1e-5)
    if search == "armijo":
        assert (got.n_evals.numpy()[::5] == 20).any()  # exhausted uphill lanes


# ---------------------------------------------------------------------------
# L-BFGS
# ---------------------------------------------------------------------------
def _memory(m=4, d=D, seed=12):
    """Six lanes of circular buffers: empty, partly filled (1 and 3 pairs),
    exactly full, and full and wrapped twice over (heads 1 and 3). Every
    stored pair has positive curvature; empty slots are zero."""
    rng = np.random.default_rng(seed)
    heads, counts = [0, 1, 3, 0, 1, 3], [0, 1, 3, m, m, m]
    n = len(heads)
    s = np.zeros((n, m, d), np.float32)
    y = np.zeros((n, m, d), np.float32)
    rho = np.zeros((n, m), np.float32)
    for b, (head, count) in enumerate(zip(heads, counts)):
        for k in range(count):
            slot = (head - 1 - k) % m
            s[b, slot] = rng.normal(size=d)
            y[b, slot] = s[b, slot] * rng.uniform(0.5, 2.0, d) + 0.1 * rng.normal(size=d)
            rho[b, slot] = 1.0 / np.dot(s[b, slot], y[b, slot])
    assert (rho >= 0).all()
    return lbfgs.LBFGSMemory(s, y, rho, np.array(heads, np.int32),
                             np.array(counts, np.int32))


def test_two_loop_direction_matches_reference():
    mem = _memory()
    G = np.random.default_rng(13).normal(size=(6, D)).astype(np.float32)
    ref = np.asarray(jax.vmap(jlbfgs.two_loop_direction)(_jax_tree(mem), jnp.asarray(G)))
    got = lbfgs.two_loop_direction(interop.lbfgs_memory_from_numpy(mem),
                                   torch.from_numpy(G))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    # no pairs: steepest descent, exactly
    np.testing.assert_array_equal(got.numpy()[0], -G[0])


def test_lbfgs_update_state_matches_reference():
    mem = _memory(seed=14)
    rng = np.random.default_rng(15)
    dx = rng.normal(size=(6, D)).astype(np.float32)
    dg = (dx * rng.uniform(0.5, 2.0, (6, D))).astype(np.float32)
    ref = jax.device_get(jax.vmap(jlbfgs.LBFGS(4).update_state)(
        _jax_tree(mem), jnp.asarray(dx), jnp.asarray(dg)))
    got = lbfgs.LBFGS(4).update_state(interop.lbfgs_memory_from_numpy(mem),
                                      torch.from_numpy(dx), torch.from_numpy(dg))
    _assert_state_close(_np(got), ref, 1e-6, "memory")


# ---------------------------------------------------------------------------
# one step from the reference's own state
# ---------------------------------------------------------------------------
STEP_CASES = {
    "dense-reference": dict(solver="bfgs", hessian_impl="reference"),
    "dense-fast": dict(solver="bfgs", hessian_impl="fast"),
    "dense-pallas": dict(solver="bfgs", hessian_impl="pallas"),
    "dense-fast-wolfe": dict(solver="bfgs", hessian_impl="fast", linesearch="wolfe"),
    "lbfgs-per_lane": dict(solver="lbfgs"),
    "lbfgs-batched": dict(solver="lbfgs", sweep_mode="batched"),
}


def _strategies(case):
    c = STEP_CASES[case]
    if c["solver"] == "bfgs":
        return jbfgs.DenseBFGS(c["hessian_impl"]), bfgs.DenseBFGS(c["hessian_impl"])
    return jlbfgs.LBFGS(4), lbfgs.LBFGS(4)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_step_from_reference_state(case):
    """Two reference steps build a non-trivial direction state; the port
    then takes the third step from that exact state, as does the reference."""
    c = STEP_CASES[case]
    name = "rosenbrock"
    batched = c.get("sweep_mode") == "batched"
    linesearch_ = c.get("linesearch", "armijo")
    jfn, pfn = jobj.get_objective(name).fn, get_objective(name).fn
    jstrat, pstrat = _strategies(case)
    jopts = jengine.EngineOptions(sweep_mode="batched" if batched else "per_lane",
                                  theta=1e-4, linesearch=linesearch_)
    popts = engine.EngineOptions(sweep_mode=jopts.sweep_mode, theta=1e-4,
                                 linesearch=linesearch_)
    X0 = jnp.asarray(_starts(name, B, D, seed=16))
    with reference_kernels_off_tpu():
        if batched:
            # the per-lane vmap evaluators as the batched objective: the same
            # values the port's vmap(f) gives, with no fused kernel
            jb = jobj.BatchedObjective(jfn, name=None, ad_mode="forward")
            js = jengine.as_batched_strategy(jstrat)
            init = lambda X: jengine.batch_lanes_init(jb, js, X, 1e-4)  # noqa: E731
            step = jax.jit(lambda ls: jengine.batch_lanes_step(jb, js, jopts, ls)[0])
        else:
            jvg = jvg_fn(jfn, "forward")
            init = jax.vmap(lambda x: jengine.lane_init(jvg, jstrat, x, 1e-4))
            step = jax.jit(jax.vmap(functools.partial(jengine.lane_step, jfn, jvg,
                                                      jstrat, jopts)))
        lanes = init(X0)
        for _ in range(2):
            lanes = step(lanes)
        before = jax.device_get(lanes)
        after = jax.device_get(step(lanes))

    if batched:
        pb = engine.per_lane_objective(pfn, "forward")
        got = engine.batch_lanes_step(pb, engine.as_batched_strategy(pstrat), popts,
                                      interop.batch_lanes_from_numpy(before))[0]
    elif case == "dense-fast":  # through the reference's LaneState API
        state = bfgs._from_engine_lane(interop.lane_from_numpy(before))
        got = bfgs._to_engine_lane(bfgs._lane_step(
            pfn, bfgs.BFGSOptions(theta=1e-4, sweep_mode="per_lane"), state))
    else:
        obj = engine.per_lane_objective(pfn, "forward")
        got = engine.lane_step(obj.value_batch, obj.value_and_grad_batch, pstrat, popts,
                               interop.lane_from_numpy(before))
    got = _np(got)
    assert int((~(before.converged | before.failed)).sum()) > B // 2
    # 1e-5 of each lane's scale; the ρ-form against the literal triple
    # product (hessian_impl="pallas" here) 1e-4, as in the kernel test
    tol = 1e-4 if c.get("hessian_impl") == "pallas" else 1e-5
    _assert_state_close(got, after, tol, case)


# ---------------------------------------------------------------------------
# zeus() sweep by sweep
# ---------------------------------------------------------------------------
N_PART, DIM, ITER_PSO, ITER_BFGS, THETA = 40, 5, 2, 20, 1e-4
ZEUS_CASES = {
    "per_lane-bfgs-rastrigin": dict(name="rastrigin", sweep_mode="per_lane"),
    "per_lane-lbfgs-ackley": dict(name="ackley", sweep_mode="per_lane", solver="lbfgs"),
    "batched-lbfgs-rastrigin": dict(name="rastrigin", sweep_mode="batched",
                                    solver="lbfgs"),
}


def _zeus_opts(case):
    c = ZEUS_CASES[case]
    return ZeusOptions(
        pso=pso.PSOOptions(n_particles=N_PART, iter_pso=ITER_PSO),
        bfgs=bfgs.BFGSOptions(iter_bfgs=ITER_BFGS, theta=THETA),
        solver=c.get("solver", "bfgs"), sweep_mode=c["sweep_mode"])


def _knife_edge(value_batch, x, p, f0, g0, alpha, c1):
    """Armijo margin at step α, relative to max(1, |threshold|)."""
    rhs = f0 + c1 * alpha * torch.dot(g0, p)
    f = value_batch((x + alpha * p)[None])[0]
    return float((f - rhs).abs()) / max(1.0, float(rhs.abs()))


@pytest.mark.parametrize("case", list(ZEUS_CASES))
def test_zeus_sweep_by_sweep(case):
    """The port's phase 2 stepped by hand, with the reference's step applied
    to the port's exact state before every sweep; then zeus() must have run
    exactly those sweeps."""
    c = ZEUS_CASES[case]
    name, per_lane = c["name"], c["sweep_mode"] == "per_lane"
    seed = list(ZEUS_CASES).index(case)
    pobj = get_objective(name)
    opts = _zeus_opts(case)
    draws = jax_pso_draws(jax.random.key(seed), N_PART, DIM, pobj.lower, pobj.upper,
                          ITER_PSO)
    got = zeus(pobj.fn, DIM, pobj.lower, pobj.upper, opts, device="cpu",
                    draws=ReplayDraws(draws))
    starts = pso.run_pso(pobj.fn, DIM, pobj.lower, pobj.upper, opts.pso, device="cpu",
                         draws=ReplayDraws(draws)).x

    pstrat, eo = phase2_setup(opts)
    jfn = jobj.get_objective(name).fn
    jopts = jengine.EngineOptions(
        sweep_mode=eo.sweep_mode, iter_max=eo.iter_max, theta=eo.theta,
        ls_iters=eo.ls_iters, ls_c1=eo.ls_c1, ad_mode=eo.ad_mode)
    jstrat = (jlbfgs.LBFGS(pstrat.memory) if isinstance(pstrat, lbfgs.LBFGS)
              else jbfgs.DenseBFGS(pstrat.hessian_impl))
    obj = engine.per_lane_objective(pobj.fn, eo.ad_mode)
    if per_lane:
        jvg = jvg_fn(jfn, eo.ad_mode)
        jstep = jax.jit(jax.vmap(functools.partial(jengine.lane_step, jfn, jvg, jstrat,
                                                   jopts)))
        pstep = functools.partial(engine.lane_step, obj.value_batch,
                                  obj.value_and_grad_batch, pstrat, eo)
        lanes = engine.lane_init(obj.value_and_grad_batch, pstrat, starts, THETA,
                                 eo.ad_mode)
        vg_cost = grad_eval_cost(DIM, eo.ad_mode)
    else:
        pb = engine.as_batched_strategy(pstrat)
        bobj = engine.as_batched(pobj.fn, ad_mode=eo.ad_mode)
        jb = jobj.as_batched(jfn, ad_mode=eo.ad_mode)
        js = jengine.as_batched_strategy(jstrat)
        jstep_full = jax.jit(lambda ls: jengine.batch_lanes_step(jb, js, jopts, ls))
        jstep = lambda ls: jstep_full(ls)[0]  # noqa: E731
        jrung = jax.jit(lambda x, p, f, g: jls.armijo_backtracking_batch(
            jb.value_batch, x, p, f, g, c1=eo.ls_c1, max_iters=eo.ls_iters).rung)
        lanes = engine.batch_lanes_init(bobj, pb, starts, THETA)
    alphas = torch.as_tensor(linesearch.ladder_alphas(eo.ls_iters, np.float32))

    knife, k = [], 0
    with reference_kernels_off_tpu():
        while (k < ITER_BFGS and int(lanes.converged.sum()) < N_PART
               and int((~(lanes.converged | lanes.failed)).sum()) > 0):
            pre, pre_np = lanes, _np(lanes)
            ref = jax.device_get(jstep(_jax_tree(pre_np)))
            if per_lane:
                lanes = pstep(pre)
                P = pstrat.direction(pre.direction_state, pre.g)
                P = torch.where((torch.sum(P * pre.g, -1) < 0)[:, None], P, -pre.g)
                active = (~(pre.converged | pre.failed)).numpy()
                # trials per lane: the n_evals increment less one value+grad
                n_port = (lanes.n_evals - pre.n_evals).numpy() - vg_cost
                n_ref = ref.n_evals - pre_np.n_evals - vg_cost
                odd = np.nonzero(active & (n_port != n_ref))[0]
                disputed = {i: alphas[min(n_port[i], n_ref[i]) - 1] for i in odd}
                value_batch = obj.value_batch
            else:
                lanes, _, rung = engine.batch_lanes_step(bobj, pb, eo, pre)
                P = torch.where((torch.sum(pre.p * pre.g, -1) < 0)[:, None], pre.p,
                                -pre.g)
                ref_rung = np.asarray(jrung(jnp.asarray(pre_np.x), jnp.asarray(P.numpy()),
                                            jnp.asarray(pre_np.f), jnp.asarray(pre_np.g)))
                odd = np.nonzero(rung.numpy() != ref_rung)[0]
                disputed = {i: alphas[min(int(rung[i]), ref_rung[i])] for i in odd}
                value_batch = bobj.value_batch
            odd = set(odd.tolist())
            for i in sorted(odd):
                margin = _knife_edge(value_batch, pre.x[i], P[i], pre.f[i], pre.g[i],
                                     disputed[i], eo.ls_c1)
                assert margin <= 1e-5, (case, k, i, margin)
                knife.append((k, i, "accept", margin))
            for i in set(np.nonzero(lanes.converged.numpy() != ref.converged)[0]) - odd:
                gn = float(torch.linalg.vector_norm(lanes.g[i]))
                assert abs(gn - THETA) <= 1e-3 * THETA, (case, k, i, gn)
                knife.append((k, i, "status", gn))
                odd.add(i)
            keep = np.array([i not in odd for i in range(N_PART)])
            now = _np(lanes)
            np.testing.assert_array_equal(now.failed[keep], ref.failed[keep])
            fields = [("x", now.x, ref.x), ("f", now.f[:, None], ref.f[:, None]),
                      ("g", now.g, ref.g)]
            ds = now.direction_state
            if isinstance(ds, lbfgs.LBFGSMemory):
                np.testing.assert_array_equal(ds.head[keep], ref.direction_state.head[keep])
                fields += [(f, getattr(ds, f), getattr(ref.direction_state, f))
                           for f in ("s_buf", "y_buf", "rho_buf")]
            else:
                fields.append(("H", ds, ref.direction_state))
            for fname, a, b in fields:
                a, b = a[keep].reshape(keep.sum(), -1), b[keep].reshape(keep.sum(), -1)
                scale = np.maximum(1.0, np.abs(b).max(axis=1))
                err = (np.abs(a - b).max(axis=1) / scale).max()
                assert err <= 1e-3, (case, k, fname, err)
            k += 1
    for edge in knife:
        print(f"{case}: knife edge at sweep {edge[0]} lane {edge[1]} ({edge[2]}, "
              f"{edge[3]:.3g})")
    assert k > 3
    assert got.raw.iterations == k
    assert torch.equal(got.raw.x, lanes.x) and torch.equal(got.raw.fval, lanes.f)
    assert got.n_converged == int(lanes.converged.sum())
    assert got.raw.eval_rows == (0 if per_lane else N_PART * (1 + 21 * k))


# ---------------------------------------------------------------------------
# the paper's sequential baseline (Alg. 1)
# ---------------------------------------------------------------------------
def _folded_seed(key):
    """The integer the reference folds its key into for numpy."""
    return int(jax.random.randint(key, (), 0, 2**31 - 1))


def test_sequential_pso_matches_reference_exactly():
    name, n, dim = "rastrigin", 12, 3
    key = jax.random.key(21)
    jo = jobj.get_objective(name)
    ref = jax.device_get(jpso.sequential_pso(jo.fn, key, dim, jo.lower, jo.upper,
                                             jpso.PSOOptions(n_particles=n, iter_pso=3)))
    po = get_objective(name)
    got = pso.sequential_pso(po.fn, _folded_seed(key), dim, po.lower, po.upper,
                             pso.PSOOptions(n_particles=n, iter_pso=3), device="cpu")
    for field in pso.SwarmState._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(), getattr(ref, field),
                                      err_msg=field)


@pytest.mark.parametrize("use_pso", [True, False])
def test_sequential_zeus_matches_reference(use_pso):
    """Ten starts on rastrigin D=2, each solved serially until 4 converge,
    compared by outcome: the convergence count and the starts used equal,
    best f to 1e-5 and best x to 1e-4. Θ = 0.1 keeps every serial solve
    above rastrigin's fp32 floor: near its local minima (f ≈ 2-20) a step
    that lowers f by less than one ulp is accepted or not as XLA's or
    torch's rounding of cos decides, and free-running solves fork there
    (ROADMAP C5)."""
    name, dim = "rastrigin", 2
    key = jax.random.key(22)
    common = dict(iter_bfgs=30, theta=0.1, required_c=4)
    jo = jobj.get_objective(name)
    ref = jsequential_zeus(
        jo.fn, key, dim, jo.lower, jo.upper,
        JZeusOptions(pso=jpso.PSOOptions(n_particles=10, iter_pso=2),
                          bfgs=jbfgs.BFGSOptions(**common), use_pso=use_pso))
    po = get_objective(name)
    got = sequential_zeus(
        po.fn, _folded_seed(key), dim, po.lower, po.upper,
        ZeusOptions(pso=pso.PSOOptions(n_particles=10, iter_pso=2),
                         bfgs=bfgs.BFGSOptions(**common, sweep_mode="per_lane"),
                         use_pso=use_pso),
        device="cpu")
    assert (got.n_converged, got.n_started, got.n_failed) == (
        ref.n_converged, ref.n_started, ref.n_failed)
    np.testing.assert_allclose(got.best_f, ref.best_f, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.best_x, ref.best_x, rtol=1e-4, atol=1e-4)
    assert got.wall_time_s > 0


def test_serial_and_batched_solvers_run():
    """serial_bfgs, batched_bfgs and batched_lbfgs on the CPU, against the
    engine they wrap."""
    obj = get_objective("sphere")
    x0 = torch.from_numpy(_starts("sphere", 6, 3, seed=23))
    one = bfgs.serial_bfgs(obj.fn, x0[0], bfgs.BFGSOptions(sweep_mode="per_lane"),
                           device="cpu")
    assert one.status == engine.CONVERGED and float(one.fval) < 1e-8
    many = bfgs.batched_bfgs(obj.fn, x0, bfgs.BFGSOptions(), device="cpu")
    assert many.n_converged == 6
    lb = lbfgs.batched_lbfgs(obj.fn, x0, lbfgs.LBFGSOptions(sweep_mode="per_lane"),
                             device="cpu")
    assert lb.n_converged == 6 and lb.eval_rows == 0
