"""The port's core modules against the JAX package on identical inputs:
the α ladder, the batched Armijo search, one batched sweep started from the
reference's own state (carried over by repro_torch.interop), phase-1 PSO
fed the reference's random draws, and forward/reverse AD.

The JAX side runs its jnp reference kernels (`reference_kernels_off_tpu`),
the path its own CPU tests use; the Pallas ops themselves are held against
the port in test_torch_kernels.py.
"""
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
from repro.kernels.ops import reference_kernels_off_tpu  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import bfgs, engine, linesearch, objectives, pso  # noqa: E402
from repro_torch.core.dual import value_and_grad_fn  # noqa: E402

FUSED = ("sphere", "rastrigin", "rosenbrock", "ackley")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _starts(name, B, D, seed):
    obj = jobj.get_objective(name)
    return np.random.default_rng(seed).uniform(
        obj.lower, obj.upper, (B, D)).astype(np.float32)


class ReplayDraws:
    """A draws hook that hands out pre-made arrays in order (the reference's
    jax.random draws), checking each request's shape and range."""

    def __init__(self, arrays):
        self.arrays = list(arrays)

    def __call__(self, shape, low, high):
        a = self.arrays.pop(0)
        assert a.shape == tuple(shape)
        assert a.min() >= low and a.max() <= high
        return torch.from_numpy(np.array(a))


def jax_pso_draws(key, n, dim, lower, upper, iters, dtype=jnp.float32):
    """The draws of repro.core.pso.run_pso, in call order: init_swarm
    splits (key, 3) into kx, kv, knext; each step splits its key into
    k1, k2, knext. float64 draws need jax's x64 mode on."""
    kx, kv, key = jax.random.split(key, 3)
    rng = upper - lower
    out = [jax.random.uniform(kx, (n, dim), dtype, lower, upper),
           jax.random.uniform(kv, (n, dim), dtype, -rng, rng)]
    for _ in range(iters):
        k1, k2, key = jax.random.split(key, 3)
        out += [jax.random.uniform(k1, (n, dim), dtype),
                jax.random.uniform(k2, (n, dim), dtype)]
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("K,alpha0,shrink", [(20, 1.0, 0.5), (13, 0.8, 0.7),
                                             (1, 1.0, 0.5)])
def test_ladder_alphas_bit_equal(K, alpha0, shrink):
    a = linesearch.ladder_alphas(K, np.float32, alpha0, shrink)
    b = jls.ladder_alphas(K, jnp.float32, alpha0, shrink)
    assert a.dtype == b.dtype and np.array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("name", FUSED)
def test_armijo_backtracking_batch_matches(name):
    B, D = 48, 6
    X = _starts(name, B, D, seed=1)
    with reference_kernels_off_tpu():
        jb = jobj.as_batched(jobj.get_objective(name))
        F0, G0 = (np.asarray(a) for a in jb.value_and_grad_batch(jnp.asarray(X)))
        P = -G0
        P[::5] = 0.1 * G0[::5]  # ascent lanes: the exhaustion branch
        jres = jls.armijo_backtracking_batch(
            jb.value_batch, jnp.asarray(X), jnp.asarray(P), jnp.asarray(F0),
            jnp.asarray(G0), c1=0.3, max_iters=20)
    pb = objectives.as_batched(objectives.get_objective(name))
    pres = linesearch.armijo_backtracking_batch(
        pb.value_batch, *(torch.from_numpy(a) for a in (X, P, F0, G0)),
        c1=0.3, max_iters=20)
    np.testing.assert_array_equal(pres.rung.numpy(), np.asarray(jres.rung))
    np.testing.assert_allclose(pres.alpha.numpy(), np.asarray(jres.alpha), rtol=1e-6)
    np.testing.assert_allclose(pres.f_new.numpy(), np.asarray(jres.f_new),
                               rtol=1e-5, atol=1e-6)
    assert pres.n_evals == int(jres.n_evals)


@pytest.mark.parametrize("name", FUSED)
def test_batch_lanes_step_from_reference_state(name):
    """Two reference sweeps build a non-trivial H stack; the port then takes
    the third sweep from that exact state, as does the reference."""
    B, D = 40, 6
    X0 = jnp.asarray(_starts(name, B, D, seed=2))
    eopts = jengine.EngineOptions(sweep_mode="batched", theta=1e-4)
    with reference_kernels_off_tpu():
        jb, js = jobj.as_batched(jobj.get_objective(name)), jbfgs.BatchedDenseBFGS()
        lanes = jengine.batch_lanes_init(jb, js, X0, eopts.theta)
        for _ in range(2):
            lanes, _, _ = jengine.batch_lanes_step(jb, js, eopts, lanes)
        before = jax.device_get(lanes)
        after, jrows, jhist = jengine.batch_lanes_step(jb, js, eopts, lanes)
        after = jax.device_get(after)
        # per-lane rungs of that sweep, from the reference's line search
        P = np.where((np.sum(before.p * before.g, -1) < 0)[:, None],
                     before.p, -before.g)
        jrung = np.asarray(jls.armijo_backtracking_batch(
            jb.value_batch, jnp.asarray(before.x), jnp.asarray(P),
            jnp.asarray(before.f), jnp.asarray(before.g), max_iters=20).rung)

    plane = interop.batch_lanes_from_numpy(before._asdict())
    popts = engine.EngineOptions(theta=1e-4)
    pb = objectives.as_batched(objectives.get_objective(name))
    stepped, rows, rung = engine.batch_lanes_step(pb, bfgs.BatchedDenseBFGS(),
                                                  popts, plane)
    np.testing.assert_array_equal(rung.numpy(), jrung)
    active = ~(before.converged | before.failed)
    np.testing.assert_array_equal(
        np.bincount(rung.numpy()[active], minlength=21), np.asarray(jhist))
    assert rows == int(jrows)
    for field in ("converged", "failed", "n_evals"):
        np.testing.assert_array_equal(getattr(stepped, field).numpy(),
                                      getattr(after, field))
    for field in ("x", "f", "g", "direction_state"):
        np.testing.assert_allclose(getattr(stepped, field).numpy(),
                                   getattr(after, field), rtol=1e-5, atol=1e-5,
                                   err_msg=field)
    # p' = −H'g' sums D products of up to |H'||g'| and cancels where g' is
    # large (rastrigin's |g| reaches ~700); H' itself carries the rounding of
    # the cancelling rank-1 terms ρ(uδxᵀ + δxuᵀ). Bound p's error by the
    # matvec's own magnitude: 1e-4·(|H'|·|g'|)_i
    bound = 1e-4 * np.einsum("bij,bj->bi", np.abs(after.direction_state),
                             np.abs(after.g)) + 1e-6
    assert (np.abs(stepped.p.numpy() - after.p) <= bound).all()


@pytest.mark.parametrize("clip_to_range", [False, True])
def test_run_pso_with_reference_draws(clip_to_range):
    name, n, dim, iters = "rastrigin", 64, 5, 4
    obj = jobj.get_objective(name)
    key = jax.random.key(3)
    opts = dict(n_particles=n, iter_pso=iters, clip_to_range=clip_to_range)
    with reference_kernels_off_tpu():
        ref = jax.device_get(jpso.run_pso(obj.fn, key, dim, obj.lower, obj.upper,
                                          jpso.PSOOptions(**opts)))
    draws = ReplayDraws(jax_pso_draws(key, n, dim, obj.lower, obj.upper, iters))
    pobj = objectives.get_objective(name)
    got = pso.run_pso(pobj.fn, dim, pobj.lower, pobj.upper, pso.PSOOptions(**opts),
                      device="cpu", draws=draws)
    assert not draws.arrays  # every reference draw consumed, in order
    for field in pso.SwarmState._fields:
        np.testing.assert_allclose(getattr(got, field).numpy(), getattr(ref, field),
                                   rtol=1e-5, atol=1e-5, err_msg=field)


def test_swarm_state_interop_round_trip():
    state = {"x": np.ones((3, 2), np.float32), "v": np.zeros((3, 2), np.float32),
             "px": np.ones((3, 2), np.float32), "pf": np.arange(3, dtype=np.float32),
             "gx": np.ones(2, np.float32), "gf": np.float32(0.0), "key": None}
    s = interop.swarm_state_from_numpy(state)
    assert s.x.dtype == torch.float32 and s.gf.dim() == 0
    # float64 state (the reference's under x64) keeps its dtype
    s64 = interop.swarm_state_from_numpy({k: (np.asarray(v, np.float64) if v is not None
                                              else None) for k, v in state.items()})
    assert s64.x.dtype == torch.float64 and s64.gf.dtype == torch.float64
    np.testing.assert_array_equal(s64.x.numpy(), state["x"])


@pytest.mark.parametrize("mode", ["forward", "reverse"])
def test_value_and_grad_fn_goldstein_price(mode):
    X = _starts("goldstein_price", 9, 2, seed=4)
    jfn = jvg_fn(jobj.goldstein_price, mode)
    pfn = value_and_grad_fn(objectives.goldstein_price, mode)
    for x in X:
        jv, jg = jfn(jnp.asarray(x))
        pv, pg = pfn(torch.from_numpy(x))
        assert pv.dtype == torch.float32 and pg.dtype == torch.float32
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=1e-5)
        np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-3)
