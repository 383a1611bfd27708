"""The port's mean-field phase 1 against the JAX package on identical
inputs: the LSE-stable consensus point (with non-finite values), the
mean-field swarm after `iter_pso` steps fed the reference's own random
draws, in both noise modes, and zeus(phase1="meanfield") through phase 1.

Tolerances: the consensus point and one step from the reference's state
1e-5 (a softmax-weighted sum of N rows in float32, added in other orders by
XLA's dot and torch's matvec); the swarm after iter_pso steps 1e-4 of each
row's scale, since x̄ feeds every particle's next step and the objective
values (cos, exp) round differently in the two libraries.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import meanfield as jmf  # noqa: E402
from repro.core import objectives as jobj  # noqa: E402
from repro.core.zeus import ZeusOptions as JZeusOptions  # noqa: E402
from repro.core.zeus import run_phase1 as jax_run_phase1  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import BFGSOptions, ZeusOptions, get_objective, zeus  # noqa: E402
from repro_torch.core import meanfield  # noqa: E402
from repro_torch.core.zeus import phase1_particles, run_phase1  # noqa: E402
from test_torch_core import ReplayDraws  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class ReplayNormalDraws(ReplayDraws):
    """ReplayDraws with the normal draws of the mean-field swarm, handed
    out from the same queue in call order."""

    def normal(self, shape):
        a = self.arrays.pop(0)
        assert a.shape == tuple(shape)
        return torch.from_numpy(np.array(a))


def jax_meanfield_draws(key, n, dim, lower, upper, iters):
    """The draws of repro.core.meanfield.run_meanfield_pso, in call order:
    init_meanfield splits (key, 3) into kx, kv, knext; each step splits its
    key into knoise, knext."""
    kx, kv, key = jax.random.split(key, 3)
    rng = upper - lower
    out = [jax.random.uniform(kx, (n, dim), jnp.float32, lower, upper),
           jax.random.uniform(kv, (n, dim), jnp.float32, -rng, rng)]
    for _ in range(iters):
        knoise, key = jax.random.split(key)
        out.append(jax.random.normal(knoise, (n, dim), jnp.float32))
    return [np.asarray(a) for a in out]


def _fx(seed, n=50, d=4):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.0, 40.0, n).astype(np.float32),
            rng.uniform(-5.0, 5.0, (n, d)).astype(np.float32))


@pytest.mark.parametrize("case", ["finite", "some-nonfinite", "all-nonfinite"])
def test_consensus_point_matches_reference(case):
    f, x = _fx(30)
    if case == "some-nonfinite":
        f[[3, 17]] = np.nan
        f[8] = np.inf
        f[21] = -np.inf  # −β·(−inf) = +inf is not finite either: weight 0
    elif case == "all-nonfinite":
        f[:] = np.nan
        f[::2] = np.inf
    ref = np.asarray(jmf.consensus_point(jnp.asarray(f), jnp.asarray(x), 30.0))
    got = meanfield.consensus_point(torch.from_numpy(f), torch.from_numpy(x), 30.0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert torch.isfinite(got).all()
    if case == "all-nonfinite":
        assert (got == 0).all()


def test_consensus_moments_match_reference():
    f, x = _fx(31)
    jm, jS, jN = (np.asarray(a) for a in jmf.consensus_moments(
        jnp.asarray(f), jnp.asarray(x), 0.5))
    m, S, N = meanfield.consensus_moments(torch.from_numpy(f), torch.from_numpy(x), 0.5)
    assert float(m) == float(jm)
    np.testing.assert_allclose(S.numpy(), jS, rtol=1e-5)
    np.testing.assert_allclose(N.numpy(), jN, rtol=1e-5, atol=1e-5)


def _close_rows(got, ref, tol=1e-4):
    scale = np.maximum(1.0, np.abs(ref).max(axis=-1, keepdims=True))
    np.testing.assert_array_less(np.abs(got - ref) / scale, tol)


@pytest.mark.parametrize("noise,clip", [("anisotropic", False), ("isotropic", True)])
def test_run_meanfield_pso_with_reference_draws(noise, clip):
    name, n, dim, iters = "rastrigin", 96, 5, 4
    jo = jobj.get_objective(name)
    key = jax.random.key(32)
    kw = dict(n_particles=n, iter_pso=iters, noise=noise, clip_to_range=clip)
    ref = jax.device_get(jmf.run_meanfield_pso(jo.fn, key, dim, jo.lower, jo.upper,
                                               jmf.MeanFieldPSOOptions(**kw)))
    draws = ReplayNormalDraws(jax_meanfield_draws(key, n, dim, jo.lower, jo.upper, iters))
    po = get_objective(name)
    got = meanfield.run_meanfield_pso(po.fn, dim, po.lower, po.upper,
                                      meanfield.MeanFieldPSOOptions(**kw),
                                      device="cpu", draws=draws)
    assert not draws.arrays  # every reference draw consumed, in order
    got = interop.state_to_numpy(got)
    for field in ("x", "v"):
        _close_rows(getattr(got, field), getattr(ref, field))
    np.testing.assert_allclose(got.consensus, ref.consensus, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.gf, ref.gf, rtol=1e-5)
    # one more step from the reference's exact state, with its own noise
    jopts = jmf.MeanFieldPSOOptions(**kw)
    ref_next = jax.device_get(jmf.meanfield_step(jo.fn, jax.tree.map(jnp.asarray, ref),
                                                 jopts, jo.lower, jo.upper))
    xi = np.asarray(jax.random.normal(jax.random.split(ref.key)[0], (n, dim), jnp.float32))
    nxt = meanfield.meanfield_step(po.fn, interop.meanfield_state_from_numpy(ref),
                                   meanfield.MeanFieldPSOOptions(**kw), po.lower,
                                   po.upper, ReplayNormalDraws([xi]))
    nxt = interop.state_to_numpy(nxt)
    for field in ("x", "v"):
        _close_rows(getattr(nxt, field), getattr(ref_next, field), tol=1e-5)
    np.testing.assert_allclose(nxt.consensus, ref_next.consensus, rtol=1e-5, atol=1e-5)


def test_zeus_meanfield_phase1_matches_reference():
    """zeus(phase1="meanfield") hands phase 2 the mean-field swarm: with the
    reference's draws, phase 1 gives the reference's starts and best value
    seen, and phase 2 solves all n_particles lanes."""
    name, n, dim = "rastrigin", 64, 4
    jo = jobj.get_objective(name)
    key = jax.random.key(34)
    mf = dict(n_particles=n, iter_pso=3)
    ref_starts, ref_best = jax_run_phase1(
        jo.fn, key, dim, jo.lower, jo.upper,
        JZeusOptions(phase1="meanfield", meanfield=jmf.MeanFieldPSOOptions(**mf)),
        jnp.float32)
    po = get_objective(name)
    opts = ZeusOptions(phase1="meanfield", meanfield=meanfield.MeanFieldPSOOptions(**mf),
                       bfgs=BFGSOptions(iter_bfgs=5))
    assert phase1_particles(opts) == n
    draws = jax_meanfield_draws(key, n, dim, jo.lower, jo.upper, 3)
    starts, best = run_phase1(po.fn, dim, po.lower, po.upper, opts,
                              ReplayNormalDraws(draws), "cpu")
    _close_rows(starts.numpy(), np.asarray(ref_starts))
    np.testing.assert_allclose(float(best), float(ref_best), rtol=1e-5)
    got = zeus(po.fn, dim, po.lower, po.upper, opts, device="cpu",
               draws=ReplayNormalDraws(draws))
    assert float(got.pso_best_f) == float(best)
    assert got.raw.x.shape == (n, dim) and got.raw.iterations == 5
