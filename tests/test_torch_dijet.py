"""The paper's application (§V-G, Fig. 5): the dijet spectrum fit, and the
dual-number AD of Alg. 5, in the port against the JAX package.

- `dijet_rate` and `make_dijet_nll`'s value and gradient at 16 seeded
  points in the example's box, float32 on both sides;
- `simulate_dijet_counts` for the example's edges and TRUE parameters:
  the same counts exactly (both draw with numpy's default_rng(seed).poisson
  from a float32 μ);
- `Dual`'s operators, `forward_ad` and `value_and_forward_ad` on the three
  `*_dual` objectives, against the reference's and against the port's
  `value_and_grad_fn`;
- one small zeus on the dijet NLL, on the CPU, that converges lanes.

Every input comes from a numpy seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import dual as jdual  # noqa: E402
from repro.core import objectives as jobj  # noqa: E402
from repro_torch.core import BFGSOptions, PSOOptions, ZeusOptions, zeus  # noqa: E402
from repro_torch.core import dual as pdual  # noqa: E402
from repro_torch.core import objectives as pobj  # noqa: E402

TRUE = np.array([-2.0, 10.0, 4.5, 0.3])  # examples/fit_dijet.py
EDGES = np.linspace(1000.0, 6000.0, 41)
LOWER, UPPER = -5.0, 15.0
# float32 on both sides, through XLA's and torch's own exp/log/log1p: the
# NLL sums 40 terms of up to ~1e5 and cancels to ~-6e4, so values agree to
# a few float32 ulps of the largest term; gradients to 1e-4 of the largest
# component (forward-mode AD on both sides)
NLL_RTOL, GRAD_RTOL = 2e-6, 1e-4
# the rate is exp(log-rate), and the log-rate a sum of three terms that may
# cancel: an ulp of a term of magnitude t moves the rate by a relative
# 2^-23·t, so rates agree to a few ulps of the terms' summed magnitude
RATE_ULPS = 8
DUAL_RTOL = 1e-6  # the same operator sequence in float32


@pytest.fixture(scope="module")
def counts():
    return jobj.simulate_dijet_counts(TRUE, EDGES, seed=7)


def _points(n=16, seed=22):
    """n points in the example's box, half of them near TRUE (where the
    NLL is finite), half uniform (where exp may overflow to inf)."""
    rng = np.random.default_rng(seed)
    near = TRUE + rng.normal(0.0, 0.5, (n // 2, 4))
    box = rng.uniform(LOWER, UPPER, (n - n // 2, 4))
    return np.concatenate([near, box]).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 7])
def test_simulated_counts_equal_reference(seed):
    want = jobj.simulate_dijet_counts(TRUE, EDGES, seed=seed)
    got = pobj.simulate_dijet_counts(TRUE, EDGES, seed=seed)
    assert got.dtype == np.float64 and got.shape == (40,)
    np.testing.assert_array_equal(got, want)


def test_rate_matches_reference():
    centers = (0.5 * (EDGES[:-1] + EDGES[1:])).astype(np.float32)
    pts = _points()
    want = np.stack([np.asarray(jobj.dijet_rate(jnp.asarray(p), jnp.asarray(centers)))
                     for p in pts])
    got = pobj.dijet_rate(torch.from_numpy(pts), torch.from_numpy(centers)).numpy()
    assert got.shape == (16, 40)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    p = pts.astype(np.float64)[:, :, None]
    lx = np.log(centers.astype(np.float64) / pobj.SQRT_S)
    terms = (np.abs(p[:, 0]) + np.abs(p[:, 1] * np.log1p(-np.exp(lx)))
             + np.abs((p[:, 2] + p[:, 3] * lx) * lx))
    rel = np.abs(got[fin] - want[fin]) / want[fin]
    assert np.all(rel <= RATE_ULPS * 2.0 ** -23 * np.maximum(1.0, terms[fin]))


def test_nll_value_and_gradient_match_reference(counts):
    jnll = jobj.make_dijet_nll(EDGES, counts)
    pnll = pobj.make_dijet_nll(EDGES, counts)
    jvg = jax.jit(jax.vmap(jdual.value_and_grad_fn(jnll, "forward")))
    pvg = torch.func.vmap(pdual.value_and_grad_fn(pnll, "forward"))
    pts = _points()
    jf, jg = (np.asarray(a) for a in jvg(jnp.asarray(pts)))
    pf, pg = (a.numpy() for a in pvg(torch.from_numpy(pts)))
    fin = np.isfinite(jf)
    assert fin.sum() >= 8
    np.testing.assert_array_equal(np.isfinite(pf), fin)
    scale = np.maximum(1.0, np.abs(jf[fin]))
    assert np.all(np.abs(pf[fin] - jf[fin]) <= NLL_RTOL * scale * 40)
    gscale = np.max(np.abs(jg[fin]), axis=1, keepdims=True)
    assert np.all(np.abs(pg[fin] - jg[fin]) <= GRAD_RTOL * gscale)
    # the batched call is the per-point one
    one = pnll(torch.from_numpy(pts[0]))
    assert one.shape == () and torch.equal(one, pnll(torch.from_numpy(pts[:1]))[0])


# ---------------------------------------------------------------------------
# Dual numbers (Alg. 5)
# ---------------------------------------------------------------------------
def _pair(seed, n=6, positive=False):
    rng = np.random.default_rng(seed)
    v = rng.uniform(0.5, 2.0, n) if positive else rng.uniform(-2.0, 2.0, n)
    return v.astype(np.float32), rng.normal(size=n).astype(np.float32)


OPS = {
    "add": lambda M, a, b: a + b, "radd": lambda M, a, b: 1.5 + a,
    "sub": lambda M, a, b: a - b, "rsub": lambda M, a, b: 1.5 - a,
    "neg": lambda M, a, b: -a, "mul": lambda M, a, b: a * b,
    "rmul": lambda M, a, b: 2.5 * a, "div": lambda M, a, b: a / b,
    "rdiv": lambda M, a, b: 2.0 / a, "pow": lambda M, a, b: a ** 3,
    "dual-pow": lambda M, a, b: a ** b,
    "sin": lambda M, a, b: M.dsin(a), "cos": lambda M, a, b: M.dcos(a),
    "exp": lambda M, a, b: M.dexp(a), "log": lambda M, a, b: M.dlog(a),
    "sqrt": lambda M, a, b: M.dsqrt(a), "sum": lambda M, a, b: M.dsum([a, b, a]),
}


@pytest.mark.parametrize("op", list(OPS))
def test_dual_operators_match_reference(op):
    (av, at), (bv, bt) = _pair(1, positive=True), _pair(2, positive=True)
    want = OPS[op](jdual, jdual.Dual(jnp.asarray(av), jnp.asarray(at)),
                   jdual.Dual(jnp.asarray(bv), jnp.asarray(bt)))
    got = OPS[op](pdual, pdual.Dual(torch.from_numpy(av), torch.from_numpy(at)),
                  pdual.Dual(torch.from_numpy(bv), torch.from_numpy(bt)))
    np.testing.assert_allclose(got.val.numpy(), np.asarray(want.val), rtol=DUAL_RTOL)
    np.testing.assert_allclose(got.tan.numpy(), np.asarray(want.tan), rtol=DUAL_RTOL,
                               atol=DUAL_RTOL)


def test_dual_comparisons_act_on_primals():
    a, b = pdual.Dual(torch.tensor(1.0), torch.tensor(5.0)), pdual.Dual(
        torch.tensor(2.0), torch.tensor(-5.0))
    assert bool(a < b) and bool(a <= b) and bool(b > a) and bool(b >= a)
    assert bool(a < 1.5) and not bool(a > 1.5)


@pytest.mark.parametrize("name", ["rosenbrock", "rastrigin", "sphere"])
def test_forward_ad_matches_reference_and_value_and_grad(name):
    x = np.random.default_rng(5).uniform(-2.0, 2.0, 5).astype(np.float32)
    f_dual_j, f_dual_p = getattr(jdual, f"{name}_dual"), getattr(pdual, f"{name}_dual")
    jv, jg = jdual.value_and_forward_ad(f_dual_j, jnp.asarray(x))
    pv, pg = pdual.value_and_forward_ad(f_dual_p, torch.from_numpy(x))
    np.testing.assert_allclose(float(pv), float(jv), rtol=DUAL_RTOL)
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=DUAL_RTOL,
                               atol=DUAL_RTOL * float(np.abs(jg).max()))
    assert torch.equal(pdual.forward_ad(f_dual_p, torch.from_numpy(x)), pg)
    # against the production path's forward AD on the port's objective
    fv, fg = pdual.value_and_grad_fn(pobj.get_objective(name).fn)(torch.from_numpy(x))
    np.testing.assert_allclose(float(pv), float(fv), rtol=1e-5)
    np.testing.assert_allclose(pg.numpy(), fg.numpy(), rtol=1e-5,
                               atol=1e-5 * float(fg.abs().max()))


def test_zeus_fits_the_dijet_spectrum_on_cpu(counts):
    """A small fit through the port's zeus (batched sweep, forward AD): lanes
    converge, and the best lane's NLL is at most the true parameters' + 1,
    the example's own criterion."""
    nll = pobj.make_dijet_nll(EDGES, counts)
    opts = ZeusOptions(pso=PSOOptions(n_particles=64, iter_pso=5),
                       bfgs=BFGSOptions(iter_bfgs=150, theta=1e-2, required_c=4))
    res = zeus(nll, 4, LOWER, UPPER, opts, device="cpu",
               generator=torch.Generator().manual_seed(3))
    true_f = float(nll(torch.tensor(TRUE, dtype=torch.float32)))
    assert res.n_converged >= 4
    assert float(res.best_f) <= true_f + 1.0
