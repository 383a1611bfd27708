"""The port's kernel modules (plain PyTorch versions, the CPU path) against
the JAX package's Pallas ops in interpret mode and its `kernels/ref.py`
oracles, on identical numpy inputs.

Tolerance: rtol 1e-5, atol 1e-6 — both sides compute in float32 and differ
only in the order of their sums and in their libm. The CUDA kernels
themselves run only on the card, where chip_smoke.py holds each against
these plain versions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.bfgs_update import (  # noqa: E402
    bfgs_update_pallas,
    update_direction_pallas,
)
from repro.kernels.meanfield_step import meanfield_step_pallas  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    bfgs_update,
    direction,
    flash_attention,
    fused_obj,
    meanfield_step,
    pso_step,
    sweep_megakernel,
)

RTOL, ATOL = 1e-5, 1e-6
N, D = 37, 7  # odd sizes: no tile or lane alignment to lean on
BOX = {"sphere": 5.0, "rastrigin": 5.12, "rosenbrock": 2.0, "ackley": 32.768}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rng(seed):
    return np.random.default_rng(seed)


def _x(name, seed=0, n=N, d=D):
    b = BOX[name]
    return _rng(seed).uniform(-b, b, (n, d)).astype(np.float32)


def _close(port, jax_out, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(jax_out),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", fused_obj.FUSED_OBJECTIVES)
class TestFusedObjective:
    def test_value_grad_matches_pallas_and_ref(self, name):
        x = _x(name)
        f, g = ops.fused_value_grad(name, torch.from_numpy(x))
        jf, jg = jops.fused_value_grad(name, jnp.asarray(x))
        rf, rg = getattr(jref, f"{name}_vg_ref")(jnp.asarray(x))
        _close(f, jf)
        _close(g, jg)
        _close(f, rf)
        _close(g, rg)

    def test_value_matches_pallas(self, name):
        x = _x(name, seed=1)
        _close(ops.fused_value(name, torch.from_numpy(x)),
               jops.fused_value(name, jnp.asarray(x)))

    def test_value_only_f_bitwise_equals_value_grad_f(self, name):
        x = torch.from_numpy(_x(name, seed=2))
        f_val = ops.fused_value(name, x)
        f_vg, _ = ops.fused_value_grad(name, x)
        assert torch.equal(f_val.view(torch.int32), f_vg.view(torch.int32))


def test_ackley_gradient_is_nan_at_origin():
    x = _x("ackley", seed=3)
    x[4] = 0.0
    f, g = ops.fused_value_grad("ackley", torch.from_numpy(x))
    _, jg = jops.fused_value_grad("ackley", jnp.asarray(x))
    assert torch.isfinite(f[4])
    assert torch.isnan(g[4]).all() and np.isnan(np.asarray(jg)[4]).all()
    assert torch.isfinite(g[np.arange(N) != 4]).all()


def _update_inputs(seed=4, b=N, d=D, frozen_every=5):
    rng = _rng(seed)
    a = rng.normal(size=(b, d, d)) * 0.1
    H = (np.eye(d) + 0.5 * (a + a.transpose(0, 2, 1))).astype(np.float32)
    dx = rng.normal(size=(b, d)).astype(np.float32)
    dg = (dx * rng.uniform(1.0, 2.0, (b, d))).astype(np.float32)
    g_new = rng.normal(size=(b, d)).astype(np.float32)
    rho = (1.0 / np.sum(dx * dg, axis=-1)).astype(np.float32)
    frozen = (np.zeros(b, bool) if frozen_every is None
              else np.arange(b) % frozen_every == 1)
    rho[frozen] = 0.0
    dx[frozen] = 0.0
    dg[frozen] = 0.0
    return H, dx, dg, g_new, rho, frozen


def test_guarded_update_direction_matches_pallas_and_ref():
    H, dx, dg, g_new, rho, frozen = _update_inputs()
    Hn, p = ops.guarded_update_direction(
        *(torch.from_numpy(a) for a in (H, dx, dg, g_new, rho)))
    jH, jp = jops.guarded_update_direction(
        *(jnp.asarray(a) for a in (H, dx, dg, g_new, rho)))
    rH, rp = jref.guarded_update_direction_ref(
        *(jnp.asarray(a) for a in (H, dx, dg, g_new, rho)))
    _close(Hn, jH)
    _close(p, jp)
    _close(Hn, rH)
    _close(p, rp)
    # ρ = 0 with zeroed pairs: H' is H, bit for bit
    assert torch.equal(Hn[frozen], torch.from_numpy(H[frozen]))


def test_guarded_update_equals_unguarded_bfgs_update():
    """The ρ-form equals the paper's literal triple product (ref oracle)."""
    H, dx, dg, g_new, _, _ = _update_inputs(seed=5, frozen_every=None)
    rho = (1.0 / np.sum(dx * dg, axis=-1)).astype(np.float32)
    Hn, _ = ops.guarded_update_direction(
        *(torch.from_numpy(a) for a in (H, dx, dg, g_new, rho)))
    _close(Hn, jref.bfgs_update_ref(jnp.asarray(H), jnp.asarray(dx),
                                    jnp.asarray(dg)), rtol=1e-4, atol=1e-5)


def test_direction_matches_pallas_and_ref():
    H, _, _, g, _, _ = _update_inputs(seed=6)
    p = ops.direction(torch.from_numpy(H), torch.from_numpy(g))
    _close(p, jops.direction(jnp.asarray(H), jnp.asarray(g)))
    _close(p, jref.direction_ref(jnp.asarray(H), jnp.asarray(g)))


def test_pso_step_matches_pallas_and_ref():
    rng = _rng(7)
    x, v, px = (rng.uniform(-5, 5, (N, D)).astype(np.float32) for _ in range(3))
    gx = rng.uniform(-5, 5, (D,)).astype(np.float32)
    r1, r2 = (rng.uniform(0, 1, (N, D)).astype(np.float32) for _ in range(2))
    args = (x, v, px, gx, r1, r2)
    xn, vn = ops.pso_step_update(*(torch.from_numpy(a) for a in args), 0.5, 1.2, 1.5)
    jx, jv = jops.pso_step_update(*(jnp.asarray(a) for a in args), 0.5, 1.2, 1.5)
    rx, rv = jref.pso_step_ref(*(jnp.asarray(a) for a in args), 0.5, 1.2, 1.5)
    for port, other in ((xn, jx), (vn, jv), (xn, rx), (vn, rv)):
        _close(port, other)


def test_cpu_tensors_never_count_launches():
    ops.reset_launch_counts()
    x = torch.from_numpy(_x("sphere"))
    ops.fused_value("sphere", x)
    ops.fused_value_grad("sphere", x)
    H = torch.eye(D).expand(N, D, D).contiguous()
    active = torch.ones(N, dtype=torch.bool)
    ops.sweep_megakernel_full("sphere", x, -x, 2 * x, H, active, torch.zeros(3, N),
                              torch.tensor([1.0, 0.5, 0.25]), 0.125)
    ops.sweep_megakernel_commit("sphere", x, -x, 2 * x, H, active, torch.ones(N))
    ops.flash_attention(torch.zeros(1, 4, 2, 16), torch.zeros(1, 4, 1, 16),
                        torch.zeros(1, 4, 1, 16))
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("call", [
    lambda: fused_obj.value_grad_cuda("sphere", torch.zeros(3, 2)),
    lambda: direction.direction_cuda(torch.zeros(2, 3, 3), torch.zeros(2, 3)),
    lambda: bfgs_update.guarded_update_direction_cuda(
        torch.zeros(2, 3, 3), *(torch.zeros(2, 3) for _ in range(3)), torch.zeros(2)),
    lambda: pso_step.pso_step_cuda(*(torch.zeros(2, 3) for _ in range(3)),
                                   torch.zeros(3), torch.zeros(2, 3),
                                   torch.zeros(2, 3), 0.5, 1.2, 1.5),
    lambda: bfgs_update.bfgs_update_cuda(torch.zeros(2, 3, 3), torch.ones(2, 3),
                                         torch.ones(2, 3)),
    lambda: bfgs_update.update_direction_cuda(
        torch.zeros(2, 3, 3), *(torch.ones(2, 3) for _ in range(3))),
    lambda: meanfield_step.meanfield_step_cuda(
        torch.zeros(2, 3), torch.zeros(2, 3), torch.zeros(3), torch.zeros(2, 3),
        0.5, 1.2, 0.3),
    lambda: sweep_megakernel.sweep_megakernel_full_cuda(
        "sphere", *(torch.zeros(2, 3) for _ in range(3)), torch.zeros(2, 3, 3),
        torch.ones(2, dtype=torch.bool), torch.zeros(4, 2), torch.ones(4), 0.5),
    lambda: sweep_megakernel.sweep_megakernel_commit_cuda(
        "sphere", *(torch.zeros(2, 3) for _ in range(3)), torch.zeros(2, 3, 3),
        torch.ones(2, dtype=torch.bool), torch.ones(2)),
    lambda: flash_attention.flash_attention_cuda(*(torch.zeros(1, 4, 2, 16) for _ in range(3))),
])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    """A kernel wrapper takes CUDA tensors only; the CPU path goes through
    the ops' device dispatch to the plain versions, never by fallback."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        call()


@pytest.mark.parametrize("threshold, want, fits, below, above", [
    # a warp per lane: the power of two that covers a row's D columns is at
    # most the warp's 32 threads
    (ops.update_small_dim, 32, lambda d: 1 << (d - 1).bit_length() <= 32,
     "small", "smem"),
    # one read of H: H, δx, δg, g' and u beside 128 bytes of static scalars
    (ops.update_smem_dim, 239,
     lambda d: (d * d + 4 * d) * 4 + 128 <= ops.SMEM_PER_BLOCK, "smem", "streaming"),
], ids=["small", "smem"])
def test_update_variant_thresholds(threshold, want, fits, below, above):
    """The BFGS-update kernel's (B2, B7a, B7b) variant thresholds: the
    largest D that fits, not D + 1, and the variant on each side."""
    got = threshold()
    assert got == want and fits(got) and not fits(got + 1)
    assert ops.update_variant(got) == below and ops.update_variant(got + 1) == above


@pytest.mark.parametrize("d", range(1, 41))
def test_fused_obj_row_threads(d):
    """B1a/B1b's row layout: a row of D takes P = min(32, the smallest power
    of two >= D) threads, so a warp holds 32 // P whole rows."""
    P = ops.fused_obj_row_threads(d)
    assert P == min(32, 1 << (d - 1).bit_length())
    assert P >= min(d, 32) and (P == 1 or P // 2 < d)
    assert 32 % P == 0 and (32 // P) * P == 32


# -- the bit argument behind B1a/B1b's row groups -------------------------------
# csrc/fused_obj.cu sums a row of D <= 16 over a group of P < 32 lanes, the
# sweep megakernel (csrc/sweep_megakernel.cu) over a whole warp, and both must
# give the same bits (objective.cuh). Here numpy replays both butterflies on
# float32 row terms as objective.cuh forms them: lane j holds 0.0f + term j,
# empty lanes +0.0, and each round adds the lane `offset` apart (xor). The
# CUDA kernels themselves run only on the card, where chip_smoke.py's phase
# 3 (value-only f == value+grad f, and B5/B5b's f' against B1b's) and phase
# 4b (megakernel against staged kernels) hold them bit for bit.
_TWO_PI32 = np.float32(2.0 * np.pi)


def _row_terms(name, x):
    """The float32 per-lane terms of each reduction objective.cuh takes for
    rows x (M, D): a list of (M, T) arrays (ackley has two sums)."""
    f32 = np.float32
    if name == "sphere":
        return [x * x]
    if name == "rastrigin":
        return [x * x - f32(10.0) * np.cos(_TWO_PI32 * x)]
    if name == "rosenbrock":
        xi, xn = x[:, :-1], x[:, 1:]
        d = xn - xi * xi
        t = f32(1.0) - xi
        return [t * t + f32(100.0) * d * d]
    return [x * x, np.cos(_TWO_PI32 * x)]


def _butterfly(lanes, width):
    """Every lane's sum after the xor butterfly over aligned groups of
    `width` lanes of a (warps, 32) float32 array."""
    idx = np.arange(32)
    off = width // 2
    while off:
        lanes = lanes + lanes[:, idx ^ off]
        off //= 2
    return lanes


@pytest.mark.parametrize("name", fused_obj.FUSED_OBJECTIVES)
def test_row_group_butterfly_matches_warp_butterfly_bitwise(name):
    rng = _rng(20)
    for d in range(1, 33):
        P = ops.fused_obj_row_threads(d)
        rows_per_warp = 32 // P
        x = rng.uniform(-BOX[name], BOX[name], (64, d)).astype(np.float32)
        x[0] = 0.0  # ackley's origin; sphere's all-zero row
        x[1, ::2] = -0.0
        for terms in _row_terms(name, x):
            M, T = terms.shape
            assert T <= P  # at most one term a lane
            parts = np.float32(0.0) + terms  # a lane's partial sum
            warp = np.zeros((M, 32), np.float32)
            warp[:, :T] = parts
            whole = _butterfly(warp, 32)  # the megakernel's warp per row
            group = np.zeros((M, P), np.float32)
            group[:, :T] = parts
            grouped = _butterfly(group.reshape(M // rows_per_warp, 32), P).reshape(M, P)
            want = np.repeat(whole[:, :1], P, axis=1).view(np.int32)
            assert np.array_equal(grouped.view(np.int32), want), (name, d)
            assert not np.any(np.signbit(parts) & (parts == 0.0))


# -- B7a/B7b: the unguarded ρ-form update, ρ = 1/(δxᵀδg) per lane ------------
# Against bfgs_update_pallas / update_direction_pallas (interpret mode), which
# compute the same ρ-form: RTOL/ATOL. Against kernels/ref.py's literal
# V H Vᵀ + ρδxδxᵀ (what the reference's ops take under
# REPRO_DISABLE_PALLAS=1), which rounds its two D×D products differently:
# rtol 1e-4, atol 1e-5, as for the guarded form above.
def _unguarded_inputs(seed):
    """Update inputs with no ρ = 0 lane and lane 3 on the engine's stand-in
    pair δx = δg = (1, …, 1), the pair guarded lanes feed the kernel."""
    H, dx, dg, g_new, _, _ = _update_inputs(seed=seed, frozen_every=None)
    dx[3] = 1.0
    dg[3] = 1.0
    return H, dx, dg, g_new


def test_bfgs_update_matches_pallas_and_ref():
    H, dx, dg, _ = _unguarded_inputs(seed=8)
    Hn = ops.bfgs_update(*(torch.from_numpy(a) for a in (H, dx, dg)))
    jH = bfgs_update_pallas(*(jnp.asarray(a) for a in (H, dx, dg)), interpret=True)
    _close(Hn, jH)
    _close(Hn, jref.bfgs_update_ref(*(jnp.asarray(a) for a in (H, dx, dg))),
           rtol=1e-4, atol=1e-5)
    assert torch.isfinite(Hn).all()


def test_bfgs_update_direction_matches_pallas_and_ref():
    H, dx, dg, g_new = _unguarded_inputs(seed=9)
    args = (H, dx, dg, g_new)
    Hn, p = ops.bfgs_update_direction(*(torch.from_numpy(a) for a in args))
    jH, jp = update_direction_pallas(*(jnp.asarray(a) for a in args), interpret=True)
    _close(Hn, jH)
    _close(p, jp)
    rH, rp = jref.update_direction_ref(*(jnp.asarray(a) for a in args))
    _close(Hn, rH, rtol=1e-4, atol=1e-5)
    _close(p, rp, rtol=1e-4, atol=1e-5)
    # B7b is B7a plus the direction: the same H', bit for bit
    assert torch.equal(Hn, ops.bfgs_update(*(torch.from_numpy(a) for a in args[:3])))


# -- B6: the fused mean-field update ---------------------------------------------
@pytest.mark.parametrize("noise", ["anisotropic", "isotropic"])
def test_meanfield_step_matches_pallas_and_ref(noise):
    """N = 300 is no multiple of the Pallas op's 256-particle tile (it pads
    to 512); row 5 holds an inf and row 9 a NaN, which stay in their rows."""
    rng = _rng(10)
    n = 300
    x, v, xi = (rng.uniform(-5, 5, (n, D)).astype(np.float32) for _ in range(3))
    xbar = rng.uniform(-1, 1, (D,)).astype(np.float32)
    x[5, 2] = np.inf
    x[9, 0] = np.nan
    args = (x, v, xbar, xi)
    xn, vn = ops.meanfield_step_update(*(torch.from_numpy(a) for a in args),
                                       0.5, 1.2, 0.3, noise)
    jx, jv = meanfield_step_pallas(*(jnp.asarray(a) for a in args), 0.5, 1.2, 0.3,
                                   isotropic=noise == "isotropic", interpret=True)
    rx, rv = jref.meanfield_step_ref(*(jnp.asarray(a) for a in args), 0.5, 1.2, 0.3,
                                     noise)
    for port, other in ((xn, jx), (vn, jv), (xn, rx), (vn, rv)):
        _close(port, other)
    finite = np.ones(n, bool)
    finite[[5, 9]] = False
    assert torch.isfinite(xn[finite]).all() and torch.isfinite(vn[finite]).all()
    if noise == "isotropic":  # the row norm spreads a row's inf/NaN over it
        assert not torch.isfinite(xn[[5, 9]]).any()


def test_meanfield_step_rejects_unknown_noise():
    z = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="noise"):
        ops.meanfield_step_update(z, z, torch.zeros(3), z, 0.5, 1.2, 0.3, "laplace")
