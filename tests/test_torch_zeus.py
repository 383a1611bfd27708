"""The port's zeus() end to end against the JAX package's
zeus(..., ZeusOptions(sweep_mode="batched")) on the four objectives with
fused kernels, started from the same random draws; plus the port's own
contracts: lane_chunk is array-equal to unchunked, clustering agrees with
the reference, entry points refuse to run on a missing card, and nothing
of JAX is imported by the port or chip_smoke.py.

End to end, phase 1 matches the reference to fp32 tolerance. Phase 2 is
compared sweep by sweep over the whole solve: before every sweep the port's
exact state goes to the reference's batched step as well, and the two must
accept the same Armijo rung and reach the same status on every lane, except
at a knife edge (an Armijo margin or |g| − Θ within fp32 rounding; each is
printed), and the state must agree to 1e-3 of each lane's largest entry. Free-running solves cannot be held to a
fixed tolerance: on rastrigin, rosenbrock and ackley the reference's own
jitted and op-by-op sweeps fork within ~6 sweeps (ROADMAP §C), so the port
is held to the per-sweep contract instead, and to reproducing its own
zeus() result exactly from those sweeps.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bfgs as jbfgs  # noqa: E402
from repro.core import clustering as jclustering  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import linesearch as jls  # noqa: E402
from repro.core import objectives as jobj  # noqa: E402
from repro.core.zeus import ZeusOptions as JZeusOptions  # noqa: E402
from repro.core.zeus import zeus as jax_zeus  # noqa: E402
from repro.core.bfgs import BFGSOptions as JBFGSOptions  # noqa: E402
from repro.core.objectives import get_objective as jget_objective  # noqa: E402
from repro.core.pso import PSOOptions as JPSOOptions  # noqa: E402
from repro.kernels.ops import reference_kernels_off_tpu  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import (  # noqa: E402
    BFGSOptions,
    MeanFieldPSOOptions,
    PSOOptions,
    ZeusOptions,
    cluster_solutions,
    get_objective,
    run_multistart,
    run_pso,
    run_until_confident,
    zeus,
)
from repro_torch.core import engine, objectives  # noqa: E402
from repro_torch.core.bfgs import BatchedDenseBFGS  # noqa: E402
from repro_torch.core.engine import EngineOptions  # noqa: E402
from repro_torch.core.linesearch import armijo_thresholds, ladder_alphas  # noqa: E402
from test_torch_core import ReplayDraws, jax_pso_draws  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
N_PART, DIM, ITER_PSO, ITER_BFGS, ITER_LS, THETA = 64, 6, 3, 30, 20, 1e-4
CASES = [(name, rc) for name in ("sphere", "rastrigin", "rosenbrock", "ackley")
         for rc in (None, 16)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _opts(required_c):
    return dict(pso=dict(n_particles=N_PART, iter_pso=ITER_PSO),
                bfgs=dict(iter_bfgs=ITER_BFGS, theta=THETA, required_c=required_c))


def _jax_zeus(name, required_c, seed):
    obj = jget_objective(name)
    o = _opts(required_c)
    opts = JZeusOptions(pso=JPSOOptions(**o["pso"]),
                             bfgs=JBFGSOptions(**o["bfgs"]), sweep_mode="batched")
    with reference_kernels_off_tpu():
        res = jax_zeus(obj.fn, jax.random.key(seed), DIM, obj.lower, obj.upper, opts)
        return jax.device_get(res)


def _port_zeus(name, required_c, seed, **kw):
    obj = get_objective(name)
    o = _opts(required_c)
    draws = ReplayDraws(jax_pso_draws(jax.random.key(seed), N_PART, DIM, obj.lower,
                                      obj.upper, ITER_PSO))
    opts = ZeusOptions(pso=PSOOptions(**o["pso"]), bfgs=BFGSOptions(**o["bfgs"]), **kw)
    return zeus(obj.fn, DIM, obj.lower, obj.upper, opts, device="cpu", draws=draws)


class _ReferenceRuns(dict):
    """JAX zeus results by case, each computed on first use: xdist spreads a
    module's tests over workers, and each worker pays only for its cases."""

    def __missing__(self, case):
        self[case] = _jax_zeus(*case, seed=CASES.index(case))
        return self[case]


@pytest.fixture(scope="module")
def reference_runs():
    return _ReferenceRuns()


def _np_lanes(lanes):
    return {k: getattr(lanes, k).numpy() for k in engine.BatchLanes._fields}


def _assert_close_per_lane(got, ref, msg, tol=1e-3):
    """|got − ref| <= tol·max(1, the lane's largest |ref|). One sweep's g
    and H' round relative to the lane's largest terms, not elementwise: the
    reference may contract x + α·p into an FMA, and rosenbrock's Hessian
    (entries ~1e4) turns that one-ulp move of x' into ~1e-4 of |g|; H'
    cancels ρ(uδxᵀ + δxuᵀ) against H."""
    scale = np.maximum(1.0, np.abs(ref).reshape(ref.shape[0], -1).max(axis=1))
    err = np.abs(got - ref).reshape(ref.shape[0], -1).max(axis=1)
    assert (err <= tol * scale).all(), (msg, float((err / scale).max()))


def _knife_edge_rung(pb, pre, i, r, c1):
    """Armijo margin of lane i at rung r, relative to max(1, |threshold|)."""
    P = pre.p[i] if float(pre.p[i] @ pre.g[i]) < 0 else -pre.g[i]
    alphas = torch.as_tensor(ladder_alphas(ITER_LS, np.float32))
    rhs = armijo_thresholds(pre.f[i:i + 1], (pre.g[i] @ P)[None], alphas, c1)[r, 0]
    f_r = pb.value_batch((pre.x[i] + alphas[r] * P)[None])[0]
    return float((f_r - rhs).abs()) / max(1.0, float(rhs.abs()))


def _phase2_sweep_by_sweep(name, required_c, starts):
    """The port's phase 2 as its engine runs it (unchunked), with the
    reference's batched step applied to the port's exact state before every
    sweep. Returns (final port lanes, sweeps, knife edges)."""
    pb, ps = objectives.as_batched(get_objective(name).fn), BatchedDenseBFGS()
    popts = EngineOptions(iter_max=ITER_BFGS, theta=THETA, required_c=required_c)
    jopts = jengine.EngineOptions(sweep_mode="batched", iter_max=ITER_BFGS,
                                  theta=THETA, required_c=required_c)
    jb, js = jobj.as_batched(jget_objective(name)), jbfgs.BatchedDenseBFGS()
    jstep = jax.jit(lambda ls: jengine.batch_lanes_step(jb, js, jopts, ls))
    jrung = jax.jit(lambda x, p, f, g: jls.armijo_backtracking_batch(
        jb.value_batch, x, p, f, g, c1=jopts.ls_c1, max_iters=ITER_LS).rung)
    lanes = engine.batch_lanes_init(pb, ps, starts, THETA)
    knife, k = [], 0
    with reference_kernels_off_tpu():
        ref0 = jax.device_get(jengine.batch_lanes_init(jb, js, jnp.asarray(starts.numpy()),
                                                       THETA))
        for field in ("f", "g", "p", "converged", "failed"):
            np.testing.assert_allclose(getattr(lanes, field).numpy(), getattr(ref0, field),
                                       rtol=1e-5, atol=1e-5, err_msg=field)
        rc = required_c if required_c is not None else starts.shape[0]
        while (k < ITER_BFGS and int(lanes.converged.sum()) < rc
               and int((~(lanes.converged | lanes.failed)).sum()) > 0):
            pre, pre_np = lanes, _np_lanes(lanes)
            state = jengine.BatchLanes(**{f: jnp.asarray(v) for f, v in pre_np.items()})
            lanes, _, rung = engine.batch_lanes_step(pb, ps, popts, pre)
            ref = jax.device_get(jstep(state)[0])
            # the reference's rung per lane, after its descent safeguard
            P = np.where((np.sum(pre_np["p"] * pre_np["g"], -1) < 0)[:, None],
                         pre_np["p"], -pre_np["g"])
            ref_rung = np.asarray(jrung(state.x, jnp.asarray(P), state.f, state.g))
            odd = set(np.nonzero(rung.numpy() != ref_rung)[0].tolist())
            for i in sorted(odd):
                r = min(int(rung[i]), int(ref_rung[i]))
                margin = _knife_edge_rung(pb, pre, i, r, popts.ls_c1)
                assert margin <= 1e-5, (name, k, i, int(rung[i]), int(ref_rung[i]), margin)
                knife.append((k, i, "rung", margin))
            flip = np.nonzero(lanes.converged.numpy() != ref.converged)[0]
            for i in set(flip.tolist()) - odd:
                gn = float(torch.linalg.vector_norm(lanes.g[i]))
                assert abs(gn - THETA) <= 1e-3 * THETA, (name, k, i, gn)
                knife.append((k, i, "status", gn))
                odd.add(i)
            keep = np.array([i not in odd for i in range(starts.shape[0])])
            np.testing.assert_array_equal(lanes.failed.numpy()[keep], ref.failed[keep])
            for field in ("x", "f", "g", "direction_state"):
                _assert_close_per_lane(getattr(lanes, field).numpy()[keep],
                                       getattr(ref, field)[keep], f"{name} sweep {k} {field}")
            k += 1
    for edge in knife:
        print(f"{name}-rc{required_c}: knife edge at sweep {edge[0]} lane {edge[1]} "
              f"({edge[2]}, {edge[3]:.3g})")
    return lanes, k, knife


@pytest.mark.parametrize("case", CASES, ids=[f"{n}-rc{rc}" for n, rc in CASES])
def test_zeus_matches_reference(case, reference_runs):
    name, required_c = case
    seed = CASES.index(case)
    ref = reference_runs[case]
    got = _port_zeus(name, required_c, seed)
    # phase 1: the same draws give the same swarm
    np.testing.assert_allclose(float(got.pso_best_f), float(ref.pso_best_f),
                               rtol=1e-5, atol=1e-6)
    pobj = get_objective(name)
    starts = run_pso(pobj.fn, DIM, pobj.lower, pobj.upper,
                     PSOOptions(**_opts(required_c)["pso"]), device="cpu",
                     draws=ReplayDraws(jax_pso_draws(jax.random.key(seed), N_PART, DIM,
                                                     pobj.lower, pobj.upper,
                                                     ITER_PSO))).x
    # phase 2: every sweep of the solve against the reference's step
    lanes, sweeps, _ = _phase2_sweep_by_sweep(name, required_c, starts)
    # and zeus() ran exactly those sweeps
    assert got.raw.iterations == sweeps
    assert torch.equal(got.raw.x, lanes.x) and torch.equal(got.raw.fval, lanes.f)
    assert got.n_converged == int(lanes.converged.sum())
    if name == "sphere":  # one sweep to the minimum: free-running parity too
        np.testing.assert_array_equal(got.raw.status.numpy(), ref.raw.status)
        np.testing.assert_allclose(float(got.best_f), float(ref.best_f),
                                   rtol=1e-4, atol=1e-5)


def test_lane_chunk_is_array_equal_to_unchunked():
    """B = 50 in chunks of 16: four chunks, the last padded with frozen lanes."""
    obj = get_objective("rastrigin")
    starts = run_pso(obj.fn, DIM, obj.lower, obj.upper,
                     PSOOptions(n_particles=50, iter_pso=2), device="cpu",
                     generator=torch.Generator().manual_seed(5)).x
    base = dict(iter_max=ITER_BFGS, theta=THETA, required_c=20)
    whole = run_multistart(obj.fn, starts, BatchedDenseBFGS(),
                           EngineOptions(**base), device="cpu")
    chunked = run_multistart(obj.fn, starts, BatchedDenseBFGS(),
                             EngineOptions(**base, lane_chunk=16), device="cpu")
    for field in ("x", "fval", "grad_norm", "status", "n_evals"):
        assert torch.equal(getattr(whole, field), getattr(chunked, field)), field
    assert whole.iterations == chunked.iterations
    assert whole.n_converged == chunked.n_converged >= 20
    assert chunked.map_trips == 4 * chunked.iterations
    assert chunked.eval_rows == 64 * (1 + 21 * chunked.iterations)
    assert whole.eval_rows == 50 * (1 + 21 * whole.iterations)


def test_cluster_solutions_matches_reference(reference_runs):
    ref = reference_runs[("rastrigin", None)]
    port = cluster_solutions(interop.result_from_numpy(ref.raw), radius=0.25)
    jrep = jclustering.cluster_solutions(ref.raw, radius=0.25)
    assert port.summary() == jrep.summary()
    assert len(port.clusters) == len(jrep.clusters)
    for a, b in zip(port.clusters, jrep.clusters):
        np.testing.assert_array_equal(a.members, b.members)
        np.testing.assert_allclose(a.center, b.center, rtol=1e-6)
        assert a.fval == b.fval and a.count == b.count


def test_run_until_confident_matches_reference(reference_runs):
    """The confidence loop over the same two rounds of lanes."""
    rounds = [reference_runs[("ackley", None)].raw, reference_runs[("ackley", 16)].raw]
    port = run_until_confident(lambda i: interop.result_from_numpy(rounds[i]), [0, 1],
                               min_lanes_in_best=10**6, radius=0.25)
    jrep = jclustering.run_until_confident(lambda i: rounds[i], [0, 1],
                                           min_lanes_in_best=10**6, radius=0.25)
    assert port.summary() == jrep.summary()
    assert port.n_lanes == 2 * N_PART


def test_result_round_trips_through_numpy(reference_runs):
    ref = reference_runs[("sphere", None)]
    back = interop.result_to_numpy(interop.result_from_numpy(ref.raw))
    for field in ("x", "fval", "grad_norm", "status", "n_evals"):
        np.testing.assert_array_equal(getattr(back, field), getattr(ref.raw, field))
    assert back.n_converged == int(ref.raw.n_converged)


@pytest.mark.parametrize("entry", ["zeus", "run_pso", "run_multistart"])
def test_entry_points_default_to_cuda_and_refuse_without_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    obj = get_objective("sphere")
    calls = {
        "zeus": lambda: zeus(obj.fn, 2, obj.lower, obj.upper),
        "run_pso": lambda: run_pso(obj.fn, 2, obj.lower, obj.upper),
        "run_multistart": lambda: run_multistart(obj.fn, np.zeros((4, 2), np.float32),
                                                 BatchedDenseBFGS()),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


@pytest.mark.parametrize("kw,item", [
    (dict(sweep_mode="per_lane", retry_budget=1), "A11"),
    (dict(sweep_mode="megakernel", compact_every=1), "A8"),
    (dict(sweep_mode="megakernel", schedule="auto"), "A8"),
    (dict(phase1="meanfield", schedule="replay"), "A8"),
    (dict(compact_every=1), "A8"),
    (dict(repack_every=1), "A8"),
    (dict(sweep_mode="megakernel", retry_budget=1), "A11"),
    (dict(schedule="auto"), "A8"),
    (dict(retry_budget=1), "A11"),
    (dict(checkpoint_every=2), "A11"),
    (dict(auto_cost_model=True), "A12"),
    (dict(solver="lbfgs", sweep_mode="per_lane", checkpoint_dir="ckpt"), "A11"),
    (dict(dtype="float64"), "float32"),
])
def test_unported_options_raise(kw, item):
    obj = get_objective("sphere")
    opts = ZeusOptions(pso=PSOOptions(n_particles=8, iter_pso=1), **kw)
    with pytest.raises(NotImplementedError, match=item):
        zeus(obj.fn, 2, obj.lower, obj.upper, opts, device="cpu")


@pytest.mark.parametrize("kw", [
    dict(sweep_mode="per_lane"),
    dict(sweep_mode="per_lane", bfgs=BFGSOptions(hessian_impl="reference")),
    dict(sweep_mode="per_lane", bfgs=BFGSOptions(hessian_impl="pallas")),
    dict(sweep_mode="per_lane", bfgs=BFGSOptions(linesearch="wolfe")),
    dict(solver="lbfgs"),
    dict(solver="lbfgs", sweep_mode="per_lane"),
    dict(phase1="meanfield", meanfield=MeanFieldPSOOptions(n_particles=8, iter_pso=1)),
    dict(sweep_mode="megakernel"),
    dict(ladder_len=4),
    dict(solver="lbfgs", ladder_len=4),
], ids=["per_lane", "reference", "pallas", "wolfe", "lbfgs", "lbfgs-per_lane",
        "meanfield", "megakernel", "ladder_len", "lbfgs-ladder_len"])
def test_options_ported_from_the_reference_run(kw):
    """Options earlier slices refused (ROADMAP A7, A10, A9 and the adaptive
    ladder of A8) now solve."""
    obj = get_objective("sphere")
    opts = ZeusOptions(pso=PSOOptions(n_particles=8, iter_pso=1), **kw)
    res = zeus(obj.fn, 2, obj.lower, obj.upper, opts, device="cpu")
    assert res.n_converged == 8 and float(res.best_f) < 1e-6


@pytest.mark.parametrize("kw,match", [
    (dict(bfgs=BFGSOptions(linesearch="wolfe")), "'armijo' only"),
    (dict(sweep_mode="per_lane", compact_every=1), "requires sweep_mode='batched'"),
    (dict(bfgs=BFGSOptions(hessian_impl="cuda")), "unknown hessian impl"),
])
def test_invalid_option_combinations_raise(kw, match):
    obj = get_objective("sphere")
    opts = ZeusOptions(pso=PSOOptions(n_particles=8, iter_pso=1), **kw)
    with pytest.raises(ValueError, match=match):
        zeus(obj.fn, 2, obj.lower, obj.upper, opts, device="cpu")


def test_port_and_chip_smoke_import_no_jax():
    """Import every repro_torch module and chip_smoke.py (without running
    it) in a fresh interpreter: neither `jax` nor `repro` may load."""
    modules = sorted(
        ".".join(p.relative_to(REPO / "src").with_suffix("").parts)
        for p in (REPO / "src" / "repro_torch").rglob("*.py"))
    modules = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in modules]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO / "src"), str(REPO)]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert len(modules) >= 23
