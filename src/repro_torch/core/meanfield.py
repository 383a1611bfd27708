"""Mean-field consensus PSO: the million-particle phase-1 strategy.

Port of src/repro/core/meanfield.py (Grassi & Huang, arXiv:2108.00393).
Every particle drifts toward one softmax-weighted consensus point

    x̄ = Σᵢ wᵢ xᵢ / Σᵢ wᵢ,       wᵢ = exp(−β f(xᵢ)),

and explores around it with scaled Gaussian noise:

    d  = x̄ − x
    v' = w·v + λ·d + σ·s(d) ⊙ ξ,     ξ ~ N(0, I_D)
    x' = x + v'

with s(d) = ‖d‖₂ per particle ("isotropic") or s(d) = d, the signed
coordinate-wise envelope ("anisotropic", as the reference's code has it).
There are no personal bests and no global argmin: per-particle state is
{x, v} only.

The consensus is computed in log space (shift by the largest log-weight),
so Σ wᵢ ≥ 1 whenever any particle is finite; non-finite f gets weight 0,
and an all-non-finite swarm gives x̄ = 0 through the `tiny` clamp. The
per-particle update always goes through `ops.meanfield_step_update`
(kernel csrc/meanfield_step.cu on the card, its plain version on the CPU):
the reference's `use_kernel` switch has no counterpart. The cross-device
moment hook `pmoments` is distributed (ROADMAP A14) and not ported.

Randomness comes from the `draws` hook of core/pso.py, in the reference's
order: x₀ and v₀ uniform at init, then one normal ξ per step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
from torch.func import vmap

from repro_torch._device import check_dtype, resolve_device
from repro_torch.core.pso import Draws, TorchDraws
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.meanfield_step import NOISE_MODES


@dataclasses.dataclass(frozen=True)
class MeanFieldPSOOptions:
    """Knobs of the mean-field phase-1 strategy (ZeusOptions.meanfield):
    swarm size N, iterations (0 = one uniform draw, no objective
    evaluations), the softmax inverse temperature β, inertia w, drift λ,
    noise scale σ, the noise envelope (NOISE_MODES) and clipping to the
    search box after each update."""

    n_particles: int = 1024
    iter_pso: int = 5
    beta: float = 30.0
    w: float = 0.5
    drift: float = 1.2
    sigma: float = 0.3
    noise: str = "anisotropic"
    clip_to_range: bool = False


class MeanFieldState(NamedTuple):
    x: torch.Tensor  # (N, D) positions (the phase-2 start set)
    v: torch.Tensor  # (N, D) velocities
    consensus: torch.Tensor  # (D,) last consensus point x̄ (diagnostics)
    gf: torch.Tensor  # () best objective value seen (reporting only)


def consensus_moments(fvals: torch.Tensor, x: torch.Tensor, beta: float):
    """Log-sum-exp partials of the softmax consensus: (m, S, N) with m the
    largest log-weight, S = Σᵢ wᵢ and N = Σᵢ wᵢ xᵢ, wᵢ = exp(−β fᵢ − m).
    Non-finite fᵢ get weight 0; an all-non-finite swarm gives (−inf, 0, 0)."""
    logw = torch.where(torch.isfinite(fvals), (-beta * fvals).to(x.dtype),
                       float("-inf"))
    m = torch.max(logw)
    # all-non-finite guard: exp(−inf − (−inf)) = NaN, so shift by 0 instead
    w = torch.exp(logw - torch.where(torch.isfinite(m), m, 0.0))
    return m, torch.sum(w), w @ x


def consensus_point(fvals: torch.Tensor, x: torch.Tensor, beta: float) -> torch.Tensor:
    """Softmax-weighted consensus x̄ = Σ wᵢxᵢ / Σ wᵢ, LSE-stable. The tiny
    clamp only engages when the whole swarm is non-finite (x̄ = 0)."""
    _, S, N = consensus_moments(fvals, x, beta)
    return N / torch.clamp(S, min=torch.finfo(x.dtype).tiny)


def meanfield_step(f: Callable, state: MeanFieldState, opts: MeanFieldPSOOptions,
                   lower: float, upper: float, draws: Draws) -> MeanFieldState:
    """One iteration: evaluate at the current positions, form the consensus,
    drift and explore. Each iteration costs N objective rows; the final
    positions go to phase 2 unevaluated."""
    fvals = vmap(f)(state.x)
    xbar = consensus_point(fvals, state.x, opts.beta)
    # reporting-only running min (masked against NaN escapes)
    inf = torch.tensor(float("inf"), dtype=fvals.dtype, device=fvals.device)
    gf = torch.minimum(state.gf, torch.min(torch.where(torch.isfinite(fvals), fvals, inf)))
    xi = draws.normal(state.x.shape).to(state.x.device, state.x.dtype)
    x, v = kernel_ops.meanfield_step_update(state.x, state.v, xbar, xi, opts.w,
                                            opts.drift, opts.sigma, opts.noise)
    if opts.clip_to_range:
        x = torch.clamp(x, lower, upper)
    return MeanFieldState(x=x, v=v, consensus=xbar, gf=gf)


def init_meanfield(draws: Draws, n: int, dim: int, lower: float, upper: float,
                   device, dtype=torch.float32) -> MeanFieldState:
    """Uniform positions in [lower, upper], velocities in ±range, in
    `dtype`, as the paper swarm's init, minus the personal bests and the
    init objective pass (the first step evaluates before it moves)."""
    vel_range = upper - lower
    x = draws((n, dim), lower, upper).to(device, dtype)
    v = draws((n, dim), -vel_range, vel_range).to(device, dtype)
    return MeanFieldState(
        x=x, v=v, consensus=torch.zeros((dim,), dtype=x.dtype, device=x.device),
        gf=torch.tensor(float("inf"), dtype=x.dtype, device=x.device))


def run_meanfield_pso(f: Callable, dim: int, lower: float, upper: float,
                      opts: MeanFieldPSOOptions = MeanFieldPSOOptions(), *,
                      device="cuda", draws: Optional[Draws] = None,
                      generator: Optional[torch.Generator] = None,
                      dtype: torch.dtype = torch.float32) -> MeanFieldState:
    """Phase 1 by mean-field consensus PSO: init + iter_pso iterations.

    f:      scalar objective `(dim,) -> ()` in torch, vmapped over the swarm.
    device: "cuda" (default) or "cpu"; no silent CPU fallback.
    draws:  the random-draw hook (core/pso.py), with `normal`; by default
            TorchDraws(device, generator, dtype=dtype).
    dtype:  float32 or float64: the swarm's positions, velocities, noise
            and consensus (and B6's w, λ and σ, rounded to it).
    Returns the final state: `.x` is the phase-2 start set, `.gf` the best
    value seen (inf when iter_pso=0)."""
    if opts.noise not in NOISE_MODES:
        raise ValueError(
            f"unknown noise mode {opts.noise!r}; expected one of {NOISE_MODES}")
    dev = resolve_device(device)
    dtype = check_dtype(dtype)
    if draws is None:
        draws = TorchDraws(dev, generator, dtype=dtype)
    state = init_meanfield(draws, opts.n_particles, dim, lower, upper, dev, dtype)
    for _ in range(opts.iter_pso):
        state = meanfield_step(f, state, opts, lower, upper, draws)
    return state
