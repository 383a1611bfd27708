"""Particle Swarm Optimization phase (paper §III-A, Algs. 2/3/8/9).

Port of src/repro/core/pso.py: uniform init, then `iter_pso` synchronous
velocity/position updates with personal and global bests; the global best
is a deterministic argmin. Swarm values use the plain batched objective
(`vmap(f)`), as the JAX package uses `jax.vmap(f)`; the velocity/position
update always goes through kernels/ops.pso_step_update, which takes the
fused CUDA kernel on the card and its plain version on the CPU. The JAX
package's `use_kernel` switch has no counterpart.

Randomness goes through a `draws` hook, `draws(shape, low, high) -> tensor`
uniform in [low, high), called in a fixed order: x₀ and v₀ in init_swarm,
then r1 and r2 in every step. The default, `TorchDraws`, uses a
torch.Generator on the device. `jax.random` streams cannot be reproduced in
torch, so parity tests pass a hook that replays the JAX draws.

Paper hyperparameters: w=0.5, c1=1.2, c2=1.5 (Deboucha et al. 2020).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import torch
from torch.func import vmap

from repro_torch._device import resolve_device
from repro_torch.kernels import ops as kernel_ops

Draws = Callable[[Sequence[int], float, float], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class PSOOptions:
    n_particles: int = 1024
    iter_pso: int = 5
    w: float = 0.5  # inertia
    c1: float = 1.2  # cognitive coefficient
    c2: float = 1.5  # social coefficient
    clip_to_range: bool = False  # paper does not clip; optional extension


class SwarmState(NamedTuple):
    x: torch.Tensor  # (N, D) positions
    v: torch.Tensor  # (N, D) velocities
    px: torch.Tensor  # (N, D) personal best positions
    pf: torch.Tensor  # (N,)  personal best values
    gx: torch.Tensor  # (D,)  global best position
    gf: torch.Tensor  # ()    global best value


class TorchDraws:
    """The default draws hook: uniform float32 draws from a torch.Generator
    on `device` (seeded with `seed` unless a generator is given)."""

    def __init__(self, device, generator: Optional[torch.Generator] = None,
                 seed: int = 0):
        self.device = torch.device(device)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        self.generator = generator

    def __call__(self, shape, low: float, high: float) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=self.generator,
                       device=self.device, dtype=torch.float32)
        return low + (high - low) * u


def _global_best(x, fvals, gx, gf):
    """Argmin over the swarm; keep the incumbent unless strictly beaten."""
    i = torch.argmin(fvals)
    cand_f, cand_x = fvals[i], x[i]
    better = cand_f < gf
    return torch.where(better, cand_x, gx), torch.where(better, cand_f, gf)


def init_swarm(f: Callable, draws: Draws, n: int, dim: int, lower: float,
               upper: float, device) -> SwarmState:
    """Alg. 2/8: uniform positions in [lower, upper], velocities in ±range."""
    vel_range = upper - lower
    x = draws((n, dim), lower, upper).to(device)
    v = draws((n, dim), -vel_range, vel_range).to(device)
    pf = vmap(f)(x)
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    gx, gf = _global_best(x, pf, x[0], inf)
    return SwarmState(x=x, v=v, px=x, pf=pf, gx=gx, gf=gf)


def pso_step(f: Callable, state: SwarmState, opts: PSOOptions, draws: Draws,
             lower: float, upper: float) -> SwarmState:
    """Alg. 3/9: velocity/position update + personal/global best refresh."""
    n, dim = state.x.shape
    r1 = draws((n, dim), 0.0, 1.0).to(state.x.device)
    r2 = draws((n, dim), 0.0, 1.0).to(state.x.device)
    x, v = kernel_ops.pso_step_update(
        state.x, state.v, state.px, state.gx, r1, r2, opts.w, opts.c1, opts.c2)
    if opts.clip_to_range:
        x = torch.clamp(x, lower, upper)

    fvals = vmap(f)(x)
    improved = fvals < state.pf
    pf = torch.where(improved, fvals, state.pf)
    px = torch.where(improved[:, None], x, state.px)
    gx, gf = _global_best(x, fvals, state.gx, state.gf)
    return SwarmState(x=x, v=v, px=px, pf=pf, gx=gx, gf=gf)


def run_pso(f: Callable, dim: int, lower: float, upper: float,
            opts: PSOOptions = PSOOptions(), *, device="cuda",
            draws: Optional[Draws] = None,
            generator: Optional[torch.Generator] = None) -> SwarmState:
    """Phase 1 of ZEUS: init + iter_pso synchronous swarm iterations.

    f:      scalar objective `(dim,) -> ()` in torch, vmapped over the swarm.
    device: "cuda" (default) or "cpu"; no silent CPU fallback.
    draws:  the random-draw hook (module docstring); by default
            TorchDraws(device, generator).
    Returns the final SwarmState: `.x` is the phase-2 start set, `.gf/.gx`
    the global best."""
    dev = resolve_device(device)
    if draws is None:
        draws = TorchDraws(dev, generator)
    state = init_swarm(f, draws, opts.n_particles, dim, lower, upper, dev)
    for _ in range(opts.iter_pso):
        state = pso_step(f, state, opts, draws, lower, upper)
    return state
