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
then r1 and r2 in every step; the mean-field swarm (core/meanfield.py) also
takes standard-normal draws from `draws.normal(shape)`. The default,
`TorchDraws`, uses a torch.Generator on the device. A hook that also has
`get_state()`/`set_state(state)` can be snapshotted with a solve: the
engine's retry stream (core/engine.py, retry_budget) needs them under
checkpointing. `jax.random` streams
cannot be reproduced in torch, so parity tests pass a hook that replays the
JAX draws.

`sequential_pso` is the paper's particle-by-particle baseline (Fig. 2): a
host loop over numpy, seeded with an integer, that reproduces the
reference's numpy draws exactly.

Paper hyperparameters: w=0.5, c1=1.2, c2=1.5 (Deboucha et al. 2020).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Protocol, Sequence

import numpy as np
import torch
from torch.func import vmap

from repro_torch._device import check_dtype, resolve_device
from repro_torch.kernels import ops as kernel_ops



class Draws(Protocol):
    """The random-draw hook (module docstring)."""

    def __call__(self, shape: Sequence[int], low: float, high: float) -> torch.Tensor:
        """Uniform draws in [low, high), in the solve's dtype (float32 or
        float64; the swarm casts other draws to it)."""
        ...

    def normal(self, shape: Sequence[int]) -> torch.Tensor:
        """Standard-normal draws in the solve's dtype (the mean-field swarm
        and the retry stream only)."""
        ...


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
    """The default draws hook: uniform draws in `dtype` (float32 unless
    given) from a torch.Generator on `device` (seeded with `seed` unless a
    generator is given)."""

    def __init__(self, device, generator: Optional[torch.Generator] = None,
                 seed: int = 0, dtype: torch.dtype = torch.float32):
        self.device = torch.device(device)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        self.generator = generator
        self.dtype = dtype

    def __call__(self, shape, low: float, high: float) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=self.generator,
                       device=self.device, dtype=self.dtype)
        return low + (high - low) * u

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.device, dtype=self.dtype)

    def get_state(self) -> torch.Tensor:
        """The generator's state (a CPU uint8 tensor): what a solve's
        snapshot keeps of its retry stream."""
        return self.generator.get_state()

    def set_state(self, state: torch.Tensor) -> None:
        self.generator.set_state(state.cpu())


def _global_best(x, fvals, gx, gf):
    """Argmin over the swarm; keep the incumbent unless strictly beaten."""
    i = torch.argmin(fvals)
    cand_f, cand_x = fvals[i], x[i]
    better = cand_f < gf
    return torch.where(better, cand_x, gx), torch.where(better, cand_f, gf)


def init_swarm(f: Callable, draws: Draws, n: int, dim: int, lower: float,
               upper: float, device, dtype=torch.float32) -> SwarmState:
    """Alg. 2/8: uniform positions in [lower, upper], velocities in ±range,
    in `dtype`."""
    vel_range = upper - lower
    x = draws((n, dim), lower, upper).to(device, dtype)
    v = draws((n, dim), -vel_range, vel_range).to(device, dtype)
    pf = vmap(f)(x)
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    gx, gf = _global_best(x, pf, x[0], inf)
    return SwarmState(x=x, v=v, px=x, pf=pf, gx=gx, gf=gf)


def pso_step(f: Callable, state: SwarmState, opts: PSOOptions, draws: Draws,
             lower: float, upper: float) -> SwarmState:
    """Alg. 3/9: velocity/position update + personal/global best refresh."""
    n, dim = state.x.shape
    r1 = draws((n, dim), 0.0, 1.0).to(state.x.device, state.x.dtype)
    r2 = draws((n, dim), 0.0, 1.0).to(state.x.device, state.x.dtype)
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
            generator: Optional[torch.Generator] = None,
            dtype: torch.dtype = torch.float32) -> SwarmState:
    """Phase 1 of ZEUS: init + iter_pso synchronous swarm iterations.

    f:      scalar objective `(dim,) -> ()` in torch, vmapped over the swarm.
    device: "cuda" (default) or "cpu"; no silent CPU fallback.
    draws:  the random-draw hook (module docstring); by default
            TorchDraws(device, generator, dtype=dtype).
    dtype:  float32 or float64: the swarm's positions, velocities and bests
            (and B4's w, c1 and c2, rounded to it).
    Returns the final SwarmState: `.x` is the phase-2 start set, `.gf/.gx`
    the global best."""
    dev = resolve_device(device)
    dtype = check_dtype(dtype)
    if draws is None:
        draws = TorchDraws(dev, generator, dtype=dtype)
    state = init_swarm(f, draws, opts.n_particles, dim, lower, upper, dev, dtype)
    for _ in range(opts.iter_pso):
        state = pso_step(f, state, opts, draws, lower, upper)
    return state


def sequential_pso(f: Callable, seed: int, dim: int, lower: float, upper: float,
                   opts: PSOOptions, *, device="cuda") -> SwarmState:
    """Algs. 2/3 run particle by particle on the host (the Fig. 2 baseline).

    The global best propagates within an iteration (particle i+1 sees
    particle i's update), unlike the bulk-synchronous run_pso, so the two
    are comparable only statistically.

    seed: the integer the reference folds its key into
          (`int(jax.random.randint(key, (), 0, 2**31 - 1))`); the numpy
          draws are then the reference's, in the same order.
    f:    scalar objective `(dim,) -> ()`, called one particle at a time on
          a float32 tensor on `device` (the reference's positions are
          float64 numpy that f sees as float32).
    Returns the SwarmState as float32 tensors on `device`. clip_to_range is
    a parallel-path knob and ignored, as in the reference."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def fval(xi):
        return float(f(torch.as_tensor(xi, dtype=torch.float32, device=dev)))

    n = opts.n_particles
    vel_range = upper - lower
    x = rng.uniform(lower, upper, (n, dim))
    v = rng.uniform(-vel_range, vel_range, (n, dim))
    px = x.copy()
    pf = np.array([fval(x[i]) for i in range(n)])
    gi = int(np.argmin(pf))
    gx, gf = px[gi].copy(), float(pf[gi])

    for _ in range(opts.iter_pso):
        for i in range(n):
            r1, r2 = rng.uniform(size=dim), rng.uniform(size=dim)
            v[i] = (opts.w * v[i] + opts.c1 * r1 * (px[i] - x[i])
                    + opts.c2 * r2 * (gx - x[i]))
            x[i] = x[i] + v[i]
            fv = fval(x[i])
            if fv < pf[i]:
                pf[i], px[i] = fv, x[i]
            if fv < gf:
                gf, gx = fv, x[i].copy()

    def out(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

    return SwarmState(x=out(x), v=out(v), px=out(px), pf=out(pf), gx=out(gx),
                      gf=out(gf))
