"""Benchmark objective functions from the paper (§V-B), plus the dijet
model of its application (§V-G).

Port of src/repro/core/objectives.py. Every objective is written in torch
over the last axis, so the same function takes one point (D,) -> () or a
batch (..., D) -> (...), vmaps, and differentiates in forward or reverse
mode. Each comes with its search box and optimum.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import vmap

from repro_torch.core.dual import grad_eval_cost, value_and_grad_fn
from repro_torch.kernels import ops as kernel_ops


@dataclasses.dataclass(frozen=True)
class Objective:
    name: str
    fn: Callable[[torch.Tensor], torch.Tensor]
    lower: float
    upper: float
    # true minimizer for a given dim (None when dim-dependent/unknown)
    minimizer: Optional[Callable[[int], np.ndarray]] = None
    min_value: float = 0.0

    def x_star(self, dim: int) -> np.ndarray:
        if self.minimizer is None:
            raise ValueError(f"objective {self.name!r} has no known minimizer")
        return self.minimizer(dim)


def rosenbrock(x: torch.Tensor) -> torch.Tensor:
    """Paper §V-B1. Global minimum f=0 at x=(1,...,1)."""
    xi, xn = x[..., :-1], x[..., 1:]
    return torch.sum((1.0 - xi) ** 2 + 100.0 * (xn - xi ** 2) ** 2, dim=-1)


def rastrigin(x: torch.Tensor) -> torch.Tensor:
    """Paper §V-B2. A=10; global minimum f=0 at the origin."""
    a = 10.0
    return a * x.shape[-1] + torch.sum(
        x * x - a * torch.cos(2.0 * math.pi * x), dim=-1)


def ackley(x: torch.Tensor) -> torch.Tensor:
    """Paper §V-B3. The gradient is undefined at the global minimum (the
    origin): the paper's documented failure mode for |grad| < Θ."""
    d = x.shape[-1]
    s1 = torch.sqrt(torch.sum(x * x, dim=-1) / d)
    s2 = torch.sum(torch.cos(2.0 * math.pi * x), dim=-1) / d
    return -20.0 * torch.exp(-0.2 * s1) - torch.exp(s2) + math.e + 20.0


def goldstein_price(x: torch.Tensor) -> torch.Tensor:
    """Paper §V-B4. 2-D only. Global minimum f=3 at (0, -1)."""
    x1, x2 = x[..., 0], x[..., 1]
    t1 = 1.0 + (x1 + x2 + 1.0) ** 2 * (
        19.0 - 14.0 * x1 + 3.0 * x1 ** 2 - 14.0 * x2 + 6.0 * x1 * x2 + 3.0 * x2 ** 2
    )
    t2 = 30.0 + (2.0 * x1 - 3.0 * x2) ** 2 * (
        18.0 - 32.0 * x1 + 12.0 * x1 ** 2 + 48.0 * x2 - 36.0 * x1 * x2 + 27.0 * x2 ** 2
    )
    return t1 * t2


def sphere(x: torch.Tensor) -> torch.Tensor:
    """Convex sanity objective (not in the paper)."""
    return torch.sum(x * x, dim=-1)


# ---------------------------------------------------------------------------
# Dijet mass spectrum fit (paper §V-G / Fig. 5).
#
# The CMS/ATLAS dijet parameterisation
#   dN/dm = p0 · (1 - m/√s)^p1 / (m/√s)^(p2 + p3·log(m/√s)),
# fitted in (log p0, p1, p2, p3) by the Poisson negative log-likelihood of
# binned counts, in the dtype of the parameters (float32 or float64; the
# paper fits in float64): an NLL keeps its constants as float64 numpy and
# casts them to a dtype, and copies them to a device, once, at its first
# call in that dtype there.
# ---------------------------------------------------------------------------
SQRT_S = 13000.0  # GeV


def dijet_rate(params: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """dN/dm at masses m (n,) for params (..., 4) -> (..., n)."""
    logp0, p1, p2, p3 = (params[..., i, None] for i in range(4))
    xm = m / SQRT_S
    log_rate = logp0 + p1 * torch.log1p(-xm) - (p2 + p3 * torch.log(xm)) * torch.log(xm)
    return torch.exp(log_rate)


def make_dijet_nll(bin_edges: np.ndarray, counts: np.ndarray) -> Callable:
    """The per-bin Poisson NLL of `counts` in the bins `bin_edges`, as a
    function of params (..., 4) -> (...), computed in log space with no
    clamp on μ: a clamp would make a zero-gradient plateau at extreme
    params, where |g| < Θ would falsely converge; in log space those params
    overflow to inf and the lane fails instead."""
    edges = np.asarray(bin_edges, np.float64)
    host = {
        "centers": 0.5 * (edges[:-1] + edges[1:]),
        "widths": edges[1:] - edges[:-1],
        "counts": np.asarray(counts, np.float64),
    }
    n_bins = host["centers"].shape[0]
    on_device: Dict[Tuple[torch.device, torch.dtype], Dict[str, torch.Tensor]] = {}

    def constants(device, dtype):
        # cast on the host, where the log of the widths is taken in `dtype`
        # (as the reference takes it in its array dtype), then copied over
        const = {k: torch.tensor(v, dtype=dtype) for k, v in host.items()}
        const["log_widths"] = torch.log(const["widths"])
        return {k: v.to(device) for k, v in const.items()}

    def nll(params: torch.Tensor) -> torch.Tensor:
        key = (params.device, params.dtype)
        const = on_device.get(key)
        if const is None:
            const = on_device[key] = constants(*key)
        logp0, p1, p2, p3 = (params[..., i, None] for i in range(4))
        xm = const["centers"] / SQRT_S
        log_mu = (logp0 + p1 * torch.log1p(-xm) - (p2 + p3 * torch.log(xm)) * torch.log(xm)
                  + const["log_widths"])
        return torch.sum(torch.exp(log_mu) - const["counts"] * log_mu, dim=-1) / n_bins

    return nll


def simulate_dijet_counts(true_params, bin_edges: np.ndarray, seed: int = 0,
                          dtype: torch.dtype = torch.float32) -> np.ndarray:
    """Poisson counts (float64) in the bins `bin_edges` at `true_params`:
    μ = dijet_rate at the bin centres (in `dtype`, on the host: float32, or
    float64 as the reference computes it under x64) × the bin widths, drawn
    by numpy's default_rng(seed).poisson as in the reference."""
    rng = np.random.default_rng(seed)
    edges = np.asarray(bin_edges, np.float64)
    centers = 0.5 * (edges[:-1] + edges[1:])
    widths = edges[1:] - edges[:-1]
    rate = dijet_rate(torch.tensor(np.asarray(true_params), dtype=dtype),
                      torch.tensor(centers, dtype=dtype))
    return rng.poisson(rate.numpy() * widths).astype(np.float64)


OBJECTIVES = {
    "rosenbrock": Objective(
        "rosenbrock", rosenbrock, -5.0, 10.0, minimizer=lambda d: np.ones(d)
    ),
    "rastrigin": Objective(
        "rastrigin", rastrigin, -5.12, 5.12, minimizer=lambda d: np.zeros(d)
    ),
    "ackley": Objective(
        "ackley", ackley, -32.768, 32.768, minimizer=lambda d: np.zeros(d)
    ),
    "goldstein_price": Objective(
        "goldstein_price",
        goldstein_price,
        -2.0,
        2.0,
        minimizer=lambda d: np.array([0.0, -1.0]),
        min_value=3.0,
    ),
    "sphere": Objective("sphere", sphere, -5.0, 5.0, minimizer=lambda d: np.zeros(d)),
}


def get_objective(name: str) -> Objective:
    return OBJECTIVES[name]


def objective_name_of(fn: Callable) -> Optional[str]:
    """Reverse lookup: the registry name of an objective function, by
    identity, so that zeus()/run_multistart route a named paper objective
    handed over as a bare callable through the fused kernels."""
    for name, obj in OBJECTIVES.items():
        if obj.fn is fn:
            return name
    return None


# ---------------------------------------------------------------------------
# Batched objective protocol (the engine's batched sweep).
# ---------------------------------------------------------------------------
BatchedVG = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]

# name -> (batched (f, g) implementation, optional value-only twin)
_BATCHED_VG: Dict[str, Tuple[BatchedVG, Optional[Callable]]] = {}


def register_batched_vg(name: str, vg_batch: BatchedVG,
                        value_batch: Optional[Callable] = None) -> None:
    """Register a hand-fused `X (B, D) -> (f (B,), g (B, D))` for `name`.

    `value_batch` (X -> f (B,)) is its value-only twin for the Armijo
    ladder; it MUST agree with vg_batch's f to fp rounding, because the
    Armijo test compares ladder values against F0 from vg_batch. Both must
    be row-independent: row i of the output depends only on row i of X,
    identically at any batch size (lane_chunk relies on it)."""
    _BATCHED_VG[name] = (vg_batch, value_batch)


def _fused_impls_for(name: str):
    """(value_and_grad_batch, value_batch) for a registered or fused-kernel
    name, or None."""
    if name in _BATCHED_VG:
        vg, value = _BATCHED_VG[name]
        return vg, (value if value is not None else (lambda X: vg(X)[0]))
    if name in kernel_ops.FUSED_OBJECTIVES:
        return (
            functools.partial(kernel_ops.fused_value_grad, name),
            functools.partial(kernel_ops.fused_value, name),
        )
    return None


def analytic_fused_name(bobj) -> Optional[str]:
    """The fused-kernel name a batched objective routes through, or None.

    The sweep megakernel runs the fused objective's row body inside its
    kernel, so only a name with such a body (kernels/fused_obj.py) that no
    `register_batched_vg` call shadows qualifies: a registered evaluator is
    an opaque callable."""
    name = getattr(bobj, "name", None)
    if name is None or name in _BATCHED_VG:
        return None
    return name if name in kernel_ops.FUSED_OBJECTIVES else None


class BatchedObjective:
    """A scalar objective lifted to whole-batch evaluation.

    value_batch(X)          -> f (B,)             one call for B trials
    value_and_grad_batch(X) -> (f (B,), g (B, D)) fused kernel or one vmap
    vg_cost(dim)            -> objective-eval equivalents per lane per call
    """

    def __init__(self, fn: Callable, name: Optional[str] = None,
                 ad_mode: str = "forward"):
        self.fn = fn
        self.name = name
        self.ad_mode = ad_mode
        impls = _fused_impls_for(name) if name is not None else None
        if impls is not None:
            self._fused_vg, self._value_batch = impls
        else:
            self._fused_vg = None
            self._value_batch = vmap(fn)
            self._vg_batch = vmap(value_and_grad_fn(fn, ad_mode))

    @property
    def fused(self) -> bool:
        return self._fused_vg is not None

    def value_batch(self, X: torch.Tensor) -> torch.Tensor:
        return self._value_batch(X)

    def value_and_grad_batch(self, X: torch.Tensor):
        if self._fused_vg is not None:
            return self._fused_vg(X)
        return self._vg_batch(X)

    def vg_cost(self, dim: int) -> int:
        # a fused kernel shares one traversal: ~2 evals
        return 2 if self.fused else grad_eval_cost(dim, self.ad_mode)


def as_batched(f, ad_mode: str = "forward") -> BatchedObjective:
    """Resolve a callable (or Objective, or an already-batched objective)
    to a BatchedObjective, picking the fused kernel for registered names."""
    if isinstance(f, BatchedObjective):
        return f
    if isinstance(f, Objective):
        return BatchedObjective(f.fn, name=f.name, ad_mode=ad_mode)
    return BatchedObjective(f, name=objective_name_of(f), ad_mode=ad_mode)
