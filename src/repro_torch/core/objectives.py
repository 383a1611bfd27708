"""Benchmark objective functions from the paper (§V-B).

Port of src/repro/core/objectives.py. Every objective is written in torch
over the last axis, so the same function takes one point (D,) -> () or a
batch (..., D) -> (...), vmaps, and differentiates in forward or reverse
mode. Each comes with its search box and optimum.

The dijet negative log-likelihood of the JAX package is not ported yet.
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
