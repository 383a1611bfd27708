"""Dual-number forward-mode AD (paper §III-C, Alg. 5) and the gradients
of user objectives.

Port of src/repro/core/dual.py:
- the paper's explicit construction: a `Dual(val, tan)` pair of torch
  tensors with overloaded arithmetic, the transcendental ops its test
  functions use, Alg. 5's `forward_ad` (one pass per input dimension) and
  the dual-number versions of rosenbrock, rastrigin and sphere;
- the production path, `value_and_grad_fn(f, mode)` and
  `grad_eval_cost(dim, mode)`:
    forward — one jvp per basis vector (torch.func.jvp under vmap): the
              vectorised form of Alg. 5;
    reverse — torch.func.grad_and_value (beyond-paper option).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch.func import grad_and_value, jvp, vmap


def _tan_of(other, like):
    if isinstance(other, Dual):
        return other.tan
    return torch.zeros_like(like)


def _val_of(other):
    return other.val if isinstance(other, Dual) else other


@dataclasses.dataclass
class Dual:
    """a + b·ε with ε² = 0: `val` carries the primal, `tan` the tangent."""

    val: torch.Tensor
    tan: torch.Tensor

    def __add__(self, other):
        return Dual(self.val + _val_of(other), self.tan + _tan_of(other, self.tan))

    __radd__ = __add__

    def __neg__(self):
        return Dual(-self.val, -self.tan)

    def __sub__(self, other):
        return Dual(self.val - _val_of(other), self.tan - _tan_of(other, self.tan))

    def __rsub__(self, other):
        return Dual(_val_of(other) - self.val, _tan_of(other, self.tan) - self.tan)

    def __mul__(self, other):
        ov, ot = _val_of(other), _tan_of(other, self.tan)
        return Dual(self.val * ov, self.tan * ov + self.val * ot)

    __rmul__ = __mul__

    def __truediv__(self, other):
        ov, ot = _val_of(other), _tan_of(other, self.tan)
        return Dual(self.val / ov, (self.tan * ov - self.val * ot) / (ov * ov))

    def __rtruediv__(self, other):
        ov, ot = _val_of(other), _tan_of(other, self.tan)
        return Dual(ov / self.val, (ot * self.val - ov * self.tan) / (self.val ** 2))

    def __pow__(self, n):
        if isinstance(n, Dual):
            return dexp(n * dlog(self))  # a^b = exp(b log a)
        return Dual(self.val ** n, n * self.val ** (n - 1) * self.tan)

    # comparisons act on the primals (branching on values, as in the paper)
    def __lt__(self, other):
        return self.val < _val_of(other)

    def __le__(self, other):
        return self.val <= _val_of(other)

    def __gt__(self, other):
        return self.val > _val_of(other)

    def __ge__(self, other):
        return self.val >= _val_of(other)


def dsin(d: Dual) -> Dual:
    return Dual(torch.sin(d.val), torch.cos(d.val) * d.tan)


def dcos(d: Dual) -> Dual:
    return Dual(torch.cos(d.val), -torch.sin(d.val) * d.tan)


def dexp(d: Dual) -> Dual:
    e = torch.exp(d.val)
    return Dual(e, e * d.tan)


def dlog(d: Dual) -> Dual:
    return Dual(torch.log(d.val), d.tan / d.val)


def dsqrt(d: Dual) -> Dual:
    s = torch.sqrt(d.val)
    return Dual(s, 0.5 * d.tan / s)


def dsum(duals) -> Dual:
    """Sum of a list of Duals, left to right."""
    out = duals[0]
    for d in duals[1:]:
        out = out + d
    return out


def _seeded(x: torch.Tensor, i: int):
    """Alg. 5's xDual: the coordinates of x with tangent 1 at i (none at
    i = -1) and 0 elsewhere."""
    one, zero = torch.ones((), dtype=x.dtype, device=x.device), torch.zeros(
        (), dtype=x.dtype, device=x.device)
    return [Dual(x[j], one if j == i else zero) for j in range(x.shape[0])]


def forward_ad(f_dual: Callable, x: torch.Tensor) -> torch.Tensor:
    """Alg. 5: ∇f at x (D,) by D evaluations of f_dual, each seeding one
    coordinate's tangent with 1. f_dual takes a list of Duals and returns
    one Dual."""
    return torch.stack([f_dual(_seeded(x, i)).tan for i in range(x.shape[0])])


def value_and_forward_ad(f_dual: Callable, x: torch.Tensor):
    return f_dual(_seeded(x, -1)).val, forward_ad(f_dual, x)


def rosenbrock_dual(xd):
    terms = [(1.0 - xd[i]) ** 2 + 100.0 * (xd[i + 1] - xd[i] ** 2) ** 2
             for i in range(len(xd) - 1)]
    return dsum(terms)


def rastrigin_dual(xd):
    a = 10.0
    terms = [xd[i] * xd[i] - a * dcos(xd[i] * (2.0 * math.pi)) for i in range(len(xd))]
    return dsum(terms) + a * len(xd)


def sphere_dual(xd):
    return dsum([d * d for d in xd])


def grad_eval_cost(dim: int, mode: str = "forward") -> int:
    """Objective-eval equivalents consumed by one value_and_grad call:
    1 + D passes in forward mode, ~2 in reverse mode."""
    if mode == "forward":
        return 1 + dim
    if mode == "reverse":
        return 2
    raise ValueError(f"unknown AD mode: {mode}")


def value_and_grad_fn(f: Callable, mode: str = "forward") -> Callable:
    """`x (D,) -> (f(x), ∇f(x))` for a scalar objective f written in torch."""
    if mode == "reverse":
        gv = grad_and_value(f)

        def vg_reverse(x):
            g, val = gv(x)
            return val, g

        return vg_reverse

    if mode == "forward":

        def vg(x):
            basis = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
            val, tangents = vmap(lambda v: jvp(f, (x,), (v,)))(basis)
            # torch's forward AD promotes the tangent of a 0-dim float32
            # intermediate combined with a Python scalar to float64
            # (e.g. 3.0 * x[0]); the gradient comes back in x's dtype,
            # float32 or float64
            return val[0], tangents.to(x.dtype)

        return vg

    raise ValueError(f"unknown AD mode: {mode}")
