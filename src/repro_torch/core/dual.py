"""Gradients of user objectives by automatic differentiation (paper §III-C).

Port of the production-path half of src/repro/core/dual.py:
`value_and_grad_fn(f, mode)` and `grad_eval_cost(dim, mode)`.
  forward — one jvp per basis vector (torch.func.jvp under vmap): the
            vectorised form of the paper's dual-number Alg. 5;
  reverse — torch.func.grad_and_value (beyond-paper option).
The explicit `Dual` number class of the JAX package is not ported yet.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import grad_and_value, jvp, vmap


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
            # (e.g. 3.0 * x[0]); the port is float32 throughout
            return val[0], tangents.to(x.dtype)

        return vg

    raise ValueError(f"unknown AD mode: {mode}")
