"""Fused objective value and value+gradient (kernel csrc/fused_obj.cu).

Port of src/repro/kernels/fused_obj.py. For sphere, rastrigin, rosenbrock
and ackley, one pass over each row of an (N, D) batch yields f(x) and,
optionally, ∇f(x), sharing subexpressions (rastrigin's 2πx feeds cos for
the value and sin for the gradient).

`value_grad_plain` is the plain PyTorch version: the CPU path, and what
the CUDA kernel is held against on the card. Like the JAX bodies it is one
row-wise body per objective with a `with_grad` flag, so the value-only call
runs exactly the value ops of the value+grad call and rounds f the same.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

FUSED_OBJECTIVES = ("sphere", "rastrigin", "rosenbrock", "ackley")
_KERNEL_ID = {name: i for i, name in enumerate(FUSED_OBJECTIVES)}
_TWO_PI = 2.0 * math.pi


def _sphere(x, with_grad):
    f = torch.sum(x * x, dim=-1)
    return f, (2.0 * x if with_grad else None)


def _rastrigin(x, with_grad):
    a = 10.0
    two_pi_x = _TWO_PI * x
    f = a * x.shape[-1] + torch.sum(x * x - a * torch.cos(two_pi_x), dim=-1)
    if not with_grad:
        return f, None
    return f, 2.0 * x + (_TWO_PI * a) * torch.sin(two_pi_x)


def _rosenbrock(x, with_grad):
    xi, xn = x[:, :-1], x[:, 1:]
    d = xn - xi * xi
    t = 1.0 - xi
    f = torch.sum(t * t + 100.0 * d * d, dim=-1)
    if not with_grad:
        return f, None
    g = torch.zeros_like(x)
    g[:, :-1] += -2.0 * (1.0 - xi) - 400.0 * xi * d
    g[:, 1:] += 200.0 * d
    return f, g


def _ackley(x, with_grad):
    """Paper §V-B3. At the origin s1 = 0 and the gradient is 0/0 = NaN, the
    paper's documented |grad| < Θ failure mode; the reference keeps it."""
    d = x.shape[-1]
    two_pi_x = _TWO_PI * x
    s1 = torch.sqrt(torch.sum(x * x, dim=-1) / d)
    s2 = torch.sum(torch.cos(two_pi_x), dim=-1) / d
    e1 = torch.exp(-0.2 * s1)
    e2 = torch.exp(s2)
    f = -20.0 * e1 - e2 + math.e + 20.0
    if not with_grad:
        return f, None
    g = (4.0 * e1 / (d * s1))[:, None] * x + (
        (_TWO_PI / d) * torch.sin(two_pi_x)) * e2[:, None]
    return f, g


_BODIES = {"sphere": _sphere, "rastrigin": _rastrigin,
           "rosenbrock": _rosenbrock, "ackley": _ackley}


def value_grad_plain(name: str, x: torch.Tensor, with_grad: bool = True):
    """x (N, D) -> (f (N,), g (N, D) or None when not with_grad)."""
    return _BODIES[name](x, with_grad)


def value_grad_cuda(name: str, x: torch.Tensor, with_grad: bool = True):
    """The CUDA kernel: x (N, D) float32 contiguous on the card, at any
    4-byte alignment -> (f (N,), g (N, D) or None). The variant follows D
    alone (ops.fused_obj_variant; csrc/fused_obj.cu)."""
    kernel_id = _KERNEL_ID.get(name)
    if kernel_id is None:
        raise ValueError(f"no fused kernel for objective {name!r}; "
                         f"have {FUSED_OBJECTIVES}")
    shape = x.shape
    if len(shape) != 2:
        raise ValueError(f"fused_obj: x must be (N, D), got {tuple(shape)}")
    _build.check_tensor("fused_obj", "x", x, shape)
    N, D = shape
    f = x.new_empty(N)
    g = torch.empty_like(x) if with_grad else None
    _build.launch("fused_obj_launch", kernel_id, int(with_grad), x.data_ptr(),
                  f.data_ptr(), g.data_ptr() if with_grad else None, N, D,
                  _build.stream(x))
    return f, g


def trig_check_cuda(device="cuda"):
    """The fused objectives' fast cosine and sine (csrc/objective.cuh
    trig_fast_path) against the toolkit's cosf and sinf on every float t
    with |t| < 105615, on the card: (cosines that differ in any bit, sines
    that differ, floats compared). A check; no solve calls it."""
    counts = torch.zeros(3, dtype=torch.int64, device=device)
    _build.launch("fused_obj_trig_check_launch", counts.data_ptr(), _build.stream(counts))
    return tuple(int(c) for c in counts.tolist())
