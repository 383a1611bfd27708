"""Public kernel entry points of the port, dispatched by the tensor's device.

Port of src/repro/kernels/ops.py for the four kernels of the main path.
Each op takes its plain PyTorch version for a tensor on the CPU, and its
hand-written CUDA kernel for a tensor on the card: there is no switch that
sends a CUDA tensor to the plain version, and a kernel that cannot launch
raises. Nothing is padded: the JAX ops pad D to the TPU's 128-lane tile,
which a warp-per-row kernel does not need.

Each op carries a plain integer counter, `<op>.launches`, that it raises by
one where it launches its kernel and nowhere else, so a run can show that
its main path went through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bfgs_update, direction as _direction
from repro_torch.kernels import fused_obj, pso_step
from repro_torch.kernels.fused_obj import FUSED_OBJECTIVES  # noqa: F401


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def fused_value_grad(name: str, x: torch.Tensor):
    """x (N, D) -> (f (N,), g (N, D)) for a name in FUSED_OBJECTIVES."""
    if _on_cpu(x):
        return fused_obj.value_grad_plain(name, x)
    out = fused_obj.value_grad_cuda(name, x)
    fused_value_grad.launches += 1
    return out


def fused_value(name: str, x: torch.Tensor) -> torch.Tensor:
    """x (N, D) -> f (N,): the value-only twin of fused_value_grad, whose f
    it matches bit for bit (the Armijo test compares the two)."""
    if _on_cpu(x):
        return fused_obj.value_grad_plain(name, x, with_grad=False)[0]
    f, _ = fused_obj.value_grad_cuda(name, x, with_grad=False)
    fused_value.launches += 1
    return f


def guarded_update_direction(H, dx, dg, g_new, rho):
    """Guarded fused H' + p' = −H' g_new; rho (B,) is 0 where the update is
    disabled, with dx, dg zeroed there, so H' = H exactly for those lanes."""
    if _on_cpu(H):
        return bfgs_update.guarded_update_direction_plain(H, dx, dg, g_new, rho)
    out = bfgs_update.guarded_update_direction_cuda(H, dx, dg, g_new, rho)
    guarded_update_direction.launches += 1
    return out


def direction(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """p = −H g for H (B, D, D), g (B, D)."""
    if _on_cpu(H):
        return _direction.direction_plain(H, g)
    p = _direction.direction_cuda(H, g)
    direction.launches += 1
    return p


def pso_step_update(x, v, px, gx, r1, r2, w, c1, c2):
    """Fused PSO step: (x', v') from x/v/px/r1/r2 (N, D) and gx (D,)."""
    if _on_cpu(x):
        return pso_step.pso_step_plain(x, v, px, gx, r1, r2, w, c1, c2)
    out = pso_step.pso_step_cuda(x, v, px, gx, r1, r2, w, c1, c2)
    pso_step_update.launches += 1
    return out


KERNEL_OPS = (fused_value, fused_value_grad, guarded_update_direction,
              direction, pso_step_update)
for _op in KERNEL_OPS:
    _op.launches = 0


def reset_launch_counts() -> None:
    for op in KERNEL_OPS:
        op.launches = 0


def launch_counts() -> dict:
    return {op.__name__: op.launches for op in KERNEL_OPS}
