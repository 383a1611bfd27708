"""Public kernel entry points of the port, dispatched by the tensor's device.

Port of src/repro/kernels/ops.py. Each op takes its plain PyTorch version
for a tensor on the CPU, and its hand-written CUDA kernel for a tensor on
the card: there is no switch that sends a CUDA tensor to the plain
version, and a kernel that cannot launch raises. Nothing is padded: the
JAX ops pad D to the TPU's 128-lane tile, which these kernels do not need.

Each op carries a plain integer counter, `<op>.launches`, that it raises by
one where it launches its kernel and nowhere else, so a run can show that
its main path went through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bfgs_update as _bfgs_update
from repro_torch.kernels import direction as _direction
from repro_torch.kernels import fused_obj, meanfield_step, pso_step
from repro_torch.kernels import sweep_megakernel as _sweep
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
        return _bfgs_update.guarded_update_direction_plain(H, dx, dg, g_new, rho)
    out = _bfgs_update.guarded_update_direction_cuda(H, dx, dg, g_new, rho)
    guarded_update_direction.launches += 1
    return out


def bfgs_update(H, dx, dg):
    """Unguarded H' with ρ = 1/(δxᵀδg) per lane, H (B, D, D), dx/dg (B, D):
    the per-lane path's hessian_impl="pallas". Never pass a zero pair."""
    if _on_cpu(H):
        return _bfgs_update.bfgs_update_plain(H, dx, dg)
    out = _bfgs_update.bfgs_update_cuda(H, dx, dg)
    bfgs_update.launches += 1
    return out


def bfgs_update_direction(H, dx, dg, g_new):
    """bfgs_update fused with p' = −H' g_new. Returns (H', p')."""
    if _on_cpu(H):
        return _bfgs_update.update_direction_plain(H, dx, dg, g_new)
    out = _bfgs_update.update_direction_cuda(H, dx, dg, g_new)
    bfgs_update_direction.launches += 1
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


def meanfield_step_update(x, v, xbar, xi, w, drift, sigma, noise="anisotropic"):
    """Fused mean-field update: (x', v') from x/v/ξ (N, D) and x̄ (D,);
    noise "isotropic" (row-norm envelope) or "anisotropic" (signed d)."""
    if _on_cpu(x):
        return meanfield_step.meanfield_step_plain(x, v, xbar, xi, w, drift, sigma,
                                                   noise)
    out = meanfield_step.meanfield_step_cuda(x, v, xbar, xi, w, drift, sigma, noise)
    meanfield_step_update.launches += 1
    return out


# -- sweep megakernel ---------------------------------------------------------
# Shared-memory cap of the sweep megakernel on the H100. A block may use
# 232,448 bytes (227 KB) of shared memory. The kernel keeps eight D-vectors
# (x, p, g, x', g', δx, δg, u) and, for the full sweep, eight trial rows of D
# and the K trial values in it, (16·D + K)·4 bytes, beside a few scalars
# (under 64 bytes); H streams from device memory and takes none. So the
# largest D for a K-rung ladder is (232448 − 64) / 4 − K, over 16:
# 3629 at the paper's K = 20. A constant of the card, not a device query, so
# the CPU and the card route alike.
SMEM_PER_BLOCK = 232_448
_SMEM_SCALARS = 64


def megakernel_max_dim(K: int) -> int:
    """The largest D the sweep megakernel takes with a K-rung ladder."""
    return ((SMEM_PER_BLOCK - _SMEM_SCALARS) // 4 - K) // 16


MEGAKERNEL_MAX_DIM = megakernel_max_dim(20)


def sweep_megakernel_full(name, X, P, G, H, active, rhs, alphas, exhaust_alpha):
    """ONE launch: ladder + accept + value+grad + guarded H' + p'.

    X/P/G (B, D), H (B, D, D), active (B,) bool, rhs (K, B) the Armijo
    thresholds (core/linesearch.armijo_thresholds), alphas (K,) the ladder
    on X's device and exhaust_alpha the float32 α_{K−1}·shrink (the
    reference takes the numpy ladder instead). Returns
    (x', f', g', H', p', α, rung)."""
    if _on_cpu(X):
        return _sweep.sweep_megakernel_full_plain(name, X, P, G, H, active, rhs, alphas,
                                                  exhaust_alpha)
    out = _sweep.sweep_megakernel_full_cuda(name, X, P, G, H, active, rhs, alphas,
                                            exhaust_alpha)
    sweep_megakernel_full.launches += 1
    return out


def sweep_megakernel_commit(name, X, P, G, H, active, alpha):
    """ONE launch: x + α·p, value+grad, guarded H' + p', with α (B,) from the
    adaptive ladder. Returns (x', f', g', H', p')."""
    if _on_cpu(X):
        return _sweep.sweep_megakernel_commit_plain(name, X, P, G, H, active, alpha)
    out = _sweep.sweep_megakernel_commit_cuda(name, X, P, G, H, active, alpha)
    sweep_megakernel_commit.launches += 1
    return out


KERNEL_OPS = (fused_value, fused_value_grad, guarded_update_direction,
              bfgs_update, bfgs_update_direction, direction, pso_step_update,
              meanfield_step_update, sweep_megakernel_full, sweep_megakernel_commit)
for _op in KERNEL_OPS:
    _op.launches = 0


def reset_launch_counts() -> None:
    for op in KERNEL_OPS:
        op.launches = 0


def launch_counts() -> dict:
    return {op.__name__: op.launches for op in KERNEL_OPS}
