"""Guarded BFGS inverse-Hessian update fused with the next direction
(kernel csrc/bfgs_update.cu).

Port of src/repro/kernels/bfgs_update.py guarded_update_direction_pallas:
per lane, with ρ given (0 where the curvature guard or a frozen lane
disables the update),
    u = H δg,  s = δgᵀu,
    H' = H − ρ(u δxᵀ + δx uᵀ) + (ρ²s + ρ) δx δxᵀ,   p' = −H' g'.
With ρ = 0 and zeroed δx, δg every term vanishes and H' = H exactly.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def guarded_update_direction_plain(H, dx, dg, g_new, rho):
    """H (B, D, D), dx/dg/g_new (B, D), rho (B,) -> (H', p'). Row-wise
    multiplies and sums, not matmuls, so each lane rounds the same whatever
    the batch size."""
    u = torch.sum(H * dg[:, None, :], dim=-1)
    s = torch.sum(dg * u, dim=-1)
    coef = rho * rho * s + rho
    r = rho[:, None, None]
    H_new = (H - r * (u[:, :, None] * dx[:, None, :] + dx[:, :, None] * u[:, None, :])
             + coef[:, None, None] * (dx[:, :, None] * dx[:, None, :]))
    return H_new, -torch.sum(H_new * g_new[:, None, :], dim=-1)


def guarded_update_direction_cuda(H, dx, dg, g_new, rho):
    """The CUDA kernel; same contract as the plain version, float32 on the
    card. H' is a new tensor (the kernel could update H in place; this
    wrapper does not)."""
    if H.dim() != 3 or H.shape[1] != H.shape[2]:
        raise ValueError(
            f"guarded_update_direction: H must be (B, D, D), got {tuple(H.shape)}")
    B, D, _ = H.shape
    op = "guarded_update_direction"
    _build.check_tensor(op, "H", H, (B, D, D))
    for arg, t in (("dx", dx), ("dg", dg), ("g_new", g_new)):
        _build.check_tensor(op, arg, t, (B, D), H.device)
    _build.check_tensor(op, "rho", rho, (B,), H.device)
    H_new = torch.empty_like(H)
    p = torch.empty((B, D), dtype=H.dtype, device=H.device)
    _build.launch("bfgs_update", _build.ptr(H), _build.ptr(dx), _build.ptr(dg),
                  _build.ptr(g_new), _build.ptr(rho), _build.ptr(H_new),
                  _build.ptr(p), B, D, _build.stream(H))
    return H_new, p
