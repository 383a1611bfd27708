"""BFGS inverse-Hessian update in the ρ-form (kernel csrc/bfgs_update.cu).

Port of src/repro/kernels/bfgs_update.py. Per lane,
    u = H δg,  s = δgᵀu,
    H' = H − ρ(u δxᵀ + δx uᵀ) + (ρ²s + ρ) δx δxᵀ,
in three variants:
  guarded_update_direction — ρ given (0 where the curvature guard or a
      frozen lane disables the update, with δx, δg zeroed there, so
      H' = H exactly), and p' = −H' g'  (guarded_update_direction_pallas);
  bfgs_update              — ρ = 1/(δxᵀδg) per lane, unguarded, H' only
      (bfgs_update_pallas);
  update_direction         — the same ρ, with p' = −H' g'
      (update_direction_pallas).
The unguarded two divide by δxᵀδg as the TPU kernels do: callers pass
curvature-safe pairs or the engine's stand-in pair (1, …, 1), never a zero
pair. The JAX package's `ref.bfgs_update_ref` oracle is the literal
V H Vᵀ + ρ δx δxᵀ, algebraically equal and rounded differently.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def _rho_form(H, dx, dg, rho):
    """H' for H (B, D, D), dx/dg (B, D), rho (B,). Row-wise multiplies and
    sums, not matmuls, so each lane rounds the same whatever the batch
    size."""
    u = torch.sum(H * dg[:, None, :], dim=-1)
    s = torch.sum(dg * u, dim=-1)
    coef = rho * rho * s + rho
    r = rho[:, None, None]
    return (H - r * (u[:, :, None] * dx[:, None, :] + dx[:, :, None] * u[:, None, :])
            + coef[:, None, None] * (dx[:, :, None] * dx[:, None, :]))


def _direction(H_new, g_new):
    return -torch.sum(H_new * g_new[:, None, :], dim=-1)


def guarded_update_direction_plain(H, dx, dg, g_new, rho):
    """H (B, D, D), dx/dg/g_new (B, D), rho (B,) -> (H', p')."""
    H_new = _rho_form(H, dx, dg, rho)
    return H_new, _direction(H_new, g_new)


def bfgs_update_plain(H, dx, dg):
    """H (B, D, D), dx/dg (B, D) -> H' with ρ = 1/(δxᵀδg) per lane."""
    return _rho_form(H, dx, dg, 1.0 / torch.sum(dx * dg, dim=-1))


def update_direction_plain(H, dx, dg, g_new):
    """bfgs_update_plain followed by p' = −H' g' -> (H', p')."""
    H_new = bfgs_update_plain(H, dx, dg)
    return H_new, _direction(H_new, g_new)


def _check(op, H, vectors, rho=None):
    """(B, D) of a call whose tensors are all contiguous CUDA tensors in H's
    dtype; raise otherwise."""
    if H.dim() != 3 or H.shape[1] != H.shape[2]:
        raise ValueError(f"{op}: H must be (B, D, D), got {tuple(H.shape)}")
    B, D, _ = H.shape
    _build.check_tensor(op, "H", H, (B, D, D), dtype=H.dtype)
    for arg, t in vectors:
        _build.check_tensor(op, arg, t, (B, D), H.device, H.dtype)
    if rho is not None:
        _build.check_tensor(op, "rho", rho, (B,), H.device, H.dtype)
    return B, D


# The CUDA kernels; same contracts as the plain versions, one launch a call,
# float32 or float64 (every tensor in H's dtype). The kernel picks its
# variant by D and the element size (ops.update_variant: a warp per lane, H
# read once through shared memory, or H streamed twice). H' is a new tensor.
def guarded_update_direction_cuda(H, dx, dg, g_new, rho):
    sym = _build.symbol("guarded_update_direction", "guarded_update_direction_launch",
                        H.dtype)
    B, D = _check("guarded_update_direction", H,
                  (("dx", dx), ("dg", dg), ("g_new", g_new)), rho)
    H_new = torch.empty_like(H)
    p = H.new_empty(B, D)
    _build.launch(sym, H.data_ptr(), dx.data_ptr(),
                  dg.data_ptr(), g_new.data_ptr(), rho.data_ptr(),
                  H_new.data_ptr(), p.data_ptr(), B, D, _build.stream(H))
    return H_new, p


def bfgs_update_cuda(H, dx, dg):
    sym = _build.symbol("bfgs_update", "bfgs_update_launch", H.dtype)
    B, D = _check("bfgs_update", H, (("dx", dx), ("dg", dg)))
    H_new = torch.empty_like(H)
    _build.launch(sym, H.data_ptr(), dx.data_ptr(), dg.data_ptr(),
                  H_new.data_ptr(), B, D, _build.stream(H))
    return H_new


def update_direction_cuda(H, dx, dg, g_new):
    sym = _build.symbol("update_direction", "update_direction_launch", H.dtype)
    B, D = _check("update_direction", H, (("dx", dx), ("dg", dg), ("g_new", g_new)))
    H_new = torch.empty_like(H)
    p = H.new_empty(B, D)
    _build.launch(sym, H.data_ptr(), dx.data_ptr(),
                  dg.data_ptr(), g_new.data_ptr(), H_new.data_ptr(), p.data_ptr(),
                  B, D, _build.stream(H))
    return H_new, p
