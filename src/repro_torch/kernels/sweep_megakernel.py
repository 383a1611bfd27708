"""The sweep megakernel: one batched dense-BFGS sweep in one launch
(kernel csrc/sweep_megakernel.cu).

Port of src/repro/kernels/sweep_megakernel.py. Per lane:
  full (B5)   — the K-rung trial fan x + α_k·p from the canonical ladder,
                its values, the first rung accepted against the Armijo
                thresholds the staged path computed (K when none, with
                α = α_{K−1}·shrink), then the commit;
  commit (B5b) — the commit alone, with α from the adaptive ladder:
                x' = x + α·p, f and ∇f at x', the curvature guard
                (δxᵀδg finite and > 1e-10, lane active), ρ and the pairs
                zeroed by selects where it fails, and the guarded ρ-form
                H' with p' = −H'g'.

The plain versions compose the port's own plain functions in the staged
path's order (the ladder's trial fan and value call, the accept, the
value+grad at x', `torch.sum` for the curvature, the ρ selects and
`guarded_update_direction_plain`), so on the CPU the megakernel sweep is
array-equal to the staged one. Nothing is padded: the JAX kernels pad D to
the TPU's 128 lanes; these take any D up to the shared-memory cap of
`ops.megakernel_max_dim`. Up to `ops.megakernel_smem_dim` the kernel copies
each lane's H into shared memory once, above it it streams H twice: a
choice by shape inside the kernel, with the same results.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bfgs_update import guarded_update_direction_plain
from repro_torch.kernels.fused_obj import _KERNEL_ID, FUSED_OBJECTIVES, value_grad_plain

_CURV_EPS = 1e-10  # engine._CURV_EPS; kept literal to avoid a core import


def _accept(F, rhs, alphas, exhaust_alpha):
    """First accepted rung per lane of the (K, B) ladder values F, K when
    none, and its α (exhaust_alpha when none)."""
    K = F.shape[0]
    ok = F <= rhs
    any_ok = torch.any(ok, dim=0)
    # argmax returns the first maximum: the first accepted rung (0 if none)
    k_acc = torch.argmax(ok.to(torch.int32), dim=0)
    alpha = torch.where(any_ok, alphas[k_acc], exhaust_alpha)
    return alpha, torch.where(any_ok, k_acc, K).to(torch.int32)


def sweep_megakernel_commit_plain(name, X, P, G, H, active, alpha):
    """X/P/G (B, D), H (B, D, D), active (B,) bool, alpha (B,)
    -> (x', f', g', H', p')."""
    X_new = X + alpha[:, None] * P
    F_new, G_new = value_grad_plain(name, X_new)
    dX, dG = X_new - X, G_new - G
    curv = torch.sum(dX * dG, dim=-1)
    ok = active & torch.isfinite(curv) & (curv > _CURV_EPS)
    rho = torch.where(ok, 1.0 / torch.where(ok, curv, 1.0), 0.0)
    dXs = torch.where(ok[:, None], dX, 0.0)
    dGs = torch.where(ok[:, None], dG, 0.0)
    H_new, P_new = guarded_update_direction_plain(H, dXs, dGs, G_new, rho)
    return X_new, F_new, G_new, H_new, P_new


def sweep_megakernel_full_plain(name, X, P, G, H, active, rhs, alphas, exhaust_alpha):
    """X/P/G (B, D), H (B, D, D), active (B,) bool, rhs (K, B) thresholds,
    alphas (K,) the ladder on X's device, exhaust_alpha the float32 constant
    α_{K−1}·shrink -> (x', f', g', H', p', α (B,), rung (B,) int32)."""
    K, B = rhs.shape
    D = X.shape[1]
    trials = X[None] + alphas[:, None, None] * P[None]  # (K, B, D)
    F = value_grad_plain(name, trials.reshape(K * B, D), with_grad=False)[0]
    alpha, rung = _accept(F.reshape(K, B), rhs, alphas, exhaust_alpha)
    return (*sweep_megakernel_commit_plain(name, X, P, G, H, active, alpha),
            alpha, rung)


def _check(op, name, X, P, G, H, active):
    if name not in _KERNEL_ID:
        raise ValueError(f"{op}: no fused body for objective {name!r}; have "
                         f"{FUSED_OBJECTIVES}")
    if X.dim() != 2:
        raise ValueError(f"{op}: X must be (B, D), got {tuple(X.shape)}")
    B, D = X.shape
    _build.check_tensor(op, "X", X, (B, D))
    for arg, t in (("P", P), ("G", G)):
        _build.check_tensor(op, arg, t, (B, D), X.device)
    _build.check_tensor(op, "H", H, (B, D, D), X.device)
    _build.check_tensor(op, "active", active, (B,), X.device, dtype=torch.bool)
    return B, D


def _outputs(X, H):
    B, D = X.shape
    return (torch.empty_like(X), X.new_empty(B),
            torch.empty_like(X), torch.empty_like(H), torch.empty_like(X))


# The CUDA kernels; same contracts as the plain versions, float32 on the
# card (active bool). H' is a new tensor.
def sweep_megakernel_full_cuda(name, X, P, G, H, active, rhs, alphas, exhaust_alpha):
    op = "sweep_megakernel_full"
    B, D = _check(op, name, X, P, G, H, active)
    K = rhs.shape[0] if rhs.dim() == 2 else -1
    if K < 1:
        raise ValueError(f"{op}: rhs must be (K, B) with K >= 1, got {tuple(rhs.shape)}")
    _build.check_tensor(op, "rhs", rhs, (K, B), X.device)
    _build.check_tensor(op, "alphas", alphas, (K,), X.device)
    x_new, f_new, g_new, H_new, p_new = outs = _outputs(X, H)
    alpha = X.new_empty(B)
    rung = X.new_empty(B, dtype=torch.int32)
    _build.launch("sweep_megakernel_full_launch", _KERNEL_ID[name], X.data_ptr(),
                  P.data_ptr(), G.data_ptr(), H.data_ptr(), active.data_ptr(),
                  rhs.data_ptr(), alphas.data_ptr(), float(exhaust_alpha),
                  *(t.data_ptr() for t in outs), alpha.data_ptr(), rung.data_ptr(),
                  B, D, K, _build.stream(X))
    return x_new, f_new, g_new, H_new, p_new, alpha, rung


def sweep_megakernel_commit_cuda(name, X, P, G, H, active, alpha):
    op = "sweep_megakernel_commit"
    B, D = _check(op, name, X, P, G, H, active)
    _build.check_tensor(op, "alpha", alpha, (B,), X.device)
    outs = _outputs(X, H)
    _build.launch("sweep_megakernel_commit_launch", _KERNEL_ID[name], X.data_ptr(),
                  P.data_ptr(), G.data_ptr(), H.data_ptr(), active.data_ptr(),
                  alpha.data_ptr(), *(t.data_ptr() for t in outs), B, D,
                  _build.stream(X))
    return outs
