"""Fused mean-field PSO update (kernel csrc/meanfield_step.cu).

Port of src/repro/kernels/meanfield_step.py (body `_meanfield_kernel`):
    d  = x̄ − x
    v' = w·v + λ·d + σ·s(d) ⊙ ξ,   s(d) = ‖d‖₂ per row ("isotropic")
                                    s(d) = d         ("anisotropic")
    x' = x + v'
The anisotropic envelope is the signed d, as in the reference's code. The
consensus point x̄ is computed outside (core/meanfield.py). Nothing is
padded: the JAX op pads D only on the TPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NOISE_MODES = ("isotropic", "anisotropic")


def _check_noise(noise: str) -> None:
    if noise not in NOISE_MODES:
        raise ValueError(f"unknown noise mode {noise!r}; expected one of {NOISE_MODES}")


def meanfield_step_plain(x, v, xbar, xi, w, drift, sigma, noise="anisotropic"):
    """x/v/xi (N, D), xbar (D,) -> (x', v')."""
    _check_noise(noise)
    d = xbar[None, :] - x
    if noise == "isotropic":
        scale = torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
    else:
        scale = d
    v_new = w * v + drift * d + sigma * scale * xi
    return x + v_new, v_new


def meanfield_step_cuda(x, v, xbar, xi, w, drift, sigma, noise="anisotropic"):
    """The CUDA kernel; same contract as meanfield_step_plain, float32 or
    float64 on the card (every tensor in x's dtype; w, drift and sigma
    rounded to it)."""
    _check_noise(noise)
    if x.dim() != 2:
        raise ValueError(f"meanfield_step: x must be (N, D), got {tuple(x.shape)}")
    N, D = x.shape
    sym = _build.symbol("meanfield_step", "meanfield_step_launch", x.dtype)
    for arg, t in (("x", x), ("v", v), ("xi", xi)):
        _build.check_tensor("meanfield_step", arg, t, (N, D), x.device, x.dtype)
    _build.check_tensor("meanfield_step", "xbar", xbar, (D,), x.device, x.dtype)
    x_new = torch.empty_like(x)
    v_new = torch.empty_like(x)
    _build.launch(sym, x.data_ptr(), v.data_ptr(),
                  xbar.data_ptr(), xi.data_ptr(), float(w), float(drift),
                  float(sigma), int(noise == "isotropic"), x_new.data_ptr(),
                  v_new.data_ptr(), N, D, _build.stream(x))
    return x_new, v_new
