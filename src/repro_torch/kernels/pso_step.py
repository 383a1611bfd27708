"""Fused PSO velocity and position update (kernel csrc/pso_step.cu).

Port of src/repro/kernels/pso_step.py (paper Alg. 9 lines 9-10):
    v' = w·v + c1·r1⊙(px − x) + c2·r2⊙(gx − x),   x' = x + v'
The personal and global best bookkeeping stays outside (core/pso.py).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def pso_step_plain(x, v, px, gx, r1, r2, w, c1, c2):
    """x/v/px/r1/r2 (N, D), gx (D,) -> (x', v')."""
    v_new = w * v + c1 * r1 * (px - x) + c2 * r2 * (gx[None, :] - x)
    return x + v_new, v_new


def pso_step_cuda(x, v, px, gx, r1, r2, w, c1, c2):
    """The CUDA kernel; same contract as pso_step_plain, float32 on the card."""
    if x.dim() != 2:
        raise ValueError(f"pso_step: x must be (N, D), got {tuple(x.shape)}")
    N, D = x.shape
    for arg, t in (("x", x), ("v", v), ("px", px), ("r1", r1), ("r2", r2)):
        _build.check_tensor("pso_step", arg, t, (N, D), x.device)
    _build.check_tensor("pso_step", "gx", gx, (D,), x.device)
    x_new = torch.empty_like(x)
    v_new = torch.empty_like(x)
    _build.launch("pso_step", _build.ptr(x), _build.ptr(v), _build.ptr(px),
                  _build.ptr(gx), _build.ptr(r1), _build.ptr(r2), float(w),
                  float(c1), float(c2), _build.ptr(x_new), _build.ptr(v_new),
                  N, D, _build.stream(x))
    return x_new, v_new
