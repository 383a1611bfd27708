"""Batched search direction p = −H·g (kernel csrc/direction.cu).

Port of src/repro/kernels/direction.py (paper Alg. 4 line 10).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def direction_plain(H, g):
    """H (B, D, D), g (B, D) -> p (B, D). A row-wise multiply and sum, not a
    matmul, so each lane rounds the same whatever the batch size."""
    return -torch.sum(H * g[:, None, :], dim=-1)


def direction_cuda(H, g):
    """The CUDA kernel; same contract as direction_plain, float32 or
    float64 on the card (g in H's dtype)."""
    shape = H.shape
    if len(shape) != 3 or shape[1] != shape[2]:
        raise ValueError(f"direction: H must be (B, D, D), got {tuple(shape)}")
    sym = _build.symbol("direction", "direction_launch", H.dtype)
    _build.check_tensor("direction", "H", H, shape, dtype=H.dtype)
    _build.check_tensor("direction", "g", g, shape[:2], H.device, H.dtype)
    p = torch.empty_like(g)
    _build.launch(sym, H.data_ptr(), g.data_ptr(), p.data_ptr(),
                  shape[0], shape[1], _build.stream(H))
    return p
