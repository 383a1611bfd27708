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
    """The CUDA kernel; same contract as direction_plain, float32 on the card."""
    if H.dim() != 3 or H.shape[1] != H.shape[2]:
        raise ValueError(f"direction: H must be (B, D, D), got {tuple(H.shape)}")
    B, D, _ = H.shape
    _build.check_tensor("direction", "H", H, (B, D, D))
    _build.check_tensor("direction", "g", g, (B, D), H.device)
    p = torch.empty((B, D), dtype=H.dtype, device=H.device)
    _build.launch("direction_launch", _build.ptr(H), _build.ptr(g), _build.ptr(p),
                  B, D, _build.stream(H))
    return p
