"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The torch.device for an entry point's `device` argument.

    Entry points default to "cuda". Without a card that raises rather than
    falling back to the CPU: a caller who wants the plain CPU path asks for
    it with device="cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


def check_dtype(dtype) -> torch.dtype:
    """Only float32 is supported in this port."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if dt != torch.float32:
        raise NotImplementedError(
            f"dtype {dtype!r}: the port supports float32 only")
    return dt
