"""Device and dtype resolution shared by the port's entry points."""
from __future__ import annotations

from typing import Optional

import torch

# the element types a solve runs in
FLOAT_DTYPES = (torch.float32, torch.float64)


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
    """A solve's dtype, a torch dtype or its name: float32 or float64."""
    dt = getattr(torch, dtype, None) if isinstance(dtype, str) else dtype
    if dt not in FLOAT_DTYPES:
        raise NotImplementedError(
            f"dtype {dtype!r}: the port solves in float32 or float64")
    return dt


def refuse_float64(dtype, opts=None, *, solver: str = "bfgs", resume=None,
                   entry: Optional[str] = None) -> None:
    """Raise NotImplementedError naming ROADMAP A19b when a float64 solve
    asks for a path that does not run in float64 yet.

    float64 runs phase 1 as PSO or the mean-field swarm (B4, B6) and phase 2
    as dense BFGS in every sweep mode: the batched sweep with the full or
    the adaptive ladder (B1a/B1b, B2, B3), the megakernel (B5, B5b) and the
    per-lane sweep (B3, B7a/B7b), with or without lane_chunk; and the
    sequential baseline (serial_bfgs, sequential_zeus). Everything else is
    refused here (A19b-2), from the options alone and before anything runs,
    so the CPU and the card refuse the same solves: solver "lbfgs",
    compact_every, repack_every, a schedule other than "static", retries,
    fault plans, checkpointing and resume, lane_deadlines, and the entries
    named by `entry` (HostedSolve, open_multistart, the solve service).
    `opts` is an EngineOptions (or any object with its fields); float32
    passes through untouched."""
    if check_dtype(dtype) is not torch.float64:
        return
    why = []
    if entry is not None:
        why.append(entry)
    if solver != "bfgs":
        why.append(f"solver={solver!r}")
    if opts is not None:
        for field in ("compact_every", "repack_every", "retry_budget",
                      "checkpoint_every", "lane_deadlines"):
            if getattr(opts, field):
                why.append(f"{field}={getattr(opts, field)!r}")
        if opts.schedule != "static":
            why.append(f"schedule={opts.schedule!r}")
        if opts.fault_plan is not None:
            why.append("fault_plan")
    if resume is not None:
        why.append("resume")
    if why:
        raise NotImplementedError(
            f"float64 with {', '.join(why)}: not ported yet (ROADMAP A19b); float64 "
            "runs PSO or mean-field phase 1 and dense BFGS in every sweep mode "
            "(static schedule, no retries, faults or checkpoints)")
