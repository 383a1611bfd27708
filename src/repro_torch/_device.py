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


def refuse_float64(dtype, opts=None, *, solver: str = "bfgs", phase1: str = "pso",
                   resume=None, entry: Optional[str] = None) -> None:
    """Raise NotImplementedError naming ROADMAP A19b when a float64 solve
    asks for a path whose float64 kernels are not ported yet.

    float64 runs phase 1 as PSO and phase 2 as dense BFGS on the batched
    sweep (sweep_mode="batched", static schedule, full Armijo ladder, with
    or without lane_chunk): kernels B1a/B1b, B2, B3 and B4 have double
    instantiations. Everything else is refused here, from the options alone
    and before anything runs, so the CPU and the card refuse the same
    solves: sweep_mode "megakernel" (B5/B5b; no fallback to the batched
    sweep) and "per_lane" (B7a/B7b), solver "lbfgs", phase1 "meanfield"
    (B6), ladder_len, compact_every, repack_every, a schedule other than
    "static", retries, fault plans, checkpointing and resume, and the
    entries named by `entry` (sequential_zeus, serial_bfgs, HostedSolve,
    open_multistart, the solve service). `opts` is an EngineOptions (or any
    object with its fields); float32 passes through untouched."""
    if check_dtype(dtype) is not torch.float64:
        return
    why = []
    if entry is not None:
        why.append(entry)
    if solver != "bfgs":
        why.append(f"solver={solver!r}")
    if phase1 != "pso":
        why.append(f"phase1={phase1!r}")
    if opts is not None:
        if opts.sweep_mode != "batched":
            why.append(f"sweep_mode={opts.sweep_mode!r}")
        for field in ("ladder_len", "compact_every", "repack_every", "retry_budget",
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
            "runs PSO and dense BFGS on the batched sweep (sweep_mode='batched', "
            "static schedule, full ladder)")
