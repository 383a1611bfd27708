"""Carry solver state between the JAX package and the port through numpy.

ZEUS holds no weights; what crosses between the two packages is solver
state. Each `*_from_numpy` takes a NamedTuple or dict of numpy arrays (what
`jax.device_get` returns for the reference's SwarmState, BatchLanes or
BFGSResult) and builds the port's tensors on a given device;
`result_to_numpy` goes the other way. Nothing here imports JAX: the parity
tests use this module to start the port from the exact reference state.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.engine import BatchLanes, BFGSResult
from repro_torch.core.pso import SwarmState


_MISSING = object()


def _field(obj: Any, name: str, default=_MISSING):
    if isinstance(obj, Mapping):
        value = obj.get(name, default)
    else:
        value = getattr(obj, name, default)
    if value is _MISSING:
        raise KeyError(f"state has no field {name!r}")
    return value


def _tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype == np.float64:
        raise TypeError("float64 state: the port supports float32 only")
    return torch.from_numpy(np.array(arr, order="C")).to(device)


def swarm_state_from_numpy(state, device="cpu") -> SwarmState:
    """The reference SwarmState (its PRNG key is dropped) as the port's."""
    return SwarmState(*(_tensor(_field(state, k), device)
                        for k in SwarmState._fields))


def batch_lanes_from_numpy(lanes, device="cpu") -> BatchLanes:
    """The reference BatchLanes, including the (B, D, D) H stack in
    `direction_state`, as the port's."""
    return BatchLanes(*(_tensor(_field(lanes, k), device)
                        for k in BatchLanes._fields))


def result_from_numpy(res, device="cpu") -> BFGSResult:
    """The reference BFGSResult as the port's: arrays become tensors,
    scalar counters Python ints; fields the port lacks are dropped."""
    out = {}
    for k in BFGSResult._fields:
        v = _field(res, k, None)
        if v is None:
            out[k] = None
        elif np.ndim(v) == 0:
            out[k] = int(v)
        else:
            out[k] = _tensor(v, device)
    return BFGSResult(**out)


def result_to_numpy(res: BFGSResult) -> BFGSResult:
    """The port's BFGSResult with every tensor moved to a numpy array."""
    return BFGSResult(*(v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                        else v for v in res))
