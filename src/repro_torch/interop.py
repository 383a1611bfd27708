"""Carry solver state and LM weights between the JAX package and the port
through numpy.

ZEUS holds no weights; what crosses between the two packages is solver
state. Each `*_from_numpy` takes a NamedTuple or dict of numpy arrays (what
`jax.device_get` returns for the reference's SwarmState, BatchLanes, Lane
stack, LBFGSMemory, MeanFieldState or BFGSResult) and builds the port's
tensors on a given device; `result_to_numpy` and `state_to_numpy` go the
other way. `lm_params_from_numpy` carries the LM substrate's parameter tree
(the reference's `Model.init`, stacked `layers` axis included). Nothing
here imports JAX: the parity tests use this module to start the port from
the exact reference state and weights.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.engine import BatchLanes, BFGSResult, Lane
from repro_torch.core.lbfgs import LBFGSMemory
from repro_torch.core.meanfield import MeanFieldState
from repro_torch.core.pso import SwarmState
from repro_torch.models.registry import Model


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
    """An array as a tensor of its own dtype (float64 state, the
    reference's under x64, stays float64) on `device`."""
    return torch.from_numpy(np.array(np.asarray(a), order="C")).to(device)


def swarm_state_from_numpy(state, device="cpu") -> SwarmState:
    """The reference SwarmState (its PRNG key is dropped) as the port's."""
    return SwarmState(*(_tensor(_field(state, k), device)
                        for k in SwarmState._fields))


def _direction_state(ds, device):
    """A stacked direction state: a dense (B, D, D) H stack or an
    LBFGSMemory."""
    if isinstance(ds, np.ndarray):
        return _tensor(ds, device)
    return lbfgs_memory_from_numpy(ds, device)


def _lanes(cls, lanes, device):
    out = {k: _tensor(_field(lanes, k), device)
           for k in cls._fields if k != "direction_state"}
    return cls(**out, direction_state=_direction_state(
        _field(lanes, "direction_state"), device))


def batch_lanes_from_numpy(lanes, device="cpu") -> BatchLanes:
    """The reference BatchLanes, with its direction state (the (B, D, D) H
    stack or a stacked LBFGSMemory), as the port's."""
    return _lanes(BatchLanes, lanes, device)


def lane_from_numpy(lane, device="cpu") -> Lane:
    """The reference's per-lane Lane stack (what jax.vmap of lane_init or
    lane_step returns) as the port's."""
    return _lanes(Lane, lane, device)


def lbfgs_memory_from_numpy(mem, device="cpu") -> LBFGSMemory:
    """A stacked reference LBFGSMemory (every field with a leading lane
    axis, as jax.vmap builds it) as the port's."""
    return LBFGSMemory(*(_tensor(_field(mem, k), device)
                         for k in LBFGSMemory._fields))


def meanfield_state_from_numpy(state, device="cpu") -> MeanFieldState:
    """The reference MeanFieldState as the port's (its PRNG key is dropped)."""
    return MeanFieldState(*(_tensor(_field(state, k), device)
                            for k in MeanFieldState._fields))


def state_to_numpy(state):
    """Any of the port's states (a tensor, or a NamedTuple of tensors and
    nested NamedTuples) with every tensor moved to a numpy array."""
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().numpy()
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(state_to_numpy(v) for v in state))
    return state


def result_from_numpy(res, device="cpu") -> BFGSResult:
    """The reference BFGSResult as the port's: arrays become tensors,
    scalar counters Python ints; fields the port lacks are dropped."""
    out = {}
    for k in BFGSResult._fields:
        v = _field(res, k, None)
        if v is None or k == "telemetry":  # host numpy either way
            out[k] = v
        elif np.ndim(v) == 0:
            out[k] = int(v)
        else:
            out[k] = _tensor(v, device)
    return BFGSResult(**out)


def result_to_numpy(res: BFGSResult) -> BFGSResult:
    """The port's BFGSResult with every tensor moved to a numpy array."""
    return state_to_numpy(res)


def _weight(a, device, dtype):
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        t = torch.from_numpy(np.array(arr.view(np.int16), order="C")).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, order="C"))
    return t.to(device=device, dtype=dtype)


def lm_params_from_numpy(tree, cfg, device, dtype=None):
    """The reference's LM parameter tree (`Model.init` after
    `jax.device_get`: nested dicts of numpy arrays, block weights stacked on
    a leading `layers` axis) as the port's, on `device`, each leaf cast to
    `dtype` if given. Raises unless the tree has exactly the leaves and
    shapes of the port's Model(cfg)."""
    specs = Model(cfg).specs

    def walk(spec_node, node, path):
        if not isinstance(spec_node, Mapping):
            if tuple(np.shape(node)) != tuple(spec_node.shape):
                raise ValueError(f"{'/'.join(path)}: shape {np.shape(node)}, expected "
                                 f"{spec_node.shape}")
            return _weight(node, device, dtype)
        if not isinstance(node, Mapping) or set(node) != set(spec_node):
            got = sorted(node) if isinstance(node, Mapping) else type(node).__name__
            raise KeyError(f"{'/'.join(path) or 'params'}: keys {got}, expected "
                           f"{sorted(spec_node)}")
        return {k: walk(spec_node[k], node[k], path + (k,)) for k in sorted(spec_node)}

    return walk(specs, tree, ())
