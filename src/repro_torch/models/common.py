"""Parameter-spec system: one declaration drives init and dry sizing.

Port of src/repro/models/common.py. Each module declares its parameters as
a nested dict of `ParamSpec(shape, logical_axes, init)`. From that single
source we derive:
  * `init_params`     — materialized tensors, drawn from a torch.Generator,
  * `abstract_params` — tensors on the meta device (shape and dtype, no
                        storage): the dry-run twin,
  * `count_params`    — the parameter count.
Stacked blocks wrap their specs with `stack_specs`. The reference's
`param_shardings` belongs to distributed serving (ROADMAP A14) and is not
ported; the logical axes are kept for it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis names, len == len(shape)
    init: str = "normal"  # normal | zeros | ones
    scale: Optional[float] = None  # None -> 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn: Callable, tree, is_leaf: Callable = is_spec):
    """`fn` on every leaf of a tree of dicts and NamedTuples (a KVCache);
    dict keys in sorted order, as jax.tree orders them."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], is_leaf) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, is_leaf) for v in tree))
    return fn(tree)


def tree_leaves(tree, is_leaf: Callable = is_spec) -> list:
    out = []
    tree_map(out.append, tree, is_leaf)
    return out


def stack_specs(n: int, tree):
    """Prepend a ('layers', n) dim to every spec (stacked layer weights)."""
    return tree_map(
        lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes, s.init, s.scale),
        tree)


def _init_one(spec: ParamSpec, generator: torch.Generator, dtype, device):
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else max(spec.shape[-1], 1)
    scale = spec.scale if spec.scale is not None else 1.0 / math.sqrt(fan_in)
    out = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                      device=device)
    return out.mul_(scale).to(dtype)


def init_params(specs, generator: torch.Generator, dtype=torch.float32, device="cpu"):
    """Tensors for `specs`: normal / 1/√fan_in (or the spec's scale), zeros
    and ones, drawn in float32 from `generator` leaf by leaf and cast to
    `dtype`. The generator must live on `device`. A torch.Generator gives
    other numbers than a JAX key: the parity tests carry the reference's
    weights over instead (interop.lm_params_from_numpy)."""
    device = torch.device(device)
    return tree_map(lambda s: _init_one(s, generator, dtype, device), specs)


def abstract_params(specs, dtype=torch.bfloat16):
    """Meta-device tensors of each parameter's shape: `dtype` for normal
    leaves, float32 for ones and zeros, as the reference's dry run."""
    return tree_map(
        lambda s: torch.empty(s.shape, dtype=dtype if s.init == "normal" else torch.float32,
                              device="meta"),
        specs)


def count_params(specs) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(specs))
