"""Checkpointing: atomic step snapshots, keep-N GC, resume.

Port of src/repro/checkpoint/manager.py, with its on-disk layout byte for
byte (one directory per step):
    <root>/step_000000420/
        shard_00000.bin     — the leaves' raw bytes concatenated in flat
                              order (offsets derive from the shapes and
                              dtypes in meta.json)
        meta.json           — step, treedef (a string describing the
                              structure), n_leaves, shapes, dtypes
        COMMIT              — two-phase-commit marker (written LAST)

A snapshot written by either package restores through the other's
manager, leaf for leaf, where both flatten the structure alike (dicts by
sorted key, sequences and NamedTuples in order; None holds no leaf).

The structures are nests of tuples, lists, dicts, NamedTuples,
dataclasses and None, whose leaves are torch tensors, numpy arrays and
Python scalars. The flatten is this module's own.

Fault-tolerance contract:
  * a checkpoint without COMMIT is ignored at restore (a crashed write can
    never be resumed into);
  * writes go to step_...tmp, then os.replace: atomic on POSIX;
  * `restore` checks the snapshot against the structure it restores into
    (leaf count, each leaf's shape and dtype, the shard's byte length) and
    raises ValueError on any mismatch rather than mis-assign leaves.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

_COMMIT = "COMMIT"
_SCALARS = (bool, int, float, np.generic)


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:09d}")


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray) + _SCALARS)


def _children(x) -> Tuple[list, Any]:
    """(children, rebuild) of a container: rebuild(children) makes a
    container of x's kind from new children."""
    if isinstance(x, dict):
        keys = sorted(x)
        return [x[k] for k in keys], lambda ch: dict(zip(keys, ch))
    if isinstance(x, tuple) and hasattr(x, "_fields"):  # NamedTuple
        return list(x), lambda ch: type(x)(*ch)
    if isinstance(x, (tuple, list)):
        return list(x), lambda ch: type(x)(ch)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        names = [f.name for f in dataclasses.fields(x)]
        return ([getattr(x, n) for n in names],
                lambda ch: type(x)(**dict(zip(names, ch))))
    raise TypeError(f"cannot snapshot a leaf of type {type(x).__name__}")


def tree_flatten(tree) -> Tuple[List[Any], str]:
    """(leaves in flat order, a string describing the structure)."""
    leaves: List[Any] = []

    def walk(x) -> str:
        if x is None:
            return "None"
        if _is_leaf(x):
            leaves.append(x)
            return "*"
        children, _ = _children(x)
        parts = [walk(c) for c in children]
        if isinstance(x, dict):
            inner = ", ".join(f"{k!r}: {p}" for k, p in zip(sorted(x), parts))
            return "{" + inner + "}"
        if isinstance(x, list):
            return "[" + ", ".join(parts) + "]"
        if isinstance(x, tuple) and not hasattr(x, "_fields"):
            return "(" + ", ".join(parts) + ("," if len(parts) == 1 else "") + ")"
        names = (x._fields if isinstance(x, tuple)
                 else [f.name for f in dataclasses.fields(x)])
        inner = ", ".join(f"{n}={p}" for n, p in zip(names, parts))
        return f"{type(x).__name__}({inner})"

    return leaves, walk(tree)


def _tree_unflatten(like, leaves: list):
    """`like`'s structure with its leaves replaced, in flat order."""
    it = iter(leaves)

    def build(x):
        if x is None:
            return None
        if _is_leaf(x):
            return next(it)
        children, rebuild = _children(x)
        return rebuild([build(c) for c in children])

    return build(like)


def tree_map(fn, tree):
    """`tree` with every leaf replaced by fn(leaf)."""
    leaves, _ = tree_flatten(tree)
    return _tree_unflatten(tree, [fn(x) for x in leaves])


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    # NB: not ascontiguousarray — it promotes 0-d leaves to 1-d
    return np.asarray(x)


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(np.asarray(x).dtype)


def save(root: str, step: int, tree: Any, keep: int = 3, process_index: int = 0):
    """Atomic checkpoint of a nested structure of tensors, arrays and
    scalars (tensors are copied to the host here; the engine passes numpy
    copies it made itself)."""
    leaves, treedef = tree_flatten(tree)
    final = _step_dir(root, step)
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)

    arrays = [_host(x) for x in leaves]
    with open(os.path.join(tmp, f"shard_{process_index:05d}.bin"), "wb") as f:
        for a in arrays:
            f.write(a.data if a.flags.c_contiguous else a.tobytes())
    meta = {
        "step": step,
        "treedef": treedef,
        "n_leaves": len(leaves),
        "shapes": [list(a.shape) for a in arrays],
        "dtypes": [str(a.dtype) for a in arrays],
    }
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(tmp, _COMMIT), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(root, keep)
    return final


def _gc(root: str, keep: int):
    steps = sorted(committed_steps(root))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(_step_dir(root, s), ignore_errors=True)


def committed_steps(root: str):
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(root, name, _COMMIT)):
                out.append(int(name.split("_")[1]))
    return sorted(out)


def latest_step(root: str) -> Optional[int]:
    steps = committed_steps(root)
    return steps[-1] if steps else None


def _committed_dir(root: str, step: Optional[int]) -> str:
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints under {root}")
    d = _step_dir(root, step)
    if not os.path.exists(os.path.join(d, _COMMIT)):
        raise FileNotFoundError(f"checkpoint {d} has no COMMIT marker")
    return d


def snapshot_meta(root: str, step: Optional[int] = None) -> dict:
    """Meta of a committed snapshot (n_leaves, shapes, dtypes, treedef)
    without loading the arrays."""
    with open(os.path.join(_committed_dir(root, step), "meta.json")) as fh:
        return json.load(fh)


def restore(root: str, like: Any, step: Optional[int] = None, device="cpu",
            process_index: int = 0) -> Any:
    """Restore the newest committed snapshot (or `step`) into the structure
    of `like`: a tensor leaf comes back as a tensor on `device` (a tensor on
    the meta device serves as a leaf's shape and dtype alone), a numpy leaf
    as a numpy array, a Python scalar as a scalar of its type. Raises
    ValueError when the snapshot's leaf count, a leaf's shape or dtype, or
    the shard's byte length does not match."""
    d = _committed_dir(root, step)
    with open(os.path.join(d, "meta.json")) as fh:
        meta = json.load(fh)
    leaves, _ = tree_flatten(like)
    if meta.get("n_leaves") != len(leaves):
        raise ValueError(
            f"checkpoint {d} holds {meta.get('n_leaves')} leaves but the "
            f"restore target has {len(leaves)} — the snapshot belongs to a "
            "different carry structure (solver/schedule/options mismatch)")
    for i, (x, shp, dt) in enumerate(zip(leaves, meta["shapes"], meta["dtypes"])):
        want_shape = list(x.shape) if isinstance(x, (torch.Tensor, np.ndarray)) else []
        if list(shp) != want_shape or dt != _dtype_name(x):
            raise ValueError(
                f"checkpoint {d} leaf {i} is {dt}{shp} but the restore target "
                f"expects {_dtype_name(x)}{want_shape} — a different carry "
                "structure (solver/schedule/options mismatch)")
    path = os.path.join(d, f"shard_{process_index:05d}.bin")
    blob = bytearray(os.path.getsize(path))  # writable: tensors share it
    with open(path, "rb") as fh:
        fh.readinto(blob)
    loaded = []
    off = 0
    for x, shp, dt in zip(leaves, meta["shapes"], meta["dtypes"]):
        dtype = np.dtype(dt)
        n = int(np.prod(shp, dtype=np.int64)) if shp else 1
        if off + n * dtype.itemsize > len(blob):
            raise ValueError(
                f"checkpoint {d} shard holds {len(blob)} bytes, fewer than "
                "meta describes — torn or foreign shard file")
        a = np.frombuffer(blob, dtype=dtype, count=n, offset=off).reshape(shp)
        if off % dtype.itemsize:
            a = a.copy()  # an aligned copy of a leaf that follows narrower ones
        off += n * dtype.itemsize
        if isinstance(x, torch.Tensor):
            loaded.append(torch.from_numpy(a).to(device))
        elif isinstance(x, np.ndarray):
            loaded.append(a.copy())
        else:
            loaded.append(type(x)(a.item()) if not isinstance(x, np.generic)
                          else a[()].copy())
    if off != len(blob):
        raise ValueError(
            f"checkpoint {d} shard holds {len(blob)} bytes but meta "
            f"describes {off} — torn or foreign shard file")
    return _tree_unflatten(like, loaded)
