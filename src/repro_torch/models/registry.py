"""Model registry: ModelConfig -> Model (specs, init, forward, decode).

Port of src/repro/models/registry.py, dense family only: decoder stacks of
attention blocks without gemma2's local/global pairs (phi3-mini,
starcoder2, chatglm3). The other families raise NotImplementedError at
construction, naming their ROADMAP item.

Layout: the layers are stacked tensors, as the reference's pytree holds
them (every block weight carries a leading `layers` axis), not a
ModuleList, so that the reference's `Model.init` tree carries over one to
one (interop.lm_params_from_numpy) and a decode step indexes the stacked
KV cache the same way. The forward loops over the layers in Python (eager
PyTorch has nothing to gain from the reference's lax.scan).

`Model` is an nn.Module: `init` draws the parameters and attaches them as
buffers, and `forward`/`decode_step` take a parameter tree or, given
None, the attached one.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.common import (
    abstract_params,
    count_params,
    init_params,
    stack_specs,
    tree_map,
)

# family -> the ROADMAP item that ports it
_UNPORTED_FAMILIES = {
    "moe": "A16 (moe: qwen3-moe, grok-1)",
    "hybrid": "A16 (hybrid: zamba2)",
    "ssm": "A16 (ssm: xlstm)",
    "audio": "A16 (audio: whisper, with encode)",
    "vlm": "A16 (vlm: internvl2)",
}
_SEP = "__"  # joins a parameter's path into its buffer name


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for a config the
    port does not run yet."""
    if cfg.family in _UNPORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP "
            f"{_UNPORTED_FAMILIES[cfg.family]})")
    if cfg.family != "dense":
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    if cfg.local_global_period:
        raise NotImplementedError(
            f"{cfg.name}: local/global layer pairs and their ring-buffer decode "
            "are not ported yet (ROADMAP A16 (gemma2 local/global, _ring_decode))")


def _compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, mesh=None):
        super().__init__()
        if mesh is not None:
            raise NotImplementedError("mesh: sharded models are not ported yet "
                                      "(ROADMAP A14)")
        check_supported(cfg)
        self.cfg = cfg
        self.specs = self._build_specs()
        self._paths = self._leaf_paths(self.specs)

    # -- parameters ---------------------------------------------------------
    def _build_specs(self):
        cfg = self.cfg
        return {
            "embed": L.embed_specs(cfg),
            "blocks": stack_specs(cfg.num_layers, T.attn_block_specs(cfg)),
            "final_norm": L.norm_specs(cfg),
        }

    @staticmethod
    def _leaf_paths(tree, prefix=()):
        if isinstance(tree, dict):
            return [p for k in sorted(tree) for p in Model._leaf_paths(tree[k], prefix + (k,))]
        return [prefix]

    def init(self, generator: torch.Generator, dtype=torch.float32, device="cuda"):
        """Draw the parameters (normal / 1/√fan_in, zeros, ones, as the
        reference's `init`) on `device` from `generator`, cast to `dtype`,
        attach them, and return the tree. Raises without a card unless
        device="cpu"."""
        params = init_params(self.specs, generator, dtype, resolve_device(device))
        self.attach(params)
        return params

    def attach(self, params) -> None:
        """Register a parameter tree's tensors as this module's buffers."""
        for path in self._paths:
            t = params
            for k in path:
                t = t[k]
            self.register_buffer(_SEP.join(path), t)

    @property
    def params(self):
        """The attached parameter tree (rebuilt from the buffers, so that it
        follows `.to()`)."""
        if not self._paths or _SEP.join(self._paths[0]) not in self._buffers:
            raise RuntimeError("no parameters attached: call init() or attach()")
        tree: Dict[str, Any] = {}
        for path in self._paths:
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = self._buffers[_SEP.join(path)]
        return tree

    def abstract_params(self, dtype=torch.bfloat16):
        return abstract_params(self.specs, dtype)

    def n_params(self) -> int:
        return count_params(self.specs)

    def _layers(self, blocks):
        """The stacked block tree as one tree of views per layer."""
        return [tree_map(lambda a, i=i: a[i], blocks, is_leaf=_is_tensor)
                for i in range(self.cfg.num_layers)]

    # -- embedding / head -----------------------------------------------------
    def _embed_in(self, params, batch, dtype):
        cfg = self.cfg
        x = L.embed_tokens(params["embed"], batch["tokens"]).to(dtype)
        if cfg.tie_embeddings:  # gemma-style sqrt(d) embedding scale
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dtype)
        if not cfg.use_rope:
            S = x.shape[1]
            x = x + L.sinusoidal_positions(S, cfg.d_model, x.device).to(dtype)[None]
        return x

    # -- forward (train / prefill) ------------------------------------------
    def forward(self, params=None, batch=None, mesh=None, last_only: bool = False):
        """Returns (logits, aux_loss). last_only=True: unembed only the
        final position (serving prefill) — logits (B, 1, V). params=None
        takes the attached tree."""
        if mesh is not None:
            raise NotImplementedError("mesh: sharded models are not ported yet "
                                      "(ROADMAP A14)")
        cfg = self.cfg
        params = self.params if params is None else params
        x = self._embed_in(params, batch, _compute_dtype(cfg))
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        for p in self._layers(params["blocks"]):
            x = T.attn_block_forward(p, x, positions, cfg, window=cfg.sliding_window)
        if last_only:
            x = x[:, -1:]
        x = L.apply_norm(params["final_norm"], x, cfg.norm_kind)
        logits = L.unembed(params["embed"], x, cfg)
        return logits, torch.zeros((), dtype=torch.float32, device=x.device)

    # -- caches ----------------------------------------------------------------
    def cache_specs(self, batch: int, max_seq: int, dtype=torch.bfloat16):
        cfg = self.cfg
        return T.kv_cache_specs(cfg, cfg.num_layers, batch, max_seq, dtype)

    # -- decode ----------------------------------------------------------------
    def decode_step(self, params, cache, tokens, pos, mesh=None):
        """tokens (B, 1) at position `pos` (an int). Returns (logits (B, 1,
        V), cache); the stacked cache is updated in place. params=None
        takes the attached tree."""
        if mesh is not None:
            raise NotImplementedError("mesh: sharded models are not ported yet "
                                      "(ROADMAP A14)")
        cfg = self.cfg
        params = self.params if params is None else params
        pos = int(pos)
        dtype = _compute_dtype(cfg)
        x = L.embed_tokens(params["embed"], tokens).to(dtype)
        if cfg.tie_embeddings:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dtype)
        if not cfg.use_rope:
            x = x + L.sinusoidal_position_at(pos, cfg.d_model, x.device).to(dtype)[None, None]
        for i, p in enumerate(self._layers(params["blocks"])):
            x, _ = T.attn_block_decode(p, x, T.KVCache(cache.k[i], cache.v[i]), pos, cfg)
        x = L.apply_norm(params["final_norm"], x, cfg.norm_kind)
        return L.unembed(params["embed"], x, cfg), cache


def build_model(cfg: ModelConfig, mesh=None) -> Model:
    """A new Model for cfg (the reference caches one per config for its jit
    closures; eager PyTorch has none, and a shared module would share its
    attached parameters)."""
    return Model(cfg, mesh)
