"""Model assembly, the dense parts: attention blocks, their decode step and
the KV cache.

Port of src/repro/models/transformer.py. A block's causal self-attention
over a whole sequence runs the flash kernel (B8) where
`attention.uses_flash` holds (models/attention.py). The MoE and Mamba
blocks and the sliding-window ring-buffer decode are not ported yet: they
raise NotImplementedError naming their ROADMAP item.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models.common import tree_map


# ---------------------------------------------------------------------------
# Block specs
# ---------------------------------------------------------------------------
def attn_block_specs(cfg: ModelConfig, with_mlp=True, cross=False, d_ff=None):
    s = {
        "ln1": L.norm_specs(cfg),
        "attn": attn_mod.attn_specs(cfg),
    }
    if cross:
        s["ln_x"] = L.norm_specs(cfg)
        s["xattn"] = attn_mod.attn_specs(cfg)
    if with_mlp:
        s["ln2"] = L.norm_specs(cfg)
        s["mlp"] = L.mlp_specs(cfg, d_ff)
    if cfg.post_norm:
        s["post1"] = L.norm_specs(cfg)
        if with_mlp:
            s["post2"] = L.norm_specs(cfg)
    return s


def _unported(what: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP A16: the moe, hybrid and gemma2 "
        "local/global parts of the LM substrate)")


def moe_block_specs(cfg: ModelConfig):
    _unported("moe_block_specs (the MoE block)")


def mamba_block_specs(cfg: ModelConfig):
    _unported("mamba_block_specs (the Mamba2 block)")


# ---------------------------------------------------------------------------
# Block forward (full sequence) and decode (single token)
# ---------------------------------------------------------------------------
def _post(p, name, x, cfg):
    return L.apply_norm(p[name], x, cfg.norm_kind) if cfg.post_norm else x


def attn_block_forward(p, x, positions, cfg, *, causal=True, window=0,
                       enc_out=None, enc_positions=None, return_kv=False,
                       mesh=None):
    """x (B, S, d) -> x (B, S, d): pre-norm attention and MLP with
    residuals; positions (S,) increasing."""
    if mesh is not None:
        raise NotImplementedError("mesh: sharded blocks are not ported yet (ROADMAP A14)")
    h = L.apply_norm(p["ln1"], x, cfg.norm_kind)
    q, k, v = attn_mod.project_qkv(p["attn"], h, positions, cfg)
    o = attn_mod.self_attention(q, k, v, positions, cfg, causal, window)
    o = attn_mod._out_proj(o, p["attn"]["wo"])
    x = x + _post(p, "post1", o, cfg)

    if enc_out is not None:
        h = L.apply_norm(p["ln_x"], x, cfg.norm_kind)
        xo = attn_mod.attention(
            p["xattn"], h, positions, cfg, causal=False,
            kv_states=attn_mod.cross_kv(p["xattn"], enc_out, cfg),
            kv_positions=enc_positions,
        )
        x = x + xo

    if "mlp" in p:
        h = L.apply_norm(p["ln2"], x, cfg.norm_kind)
        o = L.apply_mlp(p["mlp"], h, cfg.mlp_kind)
        x = x + _post(p, "post2", o, cfg)
    if return_kv:
        return x, (k, v)
    return x


def moe_block_forward(p, x, positions, cfg, *, window=0, return_kv=False, mesh=None):
    _unported("moe_block_forward (the MoE block)")


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_cache, KV, hd) — S_cache = max_seq or window
    v: torch.Tensor


def attn_block_decode(p, x, cache: KVCache, pos: int, cfg, *, window=0,
                      cross_cache: Optional[KVCache] = None):
    """x (B, 1, d) at position `pos`; writes the layer's K/V row into
    `cache` in place."""
    h = L.apply_norm(p["ln1"], x, cfg.norm_kind)
    S_cache = cache.k.shape[1]
    if window > 0 and S_cache == window:
        o, ck, cv = _ring_decode(p["attn"], h, cache, pos, pos % window, cfg, window)
    else:
        o, ck, cv = attn_mod.decode_attention(
            p["attn"], h, cache.k, cache.v, pos, cfg, window=window)
    x = x + _post(p, "post1", o, cfg)
    new_cache = KVCache(k=ck, v=cv)

    if cross_cache is not None:
        h = L.apply_norm(p["ln_x"], x, cfg.norm_kind)
        xo, _, _ = attn_mod.decode_attention(
            p["xattn"], h, cross_cache.k, cross_cache.v, pos, cfg, cross=True)
        x = x + xo

    if "mlp" in p:
        h = L.apply_norm(p["ln2"], x, cfg.norm_kind)
        o = L.apply_mlp(p["mlp"], h, cfg.mlp_kind)
        x = x + _post(p, "post2", o, cfg)
    return x, new_cache


def _ring_decode(pa, h, cache: KVCache, pos, write_pos, cfg, window):
    _unported("_ring_decode (sliding-window decode against a ring buffer)")


def moe_block_decode(p, x, cache: KVCache, pos, cfg, mesh=None):
    _unported("moe_block_decode (the MoE block)")


def mamba_block_forward(p, x, cfg, cache=None, decode=False, mesh=None):
    _unported("mamba_block_forward (the Mamba2 block)")


# ---------------------------------------------------------------------------
# Cache spec helpers
# ---------------------------------------------------------------------------
class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor not yet allocated (the reference's
    jax.ShapeDtypeStruct)."""
    shape: tuple
    dtype: torch.dtype


def kv_cache_specs(cfg: ModelConfig, n_layers: int, batch: int, seq: int,
                   dtype, window: int = 0) -> KVCache:
    s = min(window, seq) if window > 0 else seq
    shape = (n_layers, batch, s, cfg.num_kv_heads, cfg.resolved_head_dim)
    return KVCache(k=TensorSpec(shape, dtype), v=TensorSpec(shape, dtype))


def materialize_cache(spec_tree, device="cpu"):
    """Zeros for every TensorSpec of the tree, on `device`."""
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
                    spec_tree, is_leaf=lambda x: isinstance(x, TensorSpec))
