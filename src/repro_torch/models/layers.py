"""Shared layers: norms, MLPs, embeddings, RoPE, softcaps.

Port of src/repro/models/layers.py. Weights stored in another dtype than
the activations are cast at each use, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamSpec


# -- norms -------------------------------------------------------------------
def norm_specs(cfg: ModelConfig, d: Optional[int] = None):
    d = d or cfg.d_model
    if cfg.norm_kind == "rmsnorm":
        return {"scale": ParamSpec((d,), ("embed",), "ones")}
    return {
        "scale": ParamSpec((d,), ("embed",), "ones"),
        "bias": ParamSpec((d,), ("embed",), "zeros"),
    }


def apply_norm(p, x, kind: str, eps: float = 1e-6):
    """RMSNorm or LayerNorm over the last axis, computed in float32 and
    returned in x's dtype."""
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"].float() + p["bias"].float()
    return out.to(x.dtype)


# -- MLP -----------------------------------------------------------------------
def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_kind in ("swiglu", "geglu"):
        return {
            "w_gate": ParamSpec((d, f), ("fsdp", "mlp")),
            "w_up": ParamSpec((d, f), ("fsdp", "mlp")),
            "w_down": ParamSpec((f, d), ("mlp", "fsdp")),
        }
    return {
        "w_in": ParamSpec((d, f), ("fsdp", "mlp")),
        "w_down": ParamSpec((f, d), ("mlp", "fsdp")),
    }


def apply_mlp(p, x, kind: str):
    """swiglu (silu gate), geglu (tanh-gelu gate) or a tanh-gelu MLP."""
    if kind in ("swiglu", "geglu"):
        gate = x @ p["w_gate"].to(x.dtype)
        act = F.silu(gate) if kind == "swiglu" else F.gelu(gate, approximate="tanh")
        h = act * (x @ p["w_up"].to(x.dtype))
        return h @ p["w_down"].to(x.dtype)
    h = F.gelu(x @ p["w_in"].to(x.dtype), approximate="tanh")
    return h @ p["w_down"].to(x.dtype)


# -- embeddings -------------------------------------------------------------------
def embed_specs(cfg: ModelConfig):
    s = {"tok": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), scale=1.0)}
    if not cfg.tie_embeddings:
        s["unembed"] = ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return s


def embed_tokens(p, tokens):
    return p["tok"][tokens]


def unembed(p, x, cfg: ModelConfig):
    w = p["tok"].T if cfg.tie_embeddings else p["unembed"]
    logits = x @ w.to(x.dtype)
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


# -- positions -------------------------------------------------------------------
def _rot_dim(hd: int, cfg: ModelConfig) -> int:
    rot = int(hd * cfg.rope_fraction)
    return rot - rot % 2


def rope_freqs(cfg: ModelConfig, device="cpu") -> torch.Tensor:
    """Inverse frequencies for the RoPE'd fraction of head_dim."""
    rot = _rot_dim(cfg.resolved_head_dim, cfg)
    return 1.0 / (cfg.rope_theta ** (
        torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    """x: (..., S, H, hd); positions: (..., S). Interleaved-pair convention;
    with rope_fraction < 1 (chatglm 2D RoPE) only the leading slice rotates."""
    hd = x.shape[-1]
    rot = _rot_dim(hd, cfg)
    inv = rope_freqs(cfg, x.device)  # (rot/2,)
    ang = positions[..., None].float() * inv  # (..., S, rot/2)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    xr = x[..., :rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(xr.shape)
    return torch.cat([rotated.to(x.dtype), x[..., rot:]], dim=-1)


def sinusoidal_positions(seq_len: int, d_model: int, device="cpu") -> torch.Tensor:
    """Whisper-style absolute sinusoidal position embeddings."""
    pos = np.arange(seq_len)[:, None]
    dim = np.arange(0, d_model, 2)[None, :]
    ang = pos / np.power(10000.0, dim / d_model)
    out = np.zeros((seq_len, d_model), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return torch.from_numpy(out).to(device)


def sinusoidal_position_at(pos: int, d_model: int, device="cpu") -> torch.Tensor:
    """(d_model,) absolute sinusoidal embedding at one position."""
    dim = torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
    ang = float(pos) / torch.pow(torch.tensor(10000.0, device=device), dim / d_model)
    out = torch.zeros((d_model,), dtype=torch.float32, device=device)
    out[0::2] = torch.sin(ang)
    out[1::2] = torch.cos(ang)
    return out


def softcap(x, cap: float):
    return cap * torch.tanh(x / cap) if cap > 0 else x
