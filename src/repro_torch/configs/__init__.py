"""Architecture registry: `get_config(arch_id)` + reduced smoke variants.

Port of src/repro/configs/__init__.py; the ten `configs/<arch>.py` modules
beside it are copies of the reference's, field for field."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, ShapeConfig, SHAPES

_ARCH_MODULES = {
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "grok-1-314b": "grok_1_314b",
    "internvl2-76b": "internvl2_76b",
    "chatglm3-6b": "chatglm3_6b",
    "phi3-mini-3.8b": "phi3_mini_3p8b",
    "starcoder2-15b": "starcoder2_15b",
    "gemma2-2b": "gemma2_2b",
    "zamba2-1.2b": "zamba2_1p2b",
    "whisper-medium": "whisper_medium",
    "xlstm-125m": "xlstm_125m",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """CPU smoke-test variant of the same family: tiny widths, few layers,
    small vocab — but every structural feature (GQA ratio, MoE routing,
    local/global pattern, hybrid period, enc-dec) preserved."""
    kw: dict = dict(
        name=cfg.name + "-smoke",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, 4 // max(1, cfg.q_per_kv)),
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=512,
        sliding_window=32 if cfg.sliding_window else 0,
        num_patches=4 if cfg.num_patches else 0,
        dtype="float32",
    )
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(
            num_experts=4,
            experts_per_token=min(2, cfg.moe.experts_per_token),
            d_ff_expert=64,
            capacity_factor=2.0,
        )
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(
            state_dim=16, conv_width=4, expand=2, head_dim=32, chunk_size=16
        )
    if cfg.hybrid_attn_period:
        kw["hybrid_attn_period"] = 2
    if cfg.xlstm_slstm_every:
        kw["xlstm_slstm_every"] = 2
    if cfg.arch_kind == "encdec":
        kw["num_encoder_layers"] = 2
        kw["num_layers"] = 2
    return dataclasses.replace(cfg, **kw)


__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "ShapeConfig",
    "get_config",
    "reduce_config",
]
