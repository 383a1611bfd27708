"""phi3-mini-3.8b — 32L d_model=3072 32H (GQA kv=32, i.e. MHA) d_ff=8192
vocab=32064. RoPE, SwiGLU. [arXiv:2404.14219; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=10_000.0,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    source="[arXiv:2404.14219; unverified]",
)
