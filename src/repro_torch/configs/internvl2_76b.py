"""internvl2-76b — 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
InternViT frontend (stub) + Llama3-70B-class text backbone.
[arXiv:2404.16821; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500_000.0,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    frontend="vision_stub",
    num_patches=256,  # precomputed patch embeddings prepended to text
    source="[arXiv:2404.16821; unverified]",
)
