"""chatglm3-6b — 28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
2D (half-dim) RoPE, GQA. [arXiv:2406.12793; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope_2d=True,
    rope_fraction=0.5,  # RoPE applied to half of head_dim (GLM 2D RoPE)
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    source="[arXiv:2406.12793; hf]",
)
