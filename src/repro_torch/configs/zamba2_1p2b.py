"""zamba2-1.2b — 38L d_model=2048 32H (kv=32) d_ff=8192, ssm_state=64.
Mamba2 backbone with a SHARED full-attention+MLP block applied periodically
(weights reused at each application). [arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    mlp_kind="gelu",
    norm_kind="rmsnorm",
    ssm=SSMConfig(state_dim=64, conv_width=4, expand=2, head_dim=64),
    hybrid_attn_period=6,  # shared attn block after every 6 mamba layers
    source="[arXiv:2411.15242; hf]",
)
