"""gemma2-2b — 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.
Alternating local(sliding-window 4096)/global attention, attn+final logit
softcaps, GeGLU, post-norms, tied embeddings. [arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    rope_theta=10_000.0,
    attn_softcap=50.0,
    logit_softcap=30.0,
    sliding_window=4096,
    local_global_period=2,  # local, global, local, global, ...
    mlp_kind="geglu",
    norm_kind="rmsnorm",
    post_norm=True,
    tie_embeddings=True,
    attn_scale_override=1.0 / 16.0,  # query_pre_attn_scalar=256 -> 1/sqrt(256)
    source="[arXiv:2408.00118; hf]",
)
