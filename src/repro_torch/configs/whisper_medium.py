"""whisper-medium — 24L(enc)+24L(dec) d_model=1024 16H (MHA kv=16) d_ff=4096
vocab=51865. Encoder-decoder; conv mel frontend is a STUB (input_specs feeds
precomputed frame embeddings). Absolute positions, LayerNorm, GELU.
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,  # decoder layers
    num_encoder_layers=24,
    arch_kind="encdec",
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    use_rope=False,  # sinusoidal/learned absolute positions
    mlp_kind="gelu",
    norm_kind="layernorm",
    frontend="audio_stub",
    source="[arXiv:2212.04356; unverified]",
)
