"""grok-1-314b — 64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
MoE 8 experts top-2. [hf:xai-org/grok-1; unverified]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    rope_theta=10_000.0,
    attn_softcap=30.0,   # grok-1 tanh attn-logit cap
    logit_softcap=30.0,  # grok-1 output softcap
    mlp_kind="geglu",
    norm_kind="rmsnorm",
    moe=MoEConfig(num_experts=8, experts_per_token=2, d_ff_expert=32768),
    moe_period=1,
    # E=8 cannot shard the 16-wide data axis; EP degenerates to replicated
    # dispatch tensors (measured 25 TB/step wire). Production layout:
    # resident 2D expert weights d(data)×f(model), dispatched tokens
    # d-sharded to match — see EXPERIMENTS.md §Perf grok iteration 2.
    sharding_overrides=(("expert", ()), ("moe_embed", ("data",)),
                    ("moe_embed_out", ("data",))),
    source="[hf:xai-org/grok-1; unverified]",
)
