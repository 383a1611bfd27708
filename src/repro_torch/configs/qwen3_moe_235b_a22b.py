"""qwen3-moe-235b-a22b — 94L d_model=4096 64H (GQA kv=4) d_ff=1536(expert)
vocab=151936, MoE 128 experts top-8. [hf:Qwen/Qwen3-235B-A22B / assignment
row hf:Qwen/Qwen3-30B-A3B family; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,  # per-expert FFN width (the assignment's d_ff)
    vocab_size=151936,
    rope_theta=1_000_000.0,
    qk_norm=True,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    moe=MoEConfig(num_experts=128, experts_per_token=8, d_ff_expert=1536),
    moe_period=1,
    # reduce-scatter the down-proj output over its slot dim: -29% memory
    # term at train_4k, wire-neutral (EXPERIMENTS.md §Perf Q3). The bigger
    # capacity_factor=1.0 lever (-18.5% wire) stays opt-in: it trades
    # token-drop rate and is a training-quality decision.
    sharding_overrides=(("moe_cap_out", ("model",)),),
    source="[hf:Qwen/Qwen3-235B-A22B; hf]",
)
