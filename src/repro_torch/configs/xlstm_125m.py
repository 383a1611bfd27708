"""xlstm-125m — 12L d_model=768 4H d_ff=0 vocab=50304. sLSTM + mLSTM blocks
(no FFN; the block itself carries the up/down projections).
[arXiv:2405.04517; unverified]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,  # xLSTM blocks have integrated projections instead of an FFN
    vocab_size=50304,
    mlp_kind="gelu",
    norm_kind="layernorm",
    ssm=SSMConfig(state_dim=64, head_dim=192, expand=2, conv_width=4),
    xlstm_slstm_every=6,  # layers 0, 6 are sLSTM; the rest mLSTM
    source="[arXiv:2405.04517; unverified]",
)
