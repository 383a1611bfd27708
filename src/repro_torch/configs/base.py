"""Model + shape configuration system.

One `ModelConfig` per assigned architecture lives in configs/<arch>.py with
the exact public numbers; `reduced()` derives the CPU smoke-test variant of
the same family. `ShapeConfig` encodes the assigned input-shape set.

Port of src/repro/configs/base.py, copied as data: the same fields,
defaults and parameter counts, so that the two packages size a model alike.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # shared expert (qwen-style optional dense expert alongside routed ones)
    d_ff_shared: int = 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64
    conv_width: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # None -> d_model // num_heads

    # attention flavour
    use_rope: bool = True  # False -> absolute sinusoidal positions (whisper)
    rope_theta: float = 10000.0
    rope_2d: bool = False  # chatglm-style 2D/partial RoPE
    rope_fraction: float = 1.0  # fraction of head_dim carrying RoPE
    attn_softcap: float = 0.0  # gemma2 attention-logit softcap
    logit_softcap: float = 0.0  # gemma2 final-logit softcap
    sliding_window: int = 0  # window size for local layers
    local_global_period: int = 0  # gemma2: alternate local/global every k
    attn_scale_override: Optional[float] = None
    qk_norm: bool = False  # qwen3-style per-head RMSNorm on q and k

    # block flavour
    mlp_kind: str = "swiglu"  # swiglu | geglu | gelu
    norm_kind: str = "rmsnorm"  # rmsnorm | layernorm
    post_norm: bool = False  # gemma2 post-attn/post-mlp extra norms
    tie_embeddings: bool = False
    parallel_block: bool = False  # attn+mlp in parallel (not used by pool)

    # mixtures / hybrids
    moe: Optional[MoEConfig] = None
    moe_period: int = 1  # every k-th layer is MoE (1 = all)
    ssm: Optional[SSMConfig] = None
    hybrid_attn_period: int = 0  # zamba2: shared attn block every k layers
    xlstm_slstm_every: int = 0  # xlstm: sLSTM block every k layers (rest mLSTM)

    # encoder-decoder (whisper)
    arch_kind: str = "decoder"  # decoder | encdec
    num_encoder_layers: int = 0

    # modality frontend stub (audio frames / vision patches)
    frontend: str = "none"  # none | audio_stub | vision_stub
    num_patches: int = 0  # vlm: patch embeddings prepended to text

    dtype: str = "bfloat16"
    source: str = ""  # provenance note [source; verified-tier]
    # per-arch logical-axis rule overrides, as ((axis, (mesh axes...)), ...)
    # — e.g. grok-1's experts (E=8) cannot shard a 16-wide axis, so its
    # production layout is resident 2D expert weights instead of EP
    sharding_overrides: tuple = ()

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def n_params(self) -> int:
        """Approximate parameter count (embedding + blocks), for rooflines."""
        hd = self.resolved_head_dim
        d = self.d_model
        attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d
        if self.mlp_kind in ("swiglu", "geglu"):
            mlp = 3 * d * self.d_ff
        else:
            mlp = 2 * d * self.d_ff
        per_layer = attn + mlp
        total = 0
        if self.ssm is not None:
            c = self.ssm
            d_in = c.expand * d
            n_ssm_heads = d_in // c.head_dim
            ssm = (
                d * (2 * d_in + 2 * c.n_groups * c.state_dim + n_ssm_heads)
                + c.conv_width * (d_in + 2 * c.n_groups * c.state_dim)
                + d_in * d
            )
            if self.family == "hybrid":
                n_attn = self.num_layers // max(self.hybrid_attn_period, 1)
                total += self.num_layers * (ssm + mlp) + min(1, n_attn) * attn
            else:
                total += self.num_layers * ssm
        elif self.family == "moe" and self.moe is not None:
            m = self.moe
            expert_mlp = m.num_experts * 3 * d * m.d_ff_expert
            router = d * m.num_experts
            n_moe = self.num_layers // self.moe_period
            n_dense = self.num_layers - n_moe
            total += n_moe * (attn + expert_mlp + router) + n_dense * per_layer
        elif self.arch_kind == "encdec":
            # encoder layers + decoder layers with cross-attention
            total += self.num_encoder_layers * per_layer
            total += self.num_layers * (per_layer + attn)
        elif self.d_ff == 0:  # xlstm: no FFN, qkv-ish block params
            total += self.num_layers * (4 * d * d)
        else:
            total += self.num_layers * per_layer
        total += d * self.vocab_size * (1 if self.tie_embeddings else 2)
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if self.family != "moe" or self.moe is None:
            return self.n_params()
        m = self.moe
        d = self.d_model
        hd = self.resolved_head_dim
        attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d
        active_mlp = m.experts_per_token * 3 * d * m.d_ff_expert
        router = d * m.num_experts
        n_moe = self.num_layers // self.moe_period
        total = n_moe * (attn + active_mlp + router)
        total += d * self.vocab_size * (1 if self.tie_embeddings else 2)
        return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}
