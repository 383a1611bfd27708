"""GQA attention: full/sliding-window/cross, chunked online-softmax, decode.

Port of src/repro/models/attention.py. Causal self-attention without a
window or a softcap is the function of the flash kernel (B8): `attention`
and the block forward send it to `kernels.ops.flash_attention`, which runs
the hand-written kernel on the card and its plain version on the CPU. Every
other case (a softcap, a window, cross or non-causal attention) takes the
reference's materialized-scores path up to _DIRECT_MAX_SEQ keys and its
KV-chunked online softmax beyond.

Where the reference multiplies bf16 operands with float32 accumulation
(`preferred_element_type=jnp.float32`), the port multiplies the operands
upcast to float32: a product of two bf16 values is exact in float32, so
the two differ only in the order of the sums.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import ParamSpec
from repro_torch.models.layers import apply_rope, softcap

NEG_INF = -1e30
_CHUNK = 1024  # KV chunk for the online-softmax path
_DIRECT_MAX_SEQ = 2048  # below this, use the direct path


def attn_specs(cfg: ModelConfig):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    s = {
        "wq": ParamSpec((d, h, hd), ("fsdp", "heads", "head_dim")),
        "wk": ParamSpec((d, kv, hd), ("fsdp", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, kv, hd), ("fsdp", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "fsdp")),
    }
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((hd,), ("head_dim",), "ones")
        s["k_norm"] = ParamSpec((hd,), ("head_dim",), "ones")
    return s


def _rms_head(x, scale, eps=1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _scale(cfg: ModelConfig) -> float:
    if cfg.attn_scale_override is not None:
        return cfg.attn_scale_override
    return cfg.resolved_head_dim ** -0.5


def _proj(x, w):
    """x (B, S, d) · w (d, N, hd) -> (B, S, N, hd), as one matmul."""
    d, n, hd = w.shape
    return (x @ w.to(x.dtype).reshape(d, n * hd)).reshape(*x.shape[:-1], n, hd)


def _out_proj(o, w):
    """o (B, S, H, hd) · wo (H, hd, d) -> (B, S, d), as one matmul."""
    h, hd, d = w.shape
    return o.reshape(*o.shape[:-2], h * hd) @ w.to(o.dtype).reshape(h * hd, d)


def project_qkv(p, x, positions, cfg: ModelConfig, rope: bool = True):
    """x (B, S, d) -> q (B, S, H, hd), k/v (B, S, KV, hd), RoPE applied."""
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.qk_norm:
        q = _rms_head(q, p["q_norm"])
        k = _rms_head(k, p["k_norm"])
    if rope and cfg.use_rope:
        q = apply_rope(q, positions, cfg)
        k = apply_rope(k, positions, cfg)
    return q, k, v


def _mask_bias(q_pos, k_pos, causal: bool, window: int):
    """(Sq, Sk) additive bias from position predicates."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        ok &= q_pos[:, None] - k_pos[None, :] < window
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, NEG_INF)


def _grouped_q(q, cfg, KV):
    B, Sq, H, hd = q.shape
    return (q * torch.tensor(_scale(cfg), dtype=q.dtype)).reshape(B, Sq, KV, H // KV, hd)


def _direct_attention(q, k, v, q_pos, k_pos, cfg, causal, window):
    """Materialized-scores path for short sequences (and the oracle in tests)."""
    B, Sq, H, hd = q.shape
    qg = _grouped_q(q, cfg, k.shape[2])
    scores = torch.einsum("bqhgk,bshk->bhgqs", qg.float(), k.float())
    scores = softcap(scores, cfg.attn_softcap)
    scores = scores + _mask_bias(q_pos, k_pos, causal, window)[None, None, None]
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqs,bshk->bqhgk", w.to(v.dtype).float(), v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _chunked_attention(q, k, v, q_pos, k_pos, cfg, causal, window):
    """Online-softmax over KV chunks; no (Sq, Sk) materialization."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    g = H // KV
    chunk = min(_CHUNK, Sk)
    qg = _grouped_q(q, cfg, KV).float()
    m = torch.full((B, KV, g, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, g, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, g, Sq, hd), dtype=torch.float32, device=q.device)
    # whole chunks first, then the remainder, as the reference's scan
    starts = list(range(0, Sk - Sk % chunk, chunk))
    spans = [(s0, s0 + chunk) for s0 in starts]
    if Sk % chunk:
        spans.append((Sk - Sk % chunk, Sk))
    for s0, s1 in spans:
        kc, vc, kp = k[:, s0:s1], v[:, s0:s1], k_pos[s0:s1]
        s = torch.einsum("bqhgk,bshk->bhgqs", qg, kc.float())
        s = softcap(s, cfg.attn_softcap)
        s = s + _mask_bias(q_pos, kp, causal, window)[None, None, None]
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        # fully-masked rows keep m = NEG_INF; the clamp keeps alpha finite
        alpha = torch.exp(torch.clamp(m - m_new, max=0.0))
        pexp = torch.exp(s - m_new[..., None])
        l = l * alpha + torch.sum(pexp, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqs,bshk->bhgqk", pexp.to(vc.dtype).float(), vc.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    # (B, KV, g, Sq, hd) -> (B, Sq, H, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def uses_flash(cfg: ModelConfig, causal: bool, window: int, cross: bool = False) -> bool:
    """Whether self-attention over a whole sequence is the flash kernel's
    function: causal, no window, no attention softcap, keys at the queries'
    own (increasing) positions. The mask then depends only on the order of
    the positions, which the kernel reads as indices 0…S−1."""
    return causal and window == 0 and cfg.attn_softcap == 0 and not cross


def self_attention(q, k, v, positions, cfg, causal, window):
    """Self-attention of q against k/v at `positions` (increasing, as
    `forward` passes 0…S−1): B8 where uses_flash holds, else the
    reference's direct or chunked path by the key count."""
    if uses_flash(cfg, causal, window):
        return ops.flash_attention(q, k, v, causal=True, scale=_scale(cfg))
    fn = _direct_attention if k.shape[1] <= _DIRECT_MAX_SEQ else _chunked_attention
    return fn(q, k, v, positions, positions, cfg, causal, window)


def attention(
    p,
    x,
    positions,
    cfg: ModelConfig,
    *,
    causal: bool = True,
    window: int = 0,
    kv_states: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    kv_positions: Optional[torch.Tensor] = None,
):
    """Self- or cross-attention over full sequences (train / prefill).

    kv_states: (k, v) from an encoder for cross-attention (q from x only).
    positions: (S,) shared across batch, increasing.
    """
    q, k, v = project_qkv(p, x, positions, cfg)
    if kv_states is not None:
        k, v = kv_states
        fn = _direct_attention if k.shape[1] <= _DIRECT_MAX_SEQ else _chunked_attention
        out = fn(q, k, v, positions, kv_positions, cfg, causal, window)
    else:
        out = self_attention(q, k, v, positions, cfg, causal, window)
    return _out_proj(out, p["wo"])


def cross_kv(p, enc_out, cfg: ModelConfig):
    """Encoder K/V for cross-attention (computed once, cached for decode)."""
    return _proj(enc_out, p["wk"]), _proj(enc_out, p["wv"])


# ---------------------------------------------------------------------------
# Decode (one new token against a cache)
# ---------------------------------------------------------------------------
def decode_attention(
    p,
    x,  # (B, 1, d)
    cache_k,  # (B, S_max, KV, hd)
    cache_v,
    pos: int,  # write/read position
    cfg: ModelConfig,
    *,
    window: int = 0,
    cross: bool = False,
    cache_len: Optional[int] = None,
):
    """Returns (out (B, 1, d), new_cache_k, new_cache_v).

    The new K/V row is written into the caches in place (the reference's
    dynamic_update_slice on a donated buffer). cross=True: the cache holds
    precomputed encoder K/V; nothing is written.
    """
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = _proj(x, p["wq"])
    if cfg.qk_norm:
        q = _rms_head(q, p["q_norm"])
    if cfg.use_rope and not cross:
        q = apply_rope(q, positions, cfg)

    if not cross:
        k_new = _proj(x, p["wk"])
        v_new = _proj(x, p["wv"])
        if cfg.qk_norm:
            k_new = _rms_head(k_new, p["k_norm"])
        if cfg.use_rope:
            k_new = apply_rope(k_new, positions, cfg)
        cache_k[:, pos:pos + 1] = k_new.to(cache_k.dtype)
        cache_v[:, pos:pos + 1] = v_new.to(cache_v.dtype)

    B, S_max, KV, hd = cache_k.shape
    H = q.shape[2]
    qg = _grouped_q(q, cfg, KV)
    s = torch.einsum("bqhgk,bshk->bhgqs", qg.float(), cache_k.to(q.dtype).float())
    s = softcap(s, cfg.attn_softcap)

    k_idx = torch.arange(S_max, device=x.device)
    limit = cache_len if cache_len is not None else (pos + 1 if not cross else S_max)
    valid = k_idx < limit
    if window > 0 and not cross:
        valid &= k_idx > pos - window
    s = torch.where(valid[None, None, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqs,bshk->bqhgk", w.to(cache_v.dtype).float(), cache_v.float())
    out = out.reshape(B, 1, H, hd).to(x.dtype)
    return _out_proj(out, p["wo"]), cache_k, cache_v
