"""Flash attention: causal or non-causal GQA attention with an online
softmax (kernel csrc/flash_attention.cu).

Port of src/repro/kernels/flash_attention.py (`flash_attention`, :76). The
LM prefill's causal self-attention runs it on the card. Unlike the JAX op,
which falls back to its oracle when a length does not divide the block
(ops.py:336-340), the kernel masks ragged lengths itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
# head_dim values the kernel is instantiated for (a template parameter)
HEAD_DIMS = (16, 32, 64, 96, 128)
_DTYPES = (torch.bfloat16, torch.float32)


def flash_attention_plain(q, k, v, causal=True, scale=None):
    """The materialized-scores function (ref.flash_attention_ref): q (B, Sq,
    H, hd), k/v (B, Sk, KV, hd) with GQA groups H // KV, computed in float32
    and returned in q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    g = H // KV
    scale = hd ** -0.5 if scale is None else scale
    qg = q.reshape(B, Sq, KV, g, hd).float() * scale
    s = torch.einsum("bqhgk,bshk->bhgqs", qg, k.float())
    if causal:
        mask = (torch.arange(Sk, device=q.device)[None, :]
                <= torch.arange(Sq, device=q.device)[:, None])
        s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqs,bshk->bqhgk", w, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def flash_attention_cuda(q, k, v, causal=True, scale=None):
    """The CUDA kernel; same contract as flash_attention_plain for bf16 or
    float32 tensors on the card, hd in HEAD_DIMS."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention: q must be (B, Sq, H, hd) and k, v "
                         "(B, Sk, KV, hd)")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} (the kernel takes "
                        "bfloat16 or float32)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if KV < 1 or H % KV or Sk < 1:
        raise ValueError(f"flash_attention: H={H}, KV={KV}, Sk={Sk} (need "
                         "H % KV == 0 and Sk >= 1)")
    _build.check_tensor("flash_attention", "q", q, (B, Sq, H, hd), dtype=q.dtype)
    _build.check_tensor("flash_attention", "k", k, (B, Sk, KV, hd), q.device, q.dtype)
    _build.check_tensor("flash_attention", "v", v, (B, Sk, KV, hd), q.device, q.dtype)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte aligned")
    scale = hd ** -0.5 if scale is None else scale
    o = torch.empty_like(q)
    _build.launch("flash_attention_launch", int(q.dtype == torch.bfloat16),
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  B, Sq, Sk, H, KV, hd, float(scale), int(bool(causal)),
                  _build.stream(q))
    return o
