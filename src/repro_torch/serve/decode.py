"""Serving: prefill + decode steps and a batched generation loop.

Port of src/repro/serve/decode.py. `make_serve_step` produces the
single-token decode function: one new token for every sequence in the
batch against a KV cache of length max_seq. `make_prefill_step` is the
full-sequence forward, whose causal self-attention runs the flash kernel
(B8) on the card. Eager PyTorch compiles nothing: where the reference
jit-compiles a step, the port calls it.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.models.registry import Model
from repro_torch.models.transformer import materialize_cache


class DecodeState(NamedTuple):
    cache: Any
    pos: int  # next write position
    last_tokens: torch.Tensor  # (B, 1)
    generator: Optional[torch.Generator]  # the reference's PRNG key


def make_serve_step(model: Model, mesh=None):
    """(params, state) -> (logits, new_state): one decode step. The cache
    is updated in place and carried into the new state."""
    if mesh is not None:
        raise NotImplementedError("mesh: sharded serving is not ported yet (ROADMAP A14)")

    def serve_step(params, state: DecodeState):
        logits, new_cache = model.decode_step(
            params, state.cache, state.last_tokens, state.pos)
        return logits, state._replace(cache=new_cache, pos=state.pos + 1)

    return serve_step


def make_prefill_step(model: Model, mesh=None, last_only: bool = True):
    """Full-sequence forward for the prefill cells.

    last_only=True (serving semantics): only the final position's logits are
    produced — the (B, S, V) unembed is the single largest matmul of a
    big-vocab prefill and next-token generation never needs it.
    last_only=False returns the full logits."""
    if mesh is not None:
        raise NotImplementedError("mesh: sharded serving is not ported yet (ROADMAP A14)")

    def prefill_step(params, batch):
        logits, _ = model.forward(params, batch, last_only=last_only)
        return logits

    return prefill_step


def greedy_generate(
    model: Model,
    params,
    prompt_tokens: torch.Tensor,  # (B, S_prompt)
    max_new_tokens: int,
    max_seq: int,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    mesh=None,
):
    """Simple batched generation: sequential prefill via decode steps
    (correct for every cache family) into a float32 cache, then greedy
    argmax, or, for temperature > 0, sampling from softmax(logits / T)
    with `generator` (on the tokens' device). Returns (B, max_new_tokens)
    tokens."""
    if mesh is not None:
        raise NotImplementedError("mesh: sharded serving is not ported yet (ROADMAP A14)")
    B, S_prompt = prompt_tokens.shape
    if S_prompt + max_new_tokens > max_seq + 1:
        raise ValueError(f"prompt {S_prompt} + {max_new_tokens} new tokens do not fit "
                         f"a cache of {max_seq}")
    if temperature > 0 and generator is None:
        raise ValueError("temperature > 0 samples: pass a torch.Generator")
    device = prompt_tokens.device
    cache = materialize_cache(model.cache_specs(B, max_seq, torch.float32), device)

    # feed the prompt one token at a time (fills the caches)
    logits = None
    for i in range(S_prompt):
        logits, cache = model.decode_step(params, cache, prompt_tokens[:, i:i + 1], i)

    out = []
    for j in range(max_new_tokens):
        lg = logits[:, -1].float()
        if temperature > 0:
            probs = torch.softmax(lg / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)
        else:
            tok = torch.argmax(lg, dim=-1)[:, None]
        out.append(tok)
        if j + 1 < max_new_tokens:
            logits, cache = model.decode_step(params, cache, tok, S_prompt + j)
    return torch.cat(out, dim=1)
