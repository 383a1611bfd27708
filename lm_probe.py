#!/usr/bin/env python3
"""Probes of the port's LM serving path on one NVIDIA GPU, beside chip_smoke.py.

    python3 lm_probe.py                 # both probes, from the repository root
    python3 lm_probe.py --kernel        # B8 only
    python3 lm_probe.py --conditioning  # the model's conditioning only

--kernel: the flash-attention kernel (B8) against its plain version at
every head_dim it is built for (16, 32, 64, 96, 128), in bf16 and float32,
causal and not, at a ragged length (B=2, S=130, H=4, KV=2), and at Sq < Sk
and Sq > Sk; then its time at the phi3-mini prefill shape (B=4, S=2048,
H=KV=32, hd=96) and the starcoder2-15b GQA shape (B=1, S=2048, H=48, KV=4,
hd=128), bf16, causal, with CUDA events (20 launches after 3 warm-up).

--conditioning: how far each way of computing phi3-mini-3.8b at full width
(the prefill through B8, the prefill through the reference's direct
attention, the decode path) stands from a finer evaluation of the same
random weights, and from each other:
  bf16 at 32, 8 and 2 layers (B=4, a 32-token prompt, last logits) against
  a float32 evaluation, with the argmax agreement and top-2 margins;
  float32 at 1, 2 and 4 layers (B=2, 256 tokens, every position) against a
  float64 evaluation on the host;
and, at each depth, the scale of the first block's attention logits. These
are the measurements behind chip_smoke.py's lm-parity criteria.

It imports neither JAX nor the JAX package `repro`; it needs a card.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def probe_kernel() -> bool:
    import torch
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator("cuda").manual_seed(0)
    ok_all = True

    def run(B, Sq, Sk, H, KV, hd, dt, causal):
        q = torch.randn(B, Sq, H, hd, generator=gen, device="cuda").to(dt)
        k = torch.randn(B, Sk, KV, hd, generator=gen, device="cuda").to(dt)
        v = torch.randn(B, Sk, KV, hd, generator=gen, device="cuda").to(dt)
        o = fa.flash_attention_cuda(q, k, v, causal=causal, scale=hd ** -0.5)
        p = fa.flash_attention_plain(q, k, v, causal=causal, scale=hd ** -0.5)
        torch.cuda.synchronize()
        tol = 2e-4 if dt == torch.float32 else 1e-2  # chip_smoke.FLASH_TOL
        err = (o.double() - p.double()).abs()
        ok = bool(torch.isfinite(o).all()) and bool((err <= tol + tol * p.double().abs()).all())
        print(f"B8 B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} hd={hd} {dt} causal={causal}: "
              f"max_abs_err {float(err.max()):.3g} ok={ok}")
        return ok, (q, k, v)

    for hd in fa.HEAD_DIMS:
        for dt in (torch.bfloat16, torch.float32):
            for causal in (True, False):
                ok_all &= run(2, 130, 130, 4, 2, hd, dt, causal)[0]
    ok_all &= run(1, 70, 200, 4, 1, 64, torch.bfloat16, True)[0]
    ok_all &= run(1, 200, 70, 4, 1, 64, torch.float32, True)[0]
    for name, shape in (("phi3-mini prefill", (4, 2048, 2048, 32, 32, 96)),
                        ("starcoder2-15b GQA", (1, 2048, 2048, 48, 4, 128))):
        ok, (q, k, v) = run(*shape, torch.bfloat16, True)
        ok_all &= ok
        for _ in range(3):
            fa.flash_attention_cuda(q, k, v, causal=True)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(20):
            fa.flash_attention_cuda(q, k, v, causal=True)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 20
        B, S, H, hd = q.shape
        flops = 4 * hd * B * H * S * (S + 1) / 2
        print(f"B8 time {name}: {ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s")
    return ok_all


def probe_conditioning() -> None:
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import attention, build_model

    def direct_prefill(model, params, tokens, last_only):
        """The prefill with every layer's attention on the reference's
        direct path (no B8)."""
        real = attention.uses_flash
        attention.uses_flash = lambda *args, **kwargs: False
        try:
            return model.forward(params, {"tokens": tokens}, last_only=last_only)[0]
        finally:
            attention.uses_flash = real

    def compare(label, a, b, std, argmax=False):
        a, b = a.double().cpu(), b.double().cpu()
        line = (f"  {label}: max|Δ|/std {float((a - b).abs().max()) / std:.4g}, "
                f"mean|Δ|/std {float((a - b).abs().mean()) / std:.4g}")
        if argmax:
            line += f", argmax equal on {int((a.argmax(-1) == b.argmax(-1)).sum())} of {a.shape[0]}"
        print(line)

    def logit_scale(model, params, tokens):
        """|max| of the first block's attention logits, scale applied."""
        from repro_torch.models import layers
        x = model._embed_in(params, {"tokens": tokens}, torch.float32)
        p0 = model._layers(params["blocks"])[0]
        h = layers.apply_norm(p0["ln1"], x, model.cfg.norm_kind).float()
        pos = torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)
        q, k, _ = attention.project_qkv(tree_float(p0["attn"]), h, pos, model.cfg)
        s = torch.einsum("bqhk,bshk->bhqs", q, k) * attention._scale(model.cfg)
        return float(s.abs().max()), float(q.pow(2).mean().sqrt())

    def tree_float(tree):
        return {k: v.float() for k, v in tree.items()}

    base = get_config(cs.LM_ARCH)
    for L in (32, 8, 2):
        model = build_model(dataclasses.replace(base, num_layers=L))
        params = model.init(torch.Generator("cuda").manual_seed(0), torch.bfloat16)
        prompt = cs.token_ids(base.vocab_size, (cs.GEN_B, cs.GEN_PROMPT), 2)
        pre = model.forward(params, {"tokens": prompt}, last_only=True)[0][:, 0].float()
        direct = direct_prefill(model, params, prompt, True)[:, 0].float()
        dec = cs.decode_logits(model, params, prompt)[:, -1]
        ref = cs.reference_logits(model, params, prompt, torch.float32, "cuda")[:, -1]
        std = float(ref.std())
        top2 = torch.topk(ref, 2, dim=-1).values
        s_max, q_rms = logit_scale(model, params, prompt)
        print(f"bf16, {L} layers: first-block attention logits |max| {s_max:.4g} (q rms "
              f"{q_rms:.3g}); float32 evaluation's top-2 margins/std "
              f"{[round(m, 3) for m in ((top2[:, 0] - top2[:, 1]) / std).tolist()]}")
        compare("prefill (B8) vs decode", pre, dec, std, argmax=True)
        compare("prefill (direct) vs decode", direct, dec, std, argmax=True)
        compare("prefill (B8) vs prefill (direct)", pre, direct, std, argmax=True)
        compare("prefill (B8) vs float32", pre, ref, std, argmax=True)
        compare("decode vs float32", dec, ref, std, argmax=True)
        del model, params
        torch.cuda.empty_cache()

    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        for L in (1, 2, 4):
            cfg = dataclasses.replace(base, num_layers=L, dtype="float32")
            model = build_model(cfg)
            params = model.init(torch.Generator("cuda").manual_seed(4), torch.float32)
            tokens = cs.token_ids(base.vocab_size, (cs.PARITY_B, cs.PARITY_S), 5)
            pre = model.forward(params, {"tokens": tokens})[0]
            direct = direct_prefill(model, params, tokens, False)
            dec = cs.decode_logits(model, params, tokens)
            ref = cs.reference_logits(model, params, tokens, torch.float64, "cpu")
            std = float(ref.std())
            s_max, q_rms = logit_scale(model, params, tokens)
            print(f"float32, {L} layers: first-block attention logits |max| {s_max:.4g} "
                  f"(q rms {q_rms:.3g})")
            compare("prefill (B8) vs decode", pre, dec, std)
            compare("prefill (direct) vs decode", direct, dec, std)
            compare("prefill (B8) vs float64", pre, ref, std)
            compare("prefill (direct) vs float64", direct, ref, std)
            compare("decode vs float64", dec, ref, std)
            del model, params
            torch.cuda.empty_cache()
    finally:
        torch.set_float32_matmul_precision(prev)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("lm_probe: no CUDA device; this script runs on a GPU host", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from repro_torch.kernels import _build

    args = set(sys.argv[1:]) or {"--kernel", "--conditioning"}
    if args - {"--kernel", "--conditioning"}:
        print(f"lm_probe: unknown arguments {sorted(args)}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    ok = True
    if "--kernel" in args:
        ok = probe_kernel()
    if "--conditioning" in args:
        probe_conditioning()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
