"""The port's LM serving path (dense family) against the JAX package on the
CPU: configs, layers, the flash kernel's plain version (B8), attention,
blocks, `Model.forward`, `decode_step` and `greedy_generate`, on reduced
configs in float32, with the reference's weights carried over through
numpy (interop.lm_params_from_numpy) and inputs made with numpy from a
seed. Each JAX oracle is computed once per module.

Tolerances, all float32 on both sides, differing only in the order of
their sums and in their libm:
  * layers: max |Δ| <= 1e-6 · max(1, max |reference|);
  * flash attention: rtol = atol = 2e-4 (tests/test_kernels.py's);
  * attention, blocks and decode attention: max |Δ| <= 1e-5 · max(1,
    max |reference|);
  * logits of forward and decode steps: max |Δ| / std(reference logits)
    < 1e-4. The weights are drawn with numpy at the reference's init
    scales; those scales give attention logits of order 100 (fan-in is
    shape[-2], the head axis of a (d, H, hd) weight), which amplify both
    packages' float32 rounding;
  * greedy tokens: equal.
The CUDA kernel itself runs only on the card, where chip_smoke.py holds it
against flash_attention_plain.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jcfg  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.serve import decode as jdecode  # noqa: E402

import repro_torch.configs as tcfg  # noqa: E402
from repro_torch.interop import lm_params_from_numpy  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.serve import decode as tdecode  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
DENSE = ("phi3-mini-3.8b", "starcoder2-15b", "chatglm3-6b")
B, S = 2, 8  # forward / decode parity shape
N_DECODE = 8
PROMPT, NEW, MAX_SEQ = 8, 4, 12  # greedy_generate
LOGIT_TOL = 1e-4  # max |Δ| / std of the reference's logits


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rel_err(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.max(np.abs(port - ref))) / max(1.0, float(np.max(np.abs(ref))))


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


def _numpy_params(specs, rng):
    """Weights for a reference spec tree, drawn with numpy at the
    reference's init scales (normal / 1/√shape[-2], zeros, ones): the
    reference's `Model.init` tree, made from a numpy seed."""
    def one(s):
        if s.init == "zeros":
            return np.zeros(s.shape, np.float32)
        if s.init == "ones":
            return np.ones(s.shape, np.float32)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else max(s.shape[-1], 1)
        scale = s.scale if s.scale is not None else 1.0 / np.sqrt(fan_in)
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)
    return jax.tree.map(one, specs, is_leaf=lambda x: hasattr(x, "init"))


def _reduced(arch):
    return tcfg.reduce_config(tcfg.get_config(arch)), jcfg.reduce_config(jcfg.get_config(arch))


# -- configs ---------------------------------------------------------------------
@pytest.mark.parametrize("arch", jcfg.ARCH_IDS)
def test_configs_match_reference(arch):
    """get_config and reduce_config copy the reference field for field;
    n_params and n_active_params agree."""
    assert tcfg.ARCH_IDS == jcfg.ARCH_IDS
    for t, j in ((tcfg.get_config(arch), jcfg.get_config(arch)), _reduced(arch)):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.n_params() == j.n_params()
        assert t.n_active_params() == j.n_active_params()
        assert (t.resolved_head_dim, t.q_per_kv) == (j.resolved_head_dim, j.q_per_kv)
    assert {k: dataclasses.asdict(v) for k, v in tcfg.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jcfg.SHAPES.items()}


# -- layers ----------------------------------------------------------------------
def _layer_inputs(seed=0, d=64, f=128):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(d)).astype(np.float32),
         "w_gate": (rng.standard_normal((d, f)) / 8).astype(np.float32),
         "w_up": (rng.standard_normal((d, f)) / 8).astype(np.float32),
         "w_in": (rng.standard_normal((d, f)) / 8).astype(np.float32),
         "w_down": (rng.standard_normal((f, d)) / 11).astype(np.float32)}
    return x, p


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind):
    x, p = _layer_inputs(1)
    got = tL.apply_norm({k: _t(v) for k, v in p.items()}, _t(x), kind)
    want = jax.jit(lambda p, x: jL.apply_norm(p, x, kind))(p, x)
    assert _rel_err(got, want) <= 1e-6


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_apply_mlp(kind):
    x, p = _layer_inputs(2)
    got = tL.apply_mlp({k: _t(v) for k, v in p.items()}, _t(x), kind)
    want = jax.jit(lambda p, x: jL.apply_mlp(p, x, kind))(p, x)
    assert _rel_err(got, want) <= 1e-6


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_apply_rope(fraction):
    cfg_t, cfg_j = (dataclasses.replace(c, rope_fraction=fraction)
                    for c in _reduced("chatglm3-6b"))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = np.arange(3, 10, dtype=np.int32)
    got = tL.apply_rope(_t(x), _t(pos), cfg_t)
    want = jax.jit(lambda x, pos: jL.apply_rope(x, pos, cfg_j))(x, pos)
    assert _rel_err(got, want) <= 1e-6
    if fraction < 1:  # the trailing half passes through untouched
        np.testing.assert_array_equal(got[..., 8:].numpy(), x[..., 8:])


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_embed_and_unembed(cap):
    cfg_t, cfg_j = (dataclasses.replace(c, logit_softcap=cap) for c in _reduced("phi3-mini-3.8b"))
    rng = np.random.default_rng(4)
    p = {"tok": rng.standard_normal((512, 64)).astype(np.float32),
         "unembed": (rng.standard_normal((64, 512)) * 2).astype(np.float32)}
    toks = rng.integers(0, 512, (2, 6)).astype(np.int32)
    tp = {k: _t(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    x = tL.embed_tokens(tp, _t(toks))
    np.testing.assert_array_equal(x.numpy(), np.asarray(jL.embed_tokens(jp, toks)))
    got = tL.unembed(tp, x, cfg_t)
    want = jL.unembed(jp, jnp.asarray(x.numpy()), cfg_j)
    assert _rel_err(got, want) <= 1e-6
    if cap:
        assert float(got.abs().max()) < cap


def test_sinusoidal_positions():
    np.testing.assert_array_equal(tL.sinusoidal_positions(9, 16).numpy(),
                                  np.asarray(jL.sinusoidal_positions(9, 16)))
    got = tL.sinusoidal_position_at(5, 16)
    want = jL.sinusoidal_position_at(jnp.asarray(5), 16)
    assert _rel_err(got, want) <= 1e-6


# -- B8: flash attention's plain version -----------------------------------------------
FLASH_KERNEL_SHAPES = [  # tests/test_kernels.py's shapes, with its blocks
    (1, 128, 2, 2, 16, 64, 64, True),
    (2, 256, 4, 2, 32, 128, 64, True),
    (1, 128, 4, 1, 16, 32, 128, False),
    (2, 64, 8, 4, 64, 64, 32, True),
]


def _qkv(seed, B_, Sq, H, KV, hd, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = Sq if Sk is None else Sk
    return (rng.standard_normal((B_, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B_, Sk, KV, hd)).astype(np.float32),
            rng.standard_normal((B_, Sk, KV, hd)).astype(np.float32))


@pytest.mark.parametrize("B_,S_,H,KV,hd,bq,bk,causal", FLASH_KERNEL_SHAPES)
def test_flash_plain_matches_pallas_interpret(B_, S_, H, KV, hd, bq, bk, causal):
    """Against the Pallas kernel in interpret mode (what the reference's
    own tests run on the CPU) and against ref.flash_attention_ref."""
    q, k, v = _qkv(B_ * S_ + H, B_, S_, H, KV, hd)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, block_q=bq, block_k=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    ref = jax.jit(lambda q, k, v: jref.flash_attention_ref(q, k, v, causal))(q, k, v)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("Sq,Sk,g,causal", [
    *((80, 80, g, c) for g in (1, 2, 4) for c in (True, False)),
    (48, 80, 2, True),  # fewer queries than keys
])
def test_flash_plain_gqa_and_ragged(Sq, Sk, g, causal):
    """GQA groups and ragged lengths (which the JAX op sends to its oracle,
    and the port's kernel masks itself) against ref.flash_attention_ref,
    with an explicit scale."""
    KV = 2
    q, k, v = _qkv(Sq + Sk + g, 1, Sq, KV * g, KV, 16, Sk)
    got = tflash.flash_attention_plain(_t(q), _t(k), _t(v), causal=causal, scale=0.3)
    want = jax.jit(lambda q, k, v: jref.flash_attention_ref(q, k, v, causal, 0.3))(q, k, v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_flash_plain_matches_model_attention_path():
    """The plain version agrees with the reference's _direct_attention, the
    function it takes over in the prefill (test_kernels.py's check)."""
    cfg_j = jcfg.reduce_config(jcfg.get_config("phi3-mini-3.8b"))
    q, k, v = _qkv(0, 2, 64, 4, 4, 16)
    pos = jnp.arange(64)
    want = jax.jit(lambda q, k, v: jattn._direct_attention(q, k, v, pos, pos, cfg_j,
                                                           True, 0))(q, k, v)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True, scale=16 ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_flash_cpu_calls_count_no_launch():
    ops.reset_launch_counts()
    q, k, v = _qkv(1, 1, 8, 2, 2, 16)
    ops.flash_attention(_t(q), _t(k), _t(v))
    assert ops.flash_attention.launches == 0


# -- the reference's model, once per arch ----------------------------------------------
@pytest.fixture(scope="module")
def oracles():
    """For each dense arch: the reduced config pair, the weights (numpy,
    the reference's tree), the tokens, full and last-only logits, 8 decode steps' logits,
    greedy tokens, and one block's attention outputs."""
    out = {}
    for i, arch in enumerate(DENSE):
        cfg_t, cfg_j = _reduced(arch)
        jm = jbuild_model(cfg_j)
        rng = np.random.default_rng(10 + i)
        np_params = _numpy_params(jm.specs, rng)
        jparams = jax.tree.map(jnp.asarray, np_params)
        toks = rng.integers(0, cfg_j.vocab_size, (B, S)).astype(np.int32)
        full, last = jax.jit(lambda p, t: (
            jm.forward(p, {"tokens": t})[0],
            jm.forward(p, {"tokens": t}, last_only=True)[0]))(jparams, toks)
        cache = jT.materialize_cache(jm.cache_specs(B, N_DECODE, jnp.float32))
        dec = jax.jit(lambda p, c, t, i: jm.decode_step(p, c, t, i))
        steps = []
        for s in range(N_DECODE):
            lg, cache = dec(jparams, cache, toks[:, s:s + 1], jnp.asarray(s, jnp.int32))
            steps.append(np.asarray(lg))
        prompt = rng.integers(0, cfg_j.vocab_size, (B, PROMPT)).astype(np.int32)
        gen = jdecode.greedy_generate(jm, jparams, jnp.asarray(prompt), NEW, MAX_SEQ)
        # one block: x, its attention and its forward, and one decode
        # attention against a cache filled with the sequence's K/V
        p0 = jax.tree.map(lambda a: a[0], jparams["blocks"])
        x = rng.standard_normal((B, S, cfg_j.d_model)).astype(np.float32)
        pos = jnp.arange(S, dtype=jnp.int32)

        def one_block(p, x, cfg=cfg_j, pos=pos):
            _, k_c, v_c = jattn.project_qkv(p["attn"], x, pos, cfg)
            return (jattn.attention(p["attn"], x, pos, cfg),
                    jT.attn_block_forward(p, x, pos, cfg), (k_c, v_c),
                    jattn.decode_attention(p["attn"], x[:, -1:], k_c, v_c, S - 1, cfg))

        attn, block, kv, decode = jax.device_get(jax.jit(one_block)(p0, x))
        out[arch] = dict(
            cfg_t=cfg_t, cfg_j=cfg_j, params=np_params, toks=toks,
            full=np.asarray(full), last=np.asarray(last), steps=steps, prompt=prompt,
            gen=np.asarray(gen), n_params=jm.n_params(), x=x, attn=attn, block=block,
            kv=kv, decode=decode)
    return out


def _port_model(o):
    m = build_model(o["cfg_t"])
    params = lm_params_from_numpy(o["params"], o["cfg_t"], "cpu")
    return m, params


@pytest.mark.parametrize("arch", DENSE)
def test_attention_block_and_decode_attention(oracles, arch):
    o = oracles[arch]
    cfg = o["cfg_t"]
    _, params = _port_model(o)
    p0 = tree_map(lambda a: a[0], params["blocks"], is_leaf=torch.is_tensor)
    x, pos = _t(o["x"]), torch.arange(S, dtype=torch.int32)
    assert _rel_err(tattn.attention(p0["attn"], x, pos, cfg), o["attn"]) <= 1e-5
    assert _rel_err(tT.attn_block_forward(p0, x, pos, cfg), o["block"]) <= 1e-5
    k_c, v_c = (_t(a) for a in o["kv"])
    d_out, d_k, d_v = tattn.decode_attention(p0["attn"], x[:, -1:], k_c, v_c, S - 1, cfg)
    for got, want in zip((d_out, d_k, d_v), o["decode"]):
        assert _rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("arch", DENSE)
def test_forward_logits_match_reference(oracles, arch):
    o = oracles[arch]
    m, params = _port_model(o)
    assert m.n_params() == o["n_params"]
    batch = {"tokens": _t(o["toks"])}
    full, aux = m.forward(params, batch)
    scale = float(np.std(o["full"]))
    assert full.shape == o["full"].shape and float(aux) == 0.0
    assert float(np.max(np.abs(full.numpy() - o["full"]))) / scale < LOGIT_TOL
    last = tdecode.make_prefill_step(m)(params, batch)
    assert last.shape == (B, 1, o["cfg_t"].vocab_size)
    assert float(np.max(np.abs(last.numpy() - o["last"]))) / scale < LOGIT_TOL
    # the attached tree gives the same logits
    m.attach(params)
    assert torch.equal(m.forward(None, batch)[0], full)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_steps_match_reference(oracles, arch):
    o = oracles[arch]
    m, params = _port_model(o)
    cache = tT.materialize_cache(m.cache_specs(B, N_DECODE, torch.float32))
    step = tdecode.make_serve_step(m)
    state = tdecode.DecodeState(cache=cache, pos=0, last_tokens=None, generator=None)
    scale = float(np.std(o["full"]))
    for s in range(N_DECODE):
        state = state._replace(last_tokens=_t(o["toks"][:, s:s + 1]))
        lg, state = step(params, state)
        assert float(np.max(np.abs(lg.numpy() - o["steps"][s]))) / scale < LOGIT_TOL, s
    assert state.pos == N_DECODE


@pytest.mark.parametrize("arch", DENSE)
def test_greedy_generate_matches_reference(oracles, arch):
    o = oracles[arch]
    m, params = _port_model(o)
    got = tdecode.greedy_generate(m, params, _t(o["prompt"]), NEW, MAX_SEQ)
    np.testing.assert_array_equal(got.numpy(), o["gen"])


def test_sampling_takes_the_generator(oracles):
    o = oracles["phi3-mini-3.8b"]
    m, params = _port_model(o)
    prompt = _t(o["prompt"])
    draws = [tdecode.greedy_generate(m, params, prompt, NEW, MAX_SEQ, temperature=1.0,
                                     generator=torch.Generator().manual_seed(5))
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1]) and draws[0].shape == (B, NEW)
    with pytest.raises(ValueError, match="Generator"):
        tdecode.greedy_generate(m, params, prompt, NEW, MAX_SEQ, temperature=1.0)


# -- dispatch ------------------------------------------------------------------------------
def _count_flash(monkeypatch):
    calls = []
    real = ops.flash_attention

    def counting(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(tattn.ops, "flash_attention", counting)
    return calls


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_dispatches_to_flash(monkeypatch, arch):
    """Every prefill layer of phi3-mini, starcoder2 and chatglm3 runs B8,
    with the config's scale; at full width the predicate holds too."""
    assert tattn.uses_flash(tcfg.get_config(arch), causal=True, window=0)
    cfg = tcfg.reduce_config(tcfg.get_config(arch))
    m = build_model(cfg)
    m.init(torch.Generator().manual_seed(0), device="cpu")
    calls = _count_flash(monkeypatch)
    m.forward(None, {"tokens": torch.zeros((1, 5), dtype=torch.int64)})
    assert len(calls) == cfg.num_layers
    assert all(c == {"causal": True, "scale": tattn._scale(cfg)} for c in calls)


def test_other_attention_takes_the_plain_paths(monkeypatch):
    """gemma2's softcap and window, cross attention and non-causal
    attention never reach B8, and agree with the reference; the chunked
    path (whole chunks and a remainder) agrees with the direct one."""
    cfg_t, cfg_j = _reduced("gemma2-2b")
    assert not tattn.uses_flash(tcfg.get_config("gemma2-2b"), causal=True, window=0)
    assert not tattn.uses_flash(cfg_t, causal=True, window=32)
    rng = np.random.default_rng(7)
    jp = jattn.attn_specs(cfg_j)
    p = {k: (rng.standard_normal(s.shape) / np.sqrt(s.shape[0])).astype(np.float32)
         for k, s in jp.items()}
    x = rng.standard_normal((2, 40, cfg_j.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 24, cfg_j.d_model)).astype(np.float32)
    pos = np.arange(40, dtype=np.int32)
    tp = {k: _t(v) for k, v in p.items()}
    jpp = {k: jnp.asarray(v) for k, v in p.items()}
    calls = _count_flash(monkeypatch)
    cases = [dict(causal=True, window=16), dict(causal=False, window=0),
             dict(causal=False, window=0, cross=True)]
    for case in cases:
        cross = case.pop("cross", False)
        kw_t = dict(case, kv_states=tattn.cross_kv(tp, _t(enc), cfg_t),
                    kv_positions=torch.arange(24)) if cross else case
        kw_j = dict(case, kv_states=jattn.cross_kv(jpp, jnp.asarray(enc), cfg_j),
                    kv_positions=jnp.arange(24)) if cross else case
        got = tattn.attention(tp, _t(x), _t(pos), cfg_t, **kw_t)
        want = jax.jit(lambda p, x, kw=kw_j: jattn.attention(
            p, x, jnp.asarray(pos), cfg_j, **kw))(jpp, jnp.asarray(x))
        assert _rel_err(got, want) <= 1e-5, case
    assert calls == []
    q, k, v = tattn.project_qkv(tp, _t(x), _t(pos), cfg_t)
    direct = tattn._direct_attention(q, k, v, _t(pos), _t(pos), cfg_t, True, 16)
    monkeypatch.setattr(tattn, "_CHUNK", 16)  # 40 keys: two chunks and 8 more
    chunked = tattn._chunked_attention(q, k, v, _t(pos), _t(pos), cfg_t, True, 16)
    assert _rel_err(chunked, direct) <= 1e-5


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "grok-1-314b", "internvl2-76b",
                                  "gemma2-2b", "zamba2-1.2b", "whisper-medium",
                                  "xlstm-125m"])
def test_unported_families_name_their_item(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP A16"):
        build_model(tcfg.reduce_config(tcfg.get_config(arch)))


def test_mesh_and_unported_blocks_raise():
    cfg = tcfg.reduce_config(tcfg.get_config("phi3-mini-3.8b"))
    with pytest.raises(NotImplementedError, match="A14"):
        build_model(cfg, mesh=object())
    with pytest.raises(NotImplementedError, match="A14"):
        tdecode.make_prefill_step(build_model(cfg), mesh=object())
    with pytest.raises(NotImplementedError, match="A16"):
        tT.moe_block_specs(cfg)
    with pytest.raises(RuntimeError, match="no parameters attached"):
        build_model(cfg).forward(None, {"tokens": torch.zeros((1, 2), dtype=torch.int64)})


# -- parameters --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE)
def test_param_specs_match_reference(arch):
    """The same tree, shapes and dry-run dtypes as the reference's specs;
    init draws zeros and ones exactly and normals at 1/√fan_in."""
    cfg_t, cfg_j = _reduced(arch)
    m, jm = build_model(cfg_t), jbuild_model(cfg_j)
    j_abs = jax.tree_util.tree_flatten_with_path(jm.abstract_params())[0]
    t_abs = m.abstract_params()
    for path, leaf in j_abs:
        node = t_abs
        for key in path:
            node = node[key.key]
        assert node.device.type == "meta"
        assert tuple(node.shape) == leaf.shape
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype)
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(params["final_norm"]["scale"], torch.ones(cfg_t.d_model))
    # the reference's fan-in is shape[-2]: the heads axis of a stacked wq
    for w in (params["blocks"]["attn"]["wq"], params["blocks"]["mlp"]["w_down"]):
        assert abs(float(w.std()) * np.sqrt(w.shape[-2]) - 1.0) < 0.05


def test_lm_params_from_numpy_checks_the_tree(oracles):
    o = oracles["phi3-mini-3.8b"]
    bad = jax.tree.map(lambda a: a, o["params"])
    bad["blocks"]["attn"]["wq"] = bad["blocks"]["attn"]["wq"][:1]
    with pytest.raises(ValueError, match="wq"):
        lm_params_from_numpy(bad, o["cfg_t"], "cpu")
    del bad["final_norm"]
    with pytest.raises(KeyError, match="final_norm"):
        lm_params_from_numpy(bad, o["cfg_t"], "cpu")
    # what jax.device_get gives for the reference's bf16 tree: ml_dtypes'
    # bfloat16 arrays, carried bit for bit
    bf16 = lm_params_from_numpy(jax.device_get(jax.tree.map(
        lambda a: jnp.asarray(a, jnp.bfloat16), o["params"])), o["cfg_t"], "cpu")
    want = torch.from_numpy(o["params"]["embed"]["tok"]).to(torch.bfloat16)
    assert torch.equal(bf16["embed"]["tok"], want)
    # the reference's Model.init tree (its abstract twin: same keys, shapes)
    jm = jbuild_model(o["cfg_j"])
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), jm.abstract_params())
    got = lm_params_from_numpy(tree, o["cfg_t"], "cpu", dtype=torch.bfloat16)
    assert got["blocks"]["attn"]["wq"].dtype == torch.bfloat16


def test_lm_modules_import_no_jax():
    """The LM modules and lm_probe.py, imported in a fresh interpreter, load
    neither `jax` nor `repro`."""
    modules = ["repro_torch.configs", "repro_torch.models", "repro_torch.models.common",
               "repro_torch.models.layers", "repro_torch.models.attention",
               "repro_torch.models.transformer", "repro_torch.models.registry",
               "repro_torch.serve.decode", "repro_torch.kernels.flash_attention",
               "repro_torch.interop"]
    modules += [f"repro_torch.configs.{m}" for m in (
        p.stem for p in (REPO / "src" / "repro_torch" / "configs").glob("*.py"))
        if m != "__init__"]
    code = (
        "import importlib, sys\n"
        f"for m in {modules + ['lm_probe']!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO / "src"), str(REPO)]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert len(modules) >= 21
