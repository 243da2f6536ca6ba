"""The port's dense and vlm LM families (gemma2, phi3, phi4, starcoder2,
qwen2-vl) and the int8 KV cache against the JAX package, on the CPU.

Weights come from the reference's ``init_params`` (``lm_smoke_models``);
tokens from ``np.random.default_rng``.  The reference runs its Pallas
flash kernel in interpret mode (``REPRO_KERNELS=interpret``) where the
test says so; the port runs on ``device="cpu"``, i.e. through the
kernel's plain version.  Prompts are 40 tokens, past gemma2-smoke's
window of 16, so that its local layers hide keys.

Tolerance: in float32, 1e-4 relative to max|reference| (the sums are
taken in another order).  Greedy tokens, shapes, cache lengths and int8
cache entries are compared exactly.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import base as jbase
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import schema as jschema
from repro.models import transformer as jtr
from repro.models.layers import ShardCtx
from repro.serve import engine as jengine
from repro.serve import kvquant as jkvquant

from repro_torch.configs import base as tbase
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import serve as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import schema as tschema
from repro_torch.models import transformer as ttr
from repro_torch.serve import engine as tengine
from repro_torch.serve import kvquant as tkvquant

from test_torch_helpers import (
    assert_close_rel, lm_cache_to_port, lm_np, lm_smoke_models,
    mrope_positions,
)

CTX = ShardCtx()
REL = 1e-4
DENSE = ["gemma2-9b", "phi3-medium-14b", "phi4-mini-3.8b", "starcoder2-15b"]
ARCHS = DENSE + ["qwen2-vl-2b"]
B, S, STEPS = 2, 40, 3


def _t(x):
    return torch.from_numpy(np.array(x))


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _batches(cfg, toks, pos):
    """(reference batch, port batch) of the same tokens and positions."""
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks)}
    if cfg.use_mrope:
        jb["pos"], tb["pos"] = jnp.asarray(pos), _t(pos)
    return jb, tb


@pytest.fixture(scope="module")
def models():
    return {arch: lm_smoke_models(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def jdecode(models):
    """The reference's ``decode_step`` per arch, jitted (eager, each step
    traces its layer scan anew: ~1 s a step on one core)."""
    return {arch: jax.jit(lambda p, c, b, cfg=m[0]: jtr.decode_step(
        cfg, p, c, b, CTX)) for arch, m in models.items()}


@pytest.fixture(scope="module")
def reference(models):
    """Per arch: the prompt (B, S + STEPS) and its positions, and the
    reference's ``prefill_forward`` of the first S tokens (its flash kernel
    in interpret mode) with room for STEPS more."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_KERNELS", "interpret")
        for arch, (jcfg, _, jp, _) in models.items():
            toks = _tokens(jcfg, B, S + STEPS, seed=len(arch))
            pos = mrope_positions(B, S + STEPS)
            jb, _ = _batches(jcfg, toks[:, :S], pos[:, :S])
            logits, cache = jtr.prefill_forward(jcfg, jp, jb, CTX,
                                                max_seq=S + STEPS)
            out[arch] = (toks, pos, logits, cache)
    return out


# ---------------------------------------------------------------------------
# Schema and caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke_cfg", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_equal_the_reference(arch, smoke_cfg):
    """Every leaf's shape, the published config not allocated: the padded
    heads (phi3 40/10 -> 48/12, phi4 24/8 -> 48/16, qwen2-vl 12/2 ->
    48/8), gemma2's sandwich norms, starcoder2's ungated MLP."""
    get = "get_smoke_config" if smoke_cfg else "get_config"
    jshapes = jax.tree.map(lambda s: tuple(s.shape), jschema.abstract_params(
        getattr(jbase, get)(arch)))
    assert tschema.param_shapes(getattr(tbase, get)(arch)) == jshapes


def test_padded_heads_of_the_published_configs():
    want = {"gemma2-9b": (16, 8, 256), "phi3-medium-14b": (48, 12, 128),
            "phi4-mini-3.8b": (48, 16, 128), "starcoder2-15b": (48, 4, 128),
            "qwen2-vl-2b": (48, 8, 128)}
    for arch, (hq, hkv, dh) in want.items():
        cfg = tbase.get_config(arch)
        assert tschema.param_shapes(cfg)["layers"]["wq"] == (
            cfg.num_layers, cfg.d_model, hq, dh)
        assert (cfg.padded_heads, cfg.padded_kv_heads) == (hq, hkv)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("arch", ["gemma2-9b", "qwen2-vl-2b"])
def test_init_cache_equals_the_reference(models, arch, kv_quant):
    jcfg, tcfg, _, _ = models[arch]
    want = jtr.init_cache(jcfg, 3, 20, dtype=jnp.bfloat16, kv_quant=kv_quant)
    got = ttr.init_cache(tcfg, 3, 20, dtype=torch.bfloat16, device="cpu",
                         kv_quant=kv_quant)
    assert set(got) == set(want) and got["len"] == int(want["len"]) == 0
    for key in set(want) - {"len"}:
        assert tuple(got[key].shape) == want[key].shape, key
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)
        assert not got[key].any()


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dh", [16, 128, 24])
def test_apply_mrope_with_three_streams(dh):
    """Three different position streams, each rotating its own contiguous
    section of the frequency pairs (dh 24: sections 4, 4, 4)."""
    rng = np.random.default_rng(dh)
    x = rng.standard_normal((2, 9, 3, dh)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 9, 3)).astype(np.int32)
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = tlayers.apply_mrope(_t(x), _t(pos), 1e6)
    assert_close_rel(lm_np(got), want, 1e-5)
    # one stream moved moves the output: the streams are not tied
    pos2 = pos.copy()
    pos2[..., 2] += 7
    assert not torch.allclose(got, tlayers.apply_mrope(_t(x), _t(pos2), 1e6))


@pytest.mark.parametrize("layer", [0, 1], ids=["local", "global"])
def test_windowed_decode_attention(models, layer):
    """gemma2-smoke's decode attention at position 30 of a 40-slot cache:
    layer 0 with the window of 16 (keys 15..30), layer 1 with none."""
    jcfg, tcfg, jp, tp = models["gemma2-9b"]
    clen, smax = 30, 40
    win = ttr.layer_window(tcfg, layer)
    assert win == (16 if layer == 0 else 0)
    rng = np.random.default_rng(5)
    shape = (B, jcfg.padded_kv_heads, smax, jcfg.head_dim)
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    pos = np.full((B, 1), clen, np.int32)
    jl = {k: v[layer] for k, v in jp["layers"].items()}
    tl = ttr.layer_params(tp, layer)
    want, wk, wv = jattn.decode_attention(
        jcfg, jl, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(ck),
        jnp.asarray(cv), jnp.int32(clen), CTX, window=win)
    tk, tv = _t(ck), _t(cv)
    got, gk, gv = tattn.decode_attention(tcfg, tl, _t(x), _t(pos).long(),
                                         tk, tv, clen, window=win)
    assert gk is tk and gv is tv
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        assert_close_rel(lm_np(g), w, REL)
    # the window hides keys: without it the local layer's output moves
    full, _, _ = tattn.decode_attention(tcfg, tl, _t(x), _t(pos).long(),
                                        _t(ck), _t(cv), clen)
    assert torch.equal(full, got) == (win == 0)


def test_attend_and_combine_q8():
    rng = np.random.default_rng(7)
    qg = rng.standard_normal((2, 2, 4, 32)).astype(np.float32)
    k = (rng.standard_normal((2, 2, 16, 32)) * 3).astype(np.float32)
    v = rng.standard_normal((2, 2, 16, 32)).astype(np.float32)
    probs = rng.random((2, 2, 4, 16)).astype(np.float32)
    jkq, jks = jkvquant.quantize(jnp.asarray(k))
    jvq, jvs = jkvquant.quantize(jnp.asarray(v))
    tkq, tks = tkvquant.quantize(_t(k))
    tvq, tvs = tkvquant.quantize(_t(v))
    np.testing.assert_array_equal(tkq.numpy(), np.asarray(jkq))
    np.testing.assert_array_equal(tvq.numpy(), np.asarray(jvq))
    assert_close_rel(lm_np(tks), jks, 1e-6)
    got = tkvquant.attend_q8(_t(qg), tkq, tks)
    assert got.shape == (2, 2, 4, 16) and got.dtype == torch.float32
    assert_close_rel(lm_np(got), jkvquant.attend_q8(jnp.asarray(qg), jkq,
                                                    jks), 1e-6)
    out = tkvquant.combine_q8(_t(probs), tvq, tvs)
    assert out.shape == (2, 2, 4, 32)
    assert_close_rel(lm_np(out), jkvquant.combine_q8(jnp.asarray(probs), jvq,
                                                     jvs), 1e-6)
    # the scales fold in: the same as against the dequantized caches
    deq = tkvquant.dequantize(tkq, tks)
    assert_close_rel(lm_np(got), lm_np(torch.einsum(
        "bhgk,bhsk->bhgs", _t(qg), deq)), 1e-6)


# ---------------------------------------------------------------------------
# The model, per architecture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits(models, reference, arch, monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "interpret")
    jcfg, tcfg, jp, tp = models[arch]
    toks, pos = reference[arch][:2]
    jb, tb = _batches(jcfg, toks[:, :S], pos[:, :S])
    want, aux = jtr.forward_logits(jcfg, jp, jb, CTX)
    got, taux = ttr.forward_logits(tcfg, tp, tb)
    assert got.shape == (B, S, tcfg.padded_vocab)
    assert float(aux) == taux == 0.0
    assert_close_rel(lm_np(got), want, REL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_forward_logits_and_cache(models, reference, arch):
    """Last logits and every cache entry, with room for three more
    positions; on the CPU the flash wrapper takes its plain version."""
    jcfg, tcfg, jp, tp = models[arch]
    toks, pos, want, wc = reference[arch]
    _, tb = _batches(jcfg, toks[:, :S], pos[:, :S])
    fa0 = tfa.launches
    got, gc = ttr.prefill_forward(tcfg, tp, tb, max_seq=S + STEPS)
    assert tfa.launches == fa0
    assert got.dtype == torch.float32
    assert_close_rel(lm_np(got), want, REL)
    assert gc["len"] == int(wc["len"]) == S and set(gc) == set(wc)
    for key in ("k", "v"):
        assert tuple(gc[key].shape) == wc[key].shape == (
            tcfg.num_layers, B, tcfg.padded_kv_heads, S + STEPS,
            tcfg.head_dim)
        assert_close_rel(lm_np(gc[key]), wc[key], REL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_from_the_reference_cache(models, reference, jdecode,
                                               arch):
    """Three decode steps from the reference's prefill cache carried over:
    logits and every cache entry after each step."""
    jcfg, tcfg, jp, tp = models[arch]
    toks, pos, _, wc = reference[arch]
    gc = lm_cache_to_port(wc)
    for t in range(S, S + STEPS):
        jb, tb = _batches(jcfg, toks[:, t:t + 1], pos[:, t:t + 1])
        want, wc = jdecode[arch](jp, wc, jb)
        before = gc
        got, gc = ttr.decode_step(tcfg, tp, gc, tb)
        assert gc is before and gc["len"] == int(wc["len"]) == t + 1
        assert_close_rel(lm_np(got), want, REL)
        for key in ("k", "v"):
            assert_close_rel(lm_np(gc[key]), wc[key], REL)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_tokens_equal_the_reference(models, arch):
    """Left-padded requests, 3 greedy tokens each, exactly the reference's
    (qwen2-vl: the engine's M-RoPE positions, three equal streams)."""
    jcfg, tcfg, jp, tp = models[arch]
    rng = np.random.default_rng(1)
    reqs = [list(rng.integers(1, jcfg.vocab_size, size=rng.integers(2, 7)))
            for _ in range(2)]
    prompts, _ = jengine.batch_requests(reqs)
    max_seq = prompts.shape[1] + 3
    want = jengine.generate(jcfg, jp, jnp.asarray(prompts), CTX,
                            jengine.ServeConfig(max_seq=max_seq), 3)
    got = tengine.generate(tcfg, tp, _t(prompts),
                           tengine.ServeConfig(max_seq=max_seq), 3)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_the_window_bites_on_a_prompt_past_it(models, reference):
    """gemma2-smoke's prefill at 2 x 40 tokens equals the reference only
    with its window: the same prefill with ``attn_window=0`` (every layer
    global) moves the last logits far past the limit."""
    _, tcfg, _, tp = models["gemma2-9b"]
    toks, _, want, _ = reference["gemma2-9b"]
    tb = {"tokens": _t(toks[:, :S])}
    got, _ = ttr.prefill_forward(tcfg, tp, tb)
    assert_close_rel(lm_np(got), want, REL)
    nowin, _ = ttr.prefill_forward(dataclasses.replace(tcfg, attn_window=0),
                                   tp, tb)
    want = np.asarray(want)
    err = np.abs(lm_np(nowin) - want).max() / np.abs(want).max()
    assert err > 100 * REL, err


def test_prefill_cache_equals_prefill_forward(models):
    """The engine's token-by-token prefill and the whole-prompt prefill
    fill the same cache (what chip_smoke.py holds on the card), for a
    windowed model past its window and under M-RoPE."""
    for arch in ("gemma2-9b", "qwen2-vl-2b"):
        _, tcfg, _, tp = models[arch]
        toks = _t(_tokens(tcfg, B, 24, seed=4))
        cache, logits = tengine.prefill_cache(
            tcfg, tp, toks, tengine.ServeConfig(max_seq=24))
        batch = {"tokens": toks}
        if tcfg.use_mrope:
            batch["pos"] = torch.arange(24)[None, :, None].expand(B, 24, 3)
        want, wc = ttr.prefill_forward(tcfg, tp, batch)
        assert cache["len"] == wc["len"] == 24
        assert_close_rel(lm_np(logits), lm_np(want), REL)
        for key in ("k", "v"):
            assert_close_rel(lm_np(cache[key]), lm_np(wc[key]), REL)


# ---------------------------------------------------------------------------
# The int8 KV cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma2-9b", "phi4-mini-3.8b",
                                  "qwen2-vl-2b"])
def test_int8_decode_equals_the_reference(models, jdecode, arch):
    """Four decode steps from an empty int8 cache: every int8 entry equal
    to the reference's, the scales and logits within 1e-4 of max."""
    jcfg, tcfg, jp, tp = models[arch]
    toks = _tokens(jcfg, B, 4, seed=9)
    pos = mrope_positions(B, 4, grid=1, start=1)
    wc = jtr.init_cache(jcfg, B, 6, dtype=jnp.float32, kv_quant=True)
    gc = ttr.init_cache(tcfg, B, 6, dtype=torch.float32, device="cpu",
                        kv_quant=True)
    for t in range(4):
        jb, tb = _batches(jcfg, toks[:, t:t + 1], pos[:, t:t + 1])
        want, wc = jdecode[arch](jp, wc, jb)
        got, gc = ttr.decode_step(tcfg, tp, gc, tb)
        assert_close_rel(lm_np(got), want, REL)
    for key in ("k", "v"):
        assert gc[key].dtype == torch.int8
        np.testing.assert_array_equal(gc[key].numpy(), np.asarray(wc[key]))
        assert_close_rel(lm_np(gc[key + "_scale"]), wc[key + "_scale"], REL)
    assert gc["len"] == int(wc["len"]) == 4


def test_int8_decode_close_to_float(models):
    """Twin of the reference's ``test_int8_decode_close_to_bf16`` in the
    port: int8 logits within rtol 0.1, atol 0.15 of the float cache's, and
    the greedy token mostly the same."""
    _, tcfg, _, tp = models["gemma2-9b"]
    toks = _t(_tokens(tcfg, B, 6, seed=2))

    def run(kv_quant):
        cache = ttr.init_cache(tcfg, B, 8, dtype=torch.float32, device="cpu",
                               kv_quant=kv_quant)
        outs = []
        for t in range(6):
            lg, cache = ttr.decode_step(tcfg, tp, cache,
                                        {"tokens": toks[:, t:t + 1]})
            outs.append(lg)
        return torch.stack(outs, 1).numpy()

    full, q8 = run(False), run(True)
    np.testing.assert_allclose(q8, full, rtol=0.1, atol=0.15)
    assert (q8.argmax(-1) == full.argmax(-1)).mean() >= 0.9


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_the_smoke_config_on_the_cpu(arch, capsys):
    tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu",
                  "--requests", "2", "--tokens", "3"])
    assert "2 requests x 3 tokens" in capsys.readouterr().out
