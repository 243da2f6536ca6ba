"""The port's encdec LM family (whisper-small) against the JAX package, on
the CPU: the encoder, cross-attention and its cache, learned positions,
the model and the engine.

The smoke config is cut to 3 encoder layers over its 2 decoder layers, so
that stacking ``enc_layers`` by the wrong count shows.  Weights come from
the reference's ``init_params`` (``lm_smoke_models``); tokens and the
encoder frames (random embeddings, as the reference's stub front end takes
them) from ``np.random.default_rng``.  The reference runs with
``REPRO_KERNELS=ref`` except in ``test_encoder``, where its Pallas flash
kernel runs in interpret mode (non-causal); the port runs on
``device="cpu"``, i.e. through the kernel's plain version.

Tolerance: in float32, 1e-4 relative to max|reference|.  Shapes, cache
lengths and greedy tokens are compared exactly.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import base as jbase
from repro.models import attention as jattn
from repro.models import schema as jschema
from repro.models import transformer as jtr
from repro.models.layers import ShardCtx
from repro.serve import engine as jengine

from repro_torch.configs import base as tbase
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import serve as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models import convert
from repro_torch.models import schema as tschema
from repro_torch.models import transformer as ttr
from repro_torch.serve import engine as tengine

from test_torch_helpers import (
    assert_close_rel, lm_cache_to_port, lm_np, lm_smoke_models,
)

CTX = ShardCtx()
REL = 1e-4
ARCH = "whisper-small"
ENC_LAYERS = 3
B, S, STEPS = 2, 10, 3


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def model():
    return lm_smoke_models(ARCH, encoder_layers=ENC_LAYERS)


@pytest.fixture(scope="module")
def data(model):
    """Tokens (B, S + STEPS) and frames (B, encoder_seq, D)."""
    jcfg = model[0]
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    frames = rng.standard_normal(
        (B, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)
    return toks, frames


@pytest.fixture(scope="module")
def reference(model, data):
    """The reference's ``prefill_forward`` of the first S tokens with the
    frames, room for STEPS more."""
    jcfg, _, jp, _ = model
    toks, frames = data
    return jtr.prefill_forward(
        jcfg, jp, {"tokens": jnp.asarray(toks[:, :S]),
                   "frames": jnp.asarray(frames)}, CTX, max_seq=S + STEPS)


# ---------------------------------------------------------------------------
# Schema, weights, cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke_cfg", [True, False], ids=["smoke", "full"])
def test_param_shapes_equal_the_reference(smoke_cfg):
    """Every leaf's shape: ``enc_pos`` (encoder_seq, D), ``dec_pos``
    (32,768, D), the ``x``-prefixed cross weights, ``enc_layers`` stacked by
    ``encoder_layers`` (here 3 against 2 decoder layers)."""
    get = "get_smoke_config" if smoke_cfg else "get_config"
    jcfg = dataclasses.replace(getattr(jbase, get)(ARCH),
                               encoder_layers=ENC_LAYERS)
    tcfg = dataclasses.replace(getattr(tbase, get)(ARCH),
                               encoder_layers=ENC_LAYERS)
    jshapes = jax.tree.map(lambda s: tuple(s.shape),
                           jschema.abstract_params(jcfg))
    tshapes = tschema.param_shapes(tcfg)
    assert tshapes == jshapes
    assert tshapes["enc_layers"]["wq"][0] == ENC_LAYERS
    assert tshapes["layers"]["xwq"][0] == tcfg.num_layers
    assert tshapes["dec_pos"] == (32_768, tcfg.d_model)


def test_params_from_numpy_carries_the_encdec_tree(model):
    jcfg, tcfg, jp, tp = model
    for path in (("enc_pos",), ("dec_pos",), ("enc_final_norm",),
                 ("enc_layers", "wq"), ("layers", "xwk"), ("layers", "ln_x")):
        got, want = tp, jp
        for k in path:
            got, want = got[k], want[k]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tree = jax.tree.map(np.asarray, jp)
    tree["enc_layers"] = jax.tree.map(lambda a: a[:2], tree["enc_layers"])
    with pytest.raises(ValueError, match="enc_layers"):
        convert.params_from_numpy(tcfg, tree, device="cpu")


def test_init_cache_equals_the_reference(model):
    jcfg, tcfg, _, _ = model
    want = jtr.init_cache(jcfg, 3, 20, dtype=jnp.bfloat16)
    got = ttr.init_cache(tcfg, 3, 20, dtype=torch.bfloat16, device="cpu")
    assert set(got) == set(want) == {"len", "k", "v", "xk", "xv"}
    for key in set(want) - {"len"}:
        assert tuple(got[key].shape) == want[key].shape, key
        assert got[key].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def test_cross_attention_equals_the_reference(model, data):
    """``attention(kv_x=, kv_pos=, causal=False)`` of decoder queries over
    the frames, with the cross K / V it returns."""
    jcfg, tcfg, jp, tp = model
    toks, frames = data
    rng = np.random.default_rng(3)
    h = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    jl = {k[1:]: v[0] for k, v in jp["layers"].items() if k[0] == "x"}
    tl = {k[1:]: v for k, v in ttr.layer_params(tp, 0).items()
          if k[0] == "x"}
    pos = np.broadcast_to(np.arange(S), (B, S))
    epos = np.broadcast_to(np.arange(jcfg.encoder_seq), frames.shape[:2])
    want, (wk, wv) = jattn.attention(
        jcfg, jl, jnp.asarray(h), jnp.asarray(pos), CTX, causal=False,
        kv_x=jnp.asarray(frames), kv_pos=jnp.asarray(epos), return_kv=True)
    got, (gk, gv) = tattn.attention(
        tcfg, tl, _t(h), _t(pos), causal=False, kv_x=_t(frames),
        kv_pos=_t(epos), return_kv=True)
    assert tuple(gk.shape) == (B, tcfg.padded_kv_heads, tcfg.encoder_seq,
                               tcfg.head_dim)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        assert_close_rel(lm_np(g), w, REL)
    # causal masking would hide frames from the first queries: it moves y
    causal = tattn.attention(tcfg, tl, _t(h), _t(pos), kv_x=_t(frames),
                             kv_pos=_t(epos))
    assert not torch.allclose(causal, got)


def test_decode_cross_attention_leaves_the_cache(model, data):
    """``decode_attention(update_cache=False)`` over a full cross cache:
    the reference's output, and the cache untouched."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(4)
    shape = (B, jcfg.padded_kv_heads, jcfg.encoder_seq, jcfg.head_dim)
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    pos = np.full((B, 1), 5, np.int32)
    jl = {k[1:]: v[0] for k, v in jp["layers"].items() if k[0] == "x"}
    tl = {k[1:]: v for k, v in ttr.layer_params(tp, 0).items()
          if k[0] == "x"}
    enc_len = jcfg.encoder_seq - 1
    want, _, _ = jattn.decode_attention(
        jcfg, jl, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(ck),
        jnp.asarray(cv), jnp.int32(enc_len), CTX, update_cache=False)
    tk, tv = _t(ck), _t(cv)
    got, gk, gv = tattn.decode_attention(tcfg, tl, _t(x), _t(pos).long(),
                                         tk, tv, enc_len, update_cache=False)
    assert_close_rel(lm_np(got), want, REL)
    assert gk is tk and np.array_equal(tk.numpy(), ck)
    assert np.array_equal(tv.numpy(), cv)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def test_encoder(model, data, monkeypatch):
    """The encoder over the frames: learned positions, 3 non-causal
    layers, the final norm; the reference's flash kernel in interpret
    mode."""
    monkeypatch.setenv("REPRO_KERNELS", "interpret")
    jcfg, tcfg, jp, tp = model
    frames = data[1]
    want = jtr.encoder(jcfg, jp, jnp.asarray(frames), CTX)
    got = ttr.encoder(tcfg, tp, _t(frames))
    assert got.shape == frames.shape
    assert_close_rel(lm_np(got), want, REL)


def test_forward_logits_with_frames(model, data):
    jcfg, tcfg, jp, tp = model
    toks, frames = data
    want, aux = jtr.forward_logits(
        jcfg, jp, {"tokens": jnp.asarray(toks[:, :S]),
                   "frames": jnp.asarray(frames)}, CTX)
    got, taux = ttr.forward_logits(
        tcfg, tp, {"tokens": _t(toks[:, :S]), "frames": _t(frames)})
    assert got.shape == (B, S, tcfg.padded_vocab)
    assert float(aux) == taux == 0.0
    assert_close_rel(lm_np(got), want, REL)


def test_prefill_forward_logits_and_cache(model, data, reference):
    """Last logits and the self (k, v) and cross (xk, xv) caches; every
    attention through the flash wrapper's plain version on the CPU."""
    _, tcfg, _, tp = model
    toks, frames = data
    want, wc = reference
    fa0 = tfa.launches
    got, gc = ttr.prefill_forward(
        tcfg, tp, {"tokens": _t(toks[:, :S]), "frames": _t(frames)},
        max_seq=S + STEPS)
    assert tfa.launches == fa0
    assert_close_rel(lm_np(got), want, REL)
    assert gc["len"] == int(wc["len"]) == S and set(gc) == set(wc)
    for key in ("k", "v", "xk", "xv"):
        assert tuple(gc[key].shape) == wc[key].shape, key
        assert_close_rel(lm_np(gc[key]), wc[key], REL)
    with pytest.raises(ValueError, match="encoder frames"):
        ttr.prefill_forward(tcfg, tp, {"tokens": _t(toks[:, :S]),
                                       "frames": _t(frames[:, :-1])})


def test_decode_steps_from_the_reference_cache(model, data, reference):
    """Three decode steps from the reference's prefill cache, each adding
    the learned position ``len`` (the reference's ``dec_pos[len]``):
    logits and the self cache after each, the cross cache unchanged."""
    jcfg, tcfg, jp, tp = model
    toks = data[0]
    wc = reference[1]
    gc = lm_cache_to_port(wc)
    xk0 = gc["xk"].clone()
    jdecode = jax.jit(lambda p, c, b: jtr.decode_step(jcfg, p, c, b, CTX))
    for t in range(S, S + STEPS):
        want, wc = jdecode(jp, wc, {"tokens": jnp.asarray(toks[:, t:t + 1])})
        got, gc = ttr.decode_step(tcfg, tp, gc,
                                  {"tokens": _t(toks[:, t:t + 1])})
        assert gc["len"] == int(wc["len"]) == t + 1
        assert_close_rel(lm_np(got), want, REL)
        for key in ("k", "v"):
            assert_close_rel(lm_np(gc[key]), wc[key], REL)
    assert torch.equal(gc["xk"], xk0)


def test_engine_prefill_cache_with_frames(model, data):
    """``engine.prefill_cache(frames=)``: the encoder, the cross cache from
    the float32 ``xwk`` / ``xwv``, then the prompt token by token."""
    jcfg, tcfg, jp, tp = model
    toks, frames = data
    scfg = dict(max_seq=S + 2)
    wc, wl = jengine.prefill_cache(jcfg, jp, jnp.asarray(toks[:, :S]), CTX,
                                   jengine.ServeConfig(**scfg),
                                   frames=jnp.asarray(frames))
    gc, gl = tengine.prefill_cache(tcfg, tp, _t(toks[:, :S]),
                                   tengine.ServeConfig(**scfg),
                                   frames=_t(frames))
    assert_close_rel(lm_np(gl), wl, REL)
    assert gc["len"] == int(wc["len"]) == S
    for key in ("k", "v", "xk", "xv"):
        assert_close_rel(lm_np(gc[key]), wc[key], REL)
    # and the whole-prompt prefill fills the same cache (what
    # chip_smoke.py holds on the card)
    want, pc = ttr.prefill_forward(
        tcfg, tp, {"tokens": _t(toks[:, :S]), "frames": _t(frames)},
        max_seq=S + 2)
    assert_close_rel(lm_np(gl), lm_np(want), REL)
    for key in ("k", "v", "xk", "xv"):
        assert_close_rel(lm_np(gc[key]), lm_np(pc[key]), REL)


def test_generate_without_frames_raises(model, data, capsys):
    """``generate`` takes no frames: the port raises a ``ValueError``
    naming them, where the reference stops at its assert; so does the
    launcher."""
    jcfg, tcfg, jp, tp = model
    prompts = data[0][:, :4]
    with pytest.raises(AssertionError):
        jengine.generate(jcfg, jp, jnp.asarray(prompts), CTX,
                         jengine.ServeConfig(max_seq=8), 2)
    with pytest.raises(ValueError, match="frames"):
        tengine.generate(tcfg, tp, _t(prompts), tengine.ServeConfig(max_seq=8),
                         2)
    with pytest.raises(ValueError, match="frames"):
        tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--requests", "1", "--tokens", "2"])
