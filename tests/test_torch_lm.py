"""The port's LM serving slice, the hybrid family (zamba2), against the
JAX package, on the CPU (the ssm, dense and vlm families:
``test_torch_lm_ssm.py``, ``test_torch_lm_dense.py``).

Weights come from the reference's ``init_params`` and are carried over
with ``models.convert.params_from_numpy``; tokens are made with
``np.random.default_rng``.  The reference runs its Pallas kernels in
interpret mode where the test says so (``REPRO_KERNELS=interpret``), the
port runs on ``device="cpu"``, i.e. through the kernels' plain versions.

Tolerance: in float32, 1e-4 relative to max|reference| (measured about
2e-6 at these sizes; the float32 sums are taken in another order: matrix
product blocking, the chunked scan against the sequential recurrence, the
online softmax against the direct one).  Greedy tokens, cache lengths,
configs, schemas and the padding of requests are compared exactly.
"""
import dataclasses
import subprocess
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import base as jbase
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import schema as jschema
from repro.models import ssm as jssm
from repro.models import transformer as jtr
from repro.models.layers import ShardCtx
from repro.serve import engine as jengine

from repro_torch.configs import base as tbase
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ssd_scan as tss
from repro_torch.launch import serve as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models import convert
from repro_torch.models import layers as tlayers
from repro_torch.models import schema as tschema
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr
from repro_torch.serve import engine as tengine

from conftest import REPO
from test_torch_helpers import assert_close_rel

ARCH = "zamba2-2.7b"
CTX = ShardCtx()
REL = 1e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def smoke():
    """(reference config, port config, reference params, port params) of
    zamba2-smoke in float32."""
    jcfg = dataclasses.replace(jbase.get_smoke_config(ARCH), dtype="float32")
    tcfg = dataclasses.replace(tbase.get_smoke_config(ARCH), dtype="float32")
    jp = jschema.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    return jcfg, tcfg, jp, tp


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _hidden(b, s, d, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


def _layer(tree, i):
    return {k: v[i] for k, v in tree["layers"].items()}


# ---------------------------------------------------------------------------
# Configs and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_configs_equal_the_reference(arch):
    """The port's copies of the ten architecture modules: every field and
    the derived shapes, published and smoke."""
    for get in ("get_config", "get_smoke_config"):
        j = getattr(jbase, get)(arch)
        t = getattr(tbase, get)(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        for prop in ("padded_vocab", "padded_heads", "padded_kv_heads",
                     "ssm_inner", "ssm_heads", "is_encdec", "attn_free",
                     "sub_quadratic"):
            assert getattr(j, prop) == getattr(t, prop), prop
        assert j.param_count() == t.param_count()
        assert j.active_param_count() == t.active_param_count()
    assert (tbase.TP_AXIS, tbase.VOCAB_PAD, tbase.ARCH_IDS) == \
        (jbase.TP_AXIS, jbase.VOCAB_PAD, jbase.ARCH_IDS)


@pytest.mark.parametrize("smoke_cfg", [True, False])
def test_param_shapes_equal_the_reference(smoke_cfg):
    """Every leaf's shape, published (2.42e9 parameters, not allocated) and
    smoke (Q heads padded to 16 with structural heads)."""
    get = "get_smoke_config" if smoke_cfg else "get_config"
    jshapes = jax.tree.map(lambda s: tuple(s.shape), jschema.abstract_params(
        getattr(jbase, get)(ARCH)))
    tshapes = tschema.param_shapes(getattr(tbase, get)(ARCH))
    assert jshapes == tshapes


def test_init_params_shapes_and_deterministic_leaves():
    """The port's own init: the reference's shapes and dtype; ones and
    zeros exactly; ``a_log`` and ``dt_bias`` (log / exp / expm1 of the same
    float32 linspace) within 2 ulp, as XLA's and PyTorch's float32
    transcendentals differ in the last bits; random leaves drawn anew."""
    cfg = tbase.get_smoke_config(ARCH)
    jcfg = jbase.get_smoke_config(ARCH)
    jp = jax.tree.map(np.asarray, jschema.init_params(jcfg,
                                                      jax.random.PRNGKey(0)))
    tp = tschema.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == len(jax.tree.leaves(tp))
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        got = tp
        for k in keys:
            got = got[k]
        assert tuple(got.shape) == leaf.shape and got.dtype == torch.float32
        name = keys[-1]
        if name in ("a_log", "dt_bias"):
            np.testing.assert_array_max_ulp(got.numpy(), leaf, maxulp=2)
        elif np.all(leaf == leaf.flat[0]) and leaf.flat[0] in (0.0, 1.0):
            np.testing.assert_array_equal(got.numpy(), leaf)
    again = tschema.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["layers"]["wx"], tp["layers"]["wx"])
    assert tschema.param_count_actual(tp) == sum(
        x.size for x in jax.tree.leaves(jp))


def test_params_from_numpy_checks_every_shape(smoke):
    jcfg, tcfg, jp, tp = smoke
    tree = jax.tree.map(np.asarray, jp)
    assert torch.equal(tp["shared_attn"]["wq"],
                       _t(tree["shared_attn"]["wq"]))
    bad = dict(tree, shared_attn=dict(tree["shared_attn"],
                                      wq=tree["shared_attn"]["wq"][:, :4]))
    with pytest.raises(ValueError, match="shared_attn/wq"):
        convert.params_from_numpy(tcfg, bad, device="cpu")
    missing = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(ValueError, match="keys"):
        convert.params_from_numpy(tcfg, missing, device="cpu")


# ---------------------------------------------------------------------------
# Layers and blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm(plus_one):
    x = _hidden(2, 5, 64)
    w = np.random.default_rng(3).standard_normal(64).astype(np.float32)
    want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), eps=1e-5,
                            plus_one=plus_one)
    got = tlayers.rms_norm(_t(x), _t(w), eps=1e-5, plus_one=plus_one)
    assert_close_rel(_np(got), want, 1e-6)


def test_apply_rope():
    x = np.random.default_rng(4).standard_normal((2, 7, 3, 16)).astype(
        np.float32)
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = tlayers.apply_rope(_t(x), _t(pos), 10_000.0)
    assert_close_rel(_np(got), want, 1e-5)


def test_attention_with_kv(smoke, monkeypatch):
    """The prefill attention block, the reference through its Pallas
    kernel (interpret), the port through the kernel's plain version."""
    monkeypatch.setenv("REPRO_KERNELS", "interpret")
    jcfg, tcfg, jp, tp = smoke
    x = _hidden(2, 128, jcfg.d_model)
    pos = np.broadcast_to(np.arange(128)[None], (2, 128)).astype(np.int32)
    want, (wk, wv) = jattn.attention(jcfg, jp["shared_attn"], jnp.asarray(x),
                                     jnp.asarray(pos), CTX, return_kv=True)
    got, (gk, gv) = tattn.attention(tcfg, tp["shared_attn"], _t(x),
                                    _t(pos).long(), return_kv=True)
    assert gk.shape == wk.shape == (2, tcfg.padded_kv_heads, 128,
                                    tcfg.head_dim)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        assert_close_rel(_np(g), w, REL)


def test_long_prefill_attention_goes_through_the_kernel_wrapper(smoke,
                                                                monkeypatch):
    """At s * s >= 2048**2 the reference leaves its kernel for a plain
    chunked version; the port still calls ``ops.flash_attention`` (the
    kernel on the card), once, with the whole sequence, and agrees with
    the reference's chunked branch."""
    from repro_torch.kernels import ops as tops
    jcfg, tcfg, jp, tp = smoke
    s = 2048
    calls = []
    real = tops.flash_attention

    def spy(q, k, v, **kw):
        calls.append(tuple(q.shape))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tops, "flash_attention", spy)
    x = _hidden(1, s, jcfg.d_model)
    pos = np.arange(s)[None].astype(np.int32)
    want = jattn.attention(jcfg, jp["shared_attn"], jnp.asarray(x),
                           jnp.asarray(pos), CTX)
    got = tattn.attention(tcfg, tp["shared_attn"], _t(x), _t(pos).long())
    assert calls == [(1, tcfg.padded_heads, s, tcfg.head_dim)]
    assert_close_rel(_np(got), want, REL)


def test_decode_attention(smoke):
    jcfg, tcfg, jp, tp = smoke
    b, smax, clen = 2, 12, 7
    rng = np.random.default_rng(5)
    shape = (b, jcfg.padded_kv_heads, smax, jcfg.head_dim)
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    x = _hidden(b, 1, jcfg.d_model)
    pos = np.full((b, 1), clen, np.int32)
    want, wk, wv = jattn.decode_attention(
        jcfg, jp["shared_attn"], jnp.asarray(x), jnp.asarray(pos),
        jnp.asarray(ck), jnp.asarray(cv), jnp.int32(clen), CTX)
    tk, tv = _t(ck), _t(cv)
    got, gk, gv = tattn.decode_attention(tcfg, tp["shared_attn"], _t(x),
                                         _t(pos).long(), tk, tv, clen)
    assert gk is tk and gv is tv          # written in place
    assert_close_rel(_np(got), want, REL)
    assert_close_rel(_np(gk), wk, REL)
    assert_close_rel(_np(gv), wv, REL)
    with pytest.raises(ValueError, match="outside the cache"):
        tattn.decode_attention(tcfg, tp["shared_attn"], _t(x),
                               _t(pos).long(), tk, tv, smax)


@pytest.mark.parametrize("s", [128, 13])
def test_ssm_block_with_state(smoke, monkeypatch, s):
    """s = 128 takes the reference's Pallas kernel (interpret); s = 13 its
    sequential oracle (13 % 128 != 0)."""
    monkeypatch.setenv("REPRO_KERNELS", "interpret")
    jcfg, tcfg, jp, tp = smoke
    x = _hidden(2, s, jcfg.d_model)
    want = jssm.ssm_block(jcfg, _layer(jp, 1), jnp.asarray(x), CTX,
                          return_state=True)
    got = tssm.ssm_block(tcfg, _layer(tp, 1), _t(x), return_state=True)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert_close_rel(_np(g), w, REL)


def test_ssm_decode(smoke):
    jcfg, tcfg, jp, tp = smoke
    rng = np.random.default_rng(6)
    conv_c = jcfg.ssm_inner + 2 * jcfg.ssm_groups * jcfg.ssm_state
    conv = rng.standard_normal((2, jcfg.ssm_conv_width - 1, conv_c)).astype(
        np.float32)
    st = rng.standard_normal((2, jcfg.ssm_heads, jcfg.ssm_head_dim,
                              jcfg.ssm_state)).astype(np.float32)
    x = _hidden(2, 1, jcfg.d_model)
    want = jssm.ssm_decode(jcfg, _layer(jp, 2), jnp.asarray(x),
                           jnp.asarray(conv), jnp.asarray(st), CTX)
    got = tssm.ssm_decode(tcfg, _layer(tp, 2), _t(x), _t(conv), _t(st))
    for g, w in zip(got, want):
        assert_close_rel(_np(g), w, REL)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def test_prefill_forward_logits_and_cache(smoke, monkeypatch):
    """The slice's prefill at s = 128: the reference through both Pallas
    kernels (interpret), the port through their plain versions; last
    logits and every cache entry."""
    monkeypatch.setenv("REPRO_KERNELS", "interpret")
    jcfg, tcfg, jp, tp = smoke
    toks = _tokens(jcfg, 2, 128)
    want, wc = jtr.prefill_forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                   CTX, max_seq=136)
    fa0, ss0 = tfa.launches, tss.launches
    got, gc = ttr.prefill_forward(tcfg, tp, {"tokens": _t(toks)},
                                  max_seq=136)
    assert (tfa.launches, tss.launches) == (fa0, ss0)   # CPU: plain versions
    assert got.dtype == torch.float32
    assert_close_rel(_np(got), want, REL)
    assert gc["len"] == int(wc["len"]) == 128
    assert set(gc) == set(wc)
    for key in ("conv", "ssm", "k", "v"):
        assert tuple(gc[key].shape) == wc[key].shape, key
        assert_close_rel(_np(gc[key]), wc[key], REL)


def test_prefill_forward_bf16_runs_in_bf16(monkeypatch):
    """The config's own dtype: caches and activations in bf16, logits in
    float32, held loosely to the reference (bf16 rounds at other places in
    the two frameworks: 5e-2 of max|logits|, measured 2.5e-2)."""
    monkeypatch.setenv("REPRO_KERNELS", "interpret")
    jcfg = jbase.get_smoke_config(ARCH)
    tcfg = tbase.get_smoke_config(ARCH)
    jp = jschema.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    toks = _tokens(jcfg, 2, 128, seed=3)
    want, wc = jtr.prefill_forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                   CTX)
    got, gc = ttr.prefill_forward(tcfg, tp, {"tokens": _t(toks)})
    assert got.dtype == torch.float32
    assert gc["k"].dtype == torch.bfloat16 and gc["ssm"].dtype == torch.float32
    assert_close_rel(_np(got), want, 5e-2)


def test_forward_logits(smoke):
    jcfg, tcfg, jp, tp = smoke
    toks = _tokens(jcfg, 2, 24, seed=1)
    want, aux = jtr.forward_logits(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                   CTX)
    got, taux = ttr.forward_logits(tcfg, tp, {"tokens": _t(toks)})
    assert got.shape == (2, 24, tcfg.padded_vocab)
    assert float(aux) == taux == 0.0
    assert_close_rel(_np(got), want, REL)


def test_decode_step_from_the_reference_cache(smoke):
    """Three decode steps from one prefilled cache, the reference's cache
    carried over: logits and every cache entry after each step."""
    jcfg, tcfg, jp, tp = smoke
    toks = _tokens(jcfg, 2, 9, seed=2)
    _, wc = jtr.prefill_forward(jcfg, jp, {"tokens": jnp.asarray(toks[:, :6])},
                                CTX, max_seq=9)
    gc = {k: (int(v) if k == "len" else _t(v)) for k, v in wc.items()}
    for t in range(6, 9):
        want, wc = jtr.decode_step(jcfg, jp, wc,
                                   {"tokens": jnp.asarray(toks[:, t:t + 1])},
                                   CTX)
        before = gc
        got, gc = ttr.decode_step(tcfg, tp, gc, {"tokens": _t(toks[:, t:t + 1])})
        assert gc is before          # one handle, advanced in place
        assert gc["len"] == int(wc["len"]) == t + 1
        assert_close_rel(_np(got), want, REL)
        for key in ("conv", "ssm", "k", "v"):
            assert_close_rel(_np(gc[key]), wc[key], REL)


def test_decode_matches_full_forward(smoke):
    """Twin of the reference's test for the hybrid family: sequential
    decode with the cache equals the full forward (teacher forcing), and
    equals the reference's decode."""
    jcfg, tcfg, jp, tp = smoke
    s = 10
    toks = _tokens(jcfg, 2, s, seed=1)
    full, _ = ttr.forward_logits(tcfg, tp, {"tokens": _t(toks)})
    cache = ttr.init_cache(tcfg, 2, s, dtype=torch.float32, device="cpu")
    outs = []
    for t in range(s):
        lg, cache = ttr.decode_step(tcfg, tp, cache,
                                    {"tokens": _t(toks[:, t:t + 1])})
        outs.append(lg)
    dec = torch.stack(outs, dim=1)
    np.testing.assert_allclose(_np(dec), _np(full), rtol=1e-3, atol=1e-3)
    jfull, _ = jtr.forward_logits(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                  CTX)
    assert_close_rel(_np(dec), jfull, REL)


def test_init_cache_equals_the_reference(smoke):
    jcfg, tcfg, _, _ = smoke
    want = jtr.init_cache(jcfg, 3, 20, dtype=jnp.bfloat16)
    got = ttr.init_cache(tcfg, 3, 20, dtype=torch.bfloat16, device="cpu")
    assert set(got) == set(want) and got["len"] == int(want["len"]) == 0
    for key in ("conv", "ssm", "k", "v"):
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)
        assert not got[key].any()


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def test_generate_greedy_tokens_equal_the_reference(smoke):
    """Left-padded requests of 2-11 tokens, 8 greedy tokens each: the same
    tokens as the reference (whose padding is not masked either)."""
    jcfg, tcfg, jp, tp = smoke
    rng = np.random.default_rng(0)
    reqs = [list(rng.integers(1, jcfg.vocab_size, size=rng.integers(2, 12)))
            for _ in range(3)]
    prompts, _ = jengine.batch_requests(reqs)
    scfg_j = jengine.ServeConfig(max_seq=prompts.shape[1] + 8)
    scfg_t = tengine.ServeConfig(max_seq=prompts.shape[1] + 8)
    want = jengine.generate(jcfg, jp, jnp.asarray(prompts), CTX, scfg_j, 8)
    got = tengine.generate(tcfg, tp, _t(prompts), scfg_t, 8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_cache_equals_prefill_forward(smoke):
    """The engine's token-by-token prefill and the whole-prompt prefill
    fill the same cache (what chip_smoke.py holds on the card)."""
    _, tcfg, _, tp = smoke
    toks = _t(_tokens(tcfg, 2, 16, seed=4))
    cache, logits = tengine.prefill_cache(
        tcfg, tp, toks, tengine.ServeConfig(max_seq=16))
    want, wc = ttr.prefill_forward(tcfg, tp, {"tokens": toks})
    assert cache["len"] == wc["len"] == 16
    assert_close_rel(_np(logits), _np(want), REL)
    for key in ("conv", "ssm", "k", "v"):
        assert_close_rel(_np(cache[key]), _np(wc[key]), REL)


def test_generate_with_temperature_is_seeded(smoke):
    _, tcfg, _, tp = smoke
    prompts = _t(_tokens(tcfg, 2, 4, seed=5))
    scfg = tengine.ServeConfig(max_seq=12, temperature=0.8, seed=3)
    a = tengine.generate(tcfg, tp, prompts, scfg, 8)
    b = tengine.generate(tcfg, tp, prompts, scfg, 8,
                         generator=torch.Generator().manual_seed(3))
    c = tengine.generate(tcfg, tp, prompts, scfg, 8,
                         generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < tcfg.vocab_size


@pytest.mark.parametrize("lists", [[[5, 6, 7], [8]], [[1, 2], [3, 4]],
                                   [[9] * 11, [1, 2, 3], [4]]])
def test_batch_requests_equal_the_reference(lists):
    want = jengine.batch_requests(lists, pad_id=0)
    got = tengine.batch_requests(lists, pad_id=0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    with pytest.raises(ValueError):
        tengine.batch_requests([])


def test_launcher_serves_the_smoke_config_on_the_cpu(capsys):
    one = tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--requests", "2", "--tokens", "3"])
    out = capsys.readouterr().out.splitlines()
    assert "2 requests x 3 tokens" in out[0] and out[0].endswith(
        "mesh (1, 1)")
    assert out[1] == f"tokens: {one.tolist()}" and one.shape == (2, 3)
    # --model-parallel 2 in one process plans the (1, 1) mesh, as the
    # reference does on one device, logs it, and serves the same tokens
    two = tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--requests", "2", "--tokens", "3",
                        "--model-parallel", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "mesh: (1, 1) ('data', 'model') (0 devices idle)"
    assert "2 requests x 3 tokens" in out[1] and out[1].endswith(
        "mesh (1, 1)")
    assert torch.equal(one, two)
    # ... which are engine.generate's without a mesh on the same requests
    cfg = tbase.get_smoke_config(ARCH)
    rng = np.random.default_rng(0)
    prompts, _ = tengine.batch_requests(
        [list(rng.integers(1, cfg.vocab_size, size=rng.integers(2, 12)))
         for _ in range(2)])
    want = tengine.generate(
        cfg, tschema.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu"),
        torch.from_numpy(prompts),
        tengine.ServeConfig(max_seq=prompts.shape[1] + 3, temperature=0.8),
        3)
    assert torch.equal(one, want)


# ---------------------------------------------------------------------------
# Guards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_every_family_runs_on_the_cpu(arch):
    """Every config the repo ships, at smoke size with the port's own
    weights: the schema, the cache, ``forward_logits``, ``prefill_forward``
    and a ``decode_step`` run and give finite logits of the padded vocab
    (each family is held against the reference in its own file).  A
    family the port does not know raises."""
    cfg = tbase.get_smoke_config(arch)
    assert cfg.family in tschema.PORTED_FAMILIES
    params = tschema.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert set(tschema.param_schema(cfg)) == set(params)
    b, s = 2, 5
    batch = {"tokens": torch.arange(b * s, dtype=torch.int32).reshape(b, s)}
    if cfg.use_mrope:
        batch["pos"] = torch.arange(s)[None, :, None].expand(b, s, 3)
    if cfg.is_encdec:
        batch["frames"] = torch.randn(
            (b, cfg.encoder_seq, cfg.d_model),
            generator=torch.Generator().manual_seed(1))
    cache = ttr.init_cache(cfg, b, s + 1, device="cpu")
    assert cache["len"] == 0
    assert all(v.shape[1] == b for k, v in cache.items() if k != "len")
    logits, aux = ttr.forward_logits(cfg, params, batch)
    assert logits.shape == (b, s, cfg.padded_vocab)
    assert torch.isfinite(logits).all() and np.isfinite(float(aux))
    last, cache = ttr.prefill_forward(cfg, params, batch, max_seq=s + 1)
    step = {"tokens": batch["tokens"][:, :1]}
    if cfg.use_mrope:
        step["pos"] = batch["pos"][:, :1] + s
    nxt, cache = ttr.decode_step(cfg, params, cache, step)
    for out in (last, nxt):
        assert out.shape == (b, cfg.padded_vocab) and torch.isfinite(out).all()
    assert cache["len"] == s + 1
    other = dataclasses.replace(cfg, family="retnet")
    with pytest.raises(NotImplementedError, match="retnet"):
        ttr.forward_logits(other, params, batch)


def test_a_cuda_request_without_cuda_raises(monkeypatch):
    """The entry points default to the GPU and never fall back to the
    CPU; the kernel wrappers raise for a device they have no kernel for,
    before any launch is counted.  On ``meta`` (the dry run) they return
    the kernel's shapes, count no launch and never reach the plain
    version."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tbase.get_smoke_config(ARCH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tschema.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        tschema.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_numpy(cfg, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--arch", ARCH, "--smoke"])
    before = (tfa.launches, tss.launches)

    def plain(*args, **kwargs):
        raise AssertionError("a meta tensor reached the plain version")

    monkeypatch.setattr(tfa, "flash_attention_ref", plain)
    monkeypatch.setattr(tss, "ssd_scan_ref", plain)
    q = torch.zeros((1, 2, 4, 16), device="meta")
    assert tfa.flash_attention(q, q, q).device.type == "meta"
    x = torch.zeros((1, 8, 2, 16), device="meta")
    dt = torch.zeros((1, 8, 2), device="meta")
    a = torch.zeros((2,), device="meta")
    bc = torch.zeros((1, 8, 1, 16), device="meta")
    y, h = tss.ssd_scan(x, dt, a, bc, bc)
    assert y.shape == x.shape and h.device.type == "meta"
    other = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(RuntimeError, match="unsupported device"):
        tfa._forward(other, q, q, True, 0, 0.0, 1.0, False)
    with pytest.raises(RuntimeError, match="unsupported device"):
        tss._forward(other, x, dt, a, bc)
    assert (tfa.launches, tss.launches) == before


def test_the_launcher_runs_as_a_module():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--requests", "1", "--tokens", "2"],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": f"{REPO}/src", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "1 requests x 2 tokens" in out.stdout
