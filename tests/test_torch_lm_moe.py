"""The port's moe LM family (phi3.5-moe, qwen3-moe) against the JAX
package, on the CPU: capacity, routing, dropping, the model, its int8 KV
cache and the engine.

Weights come from the reference's ``init_params`` (``lm_smoke_models``);
tokens and hidden states from ``np.random.default_rng``.  The reference
runs with ``REPRO_KERNELS=ref`` except in ``test_forward_logits``, where
its Pallas flash kernel runs in interpret mode; the port runs on
``device="cpu"``, i.e. through the kernel's plain version.

Tolerance: in float32, 1e-4 relative to max|reference| (the sums are
taken in another order); routing gates and the load-balance loss 1e-6.
Expert indices, queue places, dropped sets, capacities, greedy tokens and
int8 cache entries are compared exactly.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import base as jbase
from repro.models import moe as jmoe
from repro.models import schema as jschema
from repro.models import transformer as jtr
from repro.models.layers import ShardCtx
from repro.serve import engine as jengine

from repro_torch.configs import base as tbase
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import serve as tlaunch
from repro_torch.models import moe as tmoe
from repro_torch.models import schema as tschema
from repro_torch.models import transformer as ttr
from repro_torch.serve import engine as tengine

from test_torch_helpers import (
    assert_close_rel, lm_cache_to_port, lm_np, lm_smoke_models,
)

CTX = ShardCtx()
REL = 1e-4
ARCHS = ["phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b"]
B, S, STEPS = 2, 24, 3


def _t(x):
    return torch.from_numpy(np.array(x))


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _hidden(cfg, b, s, seed=1):
    """Hidden states with a shared offset row, as a trunk's have: the
    router then favours some experts, and capacity bites."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, cfg.d_model)) \
        + 2.0 * rng.standard_normal(cfg.d_model)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def models():
    return {arch: lm_smoke_models(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def jdecode(models):
    return {arch: jax.jit(lambda p, c, b, cfg=m[0]: jtr.decode_step(
        cfg, p, c, b, CTX)) for arch, m in models.items()}


@pytest.fixture(scope="module")
def reference(models):
    """Per arch: the prompt (B, S + STEPS) and the reference's
    ``prefill_forward`` of the first S tokens, room for STEPS more."""
    out = {}
    for arch, (jcfg, _, jp, _) in models.items():
        toks = _tokens(jcfg, B, S + STEPS, seed=len(arch))
        logits, cache = jtr.prefill_forward(
            jcfg, jp, {"tokens": jnp.asarray(toks[:, :S])}, CTX,
            max_seq=S + STEPS)
        out[arch] = (toks, logits, cache)
    return out


# ---------------------------------------------------------------------------
# Capacity, routing, dropping
# ---------------------------------------------------------------------------

def test_capacity_equals_the_reference():
    """``_capacity`` over a grid of (E, K, capacity factor, tokens), both
    clamps (at least 1 slot, at most t * K) among the cases."""
    clamps = set()
    for e, k in ((4, 1), (4, 2), (16, 2), (128, 8)):
        for cf in (0.0, 0.3, 1.0, 1.25, 8.0, 100.0):
            for t in (1, 3, 7, 24, 2048):
                over = dict(num_experts=e, experts_per_token=k,
                            capacity_factor=cf)
                jc = dataclasses.replace(
                    jbase.get_smoke_config(ARCHS[0]), **over)
                tc = dataclasses.replace(
                    tbase.get_smoke_config(ARCHS[0]), **over)
                got = tmoe._capacity(tc, t)
                assert got == jmoe._capacity(jc, t), (e, k, cf, t)
                assert isinstance(got, int)
                if got == 1 and cf == 0.0:
                    clamps.add("low")
                if got == t * k:
                    clamps.add("high")
    assert clamps == {"low", "high"}


@pytest.mark.parametrize("arch", ARCHS)
def test_route_equals_the_reference(models, arch):
    jcfg, tcfg, jp, tp = models[arch]
    x = _hidden(jcfg, 1, 40)[0]
    router = np.asarray(jp["layers"]["router"][0])
    gates, idx, aux = jmoe._route(jcfg, jnp.asarray(router), jnp.asarray(x))
    tg, ti, ta = tmoe._route(tcfg, _t(router), _t(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(idx))
    assert_close_rel(lm_np(tg), gates, 1e-6)
    assert ta.shape == () and ta.dtype == torch.float32
    assert abs(float(ta) - float(aux)) <= 1e-6 * abs(float(aux))


@pytest.mark.parametrize("arch", ARCHS)
def test_route_ties_keep_the_lower_expert(models, arch):
    """A zero router makes every probability equal: the top K are experts
    0..K-1, as ``lax.top_k`` keeps them, with equal gates."""
    jcfg, tcfg, _, _ = models[arch]
    x = _hidden(jcfg, 1, 9)[0]
    zero = np.zeros((jcfg.d_model, jcfg.num_experts), np.float32)
    k = jcfg.experts_per_token
    want = np.broadcast_to(np.arange(k), (9, k))
    _, idx, _ = jmoe._route(jcfg, jnp.asarray(zero), jnp.asarray(x))
    gates, ti, _ = tmoe._route(tcfg, _t(zero), _t(x))
    np.testing.assert_array_equal(np.asarray(idx), want)
    np.testing.assert_array_equal(ti.numpy(), want)
    assert torch.equal(gates, torch.full((9, k), 1.0 / k))


def _numpy_places(idx: np.ndarray, e: int) -> np.ndarray:
    """Each (token, k)'s place in its expert's queue, over the flattened
    (T * K) order: a one-hot cumsum in numpy."""
    flat = idx.reshape(-1)
    oh = np.eye(e, dtype=np.int64)[flat]
    return (np.cumsum(oh, axis=0) - 1)[np.arange(flat.size), flat]


@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_drops_as_the_reference(models, arch, cf):
    """``moe_block`` of layer 0 at three capacity factors: y and the loss
    against the reference; the port's slots against a numpy one-hot
    cumsum, exactly; some (token, k) dropped at 0.5 and 1.25, none at the
    no-drop factor 8.0 (>= E / K)."""
    jcfg, tcfg, jp, tp = models[arch]
    jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
    tcfg = dataclasses.replace(tcfg, capacity_factor=cf)
    x = _hidden(jcfg, B, S, seed=3)
    jl = {k: v[0] for k, v in jp["layers"].items()}
    tl = ttr.layer_params(tp, 0)
    want, waux = jmoe.moe_block(jcfg, jl, jnp.asarray(x), CTX)
    got, gaux = tmoe.moe_block(tcfg, tl, _t(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    assert_close_rel(lm_np(got), want, REL)
    assert abs(float(gaux) - float(waux)) <= 1e-6 * abs(float(waux))

    _, idx, _ = tmoe._route(tcfg, tl["router"], _t(x).reshape(B * S, -1))
    slot, valid, cap = tmoe._slots(tcfg, idx)
    places = _numpy_places(idx.numpy(), tcfg.num_experts)
    flat = idx.numpy().reshape(-1)
    assert cap == jmoe._capacity(jcfg, B * S)
    np.testing.assert_array_equal(valid.numpy(), places < cap)
    np.testing.assert_array_equal(
        slot.numpy(), np.where(places < cap, flat * cap + places,
                               tcfg.num_experts * cap))
    dropped = int((~valid).sum())
    assert (dropped > 0) == (cf < 8.0), (cf, dropped)
    # y from every expert's FFN on every token, summed over the kept
    # (token, k) pairs only: a dropped pair contributes zero
    gates, _, _ = tmoe._route(tcfg, tl["router"], _t(x).reshape(B * S, -1))
    xf = _t(x).reshape(B * S, 1, -1).double()
    g = torch.einsum("tod,edf->tef", xf, tl["w_gate"].double())
    u = torch.einsum("tod,edf->tef", xf, tl["w_up"].double())
    outs = torch.einsum("tef,efd->ted", torch.nn.functional.silu(g) * u,
                        tl["w_down"].double())             # (T, E, D)
    k = tcfg.experts_per_token
    picked = outs.gather(1, idx[:, :, None].expand(-1, -1, outs.shape[-1]))
    keep = (gates.double() * valid.reshape(-1, k))[:, :, None]
    oracle = (picked * keep).sum(1).reshape(x.shape)
    assert_close_rel(lm_np(got), oracle.numpy(), REL)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke_cfg", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_equal_the_reference(arch, smoke_cfg):
    """Every leaf's shape, the published configs not allocated (qwen3-moe:
    94 layers of 128 experts)."""
    get = "get_smoke_config" if smoke_cfg else "get_config"
    jshapes = jax.tree.map(lambda s: tuple(s.shape), jschema.abstract_params(
        getattr(jbase, get)(arch)))
    assert tschema.param_shapes(getattr(tbase, get)(arch)) == jshapes


def test_params_from_numpy_carries_the_moe_tree(models):
    """The reference's moe tree carried over leaf for leaf (router and the
    (E, D, F) / (E, F, D) expert stacks), and a mis-shaped leaf refused."""
    from repro_torch.models import convert
    jcfg, tcfg, jp, tp = models[ARCHS[0]]
    for name in ("router", "w_gate", "w_up", "w_down", "wq"):
        np.testing.assert_array_equal(tp["layers"][name].numpy(),
                                      np.asarray(jp["layers"][name]))
    assert tp["layers"]["w_down"].shape == (
        tcfg.num_layers, tcfg.num_experts, tcfg.d_ff, tcfg.d_model)
    tree = jax.tree.map(np.asarray, jp)
    tree["layers"]["router"] = tree["layers"]["router"][:, :, :-1]
    with pytest.raises(ValueError, match="layers/router"):
        convert.params_from_numpy(tcfg, tree, device="cpu")


@pytest.mark.parametrize("kv_quant", [False, True], ids=["float", "int8"])
def test_init_cache_equals_the_reference(models, kv_quant):
    jcfg, tcfg, _, _ = models[ARCHS[1]]
    want = jtr.init_cache(jcfg, 3, 20, dtype=jnp.bfloat16, kv_quant=kv_quant)
    got = ttr.init_cache(tcfg, 3, 20, dtype=torch.bfloat16, device="cpu",
                         kv_quant=kv_quant)
    assert set(got) == set(want) and got["len"] == 0
    for key in set(want) - {"len"}:
        assert tuple(got[key].shape) == want[key].shape, key
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits(models, reference, arch, monkeypatch):
    """Logits and the aux loss (mean over layers x 0.01), the reference's
    flash kernel in interpret mode."""
    monkeypatch.setenv("REPRO_KERNELS", "interpret")
    jcfg, tcfg, jp, tp = models[arch]
    toks = reference[arch][0][:, :S]
    want, aux = jtr.forward_logits(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                   CTX)
    got, taux = ttr.forward_logits(tcfg, tp, {"tokens": _t(toks)})
    assert got.shape == (B, S, tcfg.padded_vocab)
    assert_close_rel(lm_np(got), want, REL)
    assert taux.shape == () and taux.dtype == torch.float32
    assert float(aux) > 0
    assert abs(float(taux) - float(aux)) <= 1e-6 * float(aux)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_forward_logits_and_cache(models, reference, arch):
    jcfg, tcfg, jp, tp = models[arch]
    toks, want, wc = reference[arch]
    fa0 = tfa.launches
    got, gc = ttr.prefill_forward(tcfg, tp, {"tokens": _t(toks[:, :S])},
                                  max_seq=S + STEPS)
    assert tfa.launches == fa0
    assert_close_rel(lm_np(got), want, REL)
    assert gc["len"] == int(wc["len"]) == S and set(gc) == set(wc)
    for key in ("k", "v"):
        assert tuple(gc[key].shape) == wc[key].shape
        assert_close_rel(lm_np(gc[key]), wc[key], REL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_from_the_reference_cache(models, reference, jdecode,
                                               arch):
    """Three decode steps from the reference's prefill cache: each routes
    its B tokens (capacity over B), logits and every cache entry."""
    jcfg, tcfg, jp, tp = models[arch]
    toks, _, wc = reference[arch]
    gc = lm_cache_to_port(wc)
    for t in range(S, S + STEPS):
        want, wc = jdecode[arch](jp, wc, {"tokens": jnp.asarray(
            toks[:, t:t + 1])})
        got, gc = ttr.decode_step(tcfg, tp, gc, {"tokens": _t(
            toks[:, t:t + 1])})
        assert gc["len"] == int(wc["len"]) == t + 1
        assert_close_rel(lm_np(got), want, REL)
        for key in ("k", "v"):
            assert_close_rel(lm_np(gc[key]), wc[key], REL)


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_decode_equals_the_reference(models, jdecode, arch):
    """Four decode steps from an empty int8 cache: every int8 entry equal
    to the reference's, the scales and logits within 1e-4 of max."""
    jcfg, tcfg, jp, tp = models[arch]
    toks = _tokens(jcfg, B, 4, seed=9)
    wc = jtr.init_cache(jcfg, B, 6, dtype=jnp.float32, kv_quant=True)
    gc = ttr.init_cache(tcfg, B, 6, dtype=torch.float32, device="cpu",
                        kv_quant=True)
    for t in range(4):
        want, wc = jdecode[arch](jp, wc, {"tokens": jnp.asarray(
            toks[:, t:t + 1])})
        got, gc = ttr.decode_step(tcfg, tp, gc, {"tokens": _t(
            toks[:, t:t + 1])})
        assert_close_rel(lm_np(got), want, REL)
    for key in ("k", "v"):
        assert gc[key].dtype == torch.int8
        np.testing.assert_array_equal(gc[key].numpy(), np.asarray(wc[key]))
        assert_close_rel(lm_np(gc[key + "_scale"]), wc[key + "_scale"], REL)


def test_int8_decode_close_to_float(models):
    """Twin of the reference's ``test_int8_decode_close_to_bf16`` for
    phi3.5-moe in the port, in its setting (float32, capacity factor
    8.0): int8 logits within rtol 0.1, atol 0.15 of the float cache's,
    the greedy token mostly the same."""
    _, tcfg, _, tp = models[ARCHS[0]]
    tcfg = dataclasses.replace(tcfg, capacity_factor=8.0)
    toks = _t(_tokens(tcfg, B, 6, seed=2))

    def run(kv_quant):
        cache = ttr.init_cache(tcfg, B, 8, dtype=torch.float32, device="cpu",
                               kv_quant=kv_quant)
        outs = []
        for t in range(6):
            lg, cache = ttr.decode_step(tcfg, tp, cache,
                                        {"tokens": toks[:, t:t + 1]})
            outs.append(lg)
        return torch.stack(outs, 1).numpy(), cache

    full, _ = run(False)
    q8, cache = run(True)
    assert cache["k"].dtype == torch.int8
    np.testing.assert_allclose(q8, full, rtol=0.1, atol=0.15)
    assert (q8.argmax(-1) == full.argmax(-1)).mean() >= 0.9


def test_int8_routing_flips_are_the_references(models):
    """At B 8 the int8 cache moves a hidden state enough to flip a token's
    top-K experts, and the logits then leave ``test_kvquant``'s limits, in
    the reference as in the port: the two agree step for step on both
    caches (float32, capacity factor 8.0).  ``chip_smoke.py`` therefore
    holds the limits with the routing pinned to the float run's."""
    jcfg, tcfg, jp, tp = models[ARCHS[0]]
    jcfg = dataclasses.replace(jcfg, capacity_factor=8.0)
    tcfg = dataclasses.replace(tcfg, capacity_factor=8.0)
    b, steps = 8, 6
    toks = _tokens(jcfg, b, steps, seed=2)
    jstep = jax.jit(lambda p, c, bt: jtr.decode_step(jcfg, p, c, bt, CTX))

    def run(kv_quant):
        wc = jtr.init_cache(jcfg, b, steps, dtype=jnp.float32,
                            kv_quant=kv_quant)
        gc = ttr.init_cache(tcfg, b, steps, dtype=torch.float32,
                            device="cpu", kv_quant=kv_quant)
        want, got = [], []
        for t in range(steps):
            lw, wc = jstep(jp, wc, {"tokens": jnp.asarray(toks[:, t:t + 1])})
            lg, gc = ttr.decode_step(tcfg, tp, gc,
                                     {"tokens": _t(toks[:, t:t + 1])})
            want.append(np.asarray(lw))
            got.append(lg.numpy())
        return np.stack(want, 1), np.stack(got, 1)

    wf, gf = run(False)
    wq, gq = run(True)
    assert_close_rel(gf, wf, REL)
    assert_close_rel(gq, wq, REL)

    def excess(q8, full):
        return float((np.abs(q8 - full) - 0.15 - 0.1 * np.abs(full)).max())

    assert excess(wq, wf) > 0 and excess(gq, gf) > 0


def test_prefill_and_decode_agree_only_without_drops(models):
    """The whole-prompt prefill against the engine's token-by-token one:
    equal at the no-drop factor E / K, apart at the default 1.25, where a
    prefill of B * S tokens drops other pairs than steps of B (the
    reference's semantics)."""
    _, tcfg, _, tp = models[ARCHS[1]]
    toks = _t(_tokens(tcfg, B, S, seed=4))
    errs = {}
    for cf in (tcfg.num_experts / tcfg.experts_per_token, 1.25):
        cfg = dataclasses.replace(tcfg, capacity_factor=cf)
        cache, logits = tengine.prefill_cache(
            cfg, tp, toks, tengine.ServeConfig(max_seq=S))
        want, wc = ttr.prefill_forward(cfg, tp, {"tokens": toks})
        errs[cf] = float((logits - want).abs().max() / want.abs().max())
        if cf != 1.25:
            assert_close_rel(lm_np(logits), lm_np(want), REL)
            for key in ("k", "v"):
                assert_close_rel(lm_np(cache[key]), lm_np(wc[key]), REL)
    assert errs[1.25] > 100 * REL, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_tokens_equal_the_reference(models, arch):
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


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_the_smoke_config_on_the_cpu(arch, capsys):
    tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu",
                  "--requests", "2", "--tokens", "3"])
    assert "2 requests x 3 tokens" in capsys.readouterr().out
