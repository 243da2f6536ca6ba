"""The port's ssm LM family (mamba2: a stack of Mamba-2 layers) against the
JAX package, on the CPU.

Weights come from the reference's ``init_params`` (``lm_smoke_models``);
tokens from ``np.random.default_rng``.  The prompt is 128 tokens so that
the reference's ``ssd_scan`` takes its Pallas kernel in interpret mode
(``REPRO_KERNELS=interpret``; a length that is no multiple of 128 takes
its sequential oracle); the port runs on ``device="cpu"``, i.e. through
the kernel's plain version.

Tolerance: in float32, 1e-4 relative to max|reference| (the chunked scan
against the sequential recurrence sums in another order).  Greedy tokens,
shapes and cache lengths are compared exactly.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import base as jbase
from repro.models import schema as jschema
from repro.models import transformer as jtr
from repro.models.layers import ShardCtx
from repro.serve import engine as jengine

from repro_torch.configs import base as tbase
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ssd_scan as tss
from repro_torch.launch import serve as tlaunch
from repro_torch.models import schema as tschema
from repro_torch.models import transformer as ttr
from repro_torch.serve import engine as tengine

from test_torch_helpers import (
    assert_close_rel, lm_cache_to_port, lm_np, lm_smoke_models,
)

ARCH = "mamba2-1.3b"
CTX = ShardCtx()
REL = 1e-4
B, S, STEPS = 2, 128, 3
STATES = ("conv", "ssm")


def _t(x):
    return torch.from_numpy(np.array(x))


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.fixture(scope="module")
def smoke():
    return lm_smoke_models(ARCH)


@pytest.fixture(scope="module")
def reference(smoke):
    """The prompt (B, S + STEPS) and the reference's ``prefill_forward`` of
    its first S tokens, ``ssd_scan`` in interpret mode."""
    jcfg, _, jp, _ = smoke
    toks = _tokens(jcfg, B, S + STEPS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_KERNELS", "interpret")
        logits, cache = jtr.prefill_forward(
            jcfg, jp, {"tokens": jnp.asarray(toks[:, :S])}, CTX,
            max_seq=S + STEPS)
    return toks, logits, cache


@pytest.mark.parametrize("smoke_cfg", [True, False], ids=["smoke", "full"])
def test_param_shapes_equal_the_reference(smoke_cfg):
    """Every leaf, the published config not allocated: 48 Mamba-2 layers,
    no attention, no ``shared_attn``."""
    get = "get_smoke_config" if smoke_cfg else "get_config"
    jshapes = jax.tree.map(lambda s: tuple(s.shape), jschema.abstract_params(
        getattr(jbase, get)(ARCH)))
    tshapes = tschema.param_shapes(getattr(tbase, get)(ARCH))
    assert tshapes == jshapes
    assert set(tshapes) == {"embed", "final_norm", "layers"}


def test_init_params_count_and_cache_shapes():
    cfg = tbase.get_smoke_config(ARCH)
    params = tschema.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert tschema.param_count_actual(params) >= cfg.param_count()
    assert params["layers"]["wx"].shape[0] == cfg.num_layers


def test_init_cache_equals_the_reference(smoke):
    jcfg, tcfg, _, _ = smoke
    want = jtr.init_cache(jcfg, 3, 20, dtype=jnp.bfloat16)
    got = ttr.init_cache(tcfg, 3, 20, dtype=torch.bfloat16, device="cpu")
    assert set(got) == set(want) == {"len", "conv", "ssm"}
    for key in STATES:
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)
        assert not got[key].any()


def test_forward_logits(smoke, monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "interpret")
    jcfg, tcfg, jp, tp = smoke
    toks = _tokens(jcfg, B, S, seed=1)
    want, aux = jtr.forward_logits(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                   CTX)
    got, taux = ttr.forward_logits(tcfg, tp, {"tokens": _t(toks)})
    assert got.shape == (B, S, tcfg.padded_vocab)
    assert float(aux) == taux == 0.0
    assert_close_rel(lm_np(got), want, REL)


def test_prefill_forward_logits_and_cache(smoke, reference):
    """Last logits and every conv and SSM state; on the CPU the scan
    wrapper takes its plain version and no kernel is counted."""
    jcfg, tcfg, jp, tp = smoke
    toks, want, wc = reference
    launched = (tfa.launches, tss.launches)
    got, gc = ttr.prefill_forward(tcfg, tp, {"tokens": _t(toks[:, :S])},
                                  max_seq=S + STEPS)
    assert (tfa.launches, tss.launches) == launched
    assert_close_rel(lm_np(got), want, REL)
    assert gc["len"] == int(wc["len"]) == S and set(gc) == set(wc)
    for key in STATES:
        assert tuple(gc[key].shape) == wc[key].shape
        assert_close_rel(lm_np(gc[key]), wc[key], REL)


def test_prefill_forward_bf16_runs_in_bf16(smoke):
    """The config's own dtype: activations in bf16, states and logits in
    float32."""
    _, _, _, tp = smoke
    cfg = tbase.get_smoke_config(ARCH)
    toks = _t(_tokens(cfg, B, 32, seed=3))
    got, gc = ttr.prefill_forward(cfg, tp, {"tokens": toks})
    want, _ = ttr.prefill_forward(smoke[1], tp, {"tokens": toks})
    assert got.dtype == gc["ssm"].dtype == torch.float32
    assert_close_rel(lm_np(got), lm_np(want), 5e-2)


def test_decode_steps_from_the_reference_cache(smoke, reference):
    """Three decode steps from the reference's prefill cache carried over:
    logits and every state after each step."""
    jcfg, tcfg, jp, tp = smoke
    toks, _, wc = reference
    gc = lm_cache_to_port(wc)
    jdecode = jax.jit(lambda p, c, b: jtr.decode_step(jcfg, p, c, b, CTX))
    for t in range(S, S + STEPS):
        want, wc = jdecode(jp, wc, {"tokens": jnp.asarray(toks[:, t:t + 1])})
        before = gc
        got, gc = ttr.decode_step(tcfg, tp, gc,
                                  {"tokens": _t(toks[:, t:t + 1])})
        assert gc is before and gc["len"] == int(wc["len"]) == t + 1
        assert_close_rel(lm_np(got), want, REL)
        for key in STATES:
            assert_close_rel(lm_np(gc[key]), wc[key], REL)


def test_decode_matches_full_forward(smoke):
    """Sequential decode with the state cache equals the full forward
    (teacher forcing)."""
    _, tcfg, _, tp = smoke
    s = 10
    toks = _t(_tokens(tcfg, B, s, seed=5))
    full, _ = ttr.forward_logits(tcfg, tp, {"tokens": toks})
    cache = ttr.init_cache(tcfg, B, s, dtype=torch.float32, device="cpu")
    outs = []
    for t in range(s):
        lg, cache = ttr.decode_step(tcfg, tp, cache,
                                    {"tokens": toks[:, t:t + 1]})
        outs.append(lg)
    assert_close_rel(lm_np(torch.stack(outs, 1)), lm_np(full), REL)


def test_prefill_cache_equals_prefill_forward(smoke):
    _, tcfg, _, tp = smoke
    toks = _t(_tokens(tcfg, B, 16, seed=4))
    cache, logits = tengine.prefill_cache(tcfg, tp, toks,
                                          tengine.ServeConfig(max_seq=16))
    want, wc = ttr.prefill_forward(tcfg, tp, {"tokens": toks})
    assert cache["len"] == wc["len"] == 16
    assert_close_rel(lm_np(logits), lm_np(want), REL)
    for key in STATES:
        assert_close_rel(lm_np(cache[key]), lm_np(wc[key]), REL)


def test_generate_greedy_tokens_equal_the_reference(smoke):
    jcfg, tcfg, jp, tp = smoke
    rng = np.random.default_rng(0)
    reqs = [list(rng.integers(1, jcfg.vocab_size, size=rng.integers(2, 12)))
            for _ in range(3)]
    prompts, _ = jengine.batch_requests(reqs)
    max_seq = prompts.shape[1] + 3
    want = jengine.generate(jcfg, jp, jnp.asarray(prompts), CTX,
                            jengine.ServeConfig(max_seq=max_seq), 3)
    got = tengine.generate(tcfg, tp, _t(prompts),
                           tengine.ServeConfig(max_seq=max_seq), 3)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_launcher_serves_the_smoke_config_on_the_cpu(capsys):
    tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                  "--requests", "2", "--tokens", "3"])
    assert "2 requests x 3 tokens" in capsys.readouterr().out
