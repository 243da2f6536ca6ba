"""The gradients of the two LM kernels on the CPU: ``flash_attention`` and
``ssd_scan`` as ``torch.autograd.Function``s (forward: the plain version
here, the kernel on the card; backward: the recompute VJPs), held against
autograd of the plain versions and against the JAX package's own
backwards: the recompute VJP ``ref.flash_attention_vjp`` and ``jax.vjp``
of the sequential ``ref.ssd_scan``.  Also the forward's log-sum-exp of the
plain version, the kernel's second output.

Inputs are made from a seed with numpy, in float32.  Tolerance: max|Δ| <=
2e-5 * max|g| per gradient (float32 sums in another order: key chunks,
the chunked scan against the step-by-step one).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as jref

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ssd_scan as tss

from test_torch_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REL = 2e-5


def assert_close(got, want, rel=REL, what=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want.detach() if isinstance(want, torch.Tensor)
                      else want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


def reference_vjp(fn, primals, cotangent):
    """``jax.vjp`` of the reference's ``fn`` at numpy ``primals``, jitted
    (one compilation instead of one a primitive)."""
    def pull(ps, ct):
        return jax.vjp(fn, *ps)[1](ct)

    return jax.jit(pull)(tuple(map(jnp.asarray, primals)),
                         jax.tree.map(jnp.asarray, cotangent))


def _qkv(b, hq, hkv, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    g = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    return q, k, v, g


# (name, shape (B, Hq, Hkv, Sq, Sk, D), options, the reference VJP's
# block_k: a divisor of Sk, as it wants; the port's own backward also runs
# at block 8, a ragged last chunk wherever 8 does not divide Sk)
FLASH_CASES = [
    ("GQA", (2, 4, 2, 24, 24, 16), {}, 8),
    ("window", (1, 2, 2, 32, 32, 8), dict(window=5), 8),
    ("softcap non-causal", (1, 2, 1, 16, 16, 8),
     dict(softcap=3.0, causal=False), 16),
    ("sq < sk right-aligned", (1, 4, 2, 8, 24, 16), {}, 8),
    ("ragged sk", (1, 2, 2, 12, 20, 8), dict(window=9, softcap=5.0), 10),
    ("rows that see no key", (1, 2, 2, 16, 8, 8), {}, 8),
]


@pytest.mark.parametrize("name,shape,kw,block", FLASH_CASES,
                         ids=[c[0] for c in FLASH_CASES])
def test_flash_backward_matches_plain_autograd_and_reference_vjp(
        name, shape, kw, block):
    b, hq, hkv, sq, sk, d = shape
    q, k, v, g = _qkv(*shape, seed=len(name))
    causal = kw.get("causal", True)
    keyless = np.arange(sq) + (sk - sq) < 0 if causal else \
        np.zeros(sq, bool)
    g[:, :, keyless] = 0.0       # the reference gives keyless rows P = 1
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tg = torch.from_numpy(g)
    out = tfa.flash_attention(tq, tk, tv, **kw)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (tq, tk, tv), tg)
    plain = torch.autograd.grad(tfa.flash_attention_ref(tq, tk, tv, **kw),
                                (tq, tk, tv), tg)
    o, lse = tfa.flash_attention_ref(tq.detach(), tk.detach(), tv.detach(),
                                     return_lse=True, **kw)
    chunked = tfa.flash_attention_bwd(tq.detach(), tk.detach(), tv.detach(),
                                      o, lse, tg, block_k=8, **kw)
    want = reference_vjp(lambda a, bb, c: jref.flash_attention_vjp(
        a, bb, c, block_k=block, **kw), (q, k, v), g)
    for i, what in enumerate("qkv"):
        assert got[i].dtype == torch.float32
        assert_close(got[i], plain[i], what=f"d{what} vs plain")
        assert_close(chunked[i], plain[i], what=f"d{what} block 8 vs plain")
        assert_close(got[i], want[i], what=f"d{what} vs reference vjp")
    if keyless.any():
        assert float(lse[:, :, keyless].max()) == float("-inf")
        # a cotangent on keyless rows changes nothing and they get dq = 0
        g2 = tg.clone()
        g2[:, :, keyless] = 1.0
        again = torch.autograd.grad(tfa.flash_attention(tq, tk, tv, **kw),
                                    (tq, tk, tv), g2)
        assert float(again[0][:, :, keyless].abs().max()) == 0.0
        for i in (1, 2):
            torch.testing.assert_close(again[i], got[i], rtol=0, atol=0)


def test_flash_lse_is_the_row_logsumexp_and_grad_is_off_in_serving():
    q, k, v, _ = _qkv(1, 2, 1, 10, 10, 8, seed=3)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = tfa.flash_attention_ref(tq, tk, tv, window=4, softcap=2.0,
                                       return_lse=True)
    s = np.einsum("bhqd,bhkd->bhqk", q, np.repeat(k, 2, axis=1)) * 8 ** -0.5
    s = 2.0 * np.tanh(s / 2.0)
    qi, ki = np.arange(10)[:, None], np.arange(10)[None, :]
    s = np.where((qi >= ki) & (qi - ki < 4), s, -np.inf)
    want = np.log(np.exp(s).sum(-1))
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6)
    # without requires_grad no Function is built (the kernel's serving
    # path, lse not wanted)
    assert tfa.flash_attention(tq, tk, tv).grad_fn is None
    with torch.no_grad():
        assert tfa.flash_attention(tq.requires_grad_(), tk, tv).grad_fn \
            is None


def _ssd_inputs(b, seq, h, g, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, seq, h, p)).astype(np.float32)
    dt = (rng.random((b, seq, h)) * 0.5).astype(np.float32)
    a = (-rng.random(h) * 2 - 0.1).astype(np.float32)
    bm = rng.standard_normal((b, seq, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, seq, g, n)).astype(np.float32)
    gy = rng.standard_normal((b, seq, h, p)).astype(np.float32)
    gh = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return (x, dt, a, bm, cm), gy, gh


@pytest.mark.parametrize("shape,chunk", [
    ((2, 16, 4, 2, 8, 8), 128),       # one chunk of the whole length
    ((1, 40, 4, 1, 4, 8), 16),        # ragged: 40 = 2 x 16 + 8
    ((2, 33, 2, 2, 4, 4), 8),         # ragged, G = H
])
def test_ssd_backward_matches_plain_autograd_and_reference_grad(
        monkeypatch, shape, chunk):
    monkeypatch.setattr(tss, "BWD_CHUNK", chunk)
    inputs, gy, gh = _ssd_inputs(*shape, seed=shape[1])
    t_in = [torch.from_numpy(x).requires_grad_() for x in inputs]
    tgy, tgh = torch.from_numpy(gy), torch.from_numpy(gh)
    y, h_fin = tss.ssd_scan(*t_in)
    assert y.grad_fn is not None
    got = torch.autograd.grad((y, h_fin), t_in, (tgy, tgh))
    y_r, h_r = tss.ssd_scan_ref(*t_in)
    plain = torch.autograd.grad((y_r, h_r), t_in, (tgy, tgh))
    want = reference_vjp(lambda *a: jref.ssd_scan(*a, return_state=True),
                         inputs, (gy, gh))
    for i, what in enumerate(("x", "dt", "a", "B", "C")):
        assert_close(got[i], plain[i], what=f"d{what} vs plain")
        assert_close(got[i], want[i], what=f"d{what} vs reference")
    # only y's gradient wanted (the final state's is None)
    only_y = torch.autograd.grad(tss.ssd_scan(*t_in)[0], t_in, tgy)
    plain_y = torch.autograd.grad(tss.ssd_scan_ref(*t_in)[0], t_in, tgy)
    for g_, w_ in zip(only_y, plain_y):
        assert_close(g_, w_)


def test_ssd_chunked_forward_matches_the_recurrence_and_reference():
    inputs, _, _ = _ssd_inputs(2, 37, 4, 2, 8, 8, seed=7)
    t_in = [torch.from_numpy(x) for x in inputs]
    y_r, h_r = tss.ssd_scan_ref(*t_in)
    jy, jh = jref.ssd_scan_chunked(*map(jnp.asarray, inputs), chunk=37)
    for chunk in (8, 16, 128):
        y, h = tss.ssd_scan_chunked(*t_in, chunk=chunk)
        assert y.dtype == torch.float32 and h.shape == h_r.shape
        assert_close(y, y_r, rel=1e-5)
        assert_close(h, h_r, rel=1e-5)
        assert_close(y, jy, rel=1e-5)
        assert_close(h, jh, rel=1e-5)
