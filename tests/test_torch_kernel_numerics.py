"""The arithmetic of the port's six Hopper kernels, modelled in plain torch
or numpy on the CPU and held against their plain versions and the JAX
oracles.

The CUDA kernels run only on a GPU (``chip_smoke.py`` holds them against
their plain versions there).  What can be checked here is the design they
implement, at small seeded shapes:

* ``flash_attention`` (``csrc/flash_attention.cu``): tile-by-tile online
  softmax over 64-key tiles with the finite -1e30 sentinel, products of
  bf16 terms summed in float32 (the tensor cores' ``mma.sync``), P split
  into P_hi + P_lo for bf16 inputs, and q, k, v, P split into three bf16
  terms (products with i + j < 3) for float32 inputs.  Held at
  ``chip_smoke.py``'s limits: one bf16 ulp of |plain| + 2e-5 * max|plain|
  for bf16 outputs, 2e-5 * max|plain| for float32.  The control -- P
  rounded to bf16 once, as stock flash kernels do -- must exceed the bf16
  limit, or the limit could not tell the split from it.
* ``topk_score`` (``csrc/topk_score.cu``): per-chunk threshold filtering by
  the strict order (value desc, index asc), candidate buffers merged into a
  sorted list by rank, thresholds published across chunks, chunks taken in
  a shuffled order, and the merge pass.  Held bit for bit (values and
  indices) against ``topk_score_ref`` and the JAX oracle.
* ``ssd_scan`` (``csrc/ssd_scan.cu``): the chunked scan on the tensor
  cores for bf16 inputs: C B^T from bf16 products, G selected before its
  exponential, G, the carried state h and x o w each as bf16 hi + lo
  terms, float32 sums, a ragged last chunk zero-filled; float32 inputs
  take float32 arithmetic throughout.  Held at ``chip_smoke.py``'s limits:
  one bf16 ulp of |plain| + 1e-4 * max|plain| for a bf16 y, 1e-4 * max
  for a float32 y and for the state.  The control -- G, h and x o w each
  rounded once to bf16 -- must exceed the bf16 limit by more than 4x.
* ``blockgram`` (``csrc/blockgram.cu``): float32 input split into bf16
  terms hi + mid + lo (exactly x), the six products mid.mid, hi.lo, lo.hi,
  hi.mid, mid.hi, hi.hi summed per 16-column k-step and added in float32,
  the products of a term skipped where a stage's terms of that kind are
  all zero (no bit changes), W cut into the launch plan's slices summed in
  order.  Exact on 0/1 data, within 1e-5 of max|G| on gaussian, mixed and
  short rows and on rows of the values the split serves worst, where
  leaving out mid.mid or lo misses that limit.
* ``sparse_gram`` (``csrc/sparse_gram.cu``): the row index (counts, scan,
  a placement in any order, each row's list sorted: complete and in
  ascending (c, k)), then every G[r1, r2] summed in the kernel's order --
  a row's list in pieces shared by warps, entries 32 at a time, their
  (entry, slot) pairs 32 a step up to each column's last non-zero slot,
  the products of one r2 in a step summed in lane order, the warps'
  copies in warp order -- in float32.  Exact on 0/1 data; within 1e-5 of
  max|G| of a float64 sum, of the plain version and of the JAX oracles on
  weighted data with duplicates, an all-padding block, a heavy row over
  several warps and pieces, K = 36 and M = 33.  The workspace is a
  function of (D, C, K, M) alone.
* ``sketch_panel`` (``csrc/sketch_panel.cu``): the slots of a column in
  ascending k, a rounded product and a rounded add each -- the plain
  version's own order, so the two are equal bit for bit -- and the route
  by which the kernel reads Omega through its strides.
* At the widths of mamba2-1.3b (N = 128) and gemma2-9b (head dim 256): the
  ssd and flash models against the JAX oracles, and the float32 chunk
  ``ssd_scan.chunk_for`` takes at each N.
* ``launch_plan`` and the flash wrapper's head-dim padding, which are plain
  Python on the launch path.
"""
import struct

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.serve import kvquant as jkvquant

from repro_torch.kernels import blockgram as tbg
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import sketch_panel as tsp
from repro_torch.kernels import sparse_gram as tsg
from repro_torch.kernels import ssd_scan as tss
from repro_torch.kernels import topk_score as ttk

from test_torch_helpers import assert_close_rel

NEG = -1e30
LOG2E = 1.4426950408889634


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

def _terms(x, n):
    """``x`` as n bf16 terms (as float32): term i is bf16 of what terms
    0..i-1 leave; each remainder is exact in float32."""
    out, rest = [], x.float()
    for _ in range(n):
        t = rest.to(torch.bfloat16).float()
        out.append(t)
        rest = rest - t
    return out


def flash_model(q, k, v, *, causal=True, window=0, softcap=0.0, scale=None,
                qkv_terms=1, p_terms=2, block_k=64):
    """The kernel's arithmetic: per 64-key tile, S = sum over i + j <
    qkv_terms of q_i k_j^T (bf16 products, float32 sums), scale, softcap,
    log2 e, masks to the sentinel; running max from -1e30, hidden keys
    weigh 0; O += sum over i + j < p_terms of P_i v_j; l the float32 sum
    of P; a row with l == 0 gives zeros."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    qs = _terms(q, qkv_terms)
    ks = _terms(k.repeat_interleave(group, 1), qkv_terms)
    vs = _terms(v.repeat_interleave(group, 1), qkv_terms)
    qpos = torch.arange(sq)[:, None] + (sk - sq)
    m = torch.full((b, hq, sq, 1), NEG)
    l = torch.zeros((b, hq, sq, 1))
    acc = torch.zeros((b, hq, sq, d))
    for k0 in range(0, sk, block_k):
        cols = slice(k0, min(sk, k0 + block_k))
        s = sum(qs[i] @ ks[j][:, :, cols].transpose(-1, -2)
                for i in range(qkv_terms) for j in range(qkv_terms - i))
        x = s * scale
        if softcap > 0:
            x = softcap * torch.tanh(x / softcap)
        x = x * LOG2E
        kpos = torch.arange(k0, min(sk, k0 + block_k))[None, :]
        vis = torch.ones(x.shape[-2:], dtype=torch.bool)
        if causal:
            vis &= qpos >= kpos
        if window > 0:
            vis &= (qpos - kpos) < window
        x = torch.where(vis, x, torch.tensor(NEG))
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.where(x > NEG, torch.exp2(x - m_new), torch.tensor(0.0))
        l = alpha * l + p.sum(-1, keepdim=True)
        ps = _terms(p, p_terms)
        acc = alpha * acc + sum(
            ps[i] @ vs[j][:, :, cols] for i in range(p_terms)
            for j in range(min(qkv_terms, p_terms - i)))
        m = m_new
    l = torch.where(l == 0, torch.ones_like(l), l)
    return (acc / l).to(q.dtype)


def _bf16_ulp(x):
    """One bf16 ulp of |x| (8 significant bits), 0 at 0: chip_smoke.py's
    ``bf16_ulp``."""
    _, e = torch.frexp(x.float().abs())
    ulp = torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)
    return torch.where(x == 0, 0.0, ulp)


def _worst_over_bf16_limit(got, want, rel=2e-5):
    """Largest |got - want| / (1 bf16 ulp of |want| + rel max|want|)."""
    tol = _bf16_ulp(want) + rel * float(want.float().abs().max())
    return float(((got.float() - want.float()).abs() / tol).max())


def _qkv(b, hq, hkv, sq, sk, d, dtype, seed=7):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to(dtype) for s in ((b, hq, sq, d), (b, hkv, sk, d),
                                      (b, hkv, sk, d)))


FLASH_CASES = [
    ("causal", (1, 4, 4, 256, 256, 80), {}),
    ("GQA 8/2", (1, 8, 2, 192, 192, 64), {}),
    ("window 96", (1, 4, 2, 256, 256, 64), dict(window=96)),
    ("softcap 30", (1, 4, 4, 256, 256, 80), dict(softcap=30.0)),
    ("non-causal", (1, 4, 4, 200, 200, 32), dict(causal=False)),
    ("sq 64 < sk 192", (2, 4, 2, 64, 192, 64), {}),
    ("ragged 100", (1, 2, 2, 100, 100, 80), {}),
    ("sq 40 > sk 25, rows without a key", (1, 2, 1, 40, 25, 16), {}),
]


@pytest.mark.parametrize("name,shape,kw", FLASH_CASES,
                         ids=[c[0] for c in FLASH_CASES])
def test_flash_model_bf16_p_split_within_one_bf16_ulp(name, shape, kw):
    q, k, v = _qkv(*shape, torch.bfloat16)
    got = flash_model(q, k, v, **kw)
    want = tfa.flash_attention_ref(q, k, v, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _worst_over_bf16_limit(got, want) <= 1.0


def test_flash_model_p_rounded_once_exceeds_the_bf16_limit():
    """The control: P rounded to bf16 once, with everything else the same,
    errs well above the limit that the P_hi + P_lo split meets."""
    q, k, v = _qkv(1, 2, 2, 256, 256, 80, torch.bfloat16, seed=0)
    want = tfa.flash_attention_ref(q, k, v)
    split = _worst_over_bf16_limit(flash_model(q, k, v, p_terms=2), want)
    once = _worst_over_bf16_limit(flash_model(q, k, v, p_terms=1), want)
    assert split <= 1.0 < 4.0 < once


@pytest.mark.parametrize("name,shape,kw", FLASH_CASES,
                         ids=[c[0] for c in FLASH_CASES])
def test_flash_model_f32_three_term_split_within_2e5(name, shape, kw):
    q, k, v = _qkv(*shape, torch.float32)
    got = flash_model(q, k, v, qkv_terms=3, p_terms=3, **kw)
    want = tfa.flash_attention_ref(q, k, v, **kw)
    limit = 2e-5 * float(want.abs().max())
    assert float((got - want).abs().max()) <= limit


def test_flash_model_f32_needs_three_terms():
    """One bf16 term of float32 inputs misses the float32 limit by far;
    three meet it with room."""
    q, k, v = _qkv(1, 2, 2, 256, 256, 80, torch.float32, seed=0)
    want = tfa.flash_attention_ref(q, k, v)
    top = float(want.abs().max())
    err = {n: float((flash_model(q, k, v, qkv_terms=n, p_terms=n)
                     - want).abs().max()) / top for n in (1, 3)}
    assert err[3] <= 2e-6 and err[1] > 2e-5


@pytest.mark.parametrize("kw", [{}, dict(window=48), dict(softcap=20.0),
                                dict(causal=False)])
def test_flash_model_matches_the_jax_oracle(kw):
    """float32 three-term model and bf16 split model against the reference's
    ``ref.flash_attention`` (rows that see a key), at the existing flash
    tests' limits: 2e-5 (float32) and 8e-3 (bf16, one rounding) of max."""
    for dtype, terms, rel in ((torch.float32, (3, 3), 2e-5),
                              (torch.bfloat16, (1, 2), 8e-3)):
        q, k, v = _qkv(1, 4, 2, 128, 128, 64, dtype, seed=3)
        got = flash_model(q, k, v, qkv_terms=terms[0], p_terms=terms[1],
                          **kw).float().numpy()
        want = np.asarray(jref.flash_attention(
            *(jnp.asarray(x.float().numpy()).astype(
                jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
              for x in (q, k, v)), **kw), np.float32)
        assert np.abs(got - want).max() <= rel * np.abs(want).max()


def test_flash_model_rows_without_a_key_are_zero():
    q, k, v = _qkv(1, 2, 1, 40, 25, 16, torch.float32)
    got = flash_model(q, k, v, qkv_terms=3, p_terms=3)
    assert float(got[:, :, :15].abs().max()) == 0.0
    assert float(got[:, :, 15:].abs().max()) > 0.0


@pytest.mark.parametrize("d", [8, 13, 80, 100])
def test_flash_wrapper_pads_head_dims_to_a_multiple_of_8(d):
    x = torch.arange(2 * 3 * d, dtype=torch.float32).reshape(2, 3, d)
    dp = -(-d // 8) * 8
    y = tfa._aligned(x, dp)
    assert y.shape == (2, 3, dp) and y.data_ptr() % 16 == 0
    assert torch.equal(y[..., :d], x) and float(y[..., d:].abs().sum()) == 0
    if dp == d:
        assert y.data_ptr() == x.data_ptr()      # no copy when not needed


WIDE_FLASH_CASES = [
    ("causal GQA 4/2", (1, 4, 2, 128, 128, 256), {}),
    ("window 64", (1, 2, 2, 160, 160, 256), dict(window=64)),
    ("softcap 50", (1, 2, 1, 128, 128, 256), dict(softcap=50.0)),
    ("sq 64 < sk 160", (1, 2, 2, 64, 160, 256), {}),
]


@pytest.mark.parametrize("name,shape,kw", WIDE_FLASH_CASES,
                         ids=[c[0] for c in WIDE_FLASH_CASES])
def test_flash_model_head_dim_256(name, shape, kw):
    """gemma2-9b's head dim: the bf16 design (P_hi + P_lo, 64-key tiles)
    within one bf16 ulp, and the float32 design (three terms, the 32-key
    tiles the kernel takes at head dim 256) within 2e-5 of max, against the
    plain version and the reference's ``ref.flash_attention``."""
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _qkv(*shape, dtype, seed=5)
        want = tfa.flash_attention_ref(q, k, v, **kw)
        jwant = np.asarray(jref.flash_attention(
            *(jnp.asarray(x.float().numpy()).astype(
                jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
              for x in (q, k, v)), **kw), np.float32)
        if dtype == torch.bfloat16:
            got = flash_model(q, k, v, **kw)
            assert _worst_over_bf16_limit(got, want) <= 1.0
            assert np.abs(got.float().numpy() - jwant).max() \
                <= 8e-3 * np.abs(jwant).max()
        else:
            got = flash_model(q, k, v, qkv_terms=3, p_terms=3, block_k=32,
                              **kw)
            limit = 2e-5 * float(want.abs().max())
            assert float((got - want).abs().max()) <= limit
            assert np.abs(got.numpy() - jwant).max() \
                <= 2e-5 * np.abs(jwant).max()


# ---------------------------------------------------------------------------
# ssd_scan
# ---------------------------------------------------------------------------

def ssd_model(x, dt, a, b, c, *, chunk, split_terms):
    """The kernel's arithmetic, chunk by chunk: la2 = cumsum(dt a) log2 e;
    y = 2^la2_i C h^T + G x with G = S o 2^(la2_i - la2_j) o dt_j for
    i >= j (0 selected inside the exponent for i < j), S = C B^T; h <-
    2^la2_last h + (x o w)^T B, w_j = 2^(la2_last - la2_j) dt_j.  G, the
    carried h and x o w enter as ``split_terms`` bf16 terms (products of
    bf16 values, float32 sums); ``split_terms=None`` keeps them float32
    (the float32 kernel).  A ragged last chunk is zero-filled."""
    bsz, seq, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g

    def terms(v):
        return [v] if split_terms is None else _terms(v, split_terms)

    x32 = x.float().permute(0, 2, 1, 3)                          # (B, H, L, P)
    dt32 = dt.float().permute(0, 2, 1)                           # (B, H, L)
    b32 = b.float().repeat_interleave(rep, 2).permute(0, 2, 1, 3)
    c32 = c.float().repeat_interleave(rep, 2).permute(0, 2, 1, 3)
    a2 = a.float()[None, :, None] * LOG2E
    state = torch.zeros((bsz, h, p, n))
    ys = []
    for c0 in range(0, seq, chunk):
        pad = max(0, c0 + chunk - seq)

        def cut(v):
            v = v[:, :, c0:c0 + chunk]
            return torch.nn.functional.pad(
                v, (0, 0) * (v.dim() - 3) + (0, pad))
        xc, dc, bc, cc = cut(x32), cut(dt32), cut(b32), cut(c32)
        la2 = torch.cumsum(dc * a2, dim=-1)                      # (B, H, Q)
        last = la2[..., -1:]
        s = cc @ bc.transpose(-1, -2)                            # (B, H, Q, Q)
        ii = torch.arange(chunk)[:, None]
        jj = torch.arange(chunk)[None, :]
        arg = torch.where(ii >= jj, la2[..., :, None] - la2[..., None, :],
                          torch.tensor(float("-inf")))
        gmat = s * torch.exp2(arg) * dc[..., None, :]
        y = torch.exp2(la2)[..., None] * sum(
            cc @ t.transpose(-1, -2) for t in terms(state))
        y = y + sum(t @ xc for t in terms(gmat))
        xw = xc * (torch.exp2(last - la2) * dc)[..., None]       # (B, H, Q, P)
        state = torch.exp2(last)[..., None] * state + sum(
            t.transpose(-1, -2) @ bc for t in terms(xw))
        ys.append(y[:, :, :chunk - pad])
    y = torch.cat(ys, dim=2).permute(0, 2, 1, 3).to(x.dtype)
    return y.contiguous(), state


def _ssd_np(b, l, h, g, p, n, seed=9):
    """chip_smoke.py's input distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, l, h)))) * 0.1).astype(
        np.float32)
    a = (-np.exp(rng.standard_normal(h))).astype(np.float32)
    bm = (rng.standard_normal((b, l, g, n)) / np.sqrt(n)).astype(np.float32)
    cm = (rng.standard_normal((b, l, g, n)) / np.sqrt(n)).astype(np.float32)
    return x, dt, a, bm, cm


def _ssd_torch(arrays, dtype):
    x, dt, a, bm, cm = (torch.from_numpy(v) for v in arrays)
    return x.to(dtype), dt.to(dtype), a, bm.to(dtype), cm.to(dtype)


def _ssd_worst(got, want, dtype):
    """(y, state) errors over chip_smoke's limits: y at one bf16 ulp of
    |want| + 1e-4 max|want| (bf16) or 1e-4 max|want| (float32), the state
    at 1e-4 max|want|."""
    (y, hf), (yr, hr) = got, want
    if dtype == torch.bfloat16:
        wy = _worst_over_bf16_limit(y, yr, rel=1e-4)
    else:
        wy = float((y - yr).abs().max()) / (1e-4 * float(yr.abs().max()))
    wh = float((hf - hr).abs().max()) / (1e-4 * float(hr.abs().max()))
    return wy, wh


SSD_CASES = [
    ("2x128 H4 G2 P32 N16", (2, 128, 4, 2, 32, 16)),
    ("1x256 H2 G2 P64 N32", (1, 256, 2, 2, 64, 32)),
    ("1x64 H4 G1 P16 N8", (1, 64, 4, 1, 16, 8)),
    ("G = H = 8", (1, 128, 8, 8, 64, 64)),
    ("L 1", (2, 1, 4, 1, 64, 64)),
    ("L 11", (2, 11, 4, 2, 64, 64)),
    ("L 100", (1, 100, 4, 1, 64, 64)),
    ("L 300", (1, 300, 4, 1, 64, 64)),
]


@pytest.mark.parametrize("chunk", [64, 128])
@pytest.mark.parametrize("name,shape", SSD_CASES,
                         ids=[c[0] for c in SSD_CASES])
def test_ssd_model_bf16_hi_lo_within_one_bf16_ulp(name, shape, chunk):
    args = _ssd_torch(_ssd_np(*shape), torch.bfloat16)
    got = ssd_model(*args, chunk=chunk, split_terms=2)
    want = tss.ssd_scan_ref(*args)
    assert got[0].dtype == torch.bfloat16 and got[0].shape == want[0].shape
    assert got[1].shape == want[1].shape
    wy, wh = _ssd_worst(got, want, torch.bfloat16)
    assert wy <= 1.0 and wh <= 1.0


@pytest.mark.parametrize("name,shape", SSD_CASES,
                         ids=[c[0] for c in SSD_CASES])
def test_ssd_model_f32_within_1e4(name, shape):
    args = _ssd_torch(_ssd_np(*shape), torch.float32)
    got = ssd_model(*args, chunk=tss.chunk_for(torch.float32, shape[5]),
                    split_terms=None)
    wy, wh = _ssd_worst(got, tss.ssd_scan_ref(*args), torch.float32)
    assert wy <= 1.0 and wh <= 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 100, 4, 2, 32, 16),
                                   (1, 128, 8, 8, 64, 64)])
def test_ssd_model_matches_the_jax_oracle(shape, dtype):
    """The model against the reference's ``ref.ssd_scan`` (the sequential
    recurrence) on the same numpy inputs, at the same limits."""
    tdtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    arrays = _ssd_np(*shape, seed=4)
    args = _ssd_torch(arrays, tdtype)
    got = ssd_model(*args, chunk=64,
                    split_terms=2 if dtype == "bfloat16" else None)
    jargs = [jnp.asarray(v) for v in arrays]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    yr, hr = jref.ssd_scan(jargs[0].astype(jdt), jargs[1].astype(jdt),
                           jargs[2], jargs[3].astype(jdt),
                           jargs[4].astype(jdt), return_state=True)
    want = (torch.from_numpy(np.asarray(yr, np.float32)).to(tdtype),
            torch.from_numpy(np.asarray(hr, np.float32)))
    wy, wh = _ssd_worst(got, want, tdtype)
    assert wy <= 1.0 and wh <= 1.0


def test_ssd_model_decaying_state_forgets_its_first_half():
    """a = -10, dt = 2: the model's state forgets the first half of x, as
    the plain version's does, and both agree."""
    x, _, _, bm, cm = _ssd_np(1, 256, 2, 1, 64, 64, seed=3)
    dt = np.full((1, 256, 2), 2.0, np.float32)
    a = np.full((2,), -10.0, np.float32)
    x2 = x.copy()
    x2[:, :128] = np.random.default_rng(4).standard_normal((1, 128, 2, 64))
    for dtype, split in ((torch.bfloat16, 2), (torch.float32, None)):
        outs = []
        for xx in (x, x2):
            args = _ssd_torch((xx, dt, a, bm, cm), dtype)
            got = ssd_model(*args, chunk=64, split_terms=split)
            wy, wh = _ssd_worst(got, tss.ssd_scan_ref(*args), dtype)
            assert wy <= 1.0 and wh <= 1.0
            outs.append(got[1])
        np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("chunk", [64, 128])
def test_ssd_model_rounded_once_exceeds_the_bf16_limit(chunk):
    """The control: G, h and x o w rounded once to bf16 (one term, as a
    stock tensor-core SSD does) err more than 4x the bf16 limit that the
    hi + lo split meets."""
    args = _ssd_torch(_ssd_np(1, 1024, 6, 1, 64, 64, seed=0),
                      torch.bfloat16)
    want = tss.ssd_scan_ref(*args)
    split = _ssd_worst(ssd_model(*args, chunk=chunk, split_terms=2), want,
                       torch.bfloat16)
    once = _ssd_worst(ssd_model(*args, chunk=chunk, split_terms=1), want,
                      torch.bfloat16)
    assert max(split) <= 1.0 < 4.0 < once[0]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_work_counts_the_recurrence_whatever_the_chunk(monkeypatch,
                                                           dtype):
    """The yardstick of the kernel's bound: each input read once and each
    output written once, and 4 P N operations a step and head, the same
    whichever chunk the kernel takes."""
    args = _ssd_torch(_ssd_np(2, 300, 8, 2, 16, 32, seed=0), dtype)
    x, dt, a, bm, cm = args
    y, hf = tss.ssd_scan_ref(*args)
    want_bytes = sum(t.numel() * t.element_size()
                     for t in (x, dt, a, bm, cm, y, hf))
    got = tss.work(2, 300, 8, 2, 16, 32, x.element_size())
    assert got == (want_bytes, 4.0 * 2 * 300 * 8 * 16 * 32)
    monkeypatch.setattr(tss, "CHUNK", 128)
    monkeypatch.setattr(tss, "F32_CHUNK", 32)
    assert tss.work(2, 300, 8, 2, 16, 32, x.element_size()) == got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 160, 4, 1, 64, 128),
                                   (1, 100, 2, 2, 128, 128)],
                         ids=["P 64 N 128", "P 128 N 128 G 2"])
def test_ssd_model_wide_state_matches_the_jax_oracle(shape, dtype):
    """mamba2-1.3b's state N = 128 (and P = 128): the model at the chunk
    the kernel takes for that N against the reference's ``ref.ssd_scan``
    and the plain version, at chip_smoke's limits."""
    tdtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    arrays = _ssd_np(*shape, seed=6)
    args = _ssd_torch(arrays, tdtype)
    got = ssd_model(*args, chunk=tss.chunk_for(tdtype, shape[5]),
                    split_terms=2 if dtype == "bfloat16" else None)
    wy, wh = _ssd_worst(got, tss.ssd_scan_ref(*args), tdtype)
    assert wy <= 1.0 and wh <= 1.0
    jargs = [jnp.asarray(v) for v in arrays]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    yr, hr = jref.ssd_scan(jargs[0].astype(jdt), jargs[1].astype(jdt),
                           jargs[2], jargs[3].astype(jdt),
                           jargs[4].astype(jdt), return_state=True)
    want = (torch.from_numpy(np.asarray(yr, np.float32)).to(tdtype),
            torch.from_numpy(np.asarray(hr, np.float32)))
    wy, wh = _ssd_worst(got, want, tdtype)
    assert wy <= 1.0 and wh <= 1.0


def test_ssd_chunk_for_follows_the_state_size():
    """The float32 kernel takes 128-step chunks up to N = 64 and 64-step
    chunks above, where 128 steps would pass the 227 KiB a block may have
    (the C entry refuses such a chunk); the bf16 kernel takes ``CHUNK``
    at every N the kernels take (multiples of 4 up to 128)."""
    for n in range(4, tss.MAX_STATE + 1, 4):
        assert tss.chunk_for(torch.float32, n) == (128 if n <= 64 else 64)
        assert tss.chunk_for(torch.bfloat16, n) == tss.CHUNK == 64


# ---------------------------------------------------------------------------
# blockgram
# ---------------------------------------------------------------------------

# the kernel's products, the smallest first: mid.mid, hi.lo, lo.hi,
# hi.mid, mid.hi, hi.hi (0 = hi, 1 = mid, 2 = lo)
SIX = ((1, 1), (0, 2), (2, 0), (0, 1), (1, 0), (0, 0))


def blockgram_model(a, *, products=SIX, skip=True, plan=None):
    """The kernel's arithmetic: W cut into the launch plan's slices; a is
    split into bf16 terms hi = bf16(x), mid = bf16(x - hi), lo = x - hi -
    mid (bf16 input: hi alone); per 16-column k-step the products term_i
    term_j^T listed in ``products`` (in that order, bf16 values, float32
    sums) start from zero and are added to the slice's sum in float32; in a
    32-column stage whose mid (lo) terms are all zero the products that
    involve mid (lo) are skipped (``skip``); the slices' partial grams are
    added in slice order and the upper triangle is mirrored."""
    d, m, w = a.shape
    slices, cols = plan or tbg.launch_plan(d, m, w, a.dtype)
    if a.dtype == torch.float32:
        terms = _terms(a, 3)
    else:
        terms = [a.float()] + [torch.zeros(a.shape)] * 2
    total = None
    for s in range(slices):
        k_lo, k_hi = s * cols, min(w, (s + 1) * cols)
        g = torch.zeros((d, m, m))
        for c0 in range(k_lo, k_hi, tbg.STAGE_COLS):
            stage = slice(c0, min(k_hi, c0 + tbg.STAGE_COLS))
            zero = [False] + [not bool(t[:, :, stage].any())
                              for t in terms[1:]]
            for k0 in range(c0, min(k_hi, c0 + tbg.STAGE_COLS), 16):
                ks = slice(k0, min(k_hi, k0 + 16))
                part = torch.zeros((d, m, m))
                for i, j in products:
                    if skip and (zero[i] or zero[j]):
                        continue
                    part = part + terms[i][:, :, ks] @ terms[j][:, :, ks].mT
                g = g + part
        total = g if total is None else total + g
    upper = torch.triu(total)
    return upper + torch.triu(total, 1).mT


def _bg_gauss(shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _bg_mixed(shape, seed=0):
    """Gaussian, with every other column rounded to bf16."""
    a = _bg_gauss(shape, seed)
    a[:, :, ::2] = a[:, :, ::2].to(torch.bfloat16).float()
    return a


# Float32 values that the split serves worst (found by a search over
# [1, 2)): the product of WORST[name] with itself errs by the most relative
# to x^2 when the products ``name`` leaves out are left out.
WORST = {"two terms": 1.0038985013961792,      # hi.hi + hi.mid + mid.hi
         "no mid.mid": 1.0039061307907104,
         "no lo": 1.0020065307617188}


def _bg_worst(shape, x, seed=0):
    """Rows of +-x scaled by powers of two (scaling by 2^k leaves the split
    relative error as it is), so every product errs the same way."""
    rng = np.random.default_rng(seed)
    v = (x * rng.choice([-1.0, 1.0], shape)
         * np.exp2(rng.integers(-3, 4, shape))).astype(np.float32)
    return torch.from_numpy(v)


def _bg_gram64(a):
    a64 = a.double()
    return (a64 @ a64.mT).float()


def _bg_rel(got, want):
    want = torch.as_tensor(np.asarray(want, np.float32))
    return float((got - want).abs().max()) / float(want.abs().max())


def test_blockgram_model_exact_on_0_1_data():
    """0/1 values (the paper matrix made dense): one product each, every
    sum a small integer, so the model equals the plain version and the
    reference's ``ref.blockgram`` exactly."""
    rng = np.random.default_rng(1)
    x = (rng.random((2, 96, 3001)) < 0.05).astype(np.float32)
    got = blockgram_model(torch.from_numpy(x))
    assert torch.equal(got, tbg.blockgram_ref(torch.from_numpy(x)))
    for k in range(2):
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(jref.blockgram(
                                          jnp.asarray(x[k]))))


@pytest.mark.parametrize("shape", [(2, 67, 4099), (1, 130, 2600),
                                   (3, 40, 5000), (1, 8, 5), (2, 40, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blockgram_model_gaussian_within_1e5(shape, dtype):
    """Gaussian data, long rows and short: the six bf16 products keep G
    within 1e-5 of max|G| against the float64 gram, the plain version and
    ``ref.blockgram``; bf16 input takes one product."""
    a = _bg_gauss(shape)
    if dtype == "bfloat16":
        a = a.to(torch.bfloat16)
    got = blockgram_model(a)
    assert torch.equal(got, got.mT)
    assert _bg_rel(got, _bg_gram64(a)) <= 1e-5
    assert _bg_rel(got, tbg.blockgram_ref(a)) <= 1e-5
    for k in range(shape[0]):
        want = jref.blockgram(jnp.asarray(a[k].float().numpy()))
        assert _bg_rel(got[k], want) <= 1e-5


@pytest.mark.parametrize("shape", [(1, 8, 5), (3, 67, 203), (1, 64, 4099)])
def test_blockgram_model_mixed_within_1e5(shape):
    """Gaussian with every other column exact in bf16 (stages whose mid
    and lo differ from stage to stage): within 1e-5 of max|G| of the
    float64 gram and of ``ref.blockgram``."""
    a = _bg_mixed(shape, seed=4)
    got = blockgram_model(a)
    assert _bg_rel(got, _bg_gram64(a)) <= 1e-5
    for k in range(shape[0]):
        want = jref.blockgram(jnp.asarray(a[k].numpy()))
        assert _bg_rel(got[k], want) <= 1e-5


@pytest.mark.parametrize("name", sorted(WORST))
@pytest.mark.parametrize("shape", [(1, 8, 5), (2, 40, 203), (1, 16, 21363)])
def test_blockgram_model_needs_six_products(name, shape):
    """Rows of the values the split serves worst, short and as long as the
    dense solve's: the six products stay within 1e-5 of max|G| (float64
    gram), and the sets that leave out a term -- two terms (hi.hi +
    hi.mid + mid.hi), no mid.mid, no lo -- miss it on the values that
    expose them."""
    a = _bg_worst(shape, WORST[name], seed=5)
    want = _bg_gram64(a)
    fewer = {"two terms": ((0, 1), (1, 0), (0, 0)),
             "no mid.mid": SIX[1:],
             "no lo": ((1, 1),) + SIX[3:]}
    assert _bg_rel(blockgram_model(a), want) <= 1e-5
    assert _bg_rel(blockgram_model(a, products=fewer[name]), want) > 1e-5


@pytest.mark.parametrize("kind", ["0/1", "half bf16-exact",
                                  "half exact in two terms"])
def test_blockgram_zero_term_skipping_changes_no_bit(kind):
    """A stage whose mid (lo) terms are all zero skips the products that
    take them: the gram is the same bits as without skipping."""
    rng = np.random.default_rng(3)
    if kind == "0/1":
        a = torch.from_numpy((rng.random((2, 70, 2500)) < 0.1)
                             .astype(np.float32))
    else:
        a = _bg_gauss((2, 70, 2500), seed=3)
        hi = a[:, :, :1280].to(torch.bfloat16).float()
        if kind == "half bf16-exact":
            a[:, :, :1280] = hi
        else:
            rest = a[:, :, :1280] - hi
            a[:, :, :1280] = hi + rest.to(torch.bfloat16).float()
    assert torch.equal(blockgram_model(a, skip=True),
                       blockgram_model(a, skip=False))


def test_blockgram_three_terms_are_float32_exactly():
    """The pack's split: hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi
    - mid), each remainder exact in float32; hi + mid + lo is x for every
    float32 of normal size, and lo needs no rounding."""
    rng = np.random.default_rng(6)
    x = (rng.standard_normal(200_000)
         * np.exp2(rng.integers(-60, 60, 200_000))).astype(np.float32)
    x = torch.from_numpy(x)
    hi, mid, lo = _terms(x, 3)
    rest = x - hi - mid
    assert torch.equal(lo, rest)
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())


def test_blockgram_launch_plan_is_a_function_of_the_shape():
    """The plan (and with it the order of every sum) depends only on (D,
    M, W, dtype): 12 slices of 1,792 columns at the dense solve's shape,
    whole stages, covering W; one slice for short rows."""
    plan = tbg.launch_plan(8, 539, 21363, torch.float32)
    assert plan == (12, 1792)
    assert tbg.launch_plan(8, 539, 21363, torch.float32) == plan
    assert tbg.launch_plan(8, 539, 21363, torch.bfloat16) == plan
    for d, m, w in ((8, 539, 21363), (1, 539, 170_893), (3, 67, 203),
                    (2, 130, 31), (1, 8, 0), (4, 1000, 9999)):
        slices, cols = tbg.launch_plan(d, m, w, torch.float32)
        assert cols % tbg.STAGE_COLS == 0 and slices >= 1
        assert slices * cols >= w and (slices - 1) * cols < max(w, 1)
    assert tbg.launch_plan(3, 67, 203, torch.float32)[0] == 1
    with pytest.raises(TypeError):
        tbg.launch_plan(1, 8, 8, torch.float64)


def test_blockgram_work_at_the_solver_shape():
    """``work`` at (8, 539, 21363) float32: A read and G written once, D M
    (M + 1) W operations; at 3.35 TB/s and 989 / 6 TFLOP/s the bound is
    0.302 ms (operations), at one product (0/1 data) 0.113 ms (bytes)."""
    nbytes, ops = tbg.work(8, 539, 21363, 4)
    assert nbytes == 8 * 539 * 21363 * 4 + 8 * 539 * 539 * 4 == 377_765_696
    assert ops == 8 * 539 * 540 * 21363 == 49_743_318_240
    assert abs(ops / (989e12 / 6) * 1e3 - 0.3018) < 1e-4
    assert abs(nbytes / 3.35e12 * 1e3 - 0.1128) < 1e-4
    assert tbg.work(8, 539, 21363, 2)[0] \
        == 8 * 539 * 21363 * 2 + 8 * 539 ** 2 * 4


# ---------------------------------------------------------------------------
# topk_score
# ---------------------------------------------------------------------------

SENTINEL = (float("-inf"), 0x7fffffff)


def better(a, b):
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def key_of(e):
    """The kernel's order-preserving 64-bit key (larger is better)."""
    u = struct.unpack("<I", struct.pack("<f", e[0] + 0.0))[0]
    u ^= 0xffffffff if u >> 31 else 0x80000000
    return (u << 32) | (~e[1] & 0xffffffff)


def rank_merge(lst, cands):
    """The kernel's merge: candidates sorted best-first; a list entry goes
    to its index plus the number of candidates strictly better, a candidate
    to its index plus the number of list entries not worse; the first
    len(lst) places are kept."""
    cands = sorted(cands, key=key_of, reverse=True)
    out = [None] * (len(lst) + len(cands))
    for i, e in enumerate(lst):
        out[i + sum(better(c, e) for c in cands)] = e
    for j, c in enumerate(cands):
        out[j + sum(not better(c, e) for e in lst)] = c
    assert all(e is not None for e in out)       # a bijection
    return out[:len(lst)]


def topk_model(scores, k_top, *, chunk_cols, tile, cap, order,
               share_bounds=True, index_offset=0):
    """Pass 1 chunk by chunk in ``order`` (threshold filter, candidate
    buffer of ``cap``, merge when it might not take another tile or while
    the list is not full, bound published after each merge), then pass 2
    over the chunk lists in chunk order with a 32-wide offer and the same
    merge."""
    b, n = scores.shape
    chunks = -(-n // chunk_cols)
    lists = {}
    out_v = np.empty((b, k_top), np.float32)
    out_i = np.empty((b, k_top), np.int64)
    for q in range(b):
        published = SENTINEL
        for ch in order(chunks):
            lst, buf = [SENTINEL] * k_top, []
            cols = range(ch * chunk_cols, min(n, (ch + 1) * chunk_cols))
            starts = list(range(cols.start, cols.stop, tile))
            for t, t0 in enumerate(starts):
                tau = lst[-1]
                if share_bounds and better(published, tau):
                    tau = published
                buf += [(float(scores[q, c]), c)
                        for c in range(t0, min(cols.stop, t0 + tile))
                        if better((float(scores[q, c]), c), tau)]
                assert len(buf) <= cap
                filling = lst[-1] == SENTINEL
                if len(buf) > (0 if t == len(starts) - 1 or filling
                               else cap - tile):
                    lst, buf = rank_merge(lst, buf), []
                    if key_of(lst[-1]) > key_of(published):
                        published = lst[-1]
            lists[q, ch] = lst
        lst, buf, tau = [SENTINEL] * k_top, [], SENTINEL
        offered = [e for ch in range(chunks) for e in lists[q, ch]]
        for s in range(0, len(offered), 32):
            buf += [e for e in offered[s:s + 32] if better(e, tau)]
            if len(buf) > cap - 32:
                lst, buf = rank_merge(lst, buf), []
                tau = lst[-1]
        lst = rank_merge(lst, buf)
        out_v[q] = [e[0] for e in lst]
        out_i[q] = [e[1] + index_offset for e in lst]
    return out_v, out_i


def _scores(qs, v, scale=None, valid_n=None):
    """The scores as ``topk_score_ref`` forms them (ascending k, one
    rounding a product, then the scale, then the mask)."""
    acc = np.zeros((qs.shape[0], v.shape[0]), np.float32)
    vf = v.astype(np.float32)
    for i in range(qs.shape[1]):
        acc = acc + qs[:, i, None] * vf[None, :, i]
    if scale is not None:
        acc = acc * scale[None, :]
    if valid_n is not None and valid_n < v.shape[0]:
        acc[:, max(valid_n, 0):] = -np.inf
    return acc


def _shuffled(seed):
    def order(chunks):
        return list(np.random.default_rng(seed).permutation(chunks))
    return order


def _int_inputs(b, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-3, 4, size=(b, k)).astype(np.float32),
            rng.integers(-3, 4, size=(n, k)).astype(np.float32))


def _hold(qs, v, k_top, got, **kw):
    """``got`` equals topk_score_ref and the JAX oracle bit for bit."""
    tkw = {k: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
           for k, x in kw.items()}
    want = ttk.topk_score_ref(torch.from_numpy(qs), torch.from_numpy(v),
                              k_top, **tkw)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    jkw = {k: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
           for k, x in kw.items()}
    jv, ji = jref.topk_score(jnp.asarray(qs), jnp.asarray(v), k_top, **jkw)
    np.testing.assert_array_equal(got[0], np.asarray(jv))
    np.testing.assert_array_equal(got[1], np.asarray(ji))


@pytest.mark.parametrize("b,k,n,k_top,chunk_cols,tile,cap", [
    (3, 5, 700, 10, 128, 64, 128),     # the kernel's tile and buffer
    (4, 8, 1000, 16, 96, 8, 16),       # merges on nearly every tile
    (2, 16, 513, 33, 256, 32, 64),     # ragged last chunk and tile
    (5, 3, 130, 7, 16, 4, 8),          # many chunks, tiny buffers
])
@pytest.mark.parametrize("seed", [0, 1])
def test_topk_model_tie_heavy_bitwise(b, k, n, k_top, chunk_cols, tile, cap,
                                      seed):
    """Integer inputs (exact sums, scores tie often), chunks offered in a
    shuffled order: the model equals the plain version and the oracle."""
    qs, v = _int_inputs(b, k, n, seed=10 * b + seed)
    got = topk_model(_scores(qs, v), k_top, chunk_cols=chunk_cols,
                     tile=tile, cap=cap, order=_shuffled(seed))
    _hold(qs, v, k_top, got)


def test_topk_model_three_way_ties_resolve_to_lowest_index():
    qs, base = _int_inputs(4, 8, 75, seed=3)
    v = np.concatenate([base, base, base])
    got = topk_model(_scores(qs, v), 9, chunk_cols=32, tile=8, cap=16,
                     order=_shuffled(5))
    _hold(qs, v, 9, got)


@pytest.mark.parametrize("valid_n,offset", [(613, 1000), (640, 0), (11, 7)])
def test_topk_model_scale_offset_valid_n(valid_n, offset):
    qs, v = _int_inputs(5, 12, 640, seed=4)
    scale = (2.0 ** np.random.default_rng(5).integers(-2, 3, size=640)
             ).astype(np.float32)
    got = topk_model(_scores(qs, v, scale, valid_n), 11, chunk_cols=128,
                     tile=32, cap=64, order=_shuffled(2), index_offset=offset)
    _hold(qs, v, 11, got, scale=scale, valid_n=valid_n, index_offset=offset)


def test_topk_model_int8_factors_with_kvquant_scale():
    rng = np.random.default_rng(6)
    qs = rng.integers(-3, 4, size=(4, 8)).astype(np.float32)
    v = rng.standard_normal((300, 8)).astype(np.float32) * 2.0
    v_q, v_scale = jkvquant.quantize(jnp.asarray(v), axis=-1)
    v_q, scale = np.array(v_q), np.array(v_scale)[:, 0]
    got = topk_model(_scores(qs, v_q, scale, 300), 6, chunk_cols=64,
                     tile=16, cap=32, order=_shuffled(1))
    _hold(qs, v_q, 6, got, scale=scale, valid_n=300)


def test_topk_model_k_top_above_valid_columns():
    """valid_n = 3 < k_top = 6: the masked columns score -inf, tie, and
    follow the valid ones by index."""
    qs, v = _int_inputs(2, 4, 10, seed=9)
    got = topk_model(_scores(qs, v, valid_n=3), 6, chunk_cols=4, tile=2,
                     cap=4, order=_shuffled(3))
    want = ttk.topk_score_ref(torch.from_numpy(qs), torch.from_numpy(v), 6,
                              valid_n=3)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    assert got[1][:, 3:].tolist() == [[3, 4, 5], [3, 4, 5]]


@pytest.mark.parametrize("share", [True, False])
def test_topk_model_gaussian_with_and_without_shared_bounds(share):
    """Distinct float32 scores: sharing thresholds across chunks changes
    what each chunk keeps, never the answer."""
    rng = np.random.default_rng(12)
    qs = rng.standard_normal((3, 16)).astype(np.float32)
    v = rng.standard_normal((2000, 16)).astype(np.float32)
    got = topk_model(_scores(qs, v), 20, chunk_cols=256, tile=64, cap=128,
                     order=_shuffled(4), share_bounds=share)
    want = ttk.topk_score_ref(torch.from_numpy(qs), torch.from_numpy(v), 20)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())


def test_topk_key_orders_like_better():
    """The published key orders entries as ``better`` does, -0 and +0
    alike."""
    vals = [float("-inf"), -3.5, -0.0, 0.0, 1e-40, 2.0, float("inf")]
    entries = [(x, i) for x in vals for i in (0, 5, 0x7fffffff)]
    for a in entries:
        for b in entries:
            assert (key_of(a) > key_of(b)) == better(a, b), (a, b)
    assert key_of(SENTINEL) > 0


@pytest.mark.parametrize("b,n,block_n,want", [
    (256, 1_048_576, 512, (32, 32256, 33)),
    (32, 170_904, 512, (32, 1024, 167)),
    (5, 1000, 128, (8, 128, 8)),
    (33, 700, 256, (32, 256, 3)),
])
def test_topk_launch_plan(b, n, block_n, want):
    qb, chunk_cols, chunks = ttk.launch_plan(b, n, block_n, 132,
                                             {32: True, 8: True})
    assert (qb, chunk_cols, chunks) == want
    assert chunk_cols % block_n == 0 and chunks * chunk_cols >= n
    assert (chunks - 1) * chunk_cols < n           # no empty chunk


def test_topk_launch_plan_falls_back_and_refuses():
    assert ttk.launch_plan(100, 5000, 128, 132, {32: False, 8: True})[0] == 8
    with pytest.raises(ValueError, match="shared memory"):
        ttk.launch_plan(100, 5000, 128, 132, {32: False, 8: False})


# ---------------------------------------------------------------------------
# sparse_gram
# ---------------------------------------------------------------------------

def _ell(d, c, k, m, *, seed=0, weighted=True, zero_frac=0.4,
         duplicates=False, empty_block=None, heavy_row=None):
    """Seeded (D, C, K) ELL arrays with padding slots anywhere in a column;
    optionally duplicate (column, row) slots, an all-padding block and
    ``heavy_row`` = (row, columns): that row in the first ``columns``
    columns of every block."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, size=(d, c, k)).astype(np.int32)
    vals = (rng.uniform(0.5, 2.0, (d, c, k)) if weighted
            else np.ones((d, c, k))).astype(np.float32)
    vals *= rng.random((d, c, k)) >= zero_frac
    if heavy_row is not None:
        r, cols = heavy_row
        rows[:, :cols, 0] = r
        vals[:, :cols, 0] = (rng.uniform(0.5, 2.0, (d, cols)) if weighted
                             else 1.0)
    if duplicates and k > 1:
        rows[:, ::3, -1] = rows[:, ::3, 0]
    if empty_block is not None:
        vals[empty_block] = 0.0
    rows[vals == 0] = 0
    return torch.from_numpy(rows), torch.from_numpy(vals)


def sg_row_index(rows, vals, m, seed=0):
    """The kernels' row index of one block, (offsets, lists): integer counts
    per row, their exclusive scan, a placement in an arbitrary order (the
    atomics' order: here a seeded shuffle), then each row's list sorted,
    as the gram pass sorts it."""
    r = rows.reshape(-1).numpy()
    live = np.flatnonzero(vals.reshape(-1).numpy() != 0)
    counts = np.bincount(r[live], minlength=m)
    off = np.concatenate([[0], np.cumsum(counts)])
    cursor = off[:-1].copy()
    lists = np.empty(len(live), np.int64)
    for s in np.random.default_rng(seed).permutation(live):
        lists[cursor[r[s]]] = s
        cursor[r[s]] += 1
    for i in range(m):
        lists[off[i]:off[i + 1]].sort()
    return off, lists


def sparse_gram_model(rows, vals, m, *, warps=None, epw=None, split=None,
                      seg_cap=None):
    """The kernel's order of every sum, in float32 (``csrc/sparse_gram.cu``),
    at the module's launch plan unless given one: per row r1 its list in
    ascending slot order; a row of at most ``epw``
    entries is one warp's, a longer one of n entries is cut into pieces of
    ``seg_cap`` and shared by nw = min(warps, ceil(n / split)) warps, each a
    contiguous part of every piece; a warp takes its entries 32 at a time,
    their pairs (entry, slot k2 < the length of its column: the last non-zero
    slot + 1) one flat sequence, 32 a step; in a step the products
    v(r1, c) * v(r2, c) of one r2 are summed in lane order and the sum added
    to the warp's copy of the row; the copies are summed in warp order."""
    warps = warps or tsg.WARPS
    epw = epw or tsg.entries_per_warp(m)
    split = split or tsg.SPLIT
    seg_cap = seg_cap or tsg.SEG_CAP
    d, c, k = rows.shape
    out = np.zeros((d, m, m), np.float32)
    f32 = np.float32
    for b in range(d):
        r = rows[b].reshape(-1).numpy()
        v = vals[b].reshape(-1).numpy()
        live = vals[b].numpy() != 0
        lens = np.where(live.any(1), k - np.argmax(live[:, ::-1], axis=1), 0)
        off, lists = sg_row_index(rows[b], vals[b], m)
        for r1 in range(m):
            lst = lists[off[r1]:off[r1 + 1]]
            n = len(lst)
            if n == 0:
                continue
            if n <= epw:
                nw, pieces = 1, [lst]
            else:
                nw = min(warps, -(-n // split))
                pieces = [lst[i:i + seg_cap] for i in range(0, n, seg_cap)]
            copies = np.zeros((nw, m), np.float32)
            for piece in pieces:
                plen = len(piece)
                for w in range(nw):
                    part = piece[w * plen // nw:(w + 1) * plen // nw]
                    for e0 in range(0, len(part), 32):
                        pairs = [(s1, s1 // k * k + k2)
                                 for s1 in part[e0:e0 + 32]
                                 for k2 in range(lens[s1 // k])]
                        for q0 in range(0, len(pairs), 32):
                            groups = {}
                            for s1, s2 in pairs[q0:q0 + 32]:
                                if v[s2] != 0:
                                    groups.setdefault(r[s2], []).append(
                                        f32(v[s1]) * f32(v[s2]))
                            for r2, ps in groups.items():
                                t = ps[0]
                                for x in ps[1:]:
                                    t = f32(t + x)
                                copies[w, r2] = f32(copies[w, r2] + t)
            row = copies[0]
            for w in range(1, nw):
                row = row + copies[w]
            out[b, r1] = row
    return torch.from_numpy(out)


def _sg_f64(rows, vals, m):
    out = []
    for b in range(rows.shape[0]):
        p = torch.zeros((rows.shape[1], m), dtype=torch.float64)
        p.scatter_add_(1, rows[b].long(), vals[b].double())
        out.append((p.T @ p).float())
    return torch.stack(out)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sparse_gram_row_index_complete_and_ascending(seed):
    """Each row's list holds every non-zero slot of that row, once, in
    ascending (c, k) order, at offsets that are the exclusive scan of the
    counts, whatever order the placement took (duplicates and padding
    anywhere in a column)."""
    rows, vals = _ell(1, 300, 6, 41, seed=seed, duplicates=True)
    off, lists = sg_row_index(rows[0], vals[0], 41, seed=seed)
    _, again = sg_row_index(rows[0], vals[0], 41, seed=seed + 10)
    np.testing.assert_array_equal(lists, again)
    r = rows[0].reshape(-1).numpy()
    live = np.flatnonzero(vals[0].reshape(-1).numpy() != 0)
    assert off[-1] == len(live)
    for i in range(41):
        got = lists[off[i]:off[i + 1]]
        np.testing.assert_array_equal(got, live[r[live] == i])
        assert np.all(np.diff(got) > 0)


@pytest.mark.parametrize("case", ["paper-like", "K 36", "ragged M 33"])
def test_sparse_gram_model_exact_on_0_1_data(case):
    """0/1 data: every partial sum is a small integer, so the model equals
    the plain version and the reference's jnp oracle bit for bit."""
    d, c, k, m = {"paper-like": (2, 600, 5, 67), "K 36": (1, 120, 36, 50),
                  "ragged M 33": (2, 90, 3, 33)}[case]
    rows, vals = _ell(d, c, k, m, seed=3, weighted=False, duplicates=True)
    got = sparse_gram_model(rows, vals, m)
    assert torch.equal(got, tsg.sparse_gram_ref(rows, vals, m))
    for b in range(d):
        np.testing.assert_array_equal(
            got[b].numpy(), np.asarray(jref.sparse_gram(
                jnp.asarray(rows[b].numpy()), jnp.asarray(vals[b].numpy()),
                m)))


@pytest.mark.parametrize("case,shape,kw,plan", [
    ("duplicates, block 1 all padding", (3, 37, 5, 67),
     dict(duplicates=True, empty_block=1), {}),
    ("K 36 > 32, M 100", (2, 80, 36, 100), dict(duplicates=True), {}),
    ("M 33", (2, 64, 1, 33), {}, {}),
    ("a row over several warps and pieces", (1, 700, 3, 40),
     dict(heavy_row=(5, 650)), dict(epw=16, split=8, seg_cap=64)),
    ("a row in 2,100 columns, the kernel's plan", (1, 2300, 2, 24),
     dict(heavy_row=(7, 2100)), {}),
])
def test_sparse_gram_model_weighted_within_1e5(case, shape, kw, plan):
    """Weighted data: the model is within 1e-5 of max|G| of a float64 sum,
    of the plain version and of the jnp oracle; an all-padding block gives
    zeros; a heavy row is cut into pieces and shared by warps."""
    d, c, k, m = shape
    rows, vals = _ell(d, c, k, m, seed=4, **kw)
    got = sparse_gram_model(rows, vals, m, **plan)
    want = _sg_f64(rows, vals, m)
    assert_close_rel(got, want)
    assert_close_rel(got, tsg.sparse_gram_ref(rows, vals, m))
    for b in range(d):
        assert_close_rel(got[b], jref.sparse_gram(
            jnp.asarray(rows[b].numpy()), jnp.asarray(vals[b].numpy()), m))
    if kw.get("empty_block") is not None:
        assert float(got[kw["empty_block"]].abs().max()) == 0.0


def test_sparse_gram_model_matches_the_pallas_body(monkeypatch):
    """The model against the reference's Pallas body in interpret mode
    (through its padding wrapper), weighted with duplicates."""
    rows, vals = _ell(2, 40, 4, 24, seed=5, duplicates=True)
    got = sparse_gram_model(rows, vals, 24)
    monkeypatch.setenv("REPRO_KERNELS", "interpret")
    for b in range(2):
        assert_close_rel(got[b], jops.sparse_gram(
            jnp.asarray(rows[b].numpy()), jnp.asarray(vals[b].numpy()), 24))


def test_sparse_gram_model_heavy_split_changes_only_last_bits():
    """The plan fixes the order: two plans give results within float32
    rounding of each other, and each is the same bits when computed again
    (the placement order does not enter)."""
    rows, vals = _ell(1, 500, 3, 30, seed=6, heavy_row=(2, 450))
    a = sparse_gram_model(rows, vals, 30, epw=16, split=8, seg_cap=64)
    b = sparse_gram_model(rows, vals, 30)
    assert torch.equal(a, sparse_gram_model(rows, vals, 30, epw=16, split=8,
                                            seg_cap=64))
    assert_close_rel(a, b)


@pytest.mark.parametrize("d,c,k,m", [(8, 5096, 5, 539), (8, 84104, 8, 2048),
                                     (3, 37, 5, 67), (1, 1, 0, 1)])
def test_sparse_gram_workspace_is_a_function_of_the_shape(d, c, k, m):
    """The int32 scratch: 8 counters, D M + 1 offsets, D M heavy rows, D C
    column lengths, D C K ranks and D C K list entries: the shape alone
    sizes it, so no call waits on the data to allocate."""
    n = tsg.workspace_ints(d, c, k, m)
    assert n == 2 * d * m + 9 + d * c + 2 * d * c * k
    assert n < 2 ** 31
    assert tsg.SEG_CAP & (tsg.SEG_CAP - 1) == 0
    assert 1 <= tsg.WARPS <= 32 and tsg.ROW_CHUNK % 4 == 0


# ---------------------------------------------------------------------------
# sketch_panel
# ---------------------------------------------------------------------------

def sketch_panel_model(omega, rows, vals):
    """The kernel's arithmetic: each out[d, l, c] sums the slots of column c
    in ascending k, a rounded product and a rounded add a slot, val-0 slots
    skipped (float32 throughout)."""
    om = omega.numpy()
    r = rows.numpy()
    v = vals.numpy()
    d, c, k = r.shape
    out = np.zeros((d, om.shape[0], c), np.float32)
    for s in range(k):
        on = v[:, :, s] != 0
        prod = (om[:, r[:, :, s]].transpose(1, 0, 2)
                * v[:, None, :, s]).astype(np.float32)
        out = np.where(on[:, None, :], (out + prod).astype(np.float32), out)
    return torch.from_numpy(out)


@pytest.mark.parametrize("shape", [(2, 60, 5, 67, 24), (1, 40, 36, 90, 64),
                                   (3, 37, 5, 67, 41)])
def test_sketch_panel_model_is_the_plain_version_bit_for_bit(shape):
    """The kernel's slot order is the plain version's: the model equals
    ``sketch_panel_ref`` bit for bit (duplicates, padding anywhere, K = 36
    above a warp, L = 24, 41 and 64), and the jnp oracle within 1e-5."""
    d, c, k, m, l = shape
    rows, vals = _ell(d, c, k, m, seed=7, duplicates=True, empty_block=0)
    omega = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (l, m)).astype(np.float32))
    got = sketch_panel_model(omega, rows, vals)
    assert torch.equal(got, tsp.sketch_panel_ref(omega, rows, vals))
    assert float(got[0].abs().max()) == 0.0
    for b in range(d):
        assert_close_rel(got[b], jref.sketch_panel(
            jnp.asarray(omega.numpy()), jnp.asarray(rows[b].numpy()),
            jnp.asarray(vals[b].numpy())))


def test_sketch_panel_reads_omega_through_its_strides():
    """Omega's route on the card: (M, L) memory is gathered from as it is,
    (L, M) memory is transposed by the kernel (one launch either way), any
    other layout is copied first (two)."""
    om = torch.zeros((24, 539))
    assert tsp.omega_route(24, 539, om.stride()) == "transpose"
    assert tsp.omega_route(24, 539, om.T.contiguous().T.stride()) == "gather"
    strided = torch.zeros((24, 1078))[:, ::2]
    assert tsp.omega_route(24, 539, strided.stride()) == "copy"
    assert tsp.omega_route(1, 539, (539, 1)) == "gather"
    for t, n in ((om, 1), (om.T.contiguous().T, 1), (strided, 2)):
        assert tsp.device_kernels(24, 539, t.stride()) == n
    q, _ = torch.linalg.qr(torch.randn(300, 16))
    assert tsp.omega_route(16, 300, q.T.stride()) == "transpose"


def test_sketch_panel_omega_stack_is_each_blocks_own_sketch():
    """A (D, L, M) Omega stack (the per-block Q_d of the tree's sketch
    leaves): block d sums its slots against Omega_d in the kernel's order,
    the model of a one-Omega call on that block alone, bit for bit; its
    routes are read from the last two strides, as for one Omega (the
    batched QR's Q_d^T are (L, M)-contiguous: transposed in the kernel)."""
    d, c, k, m, l = 3, 37, 5, 67, 24
    rows, vals = _ell(d, c, k, m, seed=9, duplicates=True, empty_block=1)
    om = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (d, l, m)).astype(np.float32))
    got = tsp.sketch_panel_ref(om, rows, vals)
    for b in range(d):
        assert torch.equal(got[b], sketch_panel_model(
            om[b], rows[b:b + 1], vals[b:b + 1])[0])
    assert float(got[1].abs().max()) == 0.0
    q, _ = torch.linalg.qr(torch.randn(d, 300, 16))
    assert tsp.omega_route(16, 300, q.mT.stride()[-2:]) == "transpose"
    assert tsp.omega_route(l, m, om.stride()[-2:]) == "transpose"
    assert tsp.omega_route(l, m, om.mT.contiguous().mT.stride()[-2:]) == \
        "gather"
