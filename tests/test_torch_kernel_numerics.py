"""The arithmetic of the port's two Hopper kernels, modelled in plain torch on
the CPU and held against their plain versions and the JAX oracles.

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
* ``launch_plan`` and the flash wrapper's head-dim padding, which are plain
  Python on the launch path.
"""
import struct

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as jref
from repro.serve import kvquant as jkvquant

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import topk_score as ttk

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


def _worst_over_bf16_limit(got, want):
    """Largest |got - want| / (1 bf16 ulp of |want| + 2e-5 max|want|)."""
    tol = _bf16_ulp(want) + 2e-5 * float(want.float().abs().max())
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
