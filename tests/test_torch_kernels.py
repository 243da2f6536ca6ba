"""The port's six kernel modules against the JAX package, on the CPU.

For each of sparse_gram, blockgram, sketch_panel, topk_score,
flash_attention and ssd_scan the same inputs (made
with ``np.random.default_rng(seed)``) go through the port's plain PyTorch
version and through the JAX function, twice: the pure-jnp oracle
(``repro.kernels.ref``) and the Pallas kernel body in interpret mode.  The
CUDA kernels themselves run only on a GPU; ``chip_smoke.py`` holds them
against these same plain versions there.

Tolerance: 1e-5 relative to max|out| everywhere (float32, the order of the
sums differs between the implementations), looser only for bf16 input,
where the two frameworks are compared after both widen to float32 (exact
products, f32 summation order).  topk_score is compared BITWISE (values and
indices) on integer-valued inputs, where every sum is exact in float32 in
any order; on Gaussian inputs its values are held at rtol 1e-6 and its
indices wherever the reference's neighbouring scores lie further apart.
flash_attention is held at 2e-5 and ssd_scan at 1e-4 in float32 (online
against direct softmax; the Pallas body's chunked sums against the
sequential recurrence), and both at 8e-3 for a bf16 output (each side
rounds its float32 result to bf16 once: one bf16 ulp is 2**-8 relative).
"""
import subprocess
import sys
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import blockgram as jbg
from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import sketch_panel as jsp
from repro.kernels import sparse_gram as jsg
from repro.kernels import ssd_scan as jssd
from repro.serve import kvquant as jkvquant

import repro_torch
from repro_torch.core import sparse as tsparse
from repro_torch.kernels import blockgram as tbg
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sketch_panel as tsp
from repro_torch.kernels import sparse_gram as tsg
from repro_torch.kernels import ssd_scan as tss
from repro_torch.kernels import topk_score as ttk

from conftest import REPO
from test_torch_helpers import assert_close_rel


def _random_ell(m, c, k, seed=0, zero_frac=0.3, d=1, duplicates=False,
                empty_block=None, weighted=True):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, size=(d, c, k)).astype(np.int32)
    vals = (rng.standard_normal((d, c, k)) if weighted
            else np.ones((d, c, k))).astype(np.float32)
    vals[rng.random((d, c, k)) < zero_frac] = 0.0  # padding slots
    if duplicates and k > 1:
        rows[:, ::2, -1] = rows[:, ::2, 0]          # same row twice in a column
    if empty_block is not None:
        vals[empty_block] = 0.0                      # a block of padding only
    rows[vals == 0] = 0
    return rows, vals


# ---------------------------------------------------------------------------
# sparse_gram
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [8, 64, 128])
@pytest.mark.parametrize("c", [128, 512])
@pytest.mark.parametrize("k", [1, 8])
def test_sparse_gram_sweep(m, c, k):
    """Aligned shapes of the reference's own sweep: plain version vs the jnp
    oracle AND the Pallas body in interpret mode (1e-5 * max|G|)."""
    rows, vals = _random_ell(m, c, k)
    got = tsg.sparse_gram_ref(torch.from_numpy(rows), torch.from_numpy(vals), m)
    assert got.shape == (1, m, m) and got.dtype == torch.float32
    assert_close_rel(got[0], jref.sparse_gram(jnp.asarray(rows[0]), jnp.asarray(vals[0]), m))
    assert_close_rel(got[0], jsg.sparse_gram(jnp.asarray(rows[0].T), jnp.asarray(vals[0].T),
                                   m, block_c=128, interpret=True))


@pytest.mark.parametrize("m,c,k,kw", [
    (13, 60, 3, dict()),
    (67, 37, 5, dict(duplicates=True)),
    (24, 40, 4, dict(d=3, empty_block=1)),
    (31, 9, 2, dict(d=2, weighted=False, duplicates=True)),
])
def test_sparse_gram_ragged_duplicates_padding(monkeypatch, m, c, k, kw):
    """Ragged shapes, duplicate (column, row) slots and an all-padding block,
    per block against the jnp oracle and against the Pallas body (interpret
    mode, through the reference's padding wrapper)."""
    rows, vals = _random_ell(m, c, k, seed=1, **kw)
    got = tops.sparse_gram(torch.from_numpy(rows), torch.from_numpy(vals), m)
    monkeypatch.setenv("REPRO_KERNELS", "interpret")
    for d in range(rows.shape[0]):
        assert_close_rel(got[d], jref.sparse_gram(jnp.asarray(rows[d]),
                                        jnp.asarray(vals[d]), m))
        assert_close_rel(got[d], jops.sparse_gram(jnp.asarray(rows[d]),
                                        jnp.asarray(vals[d]), m))
    if kw.get("empty_block") is not None:
        assert float(got[kw["empty_block"]].abs().max()) == 0.0
    if not kw.get("weighted", True):
        # 0/1 data: every partial sum is a small integer, so exact.
        want = np.stack([np.asarray(jref.sparse_gram(
            jnp.asarray(rows[d]), jnp.asarray(vals[d]), m))
            for d in range(rows.shape[0])])
        np.testing.assert_array_equal(got.numpy(), want)


def test_sparse_gram_matches_dense_gram_of_container():
    """Container-built ELL gram == dense gram of the same block."""
    coo = tsparse.ensure_full_row_rank(
        tsparse.random_bipartite(24, 2000, 0.005, seed=2), seed=2)
    ell = tsparse.block_ell_from_coo(coo, 4, device="cpu")
    a = tsparse.pad_to_block_multiple(coo.todense(), 4)
    got = tops.sparse_gram(ell.col_rows, ell.col_vals, ell.m)
    for d in range(4):
        blk = a[:, d * ell.width:(d + 1) * ell.width]
        assert_close_rel(got[d], blk @ blk.T)


# ---------------------------------------------------------------------------
# blockgram
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [8, 64, 128])
@pytest.mark.parametrize("n", [256, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blockgram_sweep(m, n, dtype):
    """The reference's sweep.  bf16: both sides get the SAME bf16 values (made
    by rounding in torch, handed over as float32 bit patterns) and widen to
    f32, so the tolerance stays 1e-5 * max|G|."""
    rng = np.random.default_rng(m * 1000 + n)
    x = rng.standard_normal((m, n)).astype(np.float32)
    if dtype == "bfloat16":
        xt = torch.from_numpy(x).to(torch.bfloat16)
        x = xt.to(torch.float32).numpy()            # exactly representable
        xj = jnp.asarray(x).astype(jnp.bfloat16)
    else:
        xt = torch.from_numpy(x)
        xj = jnp.asarray(x)
    got = tbg.blockgram_ref(xt[None])
    assert got.shape == (1, m, m) and got.dtype == torch.float32
    assert_close_rel(got[0], jref.blockgram(xj))
    assert_close_rel(got[0], jbg.blockgram(xj, block_n=256, interpret=True))


@pytest.mark.parametrize("d,m,n", [(1, 13, 300), (3, 67, 203), (2, 130, 31)])
def test_blockgram_ragged(monkeypatch, d, m, n):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((d, m, n)).astype(np.float32)
    got = tops.blockgram(torch.from_numpy(x))
    assert got.shape == (d, m, m)
    monkeypatch.setenv("REPRO_KERNELS", "interpret")
    for i in range(d):
        assert_close_rel(got[i], jref.blockgram(jnp.asarray(x[i])))
        assert_close_rel(got[i], jops.blockgram(jnp.asarray(x[i])))


def test_blockgram_plain_version_sums_in_float32():
    """The plain version (the CPU path) is the reference's product: the
    input widened to float32 and summed in float32, exact on 0/1 data, and
    bf16 input gives the gram of its float32 widening."""
    rng = np.random.default_rng(8)
    x = (rng.random((2, 40, 5000)) < 0.2).astype(np.float32)
    got = tbg.blockgram_ref(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.einsum("dmw,dnw->dmn", x, x))
    g = torch.from_numpy(rng.standard_normal((1, 30, 700))
                         .astype(np.float32)).to(torch.bfloat16)
    g32 = g.float()
    got = tbg.blockgram_ref(g)
    assert got.dtype == torch.float32 and torch.equal(got, g32 @ g32.mT)
    assert_close_rel(got[0], jref.blockgram(jnp.asarray(g32[0].numpy())))


def test_blockgram_zeros():
    got = tops.blockgram(torch.zeros((2, 16, 512)))
    assert float(got.abs().max()) == 0.0


# ---------------------------------------------------------------------------
# sketch_panel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [128, 256])
@pytest.mark.parametrize("l", [8, 16])
@pytest.mark.parametrize("c", [128, 512])
@pytest.mark.parametrize("k", [1, 8])
def test_sketch_panel_sweep(m, l, c, k):
    rows, vals = _random_ell(m, c, k)
    omega = np.random.default_rng(7).standard_normal((l, m)).astype(np.float32)
    got = tsp.sketch_panel_ref(torch.from_numpy(omega), torch.from_numpy(rows),
                               torch.from_numpy(vals))
    assert got.shape == (1, l, c) and got.dtype == torch.float32
    assert_close_rel(got[0], jref.sketch_panel(jnp.asarray(omega), jnp.asarray(rows[0]),
                                     jnp.asarray(vals[0])))
    assert_close_rel(got[0], jsp.sketch_panel(jnp.asarray(omega), jnp.asarray(rows[0].T),
                                    jnp.asarray(vals[0].T), block_c=128,
                                    block_m=128, interpret=True))


@pytest.mark.parametrize("l,m,c,k,kw", [
    (5, 13, 60, 3, dict()),
    (41, 67, 37, 5, dict(duplicates=True)),
    (7, 24, 40, 4, dict(d=3, empty_block=1)),
])
def test_sketch_panel_ragged_duplicates_padding(monkeypatch, l, m, c, k, kw):
    rows, vals = _random_ell(m, c, k, seed=1, **kw)
    omega = np.random.default_rng(8).standard_normal((l, m)).astype(np.float32)
    got = tops.sketch_panel(torch.from_numpy(omega), torch.from_numpy(rows),
                            torch.from_numpy(vals))
    monkeypatch.setenv("REPRO_KERNELS", "interpret")
    for d in range(rows.shape[0]):
        assert_close_rel(got[d], jref.sketch_panel(jnp.asarray(omega),
                                         jnp.asarray(rows[d]),
                                         jnp.asarray(vals[d])))
        assert_close_rel(got[d], jops.sketch_panel(jnp.asarray(omega),
                                         jnp.asarray(rows[d]),
                                         jnp.asarray(vals[d])))
    if kw.get("empty_block") is not None:
        assert float(got[kw["empty_block"]].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# topk_score
# ---------------------------------------------------------------------------

def _int_topk_inputs(b, k, n, seed=0, lo=-3, hi=4):
    """Integer-valued queries and factors: every partial sum of a score is
    a small integer, exact in float32 whatever the order of the sums, and
    scores tie often."""
    rng = np.random.default_rng(seed)
    qs = rng.integers(lo, hi, size=(b, k)).astype(np.float32)
    v = rng.integers(lo, hi, size=(n, k)).astype(np.float32)
    return qs, v


def _topk_three_ways(monkeypatch, qs, v, k_top, *, block_n=512, scale=None,
                     valid_n=None, index_offset=0):
    """(port plain version, reference oracle, reference Pallas body in
    interpret mode), each as numpy (vals, idx)."""
    t_scale = None if scale is None else torch.from_numpy(scale)
    got = ttk.topk_score_ref(torch.from_numpy(qs), torch.from_numpy(v), k_top,
                             scale=t_scale, valid_n=valid_n,
                             index_offset=index_offset)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    j_scale = None if scale is None else jnp.asarray(scale)
    kw = dict(scale=j_scale, valid_n=valid_n, index_offset=index_offset)
    want = jref.topk_score(jnp.asarray(qs), jnp.asarray(v), k_top, **kw)
    monkeypatch.setenv("REPRO_KERNELS", "interpret")
    pallas = jops.topk_score(jnp.asarray(qs), jnp.asarray(v), k_top,
                             block_n=block_n, **kw)
    as_np = lambda pair: (np.asarray(pair[0]), np.asarray(pair[1]))  # noqa: E731
    return (got[0].numpy(), got[1].numpy()), as_np(want), as_np(pallas)


def _assert_bitwise(*pairs):
    first = pairs[0]
    for other in pairs[1:]:
        np.testing.assert_array_equal(first[0], other[0])
        np.testing.assert_array_equal(first[1], other[1])


@pytest.mark.parametrize(
    "b,k,n,k_top,block_n",
    [
        (3, 5, 700, 10, 256),    # ragged last tile
        (8, 16, 512, 4, 512),    # single tile
        (1, 3, 130, 7, 512),     # n < block_n, unaligned everything
        (5, 16, 1024, 16, 128),  # k_top == block_n grid stress
    ],
)
def test_topk_score_sweep_bitwise(monkeypatch, b, k, n, k_top, block_n):
    """The reference's sweep on integer-valued inputs (many exact ties): the
    plain version equals the oracle and the Pallas body bit for bit, values
    and indices, ties to the lowest index."""
    qs, v = _int_topk_inputs(b, k, n, seed=b * 100 + k)
    _assert_bitwise(*_topk_three_ways(monkeypatch, qs, v, k_top,
                                      block_n=block_n))


def test_topk_score_three_way_ties_resolve_to_lowest_index(monkeypatch):
    qs, base = _int_topk_inputs(4, 8, 75, seed=3)
    v = np.concatenate([base, base, base])           # every score a 3-way tie
    ours, want, pallas = _topk_three_ways(monkeypatch, qs, v, 9, block_n=128)
    _assert_bitwise(ours, want, pallas)
    # within a run of equal scores the indices ascend
    same = ours[0][:, 1:] == ours[0][:, :-1]
    assert (ours[1][:, 1:][same] > ours[1][:, :-1][same]).all()


@pytest.mark.parametrize("valid_n,offset", [(613, 1000), (640, 0), (11, 7)])
def test_topk_score_scale_offset_valid_n(monkeypatch, valid_n, offset):
    """Per-item scales (powers of two: exact products), a global index
    offset and a ragged valid width masking the padded tail."""
    qs, v = _int_topk_inputs(5, 12, 640, seed=4)
    scale = (2.0 ** np.random.default_rng(5).integers(-2, 3, size=640)
             ).astype(np.float32)
    ours, want, pallas = _topk_three_ways(
        monkeypatch, qs, v, 11, block_n=256, scale=scale, valid_n=valid_n,
        index_offset=offset)
    _assert_bitwise(ours, want, pallas)
    assert ours[1].min() >= offset and ours[1].max() < offset + valid_n


def test_topk_score_int8_factors(monkeypatch):
    """int8 factor rows + per-item dequant scales from ``kvquant``: the
    quantized serving path, with integer-valued queries."""
    rng = np.random.default_rng(6)
    qs = rng.integers(-3, 4, size=(4, 8)).astype(np.float32)
    v = rng.standard_normal((300, 8)).astype(np.float32) * 2.0
    v_q, v_scale = jkvquant.quantize(jnp.asarray(v), axis=-1)
    # Each score is an exact integer sum times one scale: a single
    # rounding, the same in all three.
    v_q = np.array(v_q)
    scale = np.array(v_scale)[:, 0]
    got = ttk.topk_score_ref(torch.from_numpy(qs), torch.from_numpy(v_q), 6,
                             scale=torch.from_numpy(scale), valid_n=300)
    want = jref.topk_score(jnp.asarray(qs), jnp.asarray(v_q), 6,
                           scale=jnp.asarray(scale), valid_n=300)
    monkeypatch.setenv("REPRO_KERNELS", "interpret")
    pallas = jops.topk_score(jnp.asarray(qs), jnp.asarray(v_q), 6,
                             scale=jnp.asarray(scale), valid_n=300,
                             block_n=128)
    for other in (want, pallas):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(other[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(other[1]))


@pytest.mark.parametrize("b,k,n,k_top", [(6, 8, 900, 10), (2, 16, 333, 33)])
def test_topk_score_gaussian(monkeypatch, b, k, n, k_top):
    """Gaussian inputs: the sums are rounded in another order by each
    implementation, so values are held at rtol 1e-6 and an index only where
    the reference's scores around it lie further apart than that."""
    rng = np.random.default_rng(n)
    qs = rng.standard_normal((b, k)).astype(np.float32)
    v = rng.standard_normal((n, k)).astype(np.float32)
    ours, want, pallas = _topk_three_ways(monkeypatch, qs, v, k_top,
                                          block_n=128)
    for ref_vals, ref_idx in (want, pallas):
        np.testing.assert_allclose(ours[0], ref_vals, rtol=1e-6, atol=1e-6)
        gap = np.abs(np.diff(ref_vals, axis=1))
        sep = np.ones_like(ref_vals, dtype=bool)
        tight = gap <= 1e-6 * np.abs(ref_vals[:, 1:])
        sep[:, 1:] &= ~tight
        sep[:, :-1] &= ~tight
        np.testing.assert_array_equal(ours[1][sep], ref_idx[sep])
        assert sep.mean() > 0.9


def test_topk_score_fewer_valid_columns_than_k_top_orders_masked_by_index():
    """Masked columns score -inf and tie: they follow the valid ones in
    ascending index order, as the stable sort (and the kernel's order)
    leave them."""
    qs, v = _int_topk_inputs(2, 4, 10, seed=9)
    vals, idx = tops.topk_score(torch.from_numpy(qs), torch.from_numpy(v), 6,
                                valid_n=3)
    assert torch.isinf(vals[:, 3:]).all()
    assert idx[:, 3:].tolist() == [[3, 4, 5], [3, 4, 5]]
    assert sorted(idx[0, :3].tolist()) == [0, 1, 2]


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

def _qkv(b, hq, hkv, sq, sk, d, seed=7):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, hq, sq, d), (b, hkv, sk, d),
                               (b, hkv, sk, d)))


def _as(x, dtype):
    """The same values as a torch tensor and a jax array of ``dtype``."""
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return t, jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype))


def _attn_rel(dtype):
    # float32: the order of the sums (online vs direct softmax, the kernel's
    # tiles); bfloat16: both sides round the f32 result to bf16 once, so
    # they may differ by one bf16 ulp (2**-8 relative) of the largest output
    return 2e-5 if dtype == "float32" else 8e-3


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", [
    (2, 4, 2, 128, 128, 64),
    (1, 8, 1, 64, 64, 128),    # MQA
    (1, 4, 4, 256, 256, 32),   # MHA
    (2, 4, 2, 64, 192, 64),    # right-aligned (sq < sk)
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_sweep(b, hq, hkv, sq, sk, d, dtype):
    """The reference's sweep: the plain version vs the jnp oracle AND the
    Pallas body in interpret mode, inputs rounded to ``dtype`` first."""
    (tq, jq), (tk, jk), (tv, jv) = (_as(x, dtype) for x in
                                    _qkv(b, hq, hkv, sq, sk, d))
    got = tfa.flash_attention_ref(tq, tk, tv)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    rel = _attn_rel(dtype)
    assert_close_rel(got.float(), np.asarray(jref.flash_attention(jq, jk, jv),
                                             np.float32), rel)
    assert_close_rel(got.float(), np.asarray(jfa.flash_attention(
        jq, jk, jv, block_q=64, block_k=64, interpret=True), np.float32), rel)


@pytest.mark.parametrize("window", [0, 96])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_variants(window, softcap, causal):
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 4, 2, 256, 256, 64))
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = tops.flash_attention(q, k, v, **kw)
    jq, jk, jv = (jnp.asarray(x.numpy()) for x in (q, k, v))
    assert_close_rel(got, jref.flash_attention(jq, jk, jv, **kw), 2e-5)
    assert_close_rel(got, jfa.flash_attention(jq, jk, jv, block_q=64,
                                              block_k=64, interpret=True,
                                              **kw), 2e-5)


@pytest.mark.parametrize("s,bq,bk", [(100, 64, 64), (150, 64, 128),
                                     (100, 128, 64)])
def test_flash_attention_unaligned(monkeypatch, s, bq, bk):
    """Lengths that are no multiple of the reference's blocks: its wrapper
    pads Q and KV to one common length and runs the Pallas body (interpret);
    the port takes every length as it is."""
    monkeypatch.setenv("REPRO_KERNELS", "interpret")
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 2, 2, s, s, 64))
    got = tops.flash_attention(q, k, v)
    jq, jk, jv = (jnp.asarray(x.numpy()) for x in (q, k, v))
    assert_close_rel(got, jops.flash_attention(jq, jk, jv, block_q=bq,
                                               block_k=bk), 2e-5)
    assert_close_rel(got, jref.flash_attention(jq, jk, jv), 2e-5)


@pytest.mark.parametrize("kw", [dict(), dict(window=64), dict(softcap=50.0)],
                         ids=["causal", "window 64", "softcap 50"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_head_dim_256_sweep(kw, dtype):
    """gemma2-9b's head dim 256 (GQA 4/2): the plain version vs the jnp
    oracle AND the Pallas body in interpret mode."""
    (tq, jq), (tk, jk), (tv, jv) = (_as(x, dtype) for x in
                                    _qkv(1, 4, 2, 128, 128, 256, seed=11))
    got = tfa.flash_attention_ref(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    rel = _attn_rel(dtype)
    assert_close_rel(got.float(), np.asarray(
        jref.flash_attention(jq, jk, jv, **kw), np.float32), rel)
    assert_close_rel(got.float(), np.asarray(jfa.flash_attention(
        jq, jk, jv, block_q=64, block_k=64, interpret=True, **kw),
        np.float32), rel)


def test_flash_attention_rows_that_see_no_key_are_zero():
    """sq > sk, causal: the first sq - sk queries sit before every key.  The
    port gives those rows zeros (the jnp oracle gives NaN); every other row
    equals the oracle."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 2, 1, 40, 25, 16))
    got = tops.flash_attention(q, k, v)
    want = np.asarray(jref.flash_attention(*(jnp.asarray(x.numpy())
                                             for x in (q, k, v))))
    assert float(got[:, :, :15].abs().max()) == 0.0
    assert np.isnan(want[:, :, :15]).all()
    assert_close_rel(got[:, :, 15:], want[:, :, 15:], 2e-5)
    win = tops.flash_attention(q[:, :, :1].contiguous(), k, v, causal=False,
                               window=3)
    assert float(win.abs().max()) > 0.0      # sq=1 sees keys 22..24


# ---------------------------------------------------------------------------
# ssd_scan
# ---------------------------------------------------------------------------

def _ssd_inputs(b, l, h, g, p, n, seed=9):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, l, h)))) * 0.1).astype(
        np.float32)
    a = (-np.exp(rng.standard_normal(h))).astype(np.float32)
    bm = (rng.standard_normal((b, l, g, n)) / np.sqrt(n)).astype(np.float32)
    cm = (rng.standard_normal((b, l, g, n)) / np.sqrt(n)).astype(np.float32)
    return x, dt, a, bm, cm


@pytest.mark.parametrize("b,l,h,g,p,n,chunk", [
    (2, 128, 4, 2, 32, 16, 64),
    (1, 256, 2, 2, 64, 32, 128),
    (1, 64, 4, 1, 16, 8, 32),    # B/C shared by all heads
    (1, 128, 8, 8, 64, 64, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_sweep(b, l, h, g, p, n, chunk, dtype):
    """The reference's sweep: the plain version (sequential) vs the jnp
    oracle AND the Pallas body in interpret mode.  y: 1e-4 of max|y| in
    float32 (the Pallas body's chunked sums), 8e-3 in bf16 (one bf16 ulp of
    the rounded output); the float32 state at 1e-4 either way."""
    x, dt, a, bm, cm = _ssd_inputs(b, l, h, g, p, n)
    tx, jx = _as(x, dtype)
    tdt, jdt = _as(dt, dtype)
    tb, jb = _as(bm, dtype)
    tc, jc = _as(cm, dtype)
    y, hf = tss.ssd_scan_ref(tx, tdt, torch.from_numpy(a), tb, tc)
    assert y.dtype == tx.dtype and hf.dtype == torch.float32
    assert hf.shape == (b, h, p, n)
    rel = 1e-4 if dtype == "float32" else 8e-3
    yr, hr = jref.ssd_scan(jx, jdt, jnp.asarray(a), jb, jc, return_state=True)
    yk, hk = jssd.ssd_scan(jx, jdt, jnp.asarray(a), jb, jc, chunk=chunk,
                           interpret=True)
    for want_y, want_h in ((yr, hr), (yk, hk)):
        assert_close_rel(y.float(), np.asarray(want_y, np.float32), rel)
        assert_close_rel(hf, want_h, 1e-4)


@pytest.mark.parametrize("b,l,h,g,p,n", [(1, 128, 2, 1, 64, 128),
                                         (1, 64, 2, 2, 128, 128)],
                         ids=["P 64 N 128", "P 128 N 128"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_wide_state_sweep(b, l, h, g, p, n, dtype):
    """mamba2-1.3b's state N = 128 (and P = 128): the plain version vs the
    jnp oracle AND the Pallas body in interpret mode, at the sweep's
    limits."""
    x, dt, a, bm, cm = _ssd_inputs(b, l, h, g, p, n, seed=12)
    tx, jx = _as(x, dtype)
    tdt, jdt = _as(dt, dtype)
    tb, jb = _as(bm, dtype)
    tc, jc = _as(cm, dtype)
    y, hf = tss.ssd_scan_ref(tx, tdt, torch.from_numpy(a), tb, tc)
    assert hf.shape == (b, h, p, n)
    rel = 1e-4 if dtype == "float32" else 8e-3
    yr, hr = jref.ssd_scan(jx, jdt, jnp.asarray(a), jb, jc, return_state=True)
    yk, hk = jssd.ssd_scan(jx, jdt, jnp.asarray(a), jb, jc, chunk=64,
                           interpret=True)
    for want_y, want_h in ((yr, hr), (yk, hk)):
        assert_close_rel(y.float(), np.asarray(want_y, np.float32), rel)
        assert_close_rel(hf, want_h, 1e-4)


def test_ssd_scan_ragged_length(monkeypatch):
    """L = 100 is no multiple of the chunk: the reference's wrapper takes
    its sequential oracle, the port (and its kernel) every length."""
    monkeypatch.setenv("REPRO_KERNELS", "interpret")
    args = _ssd_inputs(2, 100, 4, 2, 16, 8)
    y, hf = tops.ssd_scan(*(torch.from_numpy(x) for x in args))
    yr, hr = jops.ssd_scan(*(jnp.asarray(x) for x in args))
    assert_close_rel(y, yr, 1e-5)
    assert_close_rel(hf, hr, 1e-5)


def test_ssd_state_decays():
    """With strongly negative A the state forgets the past: changing the
    first half of x leaves the final state unchanged (as the reference's
    test shows for its kernel), and both agree with it."""
    b, l, h, g, p, n = 1, 128, 2, 1, 16, 8
    x, _, _, bm, cm = _ssd_inputs(b, l, h, g, p, n, seed=3)
    dt = np.full((b, l, h), 2.0, np.float32)
    a = np.full((h,), -10.0, np.float32)
    x2 = x.copy()
    x2[:, : l // 2] = np.random.default_rng(4).standard_normal(
        (b, l // 2, h, p))
    t = [torch.from_numpy(v) for v in (dt, a, bm, cm)]
    _, hf = tops.ssd_scan(torch.from_numpy(x), *t)
    _, hf2 = tops.ssd_scan(torch.from_numpy(x2), *t)
    np.testing.assert_allclose(hf.numpy(), hf2.numpy(), rtol=1e-4, atol=1e-4)
    _, hk = jssd.ssd_scan(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(a),
                          jnp.asarray(bm), jnp.asarray(cm), chunk=64,
                          interpret=True)
    assert_close_rel(hf, hk, 1e-4)


# ---------------------------------------------------------------------------
# Dispatch and imports
# ---------------------------------------------------------------------------

def test_wrappers_validate_their_inputs():
    rows = torch.zeros((1, 4, 2), dtype=torch.int32)
    vals = torch.zeros((1, 4, 2))
    with pytest.raises(TypeError):
        tops.sparse_gram(rows.long(), vals, 3)
    with pytest.raises(ValueError):
        tops.sparse_gram(rows[0], vals[0], 3)
    with pytest.raises(TypeError):
        tops.blockgram(torch.zeros((1, 4, 4), dtype=torch.float64))
    with pytest.raises(ValueError):
        tops.blockgram(torch.zeros((4, 4)))
    with pytest.raises(TypeError):
        tops.sketch_panel(torch.zeros((2, 3), dtype=torch.float64), rows, vals)
    with pytest.raises(ValueError):
        tops.topk_score(torch.zeros((2, 3)), torch.zeros((5, 4)), 2)
    with pytest.raises(TypeError):
        tops.topk_score(torch.zeros((2, 3)), torch.zeros((5, 3),
                                                         dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="k_top"):
        tops.topk_score(torch.zeros((2, 3)), torch.zeros((5, 3)), 6)
    with pytest.raises(ValueError, match="scale"):
        tops.topk_score(torch.zeros((2, 3)), torch.zeros((5, 3)), 2,
                        scale=torch.ones(4))
    q = torch.zeros((1, 4, 8, 16))
    with pytest.raises(ValueError):
        tops.flash_attention(q, torch.zeros((1, 3, 8, 16)),
                             torch.zeros((1, 3, 8, 16)))
    with pytest.raises(TypeError):
        tops.flash_attention(q, q.double(), q.double())
    with pytest.raises(ValueError, match="contiguous"):
        tops.flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                             q.transpose(1, 2))
    x, dt = torch.zeros((1, 8, 4, 16)), torch.zeros((1, 8, 4))
    bc = torch.zeros((1, 8, 3, 8))
    with pytest.raises(ValueError, match="multiple of G"):
        tops.ssd_scan(x, dt, torch.zeros(4), bc, bc)
    with pytest.raises(TypeError):
        tops.ssd_scan(x, dt, torch.zeros(4, dtype=torch.float64),
                      bc[:, :, :2], bc[:, :, :2])


def test_cuda_request_without_cuda_raises_instead_of_plain_version(
        monkeypatch):
    """No hidden fallback: asking for the GPU where there is none raises, and
    a tensor that lies neither on the CPU nor on a CUDA device never reaches
    the plain version through a wrapper.  The two LM kernels take ``meta``
    tensors (the dry run): there they return the kernel's shapes without
    reaching the plain version; any other device raises."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the no-CUDA refusal cannot "
                    "be shown here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.resolve_device("cuda")
    coo = tsparse.random_bipartite(8, 64, 0.1, seed=0)
    with pytest.raises(RuntimeError):
        tsparse.block_ell_from_coo(coo, 2, device="cuda")
    with pytest.raises(RuntimeError):
        tsparse.block_ell_from_coo(coo, 2)          # None means the GPU
    rows = torch.zeros((1, 4, 2), dtype=torch.int32, device="meta")
    vals = torch.zeros((1, 4, 2), device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        tops.sparse_gram(rows, vals, 3)
    with pytest.raises(RuntimeError, match="unsupported device"):
        tops.blockgram(torch.zeros((1, 4, 4), device="meta"))
    with pytest.raises(RuntimeError, match="unsupported device"):
        tops.sketch_panel(torch.zeros((2, 3), device="meta"), rows, vals)
    with pytest.raises(RuntimeError, match="unsupported device"):
        tops.topk_score(torch.zeros((2, 3), device="meta"),
                        torch.zeros((5, 3), device="meta"), 2)
    def plain(*args, **kwargs):
        raise AssertionError("a meta tensor reached the plain version")

    monkeypatch.setattr(tfa, "flash_attention_ref", plain)
    monkeypatch.setattr(tss, "ssd_scan_ref", plain)
    q = torch.zeros((1, 2, 4, 16), device="meta")
    out = tops.flash_attention(q, q, q)
    assert out.device.type == "meta" and out.shape == q.shape
    bc = torch.zeros((1, 8, 1, 16), device="meta")
    y, h = tops.ssd_scan(torch.zeros((1, 8, 2, 16), device="meta"),
                         torch.zeros((1, 8, 2), device="meta"),
                         torch.zeros((2,), device="meta"), bc, bc)
    assert y.device.type == h.device.type == "meta"
    assert h.shape == (1, 2, 16, 16)
    other = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(RuntimeError, match="unsupported device"):
        tfa._forward(other, q, q, True, 0, 0.0, 1.0, False)
    with pytest.raises(RuntimeError, match="unsupported device"):
        tss._forward(other, None, None, None, None)


def test_launch_counters_do_not_move_on_the_cpu():
    """A wrapper counts where it launches its kernel and nowhere else."""
    mods = (tsg, tbg, tsp, ttk, tfa, tss)
    before = tuple(m.launches for m in mods)
    rows, vals = _random_ell(8, 16, 2)
    tops.sparse_gram(torch.from_numpy(rows), torch.from_numpy(vals), 8)
    tops.blockgram(torch.ones((1, 4, 8)))
    tops.sketch_panel(torch.ones((2, 8)), torch.from_numpy(rows),
                      torch.from_numpy(vals))
    tops.topk_score(torch.ones((2, 3)), torch.ones((7, 3)), 4)
    q = torch.ones((1, 2, 5, 16))
    tops.flash_attention(q, q, q)
    tops.ssd_scan(torch.ones((1, 9, 2, 4)), torch.ones((1, 9, 2)),
                  -torch.ones(2), torch.ones((1, 9, 1, 4)),
                  torch.ones((1, 9, 1, 4)))
    assert tuple(m.launches for m in mods) == before


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_topk_score_empty_wave_launches_nothing(device):
    """A wave of zero queries returns empty (0, k_top) outputs before any
    device dispatch: no launch, no count (on a meta tensor a dispatch would
    raise "unsupported device")."""
    before = ttk.launches
    vals, idx = tops.topk_score(torch.zeros((0, 3), device=device),
                                torch.zeros((7, 3), device=device), 4)
    assert vals.shape == idx.shape == (0, 4)
    assert vals.dtype == torch.float32 and idx.dtype == torch.int32
    assert vals.device.type == idx.device.type == device
    assert ttk.launches == before


def test_importing_the_port_pulls_in_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.core.api\n"
        "import repro_torch.core.convert, repro_torch.data.bipartite\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.build\n"
        "import repro_torch.stream, repro_torch.serve\n"
        "import repro_torch.serve.kvquant, repro_torch.core.hierarchy\n"
        "import repro_torch.kernels.flash_attention, repro_torch.kernels.ssd_scan\n"
        "import repro_torch.configs.base, repro_torch.models.layers\n"
        "import repro_torch.models.schema, repro_torch.models.convert\n"
        "import repro_torch.models.attention, repro_torch.models.ssm\n"
        "import repro_torch.models.transformer, repro_torch.serve.engine\n"
        "import repro_torch.launch.serve, repro_torch.analysis\n"
        "from repro_torch.configs.base import ARCH_IDS, get_config\n"
        "[get_config(a) for a in ARCH_IDS]\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": f"{REPO}/src", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "clean"
