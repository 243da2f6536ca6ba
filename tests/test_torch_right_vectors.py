"""The right-vector kernel (``repro_torch.kernels.right_vectors``) on the CPU.

A float32 model of ``csrc/right_vectors.cu`` builds the kernel's index as
the kernel does (counts, ranks taken in whatever order the atomic adds
land, an exclusive scan, placement, each entry's terms put after those of
the lower entries of its bin), then sums each output row's terms in order,
one rounded multiply and one rounded add a term, and multiplies by the
masked 1/S.  The model is held to the plain version (``right_vectors_ref``,
the panel-and-GEMM code the CPU runs) and to the reference's
``sparse_right_vectors`` at 1e-6 of max|V|: only the order of a row's few
non-zero terms differs.  The kernel itself runs only on the card
(``chip_smoke.py`` phase ``kernels``)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import svd as jsvd

from repro_torch.core import ranky as tranky
from repro_torch.core import sparse as tsparse
from repro_torch.core import svd as tsvd
from repro_torch.kernels import build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import right_vectors as trv

from test_torch_helpers import assert_close_rel

REL = 1e-6


def model_inverse(s, rcond=1e-7):
    """core/svd.py masked_inverse in float32, as the kernel computes it."""
    s = np.asarray(s, np.float32)
    smax = s.max()                         # a NaN wins, as in torch.max
    floor = np.float32(np.float32(rcond) * smax)
    safe = np.where(s == 0, np.float32(1), s)
    return np.where(s > floor, np.float32(1) / safe,
                    np.float32(0)).astype(np.float32)


def rv_index(ids, rows, vals, rcols, rmask, width, seed=0):
    """The kernel's index: ``(toff, terms)``, toff (D*W + 1,) the exclusive
    term offsets of the bins, terms (T, 2) (row, value) rows.  The ranks of
    a bin's entries follow the order of a random permutation (the atomic
    adds land in any order); the terms must not depend on it."""
    d, c, k = rows.shape
    mr = rcols.shape[1]
    nb = d * width
    stored = d * c
    total = stored + d * mr
    bins = np.full(total, -1, np.int64)
    nt = np.zeros(total, np.int64)
    for e in range(total):
        if e < stored:
            b, ci = divmod(e, c)
            n = int((vals[b, ci] != 0).sum())
            if n:
                bins[e], nt[e] = b * width + ids[b, ci], n
        else:
            b, j = divmod(e - stored, mr)
            if rmask[b, j]:
                bins[e], nt[e] = b * width + rcols[b, j], 1
    ecnt = np.zeros(nb + 1, np.int64)
    tcnt = np.zeros(nb + 1, np.int64)
    rank = np.zeros(total, np.int64)
    for e in np.random.default_rng(seed).permutation(total):
        if bins[e] >= 0:
            rank[e] = ecnt[bins[e]]
            ecnt[bins[e]] += 1
            tcnt[bins[e]] += nt[e]
    eoff = np.concatenate([[0], np.cumsum(ecnt)[:-1]])
    toff = np.concatenate([[0], np.cumsum(tcnt)[:-1]])
    elist = np.zeros(total, np.int64)
    for e in range(total):
        if bins[e] >= 0:
            elist[eoff[bins[e]] + rank[e]] = e
    terms = np.zeros((int(toff[-1]), 2), np.float64)
    for e in range(total):
        bn = bins[e]
        if bn < 0:
            continue
        at = toff[bn] + sum(nt[o] for o in elist[eoff[bn]:eoff[bn + 1]]
                            if o < e)
        if e < stored:
            b, ci = divmod(e, c)
            for q in range(k):
                if vals[b, ci, q] != 0:
                    terms[at] = rows[b, ci, q], vals[b, ci, q]
                    at += 1
        else:
            terms[at] = (e - stored) % mr, 1.0
    return toff, terms


def rv_model(ids, rows, vals, rcols, rmask, width, u, s, *, rcond=1e-7,
             seed=0):
    """(D*W, r) float32 as the kernel sums it."""
    ids, rows, vals, rcols, rmask = (np.asarray(x) for x in
                                     (ids, rows, vals, rcols, rmask))
    u = np.asarray(u, np.float32)
    toff, terms = rv_index(ids, rows, vals, rcols, rmask, width, seed)
    inv = model_inverse(s, rcond)
    out = np.zeros((ids.shape[0] * width, u.shape[1]), np.float32)
    for b in range(out.shape[0]):
        acc = np.zeros(u.shape[1], np.float32)
        for row, v in terms[toff[b]:toff[b + 1]]:
            acc = acc + np.float32(v) * u[int(row)]
        out[b] = acc * inv
    return out


def _case(seed, *, d=3, c=24, k=4, m=20, width=40, r=16, deficient=False,
          dup_ids=False):
    """Hand-built ELL arrays and a repair side-band (numpy), U (M, r) and
    S (r,): weighted values with padding slots and duplicate rows in a
    column; in block 0 a padding column (id 0, all values 0) at a lower
    index than the live column 0; two repair rows on one column that E
    stores, and a repair on a column E leaves empty.  ``dup_ids``: two
    live stored columns of block 1 share an id.  ``deficient``: S's tail
    below the floor and 0 (its masked inverse 0)."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((d, c), np.int32)
    live_c = c - 4                              # the last 4 are padding
    for b in range(d):
        ids[b, :live_c] = rng.choice(np.arange(1, width), live_c,
                                     replace=False)
    ids[0, 5] = 0                               # a live column 0 ...
    rows = rng.integers(0, m, size=(d, c, k)).astype(np.int32)
    vals = rng.uniform(0.5, 2.0, size=(d, c, k)).astype(np.float32)
    vals *= rng.random((d, c, k)) < 0.6         # padding slots
    vals[:, :, 0] = rng.uniform(0.5, 2.0, (d, c))
    rows[:, ::3, -1] = rows[:, ::3, 0]          # duplicates in a column
    vals[:, ::3, -1] = rng.uniform(0.5, 2.0, (d, (c + 2) // 3))
    vals[:, live_c:] = 0.0
    vals[0, 2] = 0.0                            # ... beside padding id 0
    ids[0, 2] = 0
    if dup_ids:
        ids[1, 7] = ids[1, 3]
    rows[vals == 0] = 0
    rcols = rng.integers(0, width, size=(d, m)).astype(np.int32)
    rmask = rng.random((d, m)) < 0.3
    rcols[0, [1, 3]] = ids[0, 6]                # two repairs, a stored column
    rmask[0, [1, 3]] = True
    empty = sorted(set(range(width)) - set(ids[1].tolist()))[0]
    rcols[1, 2], rmask[1, 2] = empty, True      # a repair on an empty column
    u = rng.standard_normal((m, r)).astype(np.float32)
    s = np.sort(rng.uniform(0.5, 3.0, r)).astype(np.float32)[::-1].copy()
    if deficient and r > 2:
        s[-2:] = [1e-9, 0.0]
    return ids, rows, vals, rcols, rmask, u, s


def _torch(ids, rows, vals, rcols, rmask, u, s):
    return (torch.from_numpy(ids), torch.from_numpy(rows),
            torch.from_numpy(vals), torch.from_numpy(rcols),
            torch.from_numpy(rmask), torch.from_numpy(u),
            torch.from_numpy(s))


def _jax_v(ids, rows, vals, rcols, rmask, width, u, s):
    return np.concatenate([np.asarray(jsvd.sparse_right_vectors(
        jnp.asarray(ids[b]), jnp.asarray(rows[b]), jnp.asarray(vals[b]),
        jnp.asarray(rcols[b]), jnp.asarray(rmask[b]), width,
        jnp.asarray(u), jnp.asarray(s))) for b in range(ids.shape[0])])


@pytest.mark.parametrize("r", [1, 16, 24, 88])
@pytest.mark.parametrize("deficient", [False, True])
def test_model_matches_plain_and_reference(r, deficient):
    """Truncated U (M, r), r = 1 and r not a multiple of 4 included."""
    m = 96 if r == 88 else 20
    arrays = _case(r, r=r, m=m, deficient=deficient)
    ids, rows, vals, rcols, rmask, u, s = arrays
    want = rv_model(ids, rows, vals, rcols, rmask, 40, u, s)
    plain = trv.right_vectors_ref(*_torch(*arrays)[:5], 40,
                                  *_torch(*arrays)[5:])
    assert_close_rel(want, plain.numpy(), rel=REL)
    assert_close_rel(want, _jax_v(ids, rows, vals, rcols, rmask, 40, u, s),
                     rel=REL)
    if deficient and r > 2:
        assert np.all(want[:, -2:] == 0) and np.all(plain.numpy()[:, -2:]
                                                    == 0)


@pytest.mark.parametrize("dup_ids", [False, True])
def test_model_square_u(dup_ids):
    """U square (M, M), as the exact solve passes it; two live stored
    columns sharing an id add, as the reference's scatter-add does."""
    arrays = _case(3, m=24, r=24, dup_ids=dup_ids)
    ids, rows, vals, rcols, rmask, u, s = arrays
    want = rv_model(ids, rows, vals, rcols, rmask, 40, u, s)
    plain = trv.right_vectors_ref(*_torch(*arrays)[:5], 40,
                                  *_torch(*arrays)[5:])
    assert_close_rel(want, plain.numpy(), rel=REL)
    assert_close_rel(want, _jax_v(ids, rows, vals, rcols, rmask, 40, u, s),
                     rel=REL)


def test_the_cases_hold_what_they_claim():
    ids, rows, vals, rcols, rmask, u, s = _case(5)
    live = (vals != 0).any(axis=-1)
    assert live[0, 5] and ids[0, 5] == 0                # live column 0
    assert not live[0, 2] and ids[0, 2] == 0 and 2 < 5  # padding before it
    assert rows[0, 0, -1] == rows[0, 0, 0] and vals[0, 0, -1] != 0
    assert rmask[0, 1] and rmask[0, 3] and rcols[0, 1] == rcols[0, 3]
    assert live[0][ids[0] == rcols[0, 1]].any()         # E stores it
    assert rmask[1, 2] and not live[1][ids[1] == rcols[1, 2]].any()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_index_ignores_the_order_of_the_atomic_adds(seed):
    """Each bin's terms: its live stored columns in index order, their
    non-zero slots in slot order, then its repair rows in ascending row
    order, whatever the ranks."""
    ids, rows, vals, rcols, rmask, u, s = _case(11, dup_ids=True)
    width = 40
    toff, terms = rv_index(ids, rows, vals, rcols, rmask, width, seed)
    d, c, k = rows.shape
    for b in range(d):
        for j in range(width):
            want = [(rows[b, ci, q], vals[b, ci, q]) for ci in range(c)
                    if ids[b, ci] == j and (vals[b, ci] != 0).any()
                    for q in range(k) if vals[b, ci, q] != 0]
            want += [(row, 1.0) for row in range(rcols.shape[1])
                     if rmask[b, row] and rcols[b, row] == j]
            got = terms[toff[b * width + j]:toff[b * width + j + 1]]
            assert [tuple(t) for t in got] == [(float(a), float(v))
                                               for a, v in want]
    assert toff[-1] == (vals != 0).sum() + rmask.sum()


def test_rank_deficient_s_gives_zero_directions():
    s = np.array([4.0, 2.0, 1e-9, 0.0], np.float32)
    inv = model_inverse(s)
    assert inv.tolist() == [0.25, 0.5, 0.0, 0.0]
    np.testing.assert_array_equal(
        inv, tsvd.masked_inverse(torch.from_numpy(s)).numpy())
    nan = np.array([1.0, np.nan], np.float32)
    np.testing.assert_array_equal(
        model_inverse(nan), tsvd.masked_inverse(torch.from_numpy(nan)).numpy())


@pytest.mark.parametrize("r,k_tot,k0", [(16, 40, 24), (24, 37, 13),
                                        (88, 176, 88)])
def test_strided_out_column_slice(r, k_tot, k0):
    """``out=`` a column slice of a wider panel, as the streaming merges
    pass it (``p[:, k:]``): the slice holds V, the panel's other columns
    keep their values."""
    m = 96 if r == 88 else 24
    arrays = _case(7, m=m, r=r)
    t = _torch(*arrays)
    width = 40
    panel = torch.full((3 * width, k_tot), 7.0)
    got = tops.right_vectors(*t[:5], width, *t[5:],
                             out=panel[:, k0:k0 + r])
    assert got.data_ptr() == panel[:, k0:].data_ptr()
    want = trv.right_vectors_ref(*t[:5], width, *t[5:])
    assert torch.equal(panel[:, k0:k0 + r], want)
    assert bool((panel[:, :k0] == 7.0).all())
    assert bool((panel[:, k0 + r:] == 7.0).all())
    assert_close_rel(rv_model(*arrays[:5], width, *arrays[5:]),
                     want.numpy(), rel=REL)


def test_stack_and_one_block_calls_agree_with_the_plain_version():
    """``right_vectors_stack`` makes one call over the stack;
    ``sparse_right_vectors`` is a D = 1 call: both give the plain
    version's bits on the CPU, and U may be a column slice."""
    arrays = _case(9, m=24, r=24)
    ids, rows, vals, rcols, rmask, u, s = _torch(*arrays)
    width = 40
    ell = tsparse.BlockEll(ids, rows, vals, m=24, width=width, n=3 * width)
    blocks = tsparse.RepairedSparseBlocks(ell, rcols, rmask)
    u_sl, s_sl = u[:, :10], s[:10]
    want = trv.right_vectors_ref(ids, rows, vals, rcols, rmask, width,
                                 u_sl, s_sl)
    assert torch.equal(tranky.right_vectors_stack(blocks, u_sl, s_sl), want)
    for b in range(3):
        got = tsvd.sparse_right_vectors(ids[b], rows[b], vals[b], rcols[b],
                                        rmask[b], width, u_sl, s_sl)
        assert torch.equal(got, want[b * width:(b + 1) * width])


def test_plain_version_on_the_cpu_builds_nothing(monkeypatch):
    """The wrapper imports without a compiler and takes the plain version
    for CPU tensors: nothing is built, nothing counted."""
    def refuse(*_a, **_k):
        raise AssertionError("the CPU path must not build the kernels")

    monkeypatch.setattr(build, "entry", refuse)
    monkeypatch.setattr(build, "load", refuse)
    before = trv.launches
    t = _torch(*_case(2))
    out = tops.right_vectors(*t[:5], 40, *t[5:])
    assert out.shape == (120, 16) and trv.launches == before


def test_wrapper_refuses_what_the_kernel_does_not_take():
    t = list(_torch(*_case(2)))
    with pytest.raises(TypeError, match="int32 ids"):
        tops.right_vectors(t[0].long(), *t[1:5], 40, *t[5:])
    with pytest.raises(ValueError, match="u \\(M, r\\) and s"):
        tops.right_vectors(*t[:5], 40, t[5], t[6][:3])
    with pytest.raises(ValueError, match="out must be"):
        tops.right_vectors(*t[:5], 40, *t[5:], out=torch.empty((119, 16)))
    with pytest.raises(ValueError, match="out must be"):
        tops.right_vectors(*t[:5], 40, *t[5:],
                           out=torch.empty((16, 120)).T)
    meta = [x.to("meta") for x in t]
    with pytest.raises(RuntimeError, match="unsupported device"):
        tops.right_vectors(*meta[:5], 40, *meta[5:])


@pytest.mark.parametrize("r,vec4,want", [
    (2048, True, (4, 128)),     # the exact cell: 128 threads x 4 float4
    (4096, True, (4, 256)),
    (8192, True, (4, 256)),     # two passes over the row
    (16, True, (4, 1)),         # one thread a row
    (72, True, (4, 8)),
    (88, True, (4, 8)),
    (24, False, (1, 8)),
    (1, False, (1, 1)),
    (2048, False, (1, 256)),
])
def test_row_plan_follows_r(r, vec4, want):
    vec, tpr = trv.row_plan(r, vec4)
    assert (vec, tpr) == want
    groups = r // vec
    passes = -(-groups // (tpr * trv.GROUPS))
    assert tpr * trv.GROUPS * passes >= groups
    assert passes == 1 or tpr == trv.ROW_THREADS


def test_vec4_only_where_u_and_out_allow_it():
    u = torch.zeros((8, 40))
    panel = torch.zeros((30, 37))
    wide = torch.zeros((30, 136))
    assert trv.vec4_ok(16, u[:, :16], wide[:, 64:80])
    assert not trv.vec4_ok(16, u[:, :16], wide[:, 63:79])     # start
    assert not trv.vec4_ok(16, u[:, :16], panel[:, 13:29])    # row stride
    assert not trv.vec4_ok(24, u[:, 1:25], wide[:, 64:88])    # U's start
    assert not trv.vec4_ok(18, u[:, :18], wide[:, 64:82])     # r


def test_workspace_covers_every_part():
    d, c, k, mr, w, r = 8, 84_104, 11, 2048, 131_072, 2048
    n = d * w + 1
    parts = [8 * n, 8 * -(-n // trv.SCAN_TILE), 16 * (d * c + d * mr),
             4 * (d * c + d * mr), 8 * (d * c * k + d * mr), 4 * r]
    got = trv.workspace_bytes(d, c, k, mr, w, r)
    assert got % 16 == 0 and sum(parts) <= got < sum(parts) + 16 * 6
    assert got < 120e6       # against 0.69 GB of panel a block before
