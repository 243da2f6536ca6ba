"""``repro_torch.core.sparse`` / ``data.bipartite`` / ``core.convert`` against
the reference: the host-side generators and the BlockEll layout are held to
EXACT equality (same COO in, same arrays out), the dense views to exact
equality too (0/1 and weighted values are only moved, never summed, except
where duplicates coalesce, which both sides do in the same numpy code)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ranky_paper as jcfg
from repro.core import sparse as jsparse
from repro.data import bipartite as jbip

from repro_torch.configs import ranky_paper as tcfg
from repro_torch.core import convert, sparse as tsparse
from repro_torch.data import bipartite as tbip

from test_torch_helpers import paper_like_coo, port_ell

SHAPES = [(48, 4096, 2e-3, d) for d in (2, 4, 8)] + [(64, 2000, 4e-3, 8),
                                                     (64, 2000, 4e-3, 3)]


def _same_ell(tell, jell):
    assert (tell.m, tell.width, tell.n, tell.nnz) == \
        (jell.m, jell.width, jell.n, jell.nnz)
    assert tell.col_ids.dtype == torch.int32
    assert tell.col_rows.dtype == torch.int32
    assert tell.col_vals.dtype == torch.float32
    np.testing.assert_array_equal(tell.col_ids.numpy(), np.asarray(jell.col_ids))
    np.testing.assert_array_equal(tell.col_rows.numpy(), np.asarray(jell.col_rows))
    np.testing.assert_array_equal(tell.col_vals.numpy(), np.asarray(jell.col_vals))


def test_configs_are_the_same():
    assert tcfg.config().__dict__ == jcfg.config().__dict__
    assert tcfg.smoke_config().__dict__ == jcfg.smoke_config().__dict__


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("power_law", [False, True])
def test_random_bipartite_and_full_row_rank_are_identical(weighted, power_law):
    j = jsparse.random_bipartite(40, 900, 0.004, seed=5, weighted=weighted,
                                 power_law=power_law)
    t = tsparse.random_bipartite(40, 900, 0.004, seed=5, weighted=weighted,
                                 power_law=power_law)
    for name in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    j2 = jsparse.ensure_full_row_rank(j, seed=5)
    t2 = tsparse.ensure_full_row_rank(t, seed=5)
    assert t2.nnz == j2.nnz and t2.nnz >= t.nnz
    np.testing.assert_array_equal(t2.todense(), j2.todense())
    assert t2.density() == j2.density()


def test_paper_data_matches_in_every_representation():
    jc, tc = jcfg.smoke_config(), tcfg.smoke_config()
    jcoo, tcoo = jbip.paper_coo(jc), tbip.paper_coo(tc)
    np.testing.assert_array_equal(tcoo.rows, jcoo.rows)
    np.testing.assert_array_equal(tcoo.cols, jcoo.cols)
    np.testing.assert_array_equal(tbip.paper_matrix(tc), jbip.paper_matrix(jc))
    for d in tc.blocks:
        _same_ell(tbip.paper_block_ell(tc, d, device="cpu"),
                  jbip.paper_block_ell(jc, d))
    a = tbip.paper_matrix(tc)
    assert tbip.lonely_row_stats(a, 4) == jbip.lonely_row_stats(a, 4)


@pytest.mark.parametrize("m,n,density,d", SHAPES)
def test_block_ell_layout_is_exactly_the_references(m, n, density, d):
    jcoo, tcoo = paper_like_coo(m, n, density, seed=7)
    jell = jsparse.block_ell_from_coo(jcoo, d)
    tell = tsparse.block_ell_from_coo(tcoo, d, device="cpu")
    _same_ell(tell, jell)
    assert tell.num_blocks == d and tell.capacity == jell.capacity
    assert tell.padded_shape == jell.padded_shape
    # dense views: the container, the reference's, and the padded COO agree
    dense = tsparse.pad_to_block_multiple(tcoo.todense(), d)
    np.testing.assert_array_equal(tell.todense().numpy(), dense)
    np.testing.assert_array_equal(tell.todense().numpy(),
                                  np.asarray(jell.todense()))
    np.testing.assert_array_equal(tell.todense_blocks().numpy(),
                                  np.asarray(jell.todense_blocks()))


def test_block_ell_coalesces_duplicates_by_summing():
    rows = np.array([0, 0, 1, 0, 3], np.int32)
    cols = np.array([5, 5, 2, 9, 9], np.int32)
    vals = np.array([1.0, 2.5, 1.0, 4.0, 0.5], np.float32)
    jcoo = jsparse.COOMatrix(rows, cols, vals, (4, 11))
    tcoo = convert.coo_from_numpy(rows, cols, vals, (4, 11))
    jell = jsparse.block_ell_from_coo(jcoo, 2)
    tell = tsparse.block_ell_from_coo(tcoo, 2, device="cpu")
    _same_ell(tell, jell)
    assert tell.nnz == 4
    np.testing.assert_array_equal(
        tell.todense().numpy(),
        tsparse.pad_to_block_multiple(tcoo.todense(), 2))


@pytest.mark.parametrize("n,d", [(10, 3), (4096, 8), (2000, 8), (7, 7), (5, 8)])
def test_block_convention_helpers(n, d):
    assert tsparse.block_width(n, d) == jsparse.block_width(n, d)
    for i in range(d):
        assert tsparse.block_col_bounds(n, d, i) == jsparse.block_col_bounds(n, d, i)
    a = np.arange(3 * n, dtype=np.float32).reshape(3, n)
    np.testing.assert_array_equal(tsparse.pad_to_block_multiple(a, d),
                                  jsparse.pad_to_block_multiple(a, d))
    for tb, jb in zip(tsparse.split_blocks(a, d), jsparse.split_blocks(a, d)):
        np.testing.assert_array_equal(tb, jb)


@pytest.mark.parametrize("binarize", [False, True])
def test_stored_col_panel(binarize):
    jcoo, _ = paper_like_coo(32, 600, 0.01, seed=4, weighted=True)
    jell = jsparse.block_ell_from_coo(jcoo, 3)
    tell = port_ell(jell)
    for d in range(3):
        want = jsparse.stored_col_panel(jell.col_rows[d], jell.col_vals[d],
                                        jell.m, binarize=binarize)
        got = tsparse.stored_col_panel(tell.col_rows[d], tell.col_vals[d],
                                       tell.m, binarize=binarize)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_repaired_blocks_dense_view_and_convert_roundtrip():
    jcoo, _ = paper_like_coo(24, 500, 0.006, seed=9)
    jell = jsparse.block_ell_from_coo(jcoo, 4)
    rng = np.random.default_rng(0)
    dense = np.asarray(jell.todense_blocks())
    mask = ~(dense != 0).any(axis=2)                       # lonely rows
    cols = rng.integers(0, jell.width, size=mask.shape).astype(np.int32)
    jrep = jsparse.RepairedSparseBlocks(jell, jnp.asarray(cols),
                                        jnp.asarray(mask))
    trep = convert.repaired_from_numpy(port_ell(jell), cols, mask)
    assert trep.repair_cols.dtype == torch.int32
    assert trep.repair_mask.dtype == torch.bool
    np.testing.assert_array_equal(trep.todense_blocks().numpy(),
                                  np.asarray(jrep.todense_blocks()))
    np.testing.assert_array_equal(trep.todense().numpy(),
                                  np.asarray(jrep.todense()))
    moved = trep.to("cpu")
    assert moved.ell.device.type == "cpu"
    assert torch.equal(moved.repair_cols, trep.repair_cols)


@pytest.mark.parametrize("what,value,text", [
    ("row", 4, "names row"), ("row", -1, "names row"),
    ("col", 5, "local id"), ("col", -2, "local id")])
def test_constructors_refuse_indices_outside_the_block(what, value, text):
    """A non-zero slot must name a row in [0, M) of a column in [0, W):
    the kernels rely on it, so the constructors check it on the host.  A
    padding slot (val 0) may hold anything."""
    col_ids = np.array([[0, 3]], np.int32)
    col_rows = np.array([[[1, 0], [2, 3]]], np.int32)
    col_vals = np.array([[[1.0, 0.0], [1.0, 2.0]]], np.float32)
    kw = dict(m=4, width=5, n=5, device="cpu")
    convert.block_ell_from_numpy(col_ids, col_rows, col_vals, **kw)
    padded = col_rows.copy()
    padded[0, 0, 1] = 99                                   # val 0: inert
    convert.block_ell_from_numpy(col_ids, padded, col_vals, **kw)
    if what == "row":
        col_rows[0, 1, 1] = value
    else:
        col_ids[0, 1] = value
    with pytest.raises(ValueError, match=text):
        convert.block_ell_from_numpy(col_ids, col_rows, col_vals, **kw)


def test_block_ell_from_coo_refuses_a_row_outside_the_matrix():
    coo = convert.coo_from_numpy([0, 7], [1, 2], [1.0, 1.0], (4, 6))
    with pytest.raises(ValueError, match="names row"):
        tsparse.block_ell_from_coo(coo, 2, device="cpu")
