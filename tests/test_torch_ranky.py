"""``repro_torch.core.ranky`` against the reference: lonely masks, row
adjacency and the repair of all four METHODS are held to EXACT equality given
the draws the reference makes (``jax.random.split``, ``ranky._random_cols``,
``jax.random.uniform``), for the dense and the sparse representation; the
numpy ``ref_*`` oracles are the third leg.  ``solve_single`` is held by value
(S, rtol 1e-4) and by subspace (U, V): ``eigh`` / ``svd`` leave signs and
the basis of close singular values free."""
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import ranky as jranky
from repro.core import sparse as jsparse

from repro_torch.core import ranky as tranky
from repro_torch.core import sparse as tsparse

from test_torch_helpers import (assert_same_factors, paper_like_coo, port_ell,
                                projector_gap, reference_draws)

KEY = jax.random.PRNGKey(11)
# smoke_config (48 x 4096) at D = 2, 4, 8, and a ragged last block.
SHAPES = [(48, 4096, 2e-3, 2), (48, 4096, 2e-3, 4), (48, 4096, 2e-3, 8),
          (64, 2000, 4e-3, 8)]


def _inputs(m, n, density, d, seed=2020):
    jcoo, tcoo = paper_like_coo(m, n, density, seed=seed)
    jell = jsparse.block_ell_from_coo(jcoo, d)
    dense = jsparse.pad_to_block_multiple(jcoo.todense(), d)
    return jcoo, jell, port_ell(jell), dense


# ---------------------------------------------------------------------------
# Masks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,density,d", SHAPES)
def test_lonely_masks_and_adjacency_are_exact(m, n, density, d):
    _, jell, tell, dense = _inputs(m, n, density, d)
    w = jell.width
    t_dense = torch.from_numpy(dense)
    sparse_lonely = tranky.sparse_lonely_rows(tell.col_rows, tell.col_vals, m)
    assert sparse_lonely.shape == (d, m)
    for i in range(d):
        blk = dense[:, i * w:(i + 1) * w]
        want = np.asarray(jranky.lonely_rows(jnp.asarray(blk)))
        np.testing.assert_array_equal(
            tranky.lonely_rows(t_dense[:, i * w:(i + 1) * w]).numpy(), want)
        np.testing.assert_array_equal(sparse_lonely[i].numpy(), want)
        np.testing.assert_array_equal(
            np.asarray(jranky.sparse_lonely_rows(
                jell.col_rows[i], jell.col_vals[i], m)), want)
        np.testing.assert_array_equal(tranky.ref_lonely_rows(blk), want)
        np.testing.assert_array_equal(
            tranky.sparse_row_counts(tell.col_rows[i], tell.col_vals[i],
                                     m).numpy(),
            np.asarray(jranky.sparse_row_counts(jell.col_rows[i],
                                                jell.col_vals[i], m)))
    assert tranky.lonely_rows_per_block(tell, d) == \
        jranky.lonely_rows_per_block(jell, d)
    assert tranky.lonely_rows_per_block(t_dense, d) == \
        jranky.lonely_rows_per_block(jnp.asarray(dense), d)
    want_adj = np.asarray(jranky.row_adjacency(jnp.asarray(dense)))
    np.testing.assert_array_equal(tranky.row_adjacency(t_dense).numpy(), want_adj)
    np.testing.assert_array_equal(tranky.row_adjacency_sparse(tell).numpy(),
                                  want_adj)
    np.testing.assert_array_equal(
        np.asarray(jranky.row_adjacency_sparse(jell)), want_adj)


# ---------------------------------------------------------------------------
# Repair, given the reference's draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", tranky.METHODS)
@pytest.mark.parametrize("m,n,density,d", SHAPES)
def test_sparse_repair_equals_reference_given_its_draws(method, m, n, density, d):
    _, jell, tell, _ = _inputs(m, n, density, d)
    jrep = jranky.split_and_repair(jell, d, method, KEY)
    draws = reference_draws(KEY, method, d, m, jell.width, jell.capacity[0])
    trep = tranky.split_and_repair(tell, d, method, draws=draws)
    assert trep.repair_cols.dtype == torch.int32
    assert trep.repair_mask.dtype == torch.bool
    want_mask = np.asarray(jrep.repair_mask)
    want_cols = np.asarray(jrep.repair_cols)
    np.testing.assert_array_equal(trep.repair_mask.numpy(), want_mask)
    if method == "neighbor":
        # rows without a candidate carry an arbitrary (gated) column
        np.testing.assert_array_equal(trep.repair_cols.numpy()[want_mask],
                                      want_cols[want_mask])
    else:
        np.testing.assert_array_equal(trep.repair_cols.numpy(), want_cols)
    np.testing.assert_array_equal(trep.todense().numpy(),
                                  np.asarray(jrep.todense()))
    if method in ("random", "neighbor_random"):
        assert int(want_mask.sum()) == sum(tranky.lonely_rows_per_block(tell, d))


@pytest.mark.parametrize("method", tranky.METHODS)
@pytest.mark.parametrize("m,n,density,d", SHAPES)
def test_dense_repair_equals_reference_given_its_draws(method, m, n, density, d):
    _, jell, _, dense = _inputs(m, n, density, d)
    want = np.asarray(jranky.split_and_repair(jnp.asarray(dense), d, method, KEY))
    draws = reference_draws(KEY, method, d, m, jell.width, jell.width)
    got = tranky.split_and_repair(torch.from_numpy(dense), d, method,
                                  draws=draws)
    assert got.shape == (d, m, jell.width)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,n,density,d", SHAPES)
def test_random_repair_is_identical_dense_vs_sparse(m, n, density, d):
    """Port's own draws, same key: the dense repair is the densified sparse
    one (the reference's 'random is bit-identical dense vs sparse')."""
    _, _, tell, dense = _inputs(m, n, density, d)
    for key in (None, 5, torch.Generator().manual_seed(5)):
        rep_s = tranky.split_and_repair(tell, d, "random", key)
        rep_d = tranky.split_and_repair(torch.from_numpy(dense), d, "random", key)
        assert torch.equal(rep_s.todense_blocks(), rep_d)
    a = tranky.split_and_repair(tell, d, "random", 5)
    b = tranky.split_and_repair(tell, d, "random", torch.Generator().manual_seed(5))
    c = tranky.split_and_repair(tell, d, "random", 6)
    assert torch.equal(a.repair_cols, b.repair_cols)
    assert not torch.equal(a.repair_cols, c.repair_cols)
    assert int(a.repair_cols.min()) >= 0 and int(a.repair_cols.max()) < tell.width


@pytest.mark.parametrize("method", ["neighbor", "neighbor_random"])
def test_own_neighbor_draws_choose_only_paper_candidates(method):
    """Third leg: with the port's own draws, every neighbor repair lands on a
    column the paper's literal per-row loops (ref_neighbor_candidates) allow,
    for both representations; rows the neighbor pass cannot reach stay
    lonely (neighbor) or take their random column (neighbor_random)."""
    m, n, d = 32, 600, 4
    _, jell, tell, dense = _inputs(m, n, 0.006, d, seed=3)
    w = jell.width
    rep_s = tranky.split_and_repair(tell, d, method, 9)
    rep_d = tranky.split_and_repair(torch.from_numpy(dense), d, method, 9).numpy()
    again = tranky.split_and_repair(tell, d, method, 9)
    assert torch.equal(rep_s.repair_cols, again.repair_cols)   # deterministic
    checked = 0
    for i in range(d):
        blk = dense[:, i * w:(i + 1) * w]
        for r in np.nonzero(tranky.ref_lonely_rows(blk))[0]:
            cand = tranky.ref_neighbor_candidates(dense, i * w, (i + 1) * w, r)
            added_d = np.nonzero(rep_d[i, r])[0]
            repaired_s = bool(rep_s.repair_mask[i, r])
            if cand.size:
                assert repaired_s and int(rep_s.repair_cols[i, r]) in cand
                assert added_d.size == 1 and added_d[0] in cand
                checked += 1
            elif method == "neighbor":
                assert not repaired_s and added_d.size == 0
            else:
                assert repaired_s and added_d.size == 1
    assert checked > 0


def test_rows_without_candidates_are_gated_not_argmaxed():
    """A full tie at -1 (no candidate) must not decide anything: the row is
    left alone by neighbor and takes its RANDOM column under
    neighbor_random, whatever index arg-max returns for the tie."""
    a = np.zeros((4, 12), np.float32)
    a[0, 0] = a[1, 0] = 1.0          # rows 0, 1 neighbors through column 0
    a[0, 7] = 1.0                    # row 0 has an entry in block 1
    a[2, 1] = 1.0                    # row 2: isolated, lonely in block 1
    a[3, 8] = 1.0                    # row 3: isolated, lonely in block 0
    t = torch.from_numpy(a)
    scores = torch.full((2, 4, 6), 0.5)
    rand = torch.tensor([[5, 5, 5, 5], [4, 4, 4, 4]], dtype=torch.int32)
    draws = tranky.RepairDraws(random_cols=rand, neighbor_scores=scores)
    nb = tranky.split_and_repair(t, 2, "neighbor", draws=draws)
    # row 1 is lonely in block 1 and reaches column 7 - 6 = 1 through row 0
    assert nb[1, 1].nonzero().flatten().tolist() == [1]
    assert float(nb[1, 2].abs().sum()) == 0.0       # isolated: stays lonely
    assert float(nb[0, 3].abs().sum()) == 0.0
    nr = tranky.split_and_repair(t, 2, "neighbor_random", draws=draws)
    assert nr[1, 1].nonzero().flatten().tolist() == [1]
    assert nr[1, 2].nonzero().flatten().tolist() == [4]   # its random column
    assert nr[0, 3].nonzero().flatten().tolist() == [5]
    want = np.asarray(jranky.neighbor_random_checker(
        jnp.asarray(a[:, 6:]), jranky.row_adjacency(jnp.asarray(a)),
        jax.random.PRNGKey(0)))
    assert (want != 0).sum(axis=1).tolist() == (nr[1] != 0).sum(dim=1).tolist()


def test_ref_random_checker_and_dispatch_errors():
    blk = np.zeros((5, 7), np.float32)
    blk[1, 2] = 1.0
    out = tranky.ref_random_checker(blk, np.random.default_rng(0))
    assert (out != 0).sum(axis=1).tolist() == [1, 1, 1, 1, 1]
    assert out[1, 2] == 1.0
    t = torch.from_numpy(blk)
    got = tranky.random_checker(t, torch.tensor([3, 3, 3, 3, 3], dtype=torch.int32))
    assert got[0, 3] == 1 and got[1, 3] == 0 and float(t.sum()) == 1.0  # pure
    with pytest.raises(ValueError, match="needs the row adjacency"):
        tranky.repair_block(t, "neighbor", scores=torch.zeros(5, 7))
    with pytest.raises(ValueError, match="unknown Ranky method"):
        tranky.split_and_repair(t, 1, "bogus")
    with pytest.raises(ValueError, match="pad columns"):
        tranky.split_and_repair(t, 2, "none")
    assert tranky.derive_seed(0, 1) != tranky.derive_seed(0, 2)
    assert tranky.derive_seed(0, 1) == tranky.derive_seed(0, 1)
    assert tranky.seed_of(None) == tranky.DEFAULT_SEED == jranky.DEFAULT_SEED
    assert tranky.METHODS == jranky.METHODS


# ---------------------------------------------------------------------------
# solve_single
# ---------------------------------------------------------------------------

def _solve_both(rep, method, d, *, m=48, n=4096, density=2e-3, **kw):
    _, jell, tell, dense = _inputs(m, n, density, d)
    if rep == "ell":
        ja, ta, score_cols = jell, tell, jell.capacity[0]
    else:
        ja, ta, score_cols = jnp.asarray(dense), torch.from_numpy(dense), jell.width
    draws = reference_draws(KEY, method, d, m, jell.width, score_cols)
    want = jranky.solve_single(ja, num_blocks=d, method=method, key=KEY, **kw)
    got = tranky.solve_single(ta, num_blocks=d, method=method, draws=draws, **kw)
    return got, want


@pytest.mark.parametrize("want_right", [False, True])
@pytest.mark.parametrize("rep,local_mode,merge_mode", [
    ("ell", "gram", "gram"), ("ell", "gram", "proxy"),
    ("dense", "gram", "gram"), ("dense", "gram", "proxy"),
    ("dense", "svd", "gram"), ("dense", "svd", "proxy"),
])
def test_solve_single_matches_reference(rep, local_mode, merge_mode, want_right):
    got, want = _solve_both(rep, "neighbor_random", 4, local_mode=local_mode,
                            merge_mode=merge_mode, want_right=want_right)
    assert len(got) == len(want) == (3 if want_right else 2)
    # S: rtol 1e-4 (f32 gram + eigh on both sides, different LAPACK builds)
    assert_same_factors(got[0], got[1], want[0], want[1], top=6, gap_tol=2e-3)
    u = got[0].numpy()
    np.testing.assert_allclose(u.T @ u, np.eye(u.shape[1]), atol=1e-4)
    if want_right:
        assert got[2].shape == tuple(want[2].shape)
        assert projector_gap(got[2][:, :6], np.asarray(want[2])[:, :6]) < 2e-3


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("rep", ["ell", "dense"])
@pytest.mark.parametrize("d", [2, 8])
def test_solve_single_use_kernel_and_ragged_blocks(rep, use_kernel, d):
    """M = 64, N = 2000: the last block is ragged.  ``use_kernel`` routes the
    grams through the kernel wrappers (their plain versions on the CPU)."""
    got, want = _solve_both(rep, "random", d, m=64, n=2000, density=4e-3,
                            merge_mode="gram", use_kernel=use_kernel,
                            want_right=True)
    assert_same_factors(got[0], got[1], want[0], want[1], top=5, gap_tol=2e-3)
    assert projector_gap(got[2][:, :5], np.asarray(want[2])[:, :5]) < 2e-3


def test_solve_single_sparse_rejects_local_svd():
    _, _, tell, _ = _inputs(48, 4096, 2e-3, 4)
    with pytest.raises(ValueError, match="gram-native"):
        tranky.solve_single(tell, num_blocks=4, method="none",
                            local_mode="svd", merge_mode="proxy")
    with pytest.raises(ValueError, match="unknown merge_mode"):
        tranky.solve_single(tell, num_blocks=4, method="none", merge_mode="x")


def test_undetermined_tail_with_injected_noise():
    """The rank-problem emulation, noise INJECTED (the reference's own normal
    draws, ``split(fold_in(key, 0xDEAD), D)``).  Which panel columns count as
    dead (s <= 1e-9 * smax) hangs on the last bits of each backend's
    factorization, so S is held at 1e-2 * S[0] against the reference (the
    noise is sqrt(eps)-scale), exactly against a zero-noise run of the port,
    and for shape and finiteness."""
    d, m = 8, 48
    _, jell, tell, dense = _inputs(m, 4096, 2e-3, d)
    kw = dict(num_blocks=d, method="none", local_mode="svd", merge_mode="proxy")
    nkeys = jax.random.split(jax.random.fold_in(KEY, 0xDEAD), d)
    noise = np.stack([np.asarray(jax.random.normal(k, (m, m), jnp.float32))
                      for k in nkeys])
    want = jranky.solve_single(jnp.asarray(dense), undetermined_tail=True,
                               key=KEY, **kw)
    t = torch.from_numpy(dense)
    got = tranky.solve_single(t, undetermined_tail=True,
                              tail_noise=torch.from_numpy(noise), **kw)
    assert got[0].shape == (m, m) and got[1].shape == (m,)
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()
    s_ref = np.asarray(want[1])
    np.testing.assert_allclose(got[1].numpy(), s_ref, rtol=0, atol=1e-2 * s_ref[0])
    plain = tranky.solve_single(t, **kw)
    zero = tranky.solve_single(t, undetermined_tail=True,
                               tail_noise=torch.zeros((d, m, m)), **kw)
    np.testing.assert_allclose(zero[1].numpy(), plain[1].numpy(),
                               rtol=1e-5, atol=1e-5 * s_ref[0])
    own = tranky.solve_single(t, undetermined_tail=True, key=3, **kw)
    own2 = tranky.solve_single(t, undetermined_tail=True, key=3, **kw)
    assert torch.equal(own[1], own2[1])


def test_ranky_svd_shim_matches_solve_single_and_warns():
    _, _, tell, _ = _inputs(48, 4096, 2e-3, 4)
    with pytest.warns(DeprecationWarning):
        u, s = tranky.ranky_svd(tell, num_blocks=4, method="random", key=2)
    u2, s2 = tranky.solve_single(tell, num_blocks=4, method="random", key=2)
    assert torch.equal(s, s2) and torch.equal(u, u2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        out = tranky.ranky_svd(tell, num_blocks=4, method="random", rank=5,
                               want_right=True)
    assert out[0].shape == (48, 5) and out[2].shape == (4 * tell.width, 5)
