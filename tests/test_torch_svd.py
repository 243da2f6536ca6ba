"""``repro_torch.core.svd`` against the reference, function by function.

Grams are held at 1e-5 relative to max|G| (f32, summation order differs),
singular values at rtol 1e-4, vectors by subspace projector or by the
identity they must satisfy (``U diag(S)`` panels through ``P P^T``), never
column by column: ``eigh`` / ``svd`` leave signs and the basis of close
values free, and LAPACK builds differ in both."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import ranky as jranky
from repro.core import sparse as jsparse
from repro.core import svd as jsvd

from repro_torch.core import convert
from repro_torch.core import svd as tsvd

from test_torch_helpers import (assert_close_rel, paper_like_coo, port_ell,
                                projector_gap)

KEY = jax.random.PRNGKey(5)
SHAPES = [(48, 4096, 2e-3, 2), (48, 4096, 2e-3, 4), (48, 4096, 2e-3, 8),
          (64, 2000, 4e-3, 8)]


def _repaired(m, n, density, d, method="neighbor_random", weighted=False):
    """Reference repaired blocks (both representations) and their port twins,
    carried over as numpy."""
    jcoo, _ = paper_like_coo(m, n, density, seed=6, weighted=weighted)
    jell = jsparse.block_ell_from_coo(jcoo, d)
    jrep = jranky.split_and_repair(jell, d, method, KEY)
    trep = convert.repaired_from_numpy(port_ell(jell),
                                       np.asarray(jrep.repair_cols),
                                       np.asarray(jrep.repair_mask))
    jdense = jrep.todense_blocks()
    tdense = torch.from_numpy(np.array(jdense))
    return jrep, trep, jdense, tdense


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("m,n,density,d", SHAPES)
def test_gram_stack_both_representations(m, n, density, d, use_kernel):
    jrep, trep, jdense, tdense = _repaired(m, n, density, d)
    want = np.asarray(jsvd.gram_stack(jrep))
    assert_close_rel(tsvd.gram_stack(trep, use_kernel=use_kernel), want)
    assert_close_rel(tsvd.gram_stack(tdense, use_kernel=use_kernel), want)
    assert_close_rel(tsvd.gram_stack(tdense, use_kernel=use_kernel),
           np.asarray(jsvd.gram_stack(jdense)))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_sparse_gram_block_counts_cross_and_shared_repair_terms(use_kernel):
    """A repair that hits a column E already stores, and two repairs sharing
    a column: the terms an append-only ELL would drop.  Weighted values."""
    jrep, trep, jdense, _ = _repaired(24, 300, 0.02, 2, method="random",
                                      weighted=True)
    ell = trep.ell
    rc = trep.repair_cols.clone()
    rm = trep.repair_mask.clone()
    stored = int(ell.col_ids[0, 1])
    rm[0, :3] = True                 # force three repairs in block 0 ...
    rc[0, 0] = stored                # ... one onto a stored column
    rc[0, 1] = rc[0, 2] = 7          # ... two sharing a column
    for d in range(2):
        got = tsvd.sparse_gram_block(ell.col_ids[d], ell.col_rows[d],
                                     ell.col_vals[d], rc[d], rm[d], ell.m,
                                     use_kernel=use_kernel)
        want = jsvd.sparse_gram_block(
            jrep.ell.col_ids[d], jrep.ell.col_rows[d], jrep.ell.col_vals[d],
            jnp.asarray(rc[d].numpy()), jnp.asarray(rm[d].numpy()), ell.m)
        assert_close_rel(got, want)
        blk = np.asarray(jrep.ell.todense_blocks()[d]).copy()
        rows = np.nonzero(rm[d].numpy())[0]
        np.add.at(blk, (rows, rc[d].numpy()[rows]), 1.0)
        assert_close_rel(got, blk @ blk.T)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_gram_stack_splits_repair_hits_by_block(use_kernel):
    """``gram_stack`` finds the stored columns that repairs hit for all
    blocks at once; blocks with several hits, one hit and none must each get
    their own.  Held at 1e-5 relative against the densified repaired
    blocks' A A^T."""
    _, trep, _, _ = _repaired(24, 300, 0.02, 3, method="random",
                              weighted=True)
    ell = trep.ell
    rc = trep.repair_cols.clone()
    rm = torch.zeros_like(trep.repair_mask)
    rm[0, :3] = True
    rc[0, 0] = ell.col_ids[0, 1]     # block 0: two stored columns hit ...
    rc[0, 1] = ell.col_ids[0, 4]
    rc[0, 2] = ell.col_ids[0, 4]     # ... one of them twice
    rm[2, 5] = True
    rc[2, 5] = ell.col_ids[2, 0]     # block 2: one hit; block 1: no repair
    rep = type(trep)(ell, rc, rm)
    dense = rep.todense_blocks().double()
    assert_close_rel(tsvd.gram_stack(rep, use_kernel=use_kernel),
                     (dense @ dense.mT).numpy())


@pytest.mark.parametrize("use_kernel", [False, True])
def test_gram_and_local_svd_gram(use_kernel):
    _, _, jdense, tdense = _repaired(48, 4096, 2e-3, 4)
    assert_close_rel(tsvd.gram(tdense[1], use_kernel=use_kernel), jsvd.gram(jdense[1]))
    u, s = tsvd.local_svd_gram(tdense[1], use_kernel=use_kernel)
    ju, js = jsvd.local_svd_gram(jdense[1])
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-4,
                               atol=1e-5 * float(js[0]))
    # U diag(S^2) U^T is the gram again, whatever the signs
    assert_close_rel((u * s**2) @ u.T, jsvd.gram(jdense[1]), rel=1e-4)
    assert projector_gap(u[:, :5], np.asarray(ju)[:, :5]) < 2e-3


def test_eigh_to_svd_is_descending_and_clamped():
    rng = np.random.default_rng(0)
    b = rng.standard_normal((3, 10, 4)).astype(np.float32)   # rank 4 grams
    g = b @ b.transpose(0, 2, 1)
    u, s = tsvd.eigh_to_svd(torch.from_numpy(g))
    assert u.shape == (3, 10, 10) and s.shape == (3, 10)
    assert bool((s[:, :-1] >= s[:, 1:]).all()) and bool((s >= 0).all())
    for i in range(3):
        _, js = jsvd.eigh_to_svd(jnp.asarray(g[i]))
        np.testing.assert_allclose(s[i, :4].numpy(), np.asarray(js)[:4],
                                   rtol=1e-4)
        assert float(s[i, 4:].max()) < 1e-2 * float(s[i, 0])


@pytest.mark.parametrize("shape", [(12, 40), (12, 7)])
def test_local_svd_exact_pads_to_m(shape):
    rng = np.random.default_rng(1)
    a = rng.standard_normal(shape).astype(np.float32)
    u, s = tsvd.local_svd_exact(torch.from_numpy(a))
    ju, js = jsvd.local_svd_exact(jnp.asarray(a))
    assert u.shape == (12, 12) and s.shape == (12,)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose((u.T @ u).numpy(), np.eye(12), atol=1e-5)
    k = min(shape)
    assert_close_rel((u[:, :k] * s[:k]**2) @ u[:, :k].T, a @ a.T, rel=1e-4)
    # a stack gives what the blocks give one by one
    us, ss = tsvd.local_svd_exact(torch.from_numpy(np.stack([a, 2 * a])))
    np.testing.assert_allclose(ss[1].numpy(), 2 * s.numpy(), rtol=1e-5, atol=1e-6)


def test_proxy_panel_and_both_merges():
    jrep, trep, jdense, tdense = _repaired(48, 4096, 2e-3, 8)
    tu, ts = tsvd.local_svd_gram_stack(trep)
    ju, js = jsvd.local_svd_gram_stack(jrep)
    # per-block grams square the condition number: below sqrt(eps) * smax a
    # value is rounding noise on both sides, hence the absolute floor
    np.testing.assert_allclose(
        ts.numpy(), np.asarray(js), rtol=1e-4,
        atol=2 * float(np.sqrt(np.finfo(np.float32).eps)) * float(js.max()))
    tp = tsvd.proxy_panel(tu, ts)
    jp = jax.vmap(jsvd.proxy_panel)(ju, js)
    assert tp.shape == tuple(jp.shape)
    assert_close_rel(tsvd.proxy_panel(tu[0], ts[0]), tp[0], rel=0)
    # P P^T is sign- and basis-free: it is the gram stack again
    assert_close_rel(tp @ tp.mT, np.asarray(jp @ jnp.swapaxes(jp, 1, 2)), rel=1e-4)
    mu, ms = tsvd.merge_panels_svd(tp)
    jmu, jms = jsvd.merge_panels_svd(jp)
    np.testing.assert_allclose(ms.numpy(), np.asarray(jms), rtol=1e-4,
                               atol=1e-5 * float(jms[0]))
    assert mu.shape == (48, 48)
    assert projector_gap(mu[:, :6], np.asarray(jmu)[:, :6]) < 2e-3
    grams = tsvd.gram_stack(trep)
    gu, gs = tsvd.merge_grams_eigh(grams)
    jgu, jgs = jsvd.merge_grams_eigh(jsvd.gram_stack(jrep))
    np.testing.assert_allclose(gs.numpy(), np.asarray(jgs), rtol=1e-4,
                               atol=1e-5 * float(jgs[0]))
    _, gs2 = tsvd.merge_grams_eigh(grams.sum(dim=0))          # pre-reduced
    np.testing.assert_allclose(gs2.numpy(), gs.numpy(), rtol=1e-6)
    # the two merges agree with each other
    np.testing.assert_allclose(ms.numpy(), gs.numpy(), rtol=1e-3,
                               atol=1e-4 * float(gs[0]))


def test_merge_panels_svd_pads_s_when_the_proxy_is_narrow():
    panels = torch.from_numpy(np.random.default_rng(2)
                              .standard_normal((1, 6, 4)).astype(np.float32))
    # one (6, 4) panel: the proxy has 4 columns, S is padded to M = 6
    u, s = tsvd.merge_panels_svd(torch.nn.functional.pad(panels, (0, 2)))
    assert s.shape == (6,) and float(s[4:].abs().max()) < 1e-5


@pytest.mark.parametrize("truncate", [None, 5])
def test_right_vectors_dense_and_sparse(truncate):
    """Given the SAME (U, S) (the reference's), V must agree to f32 rounding:
    no factorization stands between the inputs and the output here."""
    jrep, trep, jdense, tdense = _repaired(48, 4096, 2e-3, 4)
    ju, js = jsvd.merge_grams_eigh(jsvd.gram_stack(jrep))
    if truncate:
        ju, js = ju[:, :truncate], js[:truncate]
    u = torch.from_numpy(np.array(ju))
    s = torch.from_numpy(np.array(js))
    ell = trep.ell
    for d in range(4):
        want = np.asarray(jsvd.right_vectors(jdense[d], ju, js))
        assert_close_rel(tsvd.right_vectors(tdense[d], u, s), want, rel=1e-5)
        got = tsvd.sparse_right_vectors(
            ell.col_ids[d], ell.col_rows[d], ell.col_vals[d],
            trep.repair_cols[d], trep.repair_mask[d], ell.width, u, s)
        assert_close_rel(got, want, rel=1e-5)
        assert_close_rel(got, jsvd.sparse_right_vectors(
            jrep.ell.col_ids[d], jrep.ell.col_rows[d], jrep.ell.col_vals[d],
            jrep.repair_cols[d], jrep.repair_mask[d], ell.width, ju, js),
            rel=1e-5)


def test_masked_inverse_drops_directions_below_the_floor():
    s = torch.tensor([4.0, 2.0, 1e-9, 0.0])
    inv = tsvd.masked_inverse(s)
    assert inv.tolist() == [0.25, 0.5, 0.0, 0.0]
    a = torch.eye(4)
    v = tsvd.right_vectors(a, torch.eye(4), s)
    assert torch.isfinite(v).all() and float(v[:, 2:].abs().max()) == 0.0
    want = np.asarray(jsvd.right_vectors(jnp.eye(4), jnp.eye(4),
                                         jnp.asarray(s.numpy())))
    np.testing.assert_array_equal(v.numpy(), want)
