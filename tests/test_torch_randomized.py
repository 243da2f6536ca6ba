"""``repro_torch.core.randomized`` against the reference, with the test
matrix Omega drawn by the reference (``randomized.draw_omega``) and handed
over: per-block contractions to 1e-5 relative (f32 summation order), the
tail factorization and the whole solver by value (S, rtol 1e-4) and by
subspace projector (U, V)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import randomized as jrand
from repro.core import ranky as jranky
from repro.core import sparse as jsparse

from repro_torch.core import convert
from repro_torch.core import randomized as trand
from repro_torch.core import ranky as tranky
from repro_torch.core import sparse as tsparse

from test_torch_helpers import (assert_close_rel, paper_like_coo, port_ell,
                                projector_gap,
                                reference_draws, reference_omega)

KEY = jax.random.PRNGKey(0)
SKETCH = dict(oversample=32, power_iters=4)


def _repaired(m=24, n=2048, density=0.004, d=8, seed=3, method="neighbor_random"):
    jcoo = jsparse.ensure_full_row_rank(
        jsparse.random_bipartite(m, n, density, seed=seed, weighted=True),
        seed=seed)
    jell = jsparse.block_ell_from_coo(jcoo, d)
    jrep = jranky.split_and_repair(jell, d, method, KEY)
    trep = convert.repaired_from_numpy(port_ell(jell),
                                       np.asarray(jrep.repair_cols),
                                       np.asarray(jrep.repair_mask))
    jdense = jrep.todense_blocks()
    return jrep, trep, jdense, torch.from_numpy(np.array(jdense))


def test_sketch_width_and_its_errors():
    for args in [(6, 32, 24), (6, 8, 24), (24, 0, 24), (1, 0, 5)]:
        assert trand.sketch_width(*args) == jrand.sketch_width(*args)
    for bad in [(0, 8, 24), (25, 8, 24), (3, -1, 24)]:
        with pytest.raises(ValueError) as t_err:
            trand.sketch_width(*bad)
        with pytest.raises(ValueError) as j_err:
            jrand.sketch_width(*bad)
        assert str(t_err.value) == str(j_err.value)


def test_draw_omega_is_deterministic_in_the_key():
    a = trand.draw_omega(4, 6, 20)
    assert a.shape == (6, 20) and a.dtype == torch.float32
    assert torch.equal(a, trand.draw_omega(4, 6, 20))
    assert torch.equal(a, trand.draw_omega(torch.Generator().manual_seed(4), 6, 20))
    assert not torch.equal(a, trand.draw_omega(5, 6, 20))
    assert torch.equal(trand.draw_omega(None, 6, 20),
                       trand.draw_omega(tranky.DEFAULT_SEED, 6, 20))
    big = trand.draw_omega(1, 64, 512)
    assert abs(float(big.mean())) < 0.05 and abs(float(big.std()) - 1) < 0.05


@pytest.mark.parametrize("m,n,density,d", [(24, 2048, 0.004, 8),
                                           (64, 2000, 0.004, 8),
                                           (48, 4096, 0.002, 4)])
def test_block_contractions_dense_and_sparse(m, n, density, d):
    jrep, trep, jdense, tdense = _repaired(m, n, density, d)
    l = 10
    omega_j = jrand.draw_omega(KEY, l, m)
    omega = reference_omega(KEY, l, m)
    ell, jell = trep.ell, jrep.ell
    stack = trand.sketch_stack_sparse(omega, trep)
    assert stack.shape == (d, l, ell.width)
    for i in range(d):
        want_g = np.asarray(jrand.sketch_block_dense(omega_j, jdense[i]))
        assert_close_rel(trand.sketch_block_dense(omega, tdense[i]), want_g)
        args = (ell.col_ids[i], ell.col_rows[i], ell.col_vals[i],
                trep.repair_cols[i], trep.repair_mask[i])
        jargs = (jell.col_ids[i], jell.col_rows[i], jell.col_vals[i],
                 jrep.repair_cols[i], jrep.repair_mask[i])
        assert_close_rel(trand.sketch_block_sparse(omega, *args, ell.width), want_g)
        assert_close_rel(stack[i], want_g)
        assert_close_rel(stack[i], jrand.sketch_block_sparse(omega_j, *jargs, ell.width))
        g = torch.from_numpy(want_g.copy())
        want_t = np.asarray(jrand.pullback_block_dense(jnp.asarray(want_g),
                                                       jdense[i]))
        assert_close_rel(trand.pullback_block_dense(g, tdense[i]), want_t)
        assert_close_rel(trand.pullback_block_sparse(g, *args, m), want_t)
        assert_close_rel(trand.pullback_block_sparse(g, *args, m),
               jrand.pullback_block_sparse(jnp.asarray(want_g), *jargs, m))


def test_truncate_sketch_matches_and_masks_the_floor():
    """The whitening keeps the floor mask exactly: a rank-deficient sketch
    (duplicate rows in G) must give finite factors, not 1/sqrt(0)."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((20, 300)).astype(np.float32)
    g = rng.standard_normal((8, 20)).astype(np.float32) @ a
    g[5] = g[2]                                   # rank-deficient sketch
    g[7] = 0.0
    t, h = g @ a.T, g @ g.T
    u, s, vproj = trand.truncate_sketch(torch.from_numpy(t),
                                        torch.from_numpy(h), 5)
    ju, js, jv = jrand.truncate_sketch(jnp.asarray(t), jnp.asarray(h), 5)
    for x in (u, s, vproj):
        assert torch.isfinite(x).all()
    assert u.shape == (20, 5) and s.shape == (5,) and vproj.shape == (8, 5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-4)
    assert projector_gap(u, np.asarray(ju)) < 1e-3
    # V = G^T vproj is orthonormal on both sides and spans the same space
    v = torch.from_numpy(g).T @ vproj
    np.testing.assert_allclose((v.T @ v).numpy(), np.eye(5), atol=1e-4)
    assert projector_gap(v, g.T @ np.asarray(jv)) < 1e-3


@pytest.mark.parametrize("rep", ["dense", "ell"])
@pytest.mark.parametrize("want_right", [False, True])
def test_randomized_svd_blocks_matches_reference_given_omega(rep, want_right):
    jrep, trep, jdense, tdense = _repaired()
    m, k = 24, 6
    l = trand.sketch_width(k, SKETCH["oversample"], m)
    omega = reference_omega(KEY, l, m)
    jb, tb = (jdense, tdense) if rep == "dense" else (jrep, trep)
    want = jrand.randomized_svd_blocks(jb, rank=k, key=KEY,
                                       want_right=want_right, **SKETCH)
    got = trand.randomized_svd_blocks(tb, rank=k, omega=omega,
                                      want_right=want_right, **SKETCH)
    assert len(got) == len(want)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-4)
    assert got[0].shape == (m, k)
    assert projector_gap(got[0], np.asarray(want[0])) < 1e-3
    np.testing.assert_allclose((got[0].T @ got[0]).numpy(), np.eye(k), atol=1e-4)
    if want_right:
        assert got[2].shape == tuple(want[2].shape)
        assert projector_gap(got[2], np.asarray(want[2])) < 1e-3
    # and against the exact SVD of the repaired matrix (the reference's own
    # tolerance: rtol 1e-3, atol 1e-3 * S[0])
    s_true = np.linalg.svd(np.asarray(jrep.todense()), compute_uv=False)
    np.testing.assert_allclose(got[1].numpy(), s_true[:k], rtol=1e-3,
                               atol=1e-3 * s_true[0])


def test_randomized_own_omega_is_deterministic_and_checks_shape():
    _, trep, _, tdense = _repaired()
    a = trand.randomized_svd_blocks(trep, rank=6, key=7, **SKETCH)
    b = trand.randomized_svd_blocks(trep, rank=6, key=7, **SKETCH)
    c = trand.randomized_svd_blocks(tdense, rank=6, key=7, **SKETCH)
    assert torch.equal(a[1], b[1])
    np.testing.assert_allclose(a[1].numpy(), c[1].numpy(), rtol=1e-4)
    with pytest.raises(ValueError, match="omega has shape"):
        trand.randomized_svd_blocks(trep, rank=6, omega=torch.zeros(3, 24),
                                    **SKETCH)
    with pytest.raises(ValueError, match="rank=30"):
        trand.randomized_svd_blocks(trep, rank=30)


@pytest.mark.parametrize("rep", ["dense", "ell"])
def test_block_truncated_panels(rep):
    """Leaf panels U_d S_d: P_d P_d^T is sign-free, so compare that."""
    jrep, trep, jdense, tdense = _repaired()
    k = 6
    l = trand.sketch_width(k, SKETCH["oversample"], 24)
    jb, tb = (jdense, tdense) if rep == "dense" else (jrep, trep)
    want = np.asarray(jrand.block_truncated_panels(jb, rank=k, key=KEY, **SKETCH))
    got = trand.block_truncated_panels(tb, rank=k,
                                       omega=reference_omega(KEY, l, 24),
                                       **SKETCH)
    assert got.shape == want.shape == (8, 24, k)
    assert_close_rel(got @ got.mT, want @ want.transpose(0, 2, 1), rel=1e-3)


def test_rank_deficient_blocks_need_repair_for_sketch_recovery():
    """The reference's rank problem, sketch edition: rows lonely EVERYWHERE
    carry no sketch weight, so without repair the trailing components are
    gone; with repair (the reference's draws, injected) the sketch recovers
    the repaired spectrum at rtol 1e-3, atol 1e-3 * S[0], and equals the
    reference's own result at rtol 1e-4."""
    coo = jsparse.ensure_full_row_rank(
        jsparse.random_bipartite(16, 1024, 0.006, seed=11, weighted=True),
        seed=11)
    dead = np.isin(coo.rows, (2, 9, 13))
    jcoo = jsparse.COOMatrix(rows=coo.rows[~dead], cols=coo.cols[~dead],
                             vals=coo.vals[~dead], shape=coo.shape)
    jell = jsparse.block_ell_from_coo(jcoo, 8)
    tell = port_ell(jell)
    a = tsparse.pad_to_block_multiple(jcoo.todense(), 8)
    assert all(np.linalg.matrix_rank(b) < 16 for b in np.split(a, 8, axis=1))
    k = 15  # > rank(A) = 13: the tail components only exist after repair
    key = jax.random.PRNGKey(1)
    draws = reference_draws(key, "neighbor_random", 8, 16, jell.width,
                            jell.capacity[0])
    omega = reference_omega(key, 16, 16)

    jrep = jranky.split_and_repair(jell, 8, "neighbor_random", key)
    trep = tranky.split_and_repair(tell, 8, "neighbor_random", draws=draws)
    np.testing.assert_array_equal(trep.todense().numpy(),
                                  np.asarray(jrep.todense()))
    s_rep_true = np.linalg.svd(np.asarray(jrep.todense()), compute_uv=False)

    _, s_none = tranky.solve_single(tell, num_blocks=8, method="none", rank=k,
                                    omega=omega, **SKETCH)
    _, s_fix = tranky.solve_single(tell, num_blocks=8, method="neighbor_random",
                                   rank=k, draws=draws, omega=omega, **SKETCH)
    _, js_fix = jranky.solve_single(jell, num_blocks=8, method="neighbor_random",
                                    rank=k, key=key, **SKETCH)
    _, js_none = jranky.solve_single(jell, num_blocks=8, method="none",
                                     rank=k, key=key, **SKETCH)
    assert float(s_none[-1]) < 1e-4 * s_rep_true[0]
    assert float(js_none[-1]) < 1e-4 * s_rep_true[0]
    assert s_rep_true[k - 1] > 0.05 * s_rep_true[0]
    np.testing.assert_allclose(s_fix.numpy(), s_rep_true[:k], rtol=1e-3,
                               atol=1e-3 * s_rep_true[0])
    np.testing.assert_allclose(s_fix.numpy(), np.asarray(js_fix), rtol=1e-4)


def test_port_and_reference_agree_where_the_sketch_itself_is_inaccurate():
    """With the default sketch (oversample 8, 2 power passes) and a slowly
    decaying spectrum the sketch is percent-level off the truth; that is the
    algorithm's error, not the port's: given the same Omega and draws the
    port lands on the reference's values (rtol 1e-3) while both miss the
    exact ones by more than 1 %."""
    m, n, d, k = 48, 4096, 8, 16
    jcoo, _ = paper_like_coo(m, n, 2e-3, seed=2020)
    jell = jsparse.block_ell_from_coo(jcoo, d)
    draws = reference_draws(KEY, "random", d, m, jell.width, jell.capacity[0])
    kw = dict(num_blocks=d, method="random", rank=k, oversample=8,
              power_iters=2)
    _, js = jranky.solve_single(jell, key=KEY, **kw)
    _, ts = tranky.solve_single(port_ell(jell), draws=draws,
                                omega=reference_omega(KEY, 24, m), **kw)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-3)
    rep = jranky.split_and_repair(jell, d, "random", KEY)
    s_true = np.linalg.svd(np.asarray(rep.todense()), compute_uv=False)[:k]
    assert np.abs(ts.numpy() - s_true).max() > 1e-2 * s_true[0]
    assert np.abs(np.asarray(js) - s_true).max() > 1e-2 * s_true[0]
    assert bool((ts.numpy() <= s_true * (1 + 1e-4)).all())   # Ritz: from below
