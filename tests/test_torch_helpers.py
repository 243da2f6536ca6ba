"""Shared helpers of the ``tests/test_torch_*.py`` parity tests: hand data
and random draws from the JAX reference over to the port as numpy arrays,
and compare factors up to what ``eigh`` / ``svd`` leave free (sign, basis of
a degenerate subspace).  The few tests here hold the helpers themselves."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from repro.core import randomized as jrandomized
from repro.core import ranky as jranky
from repro.core import sparse as jsparse

from repro_torch.core import convert, sparse as tsparse


def paper_like_coo(m=48, n=4096, density=2e-3, seed=2020, weighted=False):
    """(reference COO, port COO) of the same generated matrix."""
    jcoo = jsparse.ensure_full_row_rank(
        jsparse.random_bipartite(m, n, density, seed=seed, weighted=weighted),
        seed=seed)
    return jcoo, convert.coo_from_numpy(jcoo.rows, jcoo.cols, jcoo.vals,
                                        jcoo.shape)


def port_ell(jell) -> tsparse.BlockEll:
    """A reference BlockEll carried over into the port (on the CPU)."""
    return convert.block_ell_from_numpy(
        np.asarray(jell.col_ids), np.asarray(jell.col_rows),
        np.asarray(jell.col_vals), m=jell.m, width=jell.width, n=jell.n,
        nnz=jell.nnz, device="cpu")


def reference_draws(key, method, num_blocks, m, width, score_cols):
    """The draws the reference's ``split_and_repair`` makes from ``key``, in
    the port's ``RepairDraws`` layout: the per-block key split, the
    ``k_nb, k_rand`` split of neighbor_random, ``ranky._random_cols`` and
    ``jax.random.uniform`` over the (M, score_cols) candidate mask."""
    keys = jax.random.split(key, num_blocks)
    rand, scores = [], []
    for k_d in keys:
        if method == "random":
            rand.append(np.asarray(jranky._random_cols(k_d, m, width)))
        elif method == "neighbor":
            scores.append(np.asarray(jax.random.uniform(k_d, (m, score_cols))))
        elif method == "neighbor_random":
            k_nb, k_rand = jax.random.split(k_d)
            scores.append(np.asarray(jax.random.uniform(k_nb, (m, score_cols))))
            rand.append(np.asarray(jranky._random_cols(k_rand, m, width)))
    return convert.draws_from_numpy(
        np.stack(rand) if rand else None,
        np.stack(scores) if scores else None, device="cpu")


def reference_omega(key, l, m) -> torch.Tensor:
    return torch.from_numpy(np.array(jrandomized.draw_omega(key, l, m)))


def assert_close_rel(got, want, rel=1e-5):
    """|got - want| <= rel * max|want| elementwise: the tolerance of f32
    results whose sums were taken in another order."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def projector_gap(u, u_ref) -> float:
    """max |U U^T - U_ref U_ref^T|: 0 iff the two column spaces agree,
    whatever the signs and the basis inside the space."""
    u = np.asarray(u, np.float64)
    u_ref = np.asarray(u_ref, np.float64)
    return float(np.abs(u @ u.T - u_ref @ u_ref.T).max())


def assert_same_factors(u, s, u_ref, s_ref, *, rtol=1e-4, top=None,
                        gap_tol=1e-3):
    """S by value (rtol, atol = 1e-5 * S[0]); the leading ``top`` columns of U
    by subspace projector (columns are never compared one by one: their
    signs, and the basis of close singular values, are free)."""
    s = np.asarray(s, np.float64)
    s_ref = np.asarray(s_ref, np.float64)
    np.testing.assert_allclose(s, s_ref, rtol=rtol, atol=1e-5 * s_ref[0])
    if top:
        assert projector_gap(np.asarray(u)[:, :top],
                             np.asarray(u_ref)[:, :top]) < gap_tol


def test_projector_gap_ignores_sign_and_basis():
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.standard_normal((12, 4)))
    rot, _ = np.linalg.qr(rng.standard_normal((4, 4)))
    assert projector_gap(q @ rot, -q) < 1e-12
    other, _ = np.linalg.qr(rng.standard_normal((12, 4)))
    assert projector_gap(q, other) > 1e-2


def test_reference_draws_have_the_ports_layout():
    key = jax.random.PRNGKey(3)
    d = reference_draws(key, "neighbor_random", 4, 10, 25, 7)
    assert d.random_cols.shape == (4, 10) and d.random_cols.dtype == torch.int32
    assert d.neighbor_scores.shape == (4, 10, 7)
    assert int(d.random_cols.min()) >= 0 and int(d.random_cols.max()) < 25
    assert reference_draws(key, "random", 4, 10, 25, 7).neighbor_scores is None
    assert reference_draws(key, "neighbor", 4, 10, 25, 7).random_cols is None
