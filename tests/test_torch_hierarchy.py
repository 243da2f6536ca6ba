"""The hierarchical tree merge: ``repro_torch.core.hierarchy`` and
``api.svd(..., backend="hierarchical")`` (and rule R2, ``sketch=True``)
against ``repro.core.hierarchy`` and ``repro.core.api`` on the CPU.

* Twins of the reference's hierarchical tests (``tests/test_api.py``,
  ``test_ranky.py``, ``test_randomized.py``, ``test_sparse_path.py``):
  exactness against numpy's SVD, reconstruction with ``want_right``, the
  deprecation shim.
* Direct parity: the same inputs through both front doors, the
  reference's repair draws and Omega injected into the port; S at rtol
  1e-4, atol 1e-5 * S[0]; U and V by subspace projector; plans and
  diagnostics equal.
* The stacked sketch leaves (one sketch over the whole block stack a pass)
  equal the per-block range finder to float32 rounding.
"""
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import api as japi
from repro.core import hierarchy as jhier
from repro.core import sparse as jsparse

from repro_torch.core import api as tapi
from repro_torch.core import convert
from repro_torch.core import hierarchy as thier
from repro_torch.core import randomized as trand
from repro_torch.core import ranky as tranky
from repro_torch.core import sparse as tsparse

from test_torch_helpers import (assert_close_rel, port_ell, projector_gap,
                                reference_draws, reference_omega)

KEY = jax.random.PRNGKey(5)
SKETCH = dict(oversample=32, power_iters=4)


def _coo(m=24, n=1024, density=0.01, seed=0, weighted=True):
    return jsparse.ensure_full_row_rank(
        jsparse.random_bipartite(m, n, density, seed=seed, weighted=weighted),
        seed=seed)


def _port_coo(jcoo):
    return convert.coo_from_numpy(jcoo.rows, jcoo.cols, jcoo.vals,
                                  jcoo.shape)


def _inputs(jcoo, d):
    """{kind: (reference input, port input)} for dense, ell and coo."""
    a = jsparse.pad_to_block_multiple(jcoo.todense(), d)
    jell = jsparse.block_ell_from_coo(jcoo, d)
    return {"dense": (jnp.asarray(a), torch.from_numpy(a.copy())),
            "ell": (jell, port_ell(jell)),
            "coo": (jcoo, _port_coo(jcoo))}


def _lowrank(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((16, 4)) @ rng.standard_normal((4, 512))) \
        .astype(np.float32)


def _shim(*args, **kw):
    with pytest.warns(DeprecationWarning):
        return thier.hierarchical_ranky_svd(*args, **kw)


def _leading(s):
    """Columns up to the first clear gap of the spectrum (U is compared by
    subspace only where the spectrum separates it)."""
    s = np.asarray(s, np.float64)
    gaps = s[:-1] / np.maximum(s[1:], 1e-30)
    return int(np.argmax(gaps > 1.05)) + 1 if (gaps > 1.05).any() else 1


def _same(t_u, t_s, j_u, j_s):
    j_s = np.asarray(j_s, np.float64)
    np.testing.assert_allclose(t_s.numpy(), j_s, rtol=1e-4,
                               atol=1e-5 * j_s[0])
    top = _leading(j_s)
    assert projector_gap(t_u.numpy()[:, :top], np.asarray(j_u)[:, :top]) \
        < 1e-3


# ---------------------------------------------------------------------------
# Direct parity through the front door (tests/test_api.py twins)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sketch", [False, True])
@pytest.mark.parametrize("kind", ["dense", "ell", "coo"])
def test_parity_hierarchical_backend(sketch, kind):
    """The reference's ``test_parity_hierarchical_backend`` configuration
    (fanout 2, rank 6, random repair, sketch leaves or exact ones) through
    both packages with the reference's draws and Omega; the port's legacy
    shim gives the front door's bits."""
    jcoo = _coo()
    ja, ta = _inputs(jcoo, 8)[kind]
    kw = dict(num_blocks=8, fanout=2, rank=6, method="random", sketch=sketch,
              **SKETCH)
    jres = japi.svd(ja, japi.SolveConfig(backend="hierarchical", key=KEY,
                                         **kw))
    draws = reference_draws(KEY, "random", 8, 24, 128, 128)
    omega = reference_omega(KEY, 24, 24) if sketch else None
    tres = tapi.svd(ta, tapi.SolveConfig(backend="hierarchical", **kw),
                    device="cpu", draws=draws, omega=omega)
    _same(tres.u, tres.s, jres.u, jres.s)
    assert tres.plan.reasons == jres.plan.reasons
    assert (tres.plan.backend, tres.plan.strategy, tres.plan.sketch_leaves) \
        == (jres.plan.backend, jres.plan.strategy, jres.plan.sketch_leaves)
    td, jd = tres.diagnostics, jres.diagnostics
    assert (td.lonely_rows_per_block, td.lonely_rows, td.repaired_rows,
            td.estimated_peak_bytes) == (jd.lonely_rows_per_block,
                                         jd.lonely_rows, jd.repaired_rows,
                                         jd.estimated_peak_bytes)
    # the shim and the front door run one engine (the port's own draws)
    own = tapi.svd(ta, tapi.SolveConfig(backend="hierarchical", **kw),
                   device="cpu")
    shim_in = ta if kind != "coo" else tsparse.block_ell_from_coo(
        ta, 8, device="cpu")
    u0, s0 = _shim(shim_in, **kw)
    assert torch.equal(u0, own.u) and torch.equal(s0, own.s)


def test_r2_sketch_picks_the_tree_and_matches_the_reference():
    """``sketch=True`` under ``backend="auto"``: rule R2 sends the solve to
    the tree with sketch leaves (the reference's draws and Omega)."""
    jcoo = _coo()
    ja, ta = _inputs(jcoo, 8)["coo"]
    kw = dict(sketch=True, rank=4, num_blocks=8, method="neighbor_random",
              oversample=20, power_iters=3, want_right=True)
    jres = japi.svd(ja, japi.SolveConfig(key=KEY, **kw))
    jell = jsparse.block_ell_from_coo(jcoo, 8)
    draws = reference_draws(KEY, "neighbor_random", 8, 24, jell.width,
                            jell.capacity[0])
    tres = tapi.svd(ta, tapi.SolveConfig(**kw), device="cpu", draws=draws,
                    omega=reference_omega(KEY, 24, 24))
    assert (tres.plan.backend, tres.plan.sketch_leaves) == ("hierarchical",
                                                            True)
    assert tres.plan.reasons == jres.plan.reasons
    assert tres.u.shape == (24, 4) and tres.v.shape == (1024, 4)
    _same(tres.u, tres.s, jres.u, jres.s)
    top = _leading(np.asarray(jres.s))
    assert projector_gap(tres.v.numpy()[:, :top],
                         np.asarray(jres.v)[:, :top]) < 1e-3
    assert tres.diagnostics.repaired_rows == jres.diagnostics.repaired_rows


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("kind", ["dense", "coo"])
def test_exact_tree_with_the_kernels_plain_versions(kind, use_kernel):
    """The exact tree (r = M) of the neighbor_random repair, with and
    without ``use_kernel`` (on the CPU the kernels' plain versions), as
    ``chip_smoke.py``'s ``hierarchical`` phase runs it on the card."""
    jcoo = _coo(m=32, n=2000, density=0.006, seed=3)
    ja, ta = _inputs(jcoo, 8)[kind]
    kw = dict(num_blocks=8, fanout=4, method="neighbor_random",
              want_right=True)
    jres = japi.svd(ja, japi.SolveConfig(backend="hierarchical", key=KEY,
                                         **kw))
    jell = jsparse.block_ell_from_coo(jcoo, 8)
    cols = jell.capacity[0] if kind == "coo" else jell.width
    draws = reference_draws(KEY, "neighbor_random", 8, 32, jell.width, cols)
    tres = tapi.svd(ta, tapi.SolveConfig(backend="hierarchical",
                                         use_kernel=use_kernel, **kw),
                    device="cpu", draws=draws)
    assert tres.s.shape == (32,) and tres.v.shape == (2000, 32)
    _same(tres.u, tres.s, jres.u, jres.s)
    top = _leading(np.asarray(jres.s))
    assert projector_gap(tres.v.numpy()[:, :top],
                         np.asarray(jres.v)[:, :top]) < 1e-3
    assert tres.diagnostics.lonely_rows == jres.diagnostics.lonely_rows


def test_shard_map_backend_runs_beside_the_tree():
    """The tree and the sharded engine factor the same matrix: the
    shard_map backend on a local mesh of 8 slots against the tree."""
    from repro_torch.core.collectives import LocalMesh

    _, tcoo = _inputs(_coo(), 8)["coo"]
    tree = tapi.svd(tcoo, backend="hierarchical", num_blocks=8, device="cpu")
    sharded = tapi.svd(tcoo, backend="shard_map", mesh=LocalMesh(8, "cpu"))
    assert sharded.plan.backend == "shard_map"
    s = tree.s.numpy()
    np.testing.assert_allclose(sharded.s.numpy()[:s.shape[0]], s, rtol=0,
                               atol=1e-4 * s[0])


# ---------------------------------------------------------------------------
# want_right, the shim (tests/test_api.py twins)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("container", ["dense", "ell"])
def test_hierarchical_want_right_reconstructs(container):
    jcoo = _coo(seed=4)
    a = jsparse.pad_to_block_multiple(jcoo.todense(), 8)
    inp = (torch.from_numpy(a.copy()) if container == "dense"
           else tsparse.block_ell_from_coo(_port_coo(jcoo), 8, device="cpu"))
    u, s, v = _shim(inp, num_blocks=8, fanout=2, method="none",
                    want_right=True)
    recon = (u * s) @ v.T
    assert float((recon - torch.from_numpy(a)).abs().max()) < 5e-3
    ju, js, jv = jhier.solve_hierarchical(
        jnp.asarray(a), num_blocks=8, fanout=2, method="none",
        want_right=True)
    _same(u, s, ju, js)


def test_hierarchical_truncated_want_right_quasi_optimal():
    a = jsparse.pad_to_block_multiple(_lowrank(), 8)
    u, s, v = _shim(torch.from_numpy(a.copy()), num_blocks=8, fanout=2,
                    rank=6, method="none", want_right=True)
    recon = (u[:, :4] * s[:4]) @ v[:, :4].T
    assert float((recon - torch.from_numpy(a)).abs().max()) < 1e-2


def test_hierarchical_shim_warns_like_the_reference():
    a = torch.from_numpy(_lowrank())
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        thier.hierarchical_ranky_svd(a, num_blocks=8, fanout=2,
                                     method="none")
    with warnings.catch_warnings(record=True) as want:
        warnings.simplefilter("always")
        jhier.hierarchical_ranky_svd(jnp.asarray(_lowrank()), num_blocks=8,
                                     fanout=2, method="none")
    t_msg = [str(w.message) for w in got
             if issubclass(w.category, DeprecationWarning)]
    j_msg = [str(w.message) for w in want
             if issubclass(w.category, DeprecationWarning)]
    assert len(t_msg) == 1 and len(j_msg) == 1
    assert t_msg[0] == j_msg[0].replace("repro.core.api",
                                        "repro_torch.core.api")
    assert got[0].filename == __file__        # stacklevel: the caller


# ---------------------------------------------------------------------------
# Exactness (tests/test_ranky.py, test_randomized.py, test_sparse_path.py)
# ---------------------------------------------------------------------------

def test_hierarchical_matches_flat():
    jcoo = jsparse.ensure_full_row_rank(
        jsparse.random_bipartite(16, 1024, 0.01, seed=0), seed=0)
    a = jsparse.pad_to_block_multiple(jcoo.todense(), 16)
    s_true = np.linalg.svd(a, compute_uv=False)[:16]
    u, s = _shim(torch.from_numpy(a.copy()), num_blocks=16, fanout=4,
                 method="none")
    np.testing.assert_allclose(s.numpy(), s_true, rtol=1e-3, atol=1e-3)
    ju, js = jhier.solve_hierarchical(jnp.asarray(a), num_blocks=16,
                                      fanout=4, method="none")
    _same(u, s, ju, js)


def test_truncated_hierarchy_on_lowrank():
    """The incremental truncated merge is exact when rank(A) <= r."""
    lo = _lowrank()
    s_true = np.linalg.svd(lo, compute_uv=False)[:6]
    _, s = _shim(torch.from_numpy(lo), num_blocks=8, fanout=2, rank=6,
                 method="none")
    np.testing.assert_allclose(s.numpy()[:4], s_true[:4], rtol=1e-3)
    assert np.all(s.numpy()[4:] < 1e-3 * s_true[0])


@pytest.mark.parametrize("container", ["dense", "ell"])
def test_hierarchical_sketch_leaves_exact_on_lowrank(container):
    """Truncated sketch leaves keep the incremental merge exact when
    rank(A) <= r, for both block representations (the port's own Omega,
    then the reference's)."""
    lo = _lowrank()
    s_true = np.linalg.svd(lo, compute_uv=False)[:6]
    if container == "dense":
        a = torch.from_numpy(jsparse.pad_to_block_multiple(lo, 8).copy())
        ja = jnp.asarray(jsparse.pad_to_block_multiple(lo, 8))
    else:
        r_, c_ = np.nonzero(lo)
        jcoo = jsparse.COOMatrix(rows=r_.astype(np.int32),
                                 cols=c_.astype(np.int32),
                                 vals=lo[r_, c_].astype(np.float32),
                                 shape=lo.shape)
        ja = jsparse.block_ell_from_coo(jcoo, 8)
        a = port_ell(ja)
    kw = dict(num_blocks=8, fanout=2, rank=6, method="none", sketch=True,
              **SKETCH)
    _, s = _shim(a, **kw)
    np.testing.assert_allclose(s.numpy()[:4], s_true[:4], rtol=1e-3)
    assert np.all(s.numpy()[4:] < 1e-3 * s_true[0])
    u, s = thier.solve_hierarchical(a, omega=reference_omega(KEY, 16, 16),
                                    **kw)
    ju, js = jhier.solve_hierarchical(ja, key=KEY, **kw)
    np.testing.assert_allclose(s.numpy()[:4], np.asarray(js)[:4], rtol=1e-4)
    assert projector_gap(u.numpy()[:, :4], np.asarray(ju)[:, :4]) < 1e-3


def test_sparse_hierarchical_matches_flat():
    jcoo = jsparse.ensure_full_row_rank(
        jsparse.random_bipartite(16, 1024, 0.01, seed=5), seed=5)
    a = jsparse.pad_to_block_multiple(jcoo.todense(), 16)
    tell = tsparse.block_ell_from_coo(_port_coo(jcoo), 16, device="cpu")
    s_true = np.linalg.svd(a, compute_uv=False)[:16]
    _, s = _shim(tell, num_blocks=16, fanout=4, method="none")
    np.testing.assert_allclose(s.numpy(), s_true, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# The pieces: batched group merge, stacked sketch leaves
# ---------------------------------------------------------------------------

def test_group_merge_is_the_per_group_merge_batched():
    """One batched SVD over a level's groups gives each group's own merge
    (the reference's ``_merge_group``), U S by value where S separates."""
    rng = np.random.default_rng(1)
    panels = rng.standard_normal((3, 4, 10, 5)).astype(np.float32)
    got = thier._merge_group(torch.from_numpy(panels), 5)
    assert got.shape == (3, 10, 5)
    for i in range(3):
        want = np.asarray(jhier._merge_group(jnp.asarray(panels[i]), 5))
        assert projector_gap(got[i].numpy() / np.linalg.norm(
            got[i].numpy(), axis=0), want / np.linalg.norm(want, axis=0)) \
            < 1e-4
        np.testing.assert_allclose(np.linalg.norm(got[i].numpy(), axis=0),
                                   np.linalg.norm(want, axis=0), rtol=1e-5)


@pytest.mark.parametrize("shape", [(6, 20), (6, 6), (4, 9)])
def test_svd_through_transpose_is_the_economy_svd(shape):
    """The route of a wide panel to ``gesvd`` on the GPU: P = U S W^T from
    the SVD of P^T (here on the CPU's driver)."""
    p = torch.from_numpy(np.random.default_rng(2).standard_normal(shape)
                         .astype(np.float32))
    u, s, wt = thier.svd_through_transpose(p, None)
    k = min(shape)
    assert u.shape == (shape[0], k) and wt.shape == (k, shape[1])
    assert_close_rel((u * s) @ wt, p.numpy())
    np.testing.assert_allclose(s.numpy(), np.linalg.svd(
        p.numpy(), compute_uv=False), rtol=1e-5)
    assert float((u.T @ u - torch.eye(k)).abs().max()) < 1e-5


@pytest.mark.parametrize("kind", ["dense", "ell"])
def test_stacked_sketch_leaves_equal_the_per_block_form(kind):
    """``block_truncated_panels`` runs every block's range finder in one
    stack (a (D, L, M) Omega stack after the first pass); the per-block
    loop it replaced gives the same panels to float32 rounding."""
    jcoo = _coo(m=20, n=900, density=0.02, seed=7)
    ell = port_ell(jsparse.block_ell_from_coo(jcoo, 6))
    blocks = tranky.split_and_repair(ell, 6, "random", 3)
    if kind == "dense":
        blocks = blocks.todense_blocks()
    rank, over, q = 5, 4, 2
    omega = trand.draw_omega(9, rank + over, 20)
    got = trand.block_truncated_panels(blocks, rank=rank, oversample=over,
                                       power_iters=q, omega=omega)
    for d in range(6):
        if kind == "dense":
            blk = blocks[d]
            sk = lambda om: trand.sketch_block_dense(om, blk)        # noqa
            pb = lambda g: trand.pullback_block_dense(g, blk)       # noqa
        else:
            e = blocks.ell
            args = (e.col_ids[d], e.col_rows[d], e.col_vals[d],
                    blocks.repair_cols[d], blocks.repair_mask[d])
            sk = lambda om: trand.sketch_block_sparse(om, *args, e.width)  # noqa
            pb = lambda g: trand.pullback_block_sparse(g, *args, e.m)      # noqa
        g, t = trand._range_finder(sk, pb, omega, q)
        u, s, _ = trand.truncate_sketch(t, g @ g.T, rank)
        want = u * s[None, :]
        # column signs are the SVD's to choose
        sign = torch.sign((want * got[d]).sum(dim=0))
        assert_close_rel(got[d] * sign, want.numpy(), rel=1e-5)


def test_per_block_omega_in_the_sketch_panel_plain_version():
    """A (D, L, M) Omega stack: block d is sketched with Omega_d, as the
    one-Omega form gives for each block alone."""
    rng = np.random.default_rng(4)
    rows = torch.from_numpy(rng.integers(0, 30, (3, 12, 4)).astype(np.int32))
    vals = torch.from_numpy((rng.random((3, 12, 4)) < 0.6).astype(np.float32))
    om = torch.from_numpy(rng.standard_normal((3, 7, 30)).astype(np.float32))
    from repro_torch.kernels import sketch_panel as tsp
    got = tsp.sketch_panel_ref(om, rows, vals)
    for d in range(3):
        assert torch.equal(got[d], tsp.sketch_panel_ref(
            om[d], rows[d:d + 1], vals[d:d + 1])[0])
    with pytest.raises(ValueError, match="stack"):
        tsp.sketch_panel_ref(om[:2], rows, vals)


# ---------------------------------------------------------------------------
# The merge's own Householder QR (small tall panels)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4096, 16), (600, 80), (3, 500, 20),
                                   (100, 7)])
def test_householder_qr_factors_the_panel(shape):
    """Q R = P and Q^T Q = I to float32 rounding, R upper triangular, a
    zero column (a rank-deficient panel) included; R equals LAPACK's up to
    the signs of its rows."""
    rng = np.random.default_rng(0)
    p = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    p[..., 3] = 0.0
    a, tau = thier.householder_qr(p)
    n = shape[-1]
    r = a[..., :n, :].triu()
    q = thier.householder_apply(a, tau, torch.eye(n).expand(
        *shape[:-2], n, n))
    assert float((q @ r - p).abs().max()) <= 1e-5 * float(p.abs().max()) * n
    assert float((q.mT @ q - torch.eye(n)).abs().max()) <= 1e-5
    _, r_ref = torch.linalg.qr(p)
    np.testing.assert_allclose(r.abs().numpy(), r_ref.abs().numpy(),
                               rtol=1e-4, atol=1e-4)


def test_small_and_large_panels_merge_to_the_same_factors():
    """merge_svd's two tall paths (the Householder QR below
    ``SMALL_PANEL_BYTES``, LAPACK's QR above) agree to float32 rounding
    on the same panel."""
    rng = np.random.default_rng(1)
    p = torch.from_numpy(rng.standard_normal((2048, 40)).astype(np.float32))
    small = thier.merge_svd(p, 24)
    limit = thier.SMALL_PANEL_BYTES
    try:
        thier.SMALL_PANEL_BYTES = 0
        large = thier.merge_svd(p, 24)
    finally:
        thier.SMALL_PANEL_BYTES = limit
    np.testing.assert_allclose(small[1].numpy(), large[1].numpy(),
                               rtol=1e-5)
    assert projector_gap(small[0].numpy()[:, :8], large[0].numpy()[:, :8]) \
        < 1e-4
