"""The port's three kernel modules against the JAX package, on the CPU.

For each of sparse_gram, blockgram and sketch_panel the same inputs (made
with ``np.random.default_rng(seed)``) go through the port's plain PyTorch
version and through the JAX function, twice: the pure-jnp oracle
(``repro.kernels.ref``) and the Pallas kernel body in interpret mode.  The
CUDA kernels themselves run only on a GPU; ``chip_smoke.py`` holds them
against these same plain versions there.

Tolerance: 1e-5 relative to max|out| everywhere (float32, the order of the
sums differs between the implementations), looser only for bf16 input,
where the two frameworks are compared after both widen to float32 (exact
products, f32 summation order).
"""
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import blockgram as jbg
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import sketch_panel as jsp
from repro.kernels import sparse_gram as jsg

import repro_torch
from repro_torch.core import sparse as tsparse
from repro_torch.kernels import blockgram as tbg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sketch_panel as tsp
from repro_torch.kernels import sparse_gram as tsg

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


def test_cuda_request_without_cuda_raises_instead_of_plain_version():
    """No hidden fallback: asking for the GPU where there is none raises, and
    a tensor that lies neither on the CPU nor on a CUDA device never reaches
    the plain version through a wrapper."""
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


def test_launch_counters_do_not_move_on_the_cpu():
    """A wrapper counts where it launches its kernel and nowhere else."""
    before = (tsg.launches, tbg.launches, tsp.launches)
    rows, vals = _random_ell(8, 16, 2)
    tops.sparse_gram(torch.from_numpy(rows), torch.from_numpy(vals), 8)
    tops.blockgram(torch.ones((1, 4, 8)))
    tops.sketch_panel(torch.ones((2, 8)), torch.from_numpy(rows),
                      torch.from_numpy(vals))
    assert (tsg.launches, tbg.launches, tsp.launches) == before


def test_importing_the_port_pulls_in_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.core.api\n"
        "import repro_torch.core.convert, repro_torch.data.bipartite\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.build\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": f"{REPO}/src", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "clean"
