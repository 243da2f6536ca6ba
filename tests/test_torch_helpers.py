"""Shared helpers of the ``tests/test_torch_*.py`` parity tests: hand data
and random draws from the JAX reference over to the port as numpy arrays,
and compare factors up to what ``eigh`` / ``svd`` leave free (sign, basis of
a degenerate subspace).  The few tests here hold the helpers themselves."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
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


def reference_draws(key, method, num_blocks, m, width, score_cols, *,
                    keys=None):
    """The draws the reference's ``split_and_repair`` makes from ``key``, in
    the port's ``RepairDraws`` layout: the per-block key split, the
    ``k_nb, k_rand`` split of neighbor_random, ``ranky._random_cols`` and
    ``jax.random.uniform`` over the (M, score_cols) candidate mask.
    ``keys`` gives the per-block keys instead (the reference's one-shot
    ``shard_map`` engine folds the device index into ``key``)."""
    if keys is None:
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


def shard_map_draws(key, method, num_blocks, m, width, score_cols):
    """The draws of the reference's one-shot ``shard_map`` engine: block d
    repairs with ``fold_in(key, d)`` (``distributed._local_repair``)."""
    keys = [jax.random.fold_in(key, d) for d in range(num_blocks)]
    return reference_draws(None, method, num_blocks, m, width, score_cols,
                           keys=keys)


GLOO_PRELUDE = """
import datetime, os, sys, pickle, traceback
import torch, torch.distributed as dist
rank, world, init, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=45))
"""

GLOO_EPILOGUE = """
try:
    result = main(rank, world)
    err = None
except BaseException:
    result, err = None, traceback.format_exc()
with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump({"result": result, "error": err}, f)
dist.destroy_process_group()
"""


def spawn_gloo(body: str, world: int, tmp_path, *, timeout: float = 60.0,
               while_waiting=None):
    """Run ``body`` (which defines ``main(rank, world)``; ``torch`` and
    ``dist`` are imported, the gloo group of ``world`` ranks initialized
    through a ``file://`` store in ``tmp_path``) in ``world`` processes on
    the CPU.  Returns each rank's ``main`` result, in rank order (with
    ``while_waiting``, a function called here while the ranks run: (the
    results, its result)).  A rank that raises, or a group that has not
    finished within ``timeout`` seconds (every rank is then killed), fails
    the calling test."""
    import os
    import pickle
    import subprocess
    import sys
    import textwrap
    import time

    import pytest

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = GLOO_PRELUDE + textwrap.dedent(body) + GLOO_EPILOGUE
    init = str(tmp_path / "gloo_init")
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world), init,
         str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    logs, extra = [], None
    try:
        if while_waiting is not None:
            extra = while_waiting()
        for p in procs:
            left = max(0.1, deadline - time.monotonic())
            try:
                logs.append(p.communicate(timeout=left))
            except subprocess.TimeoutExpired:
                pytest.fail(f"gloo group of {world} ranks did not finish "
                            f"within {timeout}s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, p in enumerate(procs):
        path = tmp_path / f"rank{r}.pkl"
        if not path.exists():
            pytest.fail(f"rank {r} exited {p.returncode} without a result:"
                        f"\n{logs[r][1][-3000:]}")
        with open(path, "rb") as f:
            got = pickle.load(f)
        if got["error"] is not None:
            pytest.fail(f"rank {r} raised:\n{got['error']}")
        results.append(got["result"])
    return results if while_waiting is None else (results, extra)


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


# ---------------------------------------------------------------------------
# The LM slices
# ---------------------------------------------------------------------------

def lm_smoke_models(arch: str, **overrides):
    """(reference config, port config, reference params, port params) of
    ``arch``'s smoke config in float32 (plus ``overrides``), the reference's
    ``init_params`` carried over with ``convert.params_from_numpy``."""
    import dataclasses

    from repro.configs import base as jbase
    from repro.models import schema as jschema
    from repro_torch.configs import base as tbase
    from repro_torch.models import convert as lm_convert

    jcfg = dataclasses.replace(jbase.get_smoke_config(arch), dtype="float32",
                               **overrides)
    tcfg = dataclasses.replace(tbase.get_smoke_config(arch), dtype="float32",
                               **overrides)
    jp = jschema.init_params(jcfg, jax.random.PRNGKey(0))
    tp = lm_convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                      device="cpu")
    return jcfg, tcfg, jp, tp


def lm_np(x) -> np.ndarray:
    """A port tensor or a reference array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def lm_cache_to_port(cache) -> dict:
    """A reference decode cache as the port's (``len`` a Python int)."""
    return {k: (int(v) if k == "len" else torch.from_numpy(np.array(v)))
            for k, v in cache.items()}


def mrope_positions(b: int, s: int, grid: int = 4, start: int = 2
                    ) -> np.ndarray:
    """(B, S, 3) int32 M-RoPE ids: text up to ``start``, a ``grid`` x
    ``grid`` patch block (temporal fixed, height = row, width = column),
    then text with the three streams equal, each row shifted by its
    index so that rows differ."""
    pos = np.zeros((b, s, 3), np.int32)
    for r in range(b):
        t = 0
        for i in range(s):
            j = i - start
            if 0 <= j < grid * grid:
                pos[r, i] = (start + r, start + r + j // grid,
                             start + r + j % grid)
                t = start + r + grid
            else:
                pos[r, i] = t
                t += 1
    return pos


@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a module's torch work on one CPU thread, then restore the count.
    The suite runs in parallel workers; a torch op split over every core
    then waits in OpenMP barriers for threads the other workers keep off
    the cores, which makes loops of small ops (a train loop, a stream)
    tens of times slower than alone."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
