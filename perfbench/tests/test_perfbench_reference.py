"""The plain reference against NumPy and a repair worked by hand, and the
control (the reference in TF32 in the program's place) judged not
correct at a small size."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import bipartite, spec
from perfbench.reference import matrix, solve
from perfbench.reference.matrix import REFERENCE
from perfbench.tests import helpers


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _draws(m, n, d, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return dict(random_cols=torch.randint(0, n // d, (d, m), generator=gen,
                                          dtype=torch.int32),
                scores=torch.rand((d, m, n // d), generator=gen))


def _matrix(m, n, density, seed, d):
    """A random matrix, repaired (with draws from ``seed``), as triples
    and dense."""
    rows, cols = bipartite.random_bipartite(
        m, n, density, bipartite.generator("cpu", seed), "cpu")
    draws = _draws(m, n, d, seed)
    rows, cols, _ = matrix.repair(rows, cols, m=m, n=n, num_blocks=d,
                                  **draws)
    a = np.zeros((m, n))
    a[rows.numpy(), cols.numpy()] = 1.0
    return rows, cols, a, draws


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_exact_reference_agrees_with_numpy_svd(seed):
    m, n, d = 12, 48, 4
    rows, cols, a, draws = _matrix(m, n, 0.3, seed, d)
    u, s, v = solve.exact(rows, cols, m, n, d, REFERENCE)
    want = np.linalg.svd(a, compute_uv=False)
    np.testing.assert_allclose(s.numpy(), want, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(u.numpy() @ np.diag(s.numpy()) @ v.numpy().T,
                               a, atol=1e-10)
    np.testing.assert_allclose(u.numpy().T @ u.numpy(), np.eye(m),
                               atol=1e-10)
    case = dict(rows=rows, cols=cols, m=m, n=n, num_blocks=d, rank=None,
                **draws)
    assert solve.judge(case, (u, s, v))["triplet_gap"] < 1e-12
    s_bad = s.clone()
    s_bad[0] *= 1.01
    assert solve.judge(case, (u, s_bad, v))["triplet_gap"] > 1e-3


def test_randomized_reference_is_exact_when_the_sketch_spans_all_rows():
    m, n, d = 12, 48, 4
    rows, cols, a, _ = _matrix(m, n, 0.3, 4, d)
    omega = torch.randn((m, m), generator=torch.Generator().manual_seed(5),
                        dtype=torch.float64)
    u, s, v = solve.randomized(rows, cols, m, n, omega, 4, 2, REFERENCE)
    want = np.linalg.svd(a, compute_uv=False)[:4]
    np.testing.assert_allclose(s.numpy(), want, rtol=1e-9)
    uu, ss, vv = np.linalg.svd(a)
    ref = (torch.from_numpy(uu[:, :4]), torch.from_numpy(ss[:4]),
           torch.from_numpy(vv[:4].T))
    # (the gap is a difference of squares: its floor is ~sqrt(eps) = 1e-8)
    assert matrix.lowrank_gap(u, s, v, *ref) < 1e-7


def test_repair_worked_by_hand():
    """6 x 12 in two blocks of 6.  Row 1 is lonely in block 1; its
    neighbours (rows 0 and 2, through columns 0 and 1) hold columns 7 and
    8 there, stored at places 0 and 1 of the block (7, 8, 9): the higher
    score, 0.9 at place 1, picks column 8.  Row 3 is lonely in block 0:
    its one neighbour, row 4 (column 9), holds column 3 there.  Row 5 is
    lonely in block 1 with no neighbour: its random column 4, i.e. 10."""
    entries = [(0, 0), (0, 7), (1, 0), (1, 1), (2, 1), (2, 8), (3, 9),
               (4, 3), (4, 9), (5, 5)]
    key = sorted(c * 6 + r for r, c in entries)
    rows = torch.tensor([k % 6 for k in key])
    cols = torch.tensor([k // 6 for k in key])
    random_cols = torch.full((2, 6), 2, dtype=torch.int32)
    random_cols[1, 5] = 4
    scores = torch.zeros((2, 6, 4))
    scores[1, 1, :3] = torch.tensor([0.2, 0.9, 0.5])
    out_r, out_c, added = matrix.repair(rows, cols, m=6, n=12, num_blocks=2,
                                        random_cols=random_cols,
                                        scores=scores)
    assert added == 3
    got = set(zip(out_r.tolist(), out_c.tolist())) - set(entries)
    assert got == {(1, 8), (3, 3), (5, 10)}

    # The program's repair of the same matrix and draws agrees.
    from repro_torch.core import ranky

    ell = bipartite.block_ell(rows, cols, 6, 12, 2, c_cap=4)
    rep = ranky.split_and_repair(ell, 2, "neighbor_random", draws=ranky.
                                 RepairDraws(random_cols=random_cols,
                                             neighbor_scores=scores))
    prog = {(r, d * 6 + int(rep.repair_cols[d, r]))
            for d in range(2) for r in range(6) if rep.repair_mask[d, r]}
    assert prog == got


def test_gram_counts_shared_columns():
    rows, cols, a, _ = _matrix(10, 40, 0.3, 6, 4)
    g = matrix.gram(rows, cols, 10, torch.float64)
    np.testing.assert_array_equal(g.numpy(), a @ a.T)


def test_lowrank_gap_sees_every_direction():
    """A direction past the first turned over in V, or two later
    directions' vectors swapped, is seen although S is right; signs an
    SVD may choose (u and v turned over together) are not."""
    _, _, a, _ = _matrix(12, 48, 0.3, 9, 4)
    uu, ss, vt = np.linalg.svd(a, full_matrices=False)
    u, s, v = (torch.from_numpy(x) for x in (uu[:, :6], ss[:6], vt[:6].T))
    assert matrix.lowrank_gap(u, s, v, u, s, v) < 1e-7
    both = torch.ones(6, dtype=torch.float64)
    both[3] = -1.0
    assert matrix.lowrank_gap(u * both, s, v * both, u, s, v) < 1e-7
    assert matrix.lowrank_gap(u, s, v * both, u, s, v) > 1e-2
    swap = [0, 1, 2, 3, 5, 4]
    assert matrix.lowrank_gap(u[:, swap], s, v[:, swap], u, s, v) > 1e-2


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 3.0])
    assert matrix.tf32_round(x).tolist() == [1.0, 1.0, 1.0 + 2 ** -9, 3.0]


@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.benchmark()["workloads"]])
def test_the_control_is_not_correct(name):
    """The reference in TF32 in the program's place, at a small size, is
    judged as a run judges the program, and fails a limit; the program
    in the same window passes."""
    from perfbench import common

    cell = helpers.tiny(name)
    traffic = spec.traffic(cell["workload"])
    ctx = common.Context(name=name, seed=helpers.SEED, seconds=0.3,
                         trace=False, device=torch.device("cpu"),
                         config=cell["config"], workload=cell["workload"])
    st = traffic.setup(ctx)
    win = traffic.window(ctx, st)
    traffic.free_program(st)
    limits = cell["workload"]["limits"]
    program = traffic.check(ctx, st, win)
    control = traffic.control(ctx, st, win)
    assert all(program[k] <= lim for k, lim in limits.items()), program
    assert any(control[k] > lim for k, lim in limits.items()), control
