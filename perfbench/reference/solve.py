"""The plain reference of a one-shot solve (traffic kind ``solve``).

From the matrix's triples and the repair's and the sketch's random
inputs it works out again the repair, the gram or the sketch, and the
factors; then it judges an answer (U, S, V) in float64:

* exact (``rank`` None): ``triplet_gap``, the worst of
  max_i s_i ||A v_i - s_i u_i|| / s_0^2 (U and S against the repaired
  matrix: with V = A^T U / S this is ||A A^T u_i - s_i^2 u_i|| / s_0^2, the
  eigenpair's backward error), max_i ||A^T u_i - s_i v_i|| / s_i (V) and
  max |U^T U - I|.  A full-rank U makes U S V^T = A for any orthonormal U,
  so the residuals are compared, not a reconstruction.  One number: the
  control (TF32) rounds U where V is formed, which only the second term
  sees, and a float32 eigh moves the first and third as far in the
  program as in the control.
* randomized: ``s_gap`` and ``usv_gap`` against the same sketch (the same
  Omega, the same power passes) replayed in float64.

:func:`solve` with ``matrix.CONTROL`` is the control: this reference in
the program's place, every product's inputs rounded to TF32.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from perfbench.reference import matrix
from perfbench.reference.matrix import REFERENCE, Precision

# V's rows of a direction with s_i <= RCOND * s_0 are zero (no right
# vector exists for a direction of nought weight).
RCOND = 1e-7


def repaired(case: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    rows, cols, _ = matrix.repair(
        case["rows"], case["cols"], m=case["m"], n=case["n"],
        num_blocks=case["num_blocks"], random_cols=case["random_cols"],
        scores=case["scores"])
    return rows, cols


def exact(rows, cols, m: int, n: int, num_blocks: int, prec: Precision
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(U (m, m), S (m,), V (n, m)) of the repaired matrix: eigh of the
    gram, V = A^T U / S block by block."""
    s2, u = matrix.eigh_desc(matrix.gram(rows, cols, m, prec.dtype))
    s = torch.sqrt(torch.clamp(s2, min=0.0))
    inv = torch.where(s > RCOND * s[0], 1.0 / torch.where(s > 0, s, 1.0),
                      torch.zeros_like(s))
    w = matrix.block_width(n, num_blocks)
    v = torch.empty((n, m), dtype=prec.dtype, device=u.device)
    for d in range(num_blocks):
        lo, hi = d * w, min((d + 1) * w, n)
        v[lo:hi] = matrix.at_times(rows, cols, u, lo, hi, prec) * inv[None, :]
    return u, s, v


def randomized(rows, cols, m: int, n: int, omega: torch.Tensor, rank: int,
               power_iters: int, prec: Precision
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-``rank`` (U, S, V) from the (L, m) test matrix ``omega``:
    G = Omega A, ``power_iters`` passes of T = G A^T, Q = qr(T^T),
    G = Q^T A; then T = G A^T, H = G G^T whitened by its eigh (directions
    under eps * max * L dropped), B = T^T W, svd(B); V = G^T W W_B."""
    def pull(g_t):                      # (n, L) G^T -> (m, L) T^T = A G^T
        return matrix.a_times(rows, cols, g_t, m, prec)

    def push(q):                        # (m, L) -> (n, L) A^T q
        return matrix.at_times(rows, cols, q, 0, n, prec)

    g_t = push(omega.T)
    for _ in range(power_iters):
        q, _ = torch.linalg.qr(pull(g_t))
        g_t = push(q)
    t_t = pull(g_t)
    h = prec.mm(g_t.T, g_t)
    evals, evecs = torch.linalg.eigh(h)
    floor = torch.finfo(prec.dtype).eps * evals.max() * h.shape[0]
    good = evals > floor
    w = evecs * torch.where(good, 1.0 / torch.sqrt(torch.where(
        good, evals, torch.ones_like(evals))), torch.zeros_like(evals))
    u_b, s, w_bt = torch.linalg.svd(prec.mm(t_t, w), full_matrices=False)
    vproj = prec.mm(w, w_bt.T[:, :rank])
    return u_b[:, :rank], s[:rank], prec.mm(g_t, vproj)


def solve(case: dict, prec: Precision):
    """The reference's (U, S, V) of a case, at precision ``prec``."""
    rows, cols = repaired(case)
    if case["rank"] is None:
        return exact(rows, cols, case["m"], case["n"], case["num_blocks"],
                     prec)
    return randomized(rows, cols, case["m"], case["n"], case["omega"],
                      case["rank"], case["power_iters"], prec)


def triplet_gap(rows, cols, m: int, n: int, num_blocks: int, u, s, v
                ) -> float:
    u, s = u.double(), s.double()
    s0 = float(s[0])
    if u.shape != (m, m) or s.shape != (m,) or v is None \
            or v.shape != (n, m) or not s0 > 0:
        return float("inf")
    av = torch.zeros((m, m), dtype=torch.float64, device=u.device)
    right2 = torch.zeros(m, dtype=torch.float64, device=u.device)
    w = matrix.block_width(n, num_blocks)
    for d in range(num_blocks):
        lo, hi = d * w, min((d + 1) * w, n)
        v_d = v[lo:hi].double()
        sub = (cols >= lo) & (cols < hi)
        av += matrix.a_times(rows[sub], cols[sub] - lo, v_d, m, REFERENCE)
        r_d = matrix.at_times(rows, cols, u, lo, hi, REFERENCE)
        right2 += ((r_d - v_d * s[None, :]) ** 2).sum(0)
        del v_d, r_d
    left = (torch.linalg.vector_norm(av - u * s[None, :], dim=0) * s
            / s0 ** 2)
    kept = s > RCOND * s0
    right = torch.where(kept, right2.sqrt() / torch.where(kept, s, 1.0),
                        torch.linalg.vector_norm(v.double(), dim=0))
    orth = (u.T @ u - torch.eye(m, dtype=torch.float64,
                                device=u.device)).abs().max()
    return float(torch.stack([left.max(), right.max(), orth]).max())


def judge(case: dict, answer, ref: Optional[tuple] = None
          ) -> Dict[str, float]:
    """The numbers compared for one solve's answer (U, S, V); ``ref`` is
    the float64 replay of a randomized case when already worked out."""
    u, s, v = answer
    if case["rank"] is None:
        rows, cols = repaired(case)
        return {"triplet_gap": triplet_gap(
            rows, cols, case["m"], case["n"], case["num_blocks"], u, s, v)}
    u_r, s_r, v_r = solve(case, REFERENCE) if ref is None else ref
    if v is None or u.shape != u_r.shape or v.shape != v_r.shape:
        return {"s_gap": float("inf"), "usv_gap": float("inf")}
    return {"s_gap": matrix.s_gap(s, s_r),
            "usv_gap": matrix.lowrank_gap(u, s, v, u_r, s_r, v_r)}
