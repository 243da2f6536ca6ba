"""Carry state from the reference over into the port's containers.

The counterpart of a weight converter; here the state is data.  Every
function takes numpy arrays (obtain them with ``np.asarray`` on whatever
holds the reference's arrays) and knows nothing of JAX.  Layouts and
dtypes are kept exactly: int32 indices, float32 values.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import ranky, sparse


def _tensor(x, dtype, device) -> torch.Tensor:
    # np.array copies: the tensor owns its memory, whatever held ``x``.
    return torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)


def coo_from_numpy(rows, cols, vals, shape) -> sparse.COOMatrix:
    """Host COO triples -> ``sparse.COOMatrix`` (stays on the host)."""
    return sparse.COOMatrix(rows=np.asarray(rows, np.int32),
                            cols=np.asarray(cols, np.int32),
                            vals=np.asarray(vals, np.float32),
                            shape=(int(shape[0]), int(shape[1])))


def block_ell_from_numpy(col_ids, col_rows, col_vals, *, m: int, width: int,
                         n: int, nnz: Optional[int] = None,
                         device=None) -> sparse.BlockEll:
    """The arrays of a reference ``BlockEll`` -> the port's container.
    Row and column indices of non-zero slots are checked against ``m`` and
    ``width`` here, on the host (``sparse.check_ell_arrays``)."""
    device = resolve_device(device)
    sparse.check_ell_arrays(np.asarray(col_ids), np.asarray(col_rows),
                            np.asarray(col_vals), m=int(m), width=int(width))
    return sparse.BlockEll(
        col_ids=_tensor(col_ids, torch.int32, device),
        col_rows=_tensor(col_rows, torch.int32, device),
        col_vals=_tensor(col_vals, torch.float32, device),
        m=int(m), width=int(width), n=int(n),
        nnz=None if nnz is None else int(nnz))


def repaired_from_numpy(ell: sparse.BlockEll, repair_cols,
                        repair_mask) -> sparse.RepairedSparseBlocks:
    """A repair side-band (D, M) -> ``RepairedSparseBlocks`` on the
    device of ``ell``."""
    return sparse.RepairedSparseBlocks(
        ell, _tensor(repair_cols, torch.int32, ell.device),
        _tensor(repair_mask, torch.bool, ell.device))


def draws_from_numpy(random_cols=None, neighbor_scores=None, *,
                     device=None) -> ranky.RepairDraws:
    """Repair draws computed elsewhere -> ``ranky.RepairDraws``:
    ``random_cols`` (D, M) integers, ``neighbor_scores`` (D, M, C | W)
    float32; either may be None when the method does not consume it."""
    device = resolve_device(device)
    return ranky.RepairDraws(
        random_cols=None if random_cols is None
        else _tensor(random_cols, torch.int32, device),
        neighbor_scores=None if neighbor_scores is None
        else _tensor(neighbor_scores, torch.float32, device))


def state_from_numpy(u, s, v, *, n: int, num_blocks: int, rows_seen: int,
                     batches_seen: int, lonely_rows_seen: int,
                     repaired_rows_seen: int, seed: ranky.Key = None,
                     device=None):
    """A reference ``StreamingSVDState`` (its ``u``, ``s``, ``v`` as numpy
    arrays and its counters) -> the port's ``StreamingSVDState`` on
    ``device``.  The reference's PRNG key has no counterpart: the port's
    state chains its draws from the integer ``seed`` instead, so a
    carried-over state re-draws only where the caller injects the draws."""
    from repro_torch.stream.state import StreamingSVDState

    device = resolve_device(device)
    u, s, v = (np.asarray(x, np.float32) for x in (u, s, v))
    if s.ndim != 1 or u.shape[1:] != s.shape or v.shape[1:] != s.shape:
        raise ValueError(
            f"state_from_numpy: u {u.shape}, s {s.shape}, v {v.shape} do "
            f"not share one rank")
    if u.shape[0] != rows_seen:
        raise ValueError(
            f"state_from_numpy: u has {u.shape[0]} rows, rows_seen="
            f"{rows_seen}")
    if v.shape[0] != num_blocks * sparse.block_width(n, num_blocks):
        raise ValueError(
            f"state_from_numpy: v has {v.shape[0]} rows, the universe "
            f"n={n}, num_blocks={num_blocks} pads to "
            f"{num_blocks * sparse.block_width(n, num_blocks)}")
    return StreamingSVDState(
        u=_tensor(u, torch.float32, device),
        s=_tensor(s, torch.float32, device),
        v=_tensor(v, torch.float32, device),
        seed=ranky.seed_of(seed), n=int(n), num_blocks=int(num_blocks),
        rows_seen=int(rows_seen), batches_seen=int(batches_seen),
        lonely_rows_seen=int(lonely_rows_seen),
        repaired_rows_seen=int(repaired_rows_seen))
