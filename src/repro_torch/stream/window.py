"""Scan-window streaming: a window of same-bucket ingests, the state kept
on the device throughout.

``stream/ingest.py`` folds one batch per call and reads its side-band
counters back to the host every time.  The Iwen-Ong merge that
:func:`hierarchy.merge_svd` implements is fixed-shape per step once the
state sits at ``truncate_rank``, so a whole window of ingests can run as
one sequence of steps with nothing read back until it ends:

* **Bucketing prologue**: variable-size deltas are padded to a small set
  of canonical shapes (rows to the next power of two >= 8; an ELL delta's
  stored-column capacity ``(C, K)`` likewise), so a stream of ragged
  batches reuses a handful of step shapes.  :func:`bucket_signature`
  names the bucket, :func:`build_window` stacks a group of same-bucket
  deltas on the host and copies each stacked array to the device once.

  Padded rows are **masked, not merely small**: a zero-padded row looks
  lonely, so the Ranky checkers would repair it.  The step therefore
  repairs first and then *zeroes the invalid rows back out* (dense) or
  ANDs the repair mask with the row-validity mask (ELL) before any gram
  or panel touches the block.  A padded row thus contributes *exactly* 0
  to every gram, adjacency and right panel, and the padded rows of each
  step's ``u_b`` panel are sliced off (host-side ``true_m``) before they
  reach ``u``.  Padding slots in the ELL arrays are all-zero values,
  inert by the container's own convention.

* **The step**: the ingest math (repair -> factor -> panel merge), with
  the wrinkle that ``u`` grows with ``rows_seen`` and cannot be part of a
  fixed-shape carry.  The carry holds ``(s, v, lonely and repaired
  accumulators)`` on the device for the whole window; each step's small
  rotation ``uk`` and ``u_b`` panel are kept and folded into ``u`` once,
  after the window.  Batch ``b`` draws ``ranky.derive_seed(seed,
  batches_seen + b)``, the chain the per-batch ``ingest`` uses, so a
  resumed stream re-draws the same columns mid-window.

* **What stands in for the reference's ``lax.scan``**: the port cannot
  capture a window as one dispatch while ``torch.linalg.eigh`` / ``svd``
  check cuSOLVER's ``info`` on the host, so a window is the same step run
  T times, with no host read of its own inside the window.  The side-band
  counters are read to the host once per window.

* **Loop mode is the same function**: a "per-batch loop" is nothing but
  length-1 windows through the *same* step, so scan-vs-loop comparisons
  (and planner rule R6's honest degrade) share one code path.  Every sum
  in the step runs in an order its inputs fix (no float atomics: the
  kernels are bit-stable and the scatters segmented, ``sparse.
  segment_sum``), so the two give the same bits on the GPU too.

* **Tail-adaptive merge width**: :func:`adaptive_oversample` picks the
  exact path's merge width ``l_b = k + p_eff`` from the observed spectral
  tail of the running state (Li et al., arXiv:1612.08709) instead of the
  static ``k + oversample``; widths are quantized so a drift in the tail
  re-buckets rarely.

The sharded window (``shard_map``, rule R6's per-device form) belongs to
the distributed slice and raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import hierarchy, randomized, ranky, sparse
from repro_torch.core import svd as lsvd
from repro_torch.core.stages import stage
from repro_torch.stream import state as stream_state
from repro_torch.stream.ingest import IngestInfo, _fire_seam
from repro_torch.stream.state import StreamingSVDState

# Smallest row bucket: padding everything below 8 rows to one shape costs
# a few masked rows and saves a step shape per tiny-batch size.
MIN_BUCKET_ROWS = 8

# Dispatch bookkeeping (the reference's names and meanings): one "window"
# is one ``ingest_window`` call, however many batches rode inside it; the
# per-batch loop would count windows == batches.
_DISPATCH = {"windows": 0, "batches": 0}

# The step shapes built so far (the kind and padded rows of a bucket with
# the statics of the step: width, merge width, ranks, method, ...) and the
# (step shape, ELL capacity, window length T) triples run so far: the
# port's counterparts of the reference's jitted scan callables and of the
# traces in their jit caches (whose avals carry the capacity and T).
_BUILT: set = set()
_TRACES: set = set()


def dispatch_counts() -> dict:
    """{"windows": ingest_window calls, "batches": batches ingested}."""
    return dict(_DISPATCH)


def reset_dispatch_counts() -> None:
    for k in _DISPATCH:
        _DISPATCH[k] = 0


def trace_count() -> int:
    """Distinct (step shape, ELL capacity, window length T) triples run so
    far: the counterpart of the reference's jit traces (each distinct T or
    capacity of one step shape adds one)."""
    return len(_TRACES)


def bucket_count() -> int:
    """Number of distinct step shapes (bucket kind and rows, and the step's
    statics) that have run."""
    return len(_BUILT)


def clear_caches() -> None:
    """Forget every step shape and window length (fresh counts)."""
    _BUILT.clear()
    _TRACES.clear()
    reset_dispatch_counts()


# ---------------------------------------------------------------------------
# Bucketing prologue
# ---------------------------------------------------------------------------

def _pow2_at_least(x: int) -> int:
    """Smallest power of two >= x (x >= 1)."""
    return 1 << max(0, int(x) - 1).bit_length()


def bucket_rows(m_b: int) -> int:
    """Canonical padded row count of a batch: next power of two >= 8."""
    return max(MIN_BUCKET_ROWS, _pow2_at_least(m_b))


def bucket_signature(a_norm) -> Tuple:
    """Canonical bucket shape of a NORMALIZED delta (the output of
    ``stream.state.as_delta``): every delta with the same signature runs
    through the same step shape.

    * dense (m_b, n_pad) tensor -> ``("dense", m_pad)``
    * BlockEll                  -> ``("ell", m_pad, C_pad, K_pad)``

    Rows pad to the next power of two >= 8; an ELL delta's stored-column
    capacity ``(C, K)`` pads the same way (all-zero padding slots are
    inert by the container's convention), so COO batches whose nnz
    drifts a little still land in one bucket.
    """
    if isinstance(a_norm, sparse.BlockEll):
        c, k = a_norm.capacity
        return ("ell", bucket_rows(a_norm.m),
                _pow2_at_least(max(8, c)), _pow2_at_least(max(1, k)))
    return ("dense", bucket_rows(int(a_norm.shape[0])))


def bucket_nnz_slots(sig: Tuple, num_blocks: int) -> Optional[int]:
    """Stored slots of one bucketed ELL batch (None for dense buckets):
    the ``nnz_slots`` the R6 closed form prices a window's inputs with."""
    if sig[0] != "ell":
        return None
    return num_blocks * sig[2] * sig[3]


def _pad_dense(a_norm: torch.Tensor, out: torch.Tensor) -> None:
    """Write one dense delta into its (m_pad, n_pad) slot of the stack,
    whose padding is already zero."""
    out[:a_norm.shape[0], :a_norm.shape[1]] = a_norm


def _pad_ell(e: sparse.BlockEll, ids: torch.Tensor, rows: torch.Tensor,
             vals: torch.Tensor) -> None:
    """Write one ELL delta into its (D, C_pad[, K_pad]) slots of the
    stack, whose padding slots are already zero (inert)."""
    c, k = e.capacity
    ids[:, :c] = e.col_ids
    rows[:, :c, :k] = e.col_rows
    vals[:, :c, :k] = e.col_vals


def build_window(norm_deltas: Sequence, sig: Tuple, *, device) -> Tuple:
    """Stack a group of same-bucket deltas, normalized on the host, into
    the window's inputs on ``device``: each delta written once into a
    zeroed host stack (pinned when the device is a GPU, so the copy runs at
    the bus's rate), then ONE copy per stacked array.  Dense: ``(a (T,
    m_pad, n_pad),)``; ell: ``(ids (T, D, C), rows (T, D, C, K), vals (T,
    D, C, K))``."""
    t = len(norm_deltas)
    pin = torch.device(device).type == "cuda"

    def stack(shape, dtype):
        return torch.zeros((t,) + shape, dtype=dtype, pin_memory=pin)

    if sig[0] == "dense":
        a = stack((sig[1], norm_deltas[0].shape[1]), torch.float32)
        for i, x in enumerate(norm_deltas):
            _pad_dense(x, a[i])
        return (a.to(device),)
    _, _, c_pad, k_pad = sig
    d = norm_deltas[0].num_blocks
    ids = stack((d, c_pad), torch.int32)
    rows = stack((d, c_pad, k_pad), torch.int32)
    vals = stack((d, c_pad, k_pad), torch.float32)
    for i, e in enumerate(norm_deltas):
        _pad_ell(e, ids[i], rows[i], vals[i])
    return tuple(x.to(device) for x in (ids, rows, vals))


# ---------------------------------------------------------------------------
# Tail-adaptive merge width (the l_b of planner rule R6)
# ---------------------------------------------------------------------------

def adaptive_oversample(s, rank: int, base: int) -> int:
    """Oversample p_eff for the exact merge width l_b = k + p_eff, from
    the observed spectral tail of the running state.

    ``tail = s[k-1] / s[0]`` measures how much weight the truncation
    boundary still carries: a fast-decaying spectrum (tail ~ 0) loses
    almost nothing to a narrow merge, a flat one (tail ~ 1) needs the
    full width to keep the discarded directions' energy (Li et al.,
    arXiv:1612.08709).  The tail interpolates p_eff over
    ``[max(4, base // 2), 2 * base]``, quantized to multiples of 4 so a
    slowly drifting tail re-buckets rarely.  Falls back to ``base`` while
    the state has no full-rank spectrum yet.
    """
    if isinstance(s, torch.Tensor):
        s = s.detach().cpu().numpy()
    s = np.asarray(s, np.float64)
    if rank < 1 or s.size < rank or float(s[0]) <= 0.0:
        return base
    tail = float(np.clip(s[rank - 1] / s[0], 0.0, 1.0))
    lo, hi = max(4, base // 2), 2 * base
    p_eff = lo + tail * (hi - lo)
    return int(np.clip(int(round(p_eff / 4.0)) * 4, lo, hi))


# ---------------------------------------------------------------------------
# The step (single host): the ingest math with masked padding
# ---------------------------------------------------------------------------

def _factor(kind: str, d: int, m_pad: int, width: int, n_univ: int,
            r_b: int, sk_rank: Optional[int], config, seed_b: int,
            true_m: int, x: Tuple, draws: Optional[ranky.RepairDraws],
            omega: Optional[torch.Tensor]):
    """Repair, mask and factor one padded batch: ``(U_b, P_b = B^T U_b,
    lonely rows per block (D,), repaired rows)``, the counts as device
    tensors.  The repaired blocks are this function's own, freed before
    the merge."""
    dev = x[0].device
    valid = torch.arange(m_pad, device=dev) < true_m        # (m_pad,) rows
    with stage("split_and_repair"):
        if kind == "dense":
            a = x[0]                                         # (m_pad, n_pad)
            blocks0 = a.reshape(m_pad, d, width).permute(1, 0, 2)
            lonely = ~(blocks0 != 0).any(dim=2) & valid[None, :]
            blocks = ranky.split_and_repair(a, d, config.method, seed_b,
                                            draws=draws)
            # Mask, don't trust smallness: the checkers fill every lonely
            # row, padded ones included; zero the invalid rows back out so
            # they are EXACTLY absent from the grams and panels below (in
            # place: the repaired stack is the step's own copy).
            blocks.masked_fill_(~valid[None, :, None], 0.0)
            still = ~(blocks != 0).any(dim=2) & valid[None, :]
            repaired = lonely.sum() - still.sum()
        else:
            ids, rows, vals = x                              # (D, C[, K])
            lonely = (ranky.sparse_lonely_rows(rows, vals, m_pad)
                      & valid[None, :])
            ell = sparse.BlockEll(ids, rows, vals, m=m_pad, width=width,
                                  n=n_univ)
            rep = ranky.split_and_repair(ell, d, config.method, seed_b,
                                         draws=draws)
            rm = rep.repair_mask & valid[None, :]            # padded rows inert
            blocks = sparse.RepairedSparseBlocks(ell, rep.repair_cols, rm)
            repaired = rm.sum()

    if sk_rank is None:
        with stage("gram_stack"):
            grams = lsvd.gram_stack(blocks, use_kernel=config.use_kernel)
        with stage("merge_grams_eigh"):
            u_b, _ = lsvd.merge_grams_eigh(grams)
        u_b = u_b[:, :r_b]
        with stage("right_vectors_stack"):
            panel_b = ranky.right_vectors_stack(
                blocks, u_b, torch.ones((r_b,), dtype=torch.float32,
                                        device=dev))
    else:
        u_b, s_b, v_b = randomized.randomized_svd_blocks(
            blocks, rank=sk_rank, oversample=config.oversample,
            power_iters=config.power_iters, key=seed_b, want_right=True,
            omega=omega)
        panel_b = v_b * s_b[None, :]
    return u_b, panel_b, lonely.sum(dim=1), repaired


def _step(factor_args: Tuple, k_state: int, decay: float, s: torch.Tensor,
          v: torch.Tensor):
    """One batch folded into ``(s, v)``: :func:`_factor`, then the merge
    of ``[V diag(decay s) | P_b]``.  Returns ``(s', v', uk, u_b, lonely per
    block, repaired)``."""
    u_b, panel_b, lonely_pb, repaired = _factor(*factor_args)
    p = torch.cat([v * (s * decay)[None, :], panel_b], dim=1)
    del panel_b
    v_new, s_new, uk = hierarchy.merge_svd(p, k_state)
    return s_new, v_new, uk, u_b, lonely_pb, repaired


# ---------------------------------------------------------------------------
# The window driver
# ---------------------------------------------------------------------------

Draws = Union[None, Sequence, Callable[[int], object]]


def _pick(src: Draws, t: int, b: int):
    """The injected input of the window's t-th batch (global batch index
    b): a sequence is indexed by t, a callable called with b."""
    if src is None:
        return None
    return src(b) if callable(src) else src[t]


def ingest_window(
    state: StreamingSVDState,
    deltas: Sequence,
    config,
    plan,
    *,
    draws: Draws = None,
    omegas: Draws = None,
) -> Tuple[StreamingSVDState, IngestInfo]:
    """Fold a window of same-bucket batches into the state, the state on
    the device throughout and one host read at the end (see the module
    docstring).

    ``deltas`` must share one :func:`bucket_signature`; the state must
    already sit at ``config.truncate_rank`` (the carry is fixed-shape:
    ``api.svd_stream`` grows a fresh state through the per-batch path
    first).  ``plan`` is an R5/R5d/R6 plan: ``plan.rank`` is the
    batch-factorization decision and ``plan.backend`` routes single-host
    vs shard_map.  A length-1 ``deltas`` IS the per-batch loop mode: the
    same step.  ``draws`` / ``omegas`` inject each batch's random inputs at
    the bucket's padded shape (repair draws over ``m_pad`` rows and, for an
    ELL bucket, ``C_pad`` candidate columns; Omega (L, m_pad)): a sequence
    indexed by the batch's place in the window, or a callable of its
    global batch index.

    Returns ``(new_state, IngestInfo)`` where the info aggregates the
    window (``batch_rows`` sums the window's rows;
    ``lonely_rows_per_block`` is the LAST batch's split, matching what a
    caller polling per-batch diagnostics would have seen last).
    """
    _fire_seam("ingest.window")
    k = int(config.truncate_rank)
    if state.rank != k:
        raise ValueError(
            f"scan windows need a steady-state carry: state.rank="
            f"{state.rank} != truncate_rank={k}; grow the rank with "
            f"per-batch svd_update ingests first")
    d = state.num_blocks
    t_len = len(deltas)
    if t_len < 1:
        raise ValueError("ingest_window needs at least one delta")
    if plan.backend == "shard_map":
        raise NotImplementedError(
            "the sharded scan window (plan.backend='shard_map', rule R6's "
            "per-device form) is not ported yet: ROADMAP.md Queue A item 8 "
            "(core/distributed.py); use stream_backend='single'")

    with stage("window.prologue"):
        norm = [stream_state.as_delta(x, state, device="cpu")
                for x in deltas]
        true_m = [stream_state.delta_shape(x)[0] for x in norm]
        sig = bucket_signature(norm[0])
        for x in norm[1:]:
            if bucket_signature(x) != sig:
                raise ValueError(
                    f"ingest_window got mixed buckets {bucket_signature(x)} "
                    f"vs {sig}; group deltas by bucket_signature first")
        kind, m_pad = sig[0], sig[1]
        width, n_univ = state.width, state.n
        r_b = (min(m_pad, k + config.oversample)
               if plan.rank is None else plan.rank)
        xs = build_window(norm, sig, device=state.device)
    step_key = ("single", kind, d, m_pad, width, n_univ, r_b, k, plan.rank,
                config.oversample, config.power_iters, config.method,
                config.use_kernel, float(config.history_decay))
    _BUILT.add(step_key)
    _TRACES.add((step_key, sig[2:], t_len))

    # Merge-phase fault seam: before the window's first step.
    _fire_seam("ingest.merge")
    s, v = state.s, state.v
    uks, ubs, lonely_pb = [], [], []
    repaired = torch.zeros((), dtype=torch.int64, device=state.device)
    decay = float(config.history_decay)
    for t in range(t_len):
        b = state.batches_seen + t
        s, v, uk, u_b, lon, rep = _step(
            (kind, d, m_pad, width, n_univ, r_b, plan.rank, config,
             ranky.derive_seed(state.seed, b), true_m[t],
             tuple(x[t] for x in xs), _pick(draws, t, b),
             _pick(omegas, t, b)), k, decay, s, v)
        uks.append(uk)
        ubs.append(u_b)
        lonely_pb.append(lon)
        repaired = repaired + rep

    _DISPATCH["windows"] += 1
    _DISPATCH["batches"] += t_len

    # Fold the small rotations into u AFTER the window: u grows with
    # rows_seen and never rides in the carry.  Padded u_b rows are sliced
    # off with the host-side true row counts before they touch u.
    with stage("u_update"):
        u = state.u
        for uk, u_b, m_t in zip(uks, ubs, true_m):
            u = torch.cat([u @ uk[:k], u_b[:m_t] @ uk[k:]], dim=0)

    # The ONE host read of the window: the side-band counters lived on the
    # device the whole way.
    lonely_all = torch.stack(lonely_pb)                      # (T, D)
    counts = torch.cat([lonely_all.sum().reshape(1), repaired.reshape(1),
                        lonely_all[-1]]).tolist()
    lonely_total, repaired_total, last_pb = counts[0], counts[1], counts[2:]

    new_state = StreamingSVDState(
        u=u, s=s, v=v, seed=state.seed,
        n=state.n, num_blocks=d,
        rows_seen=state.rows_seen + int(sum(true_m)),
        batches_seen=state.batches_seen + t_len,
        lonely_rows_seen=state.lonely_rows_seen + int(lonely_total),
        repaired_rows_seen=state.repaired_rows_seen + int(repaired_total))
    info = IngestInfo(
        batch_rows=int(sum(true_m)),
        lonely_rows_per_block=tuple(int(x) for x in last_pb),
        lonely_rows=int(lonely_total),
        repaired_rows=int(repaired_total))
    return new_state, info
