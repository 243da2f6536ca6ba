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

* **The sharded window** (``plan.backend == "shard_map"``, rule R6's
  per-device form): the same steps over the stream mesh, each one
  ``ingest.shard_step`` (the sharded ingest's collectives exactly), with
  ``v`` kept sharded across the window; each slot's inputs are its own
  column blocks of the stacked window, cut on the host before the copy.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import hierarchy, planner, randomized, ranky, sparse
from repro_torch.core import svd as lsvd
from repro_torch.stream import state as stream_state
from repro_torch.stream.ingest import (IngestInfo, _fire_seam,
                                       merge_panel, shard_step)
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


def build_window(norm_deltas: Sequence, sig: Tuple, *, device,
                 slots: Optional[Sequence[int]] = None,
                 num_blocks: Optional[int] = None) -> Tuple:
    """Stack a group of same-bucket deltas, normalized on the host, into
    the window's inputs on ``device``: each delta written once into a
    zeroed host stack (pinned when the device is a GPU, so the copy runs at
    the bus's rate), then ONE copy per stacked array.  Dense: ``(a (T,
    m_pad, n_pad),)``; ell: ``(ids (T, D, C), rows (T, D, C, K), vals (T,
    D, C, K))``.  ``slots`` keeps those column blocks only (a rank's
    share of a sharded window, of ``num_blocks``), cut on the host before
    the copy."""
    t = len(norm_deltas)
    pin = torch.device(device).type == "cuda"

    def stack(shape, dtype):
        return torch.zeros((t,) + shape, dtype=dtype, pin_memory=pin)

    if sig[0] == "dense":
        a = stack((sig[1], norm_deltas[0].shape[1]), torch.float32)
        for i, x in enumerate(norm_deltas):
            _pad_dense(x, a[i])
        if slots is not None and len(slots) < num_blocks:
            t_, m_pad, n_pad = a.shape
            w = n_pad // num_blocks
            a = a.view(t_, m_pad, num_blocks, w)[:, :, list(slots)].reshape(
                t_, m_pad, len(slots) * w)
        return (a.to(device),)
    _, _, c_pad, k_pad = sig
    d = norm_deltas[0].num_blocks
    ids = stack((d, c_pad), torch.int32)
    rows = stack((d, c_pad, k_pad), torch.int32)
    vals = stack((d, c_pad, k_pad), torch.float32)
    for i, e in enumerate(norm_deltas):
        _pad_ell(e, ids[i], rows[i], vals[i])
    if slots is not None and len(slots) < d:
        ids, rows, vals = (x[:, list(slots)] for x in (ids, rows, vals))
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
            omega: Optional[torch.Tensor], v: torch.Tensor,
            s_dec: torch.Tensor):
    """Repair, mask and factor one padded batch: ``(U_b, p, lonely rows
    per block (D,), repaired rows)``, the counts as device tensors and
    ``p`` the merge panel ``[V diag(s_dec) | B^T U_b]``
    (``ingest.merge_panel``).  The repaired blocks are this function's
    own, freed before the merge."""
    dev = x[0].device
    valid = torch.arange(m_pad, device=dev) < true_m        # (m_pad,) rows
    with obs.span("split_and_repair"):
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
        with obs.span("gram_stack"):
            grams = lsvd.gram_stack(blocks, use_kernel=lsvd.resolve_use_kernel(
                config.use_kernel, v.device))
        with obs.span("merge_grams_eigh"):
            u_b, _ = lsvd.merge_grams_eigh(grams)
        u_b = u_b[:, :r_b]
        del grams
        p = merge_panel(v, s_dec, r_b)
        with obs.span("right_vectors_stack"):
            ranky.right_vectors_stack(
                blocks, u_b, torch.ones((r_b,), dtype=torch.float32,
                                        device=dev), out=p[:, v.shape[1]:])
    else:
        u_b, s_b, v_b = randomized.randomized_svd_blocks(
            blocks, rank=sk_rank, oversample=config.oversample,
            power_iters=config.power_iters, key=seed_b, want_right=True,
            omega=omega)
        p = merge_panel(v, s_dec, v_b.shape[1])
        torch.mul(v_b, s_b[None, :], out=p[:, v.shape[1]:])
    return u_b, p, lonely.sum(dim=1), repaired


def _step(factor_args: Tuple, k_state: int, decay: float, s: torch.Tensor,
          v: torch.Tensor):
    """One batch folded into ``(s, v)``: :func:`_factor`, then the merge
    of ``[V diag(decay s) | P_b]``, one panel that the batch writes its
    part into.  Returns ``(s', v', uk, u_b, lonely per block,
    repaired)``."""
    u_b, p, lonely_pb, repaired = _factor(*factor_args, v, s * decay)
    v_new, s_new, uk = hierarchy.merge_svd(p, k_state)
    return s_new, v_new, uk, u_b, lonely_pb, repaired


def _sharded_steps(state, xs, kind: str, m_pad: int, true_m, r_b: int,
                   config, plan, draws, omegas):
    """The window's steps over the stream mesh (``state`` sharded): each
    step ``ingest.shard_step`` on the local slots' blocks, ``v`` sharded
    throughout.  Returns ``(s, v, uks, ubs, lonely per block (T, D),
    repaired)``."""
    mesh, w, k = state.mesh, state.width, state.rank
    s, v_d = state.s, state.v.view(mesh.n_local, w, k)
    uks, ubs, lonely = [], [], []
    repaired = torch.zeros((), dtype=torch.int64, device=state.device)
    decay = float(config.history_decay)
    for t in range(len(true_m)):
        b = state.batches_seen + t
        valid = torch.arange(m_pad, device=state.device) < true_m[t]
        if kind == "dense":
            local = ranky.dense_block_stack(xs[0][t], mesh.n_local)
        else:
            local = sparse.BlockEll(xs[0][t], xs[1][t], xs[2][t], m=m_pad,
                                    width=w, n=state.n)
        u_b, s, uk, v_d, lon, rep = shard_step(
            kind, local, mesh, m=m_pad, width=w, config=config, r_b=r_b,
            k_new=k, sk_rank=plan.rank,
            seed=ranky.derive_seed(state.seed, b), v_d=v_d,
            s_dec=s * decay, valid=valid, draws=_pick(draws, t, b),
            omega=_pick(omegas, t, b))
        uks.append(uk)
        ubs.append(u_b)
        lonely.append(lon)
        repaired = repaired + rep
    # Per-block lonely counts of every step, gathered slot-major: (T, D).
    lonely_all = mesh.all_gather(torch.stack(lonely, dim=1))[0].mT
    return (s, v_d.reshape(mesh.n_local * w, k), uks, ubs,
            list(lonely_all), repaired)


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
    sharded = plan.backend == "shard_map"
    if sharded:
        state = stream_state.shard_state(
            state, state.mesh if state.mesh is not None
            else stream_state.stream_mesh(d))
    elif state.mesh is not None:
        state = stream_state.gather_state(state)

    with obs.span("window.prologue"):
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
        xs = build_window(norm, sig, device=state.device,
                          slots=state.mesh.local_slots if sharded else None,
                          num_blocks=d)
    step_key = (plan.backend, kind, d, m_pad, width, n_univ, r_b, k, plan.rank,
                config.oversample, config.power_iters, config.method,
                lsvd.resolve_use_kernel(config.use_kernel, state.device),
                float(config.history_decay))
    traces_before = len(_TRACES)
    _BUILT.add(step_key)
    _TRACES.add((step_key, sig[2:], t_len))

    # Merge-phase fault seam: before the window's first step.
    _fire_seam("ingest.merge")

    def steps():
        if sharded:
            return _sharded_steps(state, xs, kind, m_pad, true_m, r_b,
                                  config, plan, draws, omegas)
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
        return s, v, uks, ubs, lonely_pb, repaired

    # "compiled": this window's (step shape, capacity, T) is new, the
    # counterpart of the reference's jit-cache growth.
    compiled = len(_TRACES) > traces_before
    with obs.span("ingest.window", bucket=str(sig), batches=t_len,
                  backend=plan.backend, compiled=compiled):
        if obs.enabled():
            # R6 drift at the ACTUAL window length (a tail window is
            # shorter than plan.window): the closed form re-priced for
            # t_len batches against the steps' measured peak plus the
            # resident carry and stacked inputs.  Dense nnz = the padded
            # block input; ell nnz = slot capacity (an upper bound).
            nnz_slots = bucket_nnz_slots(sig, d)
            spec = planner.ASpec(
                m=m_pad, n=n_univ,
                nnz=nnz_slots if nnz_slots is not None else m_pad * n_univ,
                num_blocks=d, kind="stream")
            est = planner.window_bytes(
                spec, k, config.oversample, exact=plan.rank is None,
                window=t_len, batch_rank=plan.rank, nnz_slots=nnz_slots,
                per_device=sharded)
            # A sharded window is held to the per-device form on each
            # rank, to D times it on a local mesh (its D slots' working
            # sets share the card), labelled "local".
            local_mesh = sharded and state.mesh.n_local > 1
            s, v, uks, ubs, lonely_pb, repaired = obs.observe_call(
                "R6", steps, est * (state.mesh.n_local if sharded else 1),
                device=state.device, component="total",
                label="local" if local_mesh else plan.backend,
                shape_key=obs.drift.shape_key(xs, state.s, state.v),
                resident=(state.s, state.v, *xs))
        else:
            s, v, uks, ubs, lonely_pb, repaired = steps()
    if obs.enabled():
        obs.counter_add("window_dispatch_total")
        if compiled:
            obs.counter_add("window_compile_total")
        obs.counter_add("ingest_batches_total", float(t_len))
        obs.counter_add("ingest_rows_total", float(sum(true_m)))
        obs.gauge_set("jit_cache_size", trace_count())

    _DISPATCH["windows"] += 1
    _DISPATCH["batches"] += t_len

    # Fold the small rotations into u AFTER the window: u grows with
    # rows_seen and never rides in the carry.  Padded u_b rows are sliced
    # off with the host-side true row counts before they touch u.
    with obs.span("u_update"):
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
        repaired_rows_seen=state.repaired_rows_seen + int(repaired_total),
        mesh=state.mesh if sharded else None)
    info = IngestInfo(
        batch_rows=int(sum(true_m)),
        lonely_rows_per_block=tuple(int(x) for x in last_pb),
        lonely_rows=int(lonely_total),
        repaired_rows=int(repaired_total))
    return new_state, info
