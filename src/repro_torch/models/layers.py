"""Shared model layers: norms, activations, RoPE and M-RoPE, embeddings,
the logit head, the vocab-parallel cross-entropy, and the sharding-rule
context ``ShardCtx``.  The counterpart of ``repro.models.layers``.

**The model mesh.**  The reference annotates tensors
(``ctx.constrain``) and lets GSPMD place the collectives.  The port writes
each rank's local computation with the collectives explicit, Megatron
style, over a :class:`~repro_torch.core.collectives.BlockMesh` with one
slot a process: a ``ProcessGroupMesh`` (NCCL, or gloo for several ranks on
one card or on the CPU), or a ``LocalMesh`` of one slot.  A ``LocalMesh``
of more slots holds them all in one process as a stack axis, which a
per-rank model cannot run: ``ShardCtx`` refuses it.  A mesh built by
:func:`layout_mesh` holds no slot: its specs are computable (the
counterpart of jax's ``AbstractMesh``), its collectives are not.

Parameters, caches and batches on a mesh are each rank's LOCAL blocks of
the reference's global arrays, the blocks the reference's specs name
(``ShardCtx.local`` cuts them, ``ShardCtx.gather`` joins them).  Two
differentiable collectives carry the gradients (Megatron's ``f`` / ``g``):
``copy_to`` (identity forward, ``psum`` backward) where a value that is
the same on every rank enters a use that differs by rank, and
``reduce_from`` (``psum`` forward, identity backward) after a
row-parallel product whose sum every rank then uses alike; ``all_reduce``
(``psum`` both ways) is a reduced value each rank then uses differently.
With ``mesh=None`` every one of these is the identity."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.collectives import BlockMesh, LocalMesh

# One entry a dimension: the mesh axes it is split over, or None.
Spec = Tuple[Optional[Tuple[str, ...]], ...]
Axes = Optional[Tuple[str, ...]]


# ---------------------------------------------------------------------------
# Sharding context: logical axis names -> mesh axes
# ---------------------------------------------------------------------------

# Production rules.  Activations: batch over (pod, data); heads/mlp/vocab/
# experts over model (Megatron TP); d_model replicated.  None => replicated.
DEFAULT_RULES: Dict[str, Optional[Tuple[str, ...]]] = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_shard": ("data",),   # long-context decode: KV/sequence sharding
    "heads": ("model",),
    "kv_heads": ("model",),   # dropped per-arch when indivisible
    "embed": None,
    "mlp": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "ssm_heads": ("model",),
    "layers": None,
    "opt_shard": ("data",),   # ZeRO-1 axis for optimizer moments
}


def layout_mesh(shape) -> BlockMesh:
    """A mesh of ``shape`` ({axis: size}) that holds no slot: the layout
    only, for the closed forms (``param_specs``, ``state_shardings``, ...)
    of a mesh larger than what runs."""
    return BlockMesh(shape, "meta", ())


def _is_staged(mesh) -> bool:
    return getattr(mesh, "backend", None) == "gloo"


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Carries the mesh + logical->physical rules through model code.

    With mesh=None every collective is the identity and every local block
    the whole tensor (the single-device path, bit for bit)."""

    mesh: Optional[BlockMesh] = None
    rules: Optional[Dict[str, Optional[Tuple[str, ...]]]] = None

    def __post_init__(self):
        if isinstance(self.mesh, LocalMesh) and self.mesh.size > 1:
            raise ValueError(
                f"the LM runs one mesh slot a process: a LocalMesh of "
                f"{self.mesh.size} slots holds them all in one process; "
                f"use a ProcessGroupMesh (one rank a slot) or a LocalMesh "
                f"of one slot")

    def _rules(self) -> Dict[str, Optional[Tuple[str, ...]]]:
        return self.rules if self.rules is not None else DEFAULT_RULES

    def axes(self, logical: Optional[str]) -> Axes:
        if logical is None:
            return None
        r = self._rules().get(logical)
        if r is None:
            return None
        # Drop axes missing from the mesh (e.g. "pod" on single-pod runs).
        if self.mesh is not None:
            r = tuple(a for a in r if a in self.mesh.axis_names)
        return r if r else None

    def spec(self, *logical: Optional[str]) -> Spec:
        return tuple(self.axes(lg) for lg in logical)

    def size(self, axes: Axes) -> int:
        """Slots over ``axes`` (mesh axis names; 1 for None or no mesh)."""
        if self.mesh is None or not axes:
            return 1
        return math.prod(self.mesh.shape[a] for a in axes)

    def checked(self, logical: Optional[str], dim: int) -> Axes:
        """The axes of ``logical`` for a dimension of size ``dim``, or None
        where the dimension does not divide them (replicated)."""
        axes = self.axes(logical)
        if not axes or self.mesh is None:
            return None
        return axes if dim % self.size(axes) == 0 else None

    # -- this rank ----------------------------------------------------------
    def _slot(self) -> int:
        if self.mesh.n_local != 1:
            raise ValueError(
                f"{self.mesh!r} holds {self.mesh.n_local} slots in this "
                f"process; the LM needs one (a layout mesh has none)")
        return self.mesh.local_slots[0]

    def index(self, axes: Axes) -> int:
        """This rank's flat index over ``axes`` (row-major, mesh order)."""
        if self.mesh is None or not axes:
            return 0
        return self.mesh.flat_index(self._slot(), axes)

    # -- plain collectives (no autograd) -----------------------------------
    def psum(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """Sum over the ranks of ``axes`` (identity for None)."""
        if self.mesh is None or not axes:
            return x
        dt = x.dtype
        # gloo stages through the host and sums half types unevenly.
        y = x.float() if _is_staged(self.mesh) and dt in (
            torch.bfloat16, torch.float16) else x
        return self.mesh.psum(y[None], axes)[0].to(dt)

    def all_gather(self, x: torch.Tensor, axes: Axes,
                   dim: Optional[int] = None) -> torch.Tensor:
        """The ranks' ``x`` over ``axes`` in flat-index order: stacked on a
        new leading dim (``dim=None``), else concatenated along ``dim``."""
        if self.mesh is None or not axes:
            return x[None] if dim is None else x
        dt = x.dtype
        y = x.float() if _is_staged(self.mesh) and dt in (
            torch.bfloat16, torch.float16) else x
        out = self.mesh.all_gather(y[None], axes)[0].to(dt)
        return out if dim is None else torch.cat(out.unbind(0), dim=dim)

    # -- differentiable collectives ----------------------------------------
    def copy_to(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """Identity forward, ``psum`` of the gradient over ``axes``."""
        if self.mesh is None or not axes or not _grad(x):
            return x
        return _CopyTo.apply(x, self, axes)

    def reduce_from(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """``psum`` forward over ``axes``, identity backward."""
        if self.mesh is None or not axes:
            return x
        if not _grad(x):
            return self.psum(x, axes)
        return _ReduceFrom.apply(x, self, axes)

    def all_reduce(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """``psum`` forward and backward over ``axes``."""
        if self.mesh is None or not axes:
            return x
        if not _grad(x):
            return self.psum(x, axes)
        return _AllReduce.apply(x, self, axes)

    # -- blocks -------------------------------------------------------------
    def local_shape(self, shape: Sequence[int], spec: Spec
                    ) -> Tuple[int, ...]:
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        return tuple(int(d) // self.size(ax) for d, ax in zip(shape, spec))

    def local(self, x: torch.Tensor, spec: Spec) -> torch.Tensor:
        """This rank's block of the full tensor ``x`` under ``spec`` (a
        view; identity without a mesh)."""
        if self.mesh is None:
            return x
        for dim, ax in enumerate(spec):
            n = self.size(ax)
            if n > 1:
                step = x.shape[dim] // n
                x = x.narrow(dim, self.index(ax) * step, step)
        return x

    def gather(self, x: torch.Tensor, spec: Spec) -> torch.Tensor:
        """The full tensor from the ranks' blocks under ``spec``."""
        if self.mesh is None:
            return x
        for dim, ax in enumerate(spec):
            if self.size(ax) > 1:
                x = self.all_gather(x.contiguous(), ax, dim=dim)
        return x


def _grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, sctx, axes):
        fctx.sctx, fctx.axes = sctx, axes
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return fctx.sctx.psum(g.contiguous(), fctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, sctx, axes):
        return sctx.psum(x.contiguous(), axes)

    @staticmethod
    def backward(fctx, g):
        return g, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, sctx, axes):
        fctx.sctx, fctx.axes = sctx, axes
        return sctx.psum(x.contiguous(), axes)

    @staticmethod
    def backward(fctx, g):
        return fctx.sctx.psum(g.contiguous(), fctx.axes), None, None



# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMS norm in float32, returned in ``x``'s dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    scale = (1.0 + w.float()) if plus_one else w.float()
    return (y * scale).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap) if cap > 0 else x


def activate(gate: torch.Tensor, up: Optional[torch.Tensor],
             kind: str) -> torch.Tensor:
    """swiglu/geglu are gated (need ``up``); gelu is the plain 2-matrix MLP."""
    if kind == "swiglu":
        return F.silu(gate) * up
    if kind == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    if kind == "gelu":
        return F.gelu(gate, approximate="tanh")
    raise ValueError(kind)


def gated(kind: str) -> bool:
    return kind in ("swiglu", "geglu")


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, pos: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); pos: (B, S) integer -> rotary-embedded x."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                 # (Dh/2,)
    ang = pos[..., None].float() * freqs                     # (B, S, Dh/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x32 = x.float()
    x1, x2 = x32[..., : dh // 2], x32[..., dh // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, pos3: torch.Tensor,
                theta: float) -> torch.Tensor:
    """M-RoPE (qwen2-vl): pos3 (B, S, 3) = (temporal, height, width) ids.
    The Dh/2 frequency pairs are split into three contiguous sections,
    each rotated by its own position stream."""
    dh = x.shape[-1]
    half = dh // 2
    s1 = half - 2 * (half // 3)
    sections = (s1, half // 3, half // 3)
    freqs = rope_freqs(dh, theta, x.device)
    parts, lo = [], 0
    for i, sec in enumerate(sections):
        parts.append(pos3[..., i][..., None].float() * freqs[lo: lo + sec])
        lo += sec
    ang = torch.cat(parts, dim=-1)                           # (B, S, Dh/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding + logits
# ---------------------------------------------------------------------------

def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor, dtype, *,
                 scale: bool = False, ctx: Optional[ShardCtx] = None,
                 v_axes: Axes = None) -> torch.Tensor:
    """Rows of the embedding table in ``dtype``.  The reference casts the
    whole table and then gathers; gathering first and casting the rows
    gives the same values without a cast copy of the table.  Over a
    vocab-sharded table (``v_axes``: this rank holds rows [lo, lo + Vl)):
    a masked local lookup, then ``reduce_from`` (each row is nonzero on one
    rank, so the sum is exact)."""
    if ctx is None or ctx.size(v_axes) == 1:
        x = embed[tokens.long()].to(dtype)
    else:
        vl = embed.shape[0]
        local = tokens.long() - ctx.index(v_axes) * vl
        ok = (local >= 0) & (local < vl)
        x = embed[local.clamp(0, vl - 1)].to(dtype)
        x = ctx.reduce_from(torch.where(ok[..., None], x, 0), v_axes)
    if scale:
        x = (x.float() * float(embed.shape[1]) ** 0.5).to(dtype)
    return x


def lm_logits(x: torch.Tensor, head: torch.Tensor, *, cap: float = 0.0,
              ctx: Optional[ShardCtx] = None,
              v_axes: Axes = None) -> torch.Tensor:
    """x: (..., D) @ head (D, V) -> float32 logits; over a vocab-sharded
    head (D, Vl) the rank's vocab slice, behind ``copy_to``."""
    if ctx is not None:
        x = ctx.copy_to(x, v_axes)
    logits = torch.matmul(x.float(), head.float())
    return softcap(logits, cap)


_NO_MESH = ShardCtx()


def xent_loss(logits: torch.Tensor, labels: torch.Tensor, *,
              real_vocab: int, ctx: ShardCtx = _NO_MESH,
              v_axes: Axes = None, b_axes: Axes = None) -> torch.Tensor:
    """Mean cross-entropy over the valid labels of a (possibly padded)
    logits tensor (..., Vp): padded vocab slots are masked to -1e30,
    labels < 0 are ignored.  On a mesh the mean is over the valid labels
    of the whole batch (``b_axes``: the rows are this rank's), and with
    ``v_axes`` the logits are this rank's vocab slice (..., Vl): the
    vocab-parallel form (:class:`_VocabXent`)."""
    if ctx.size(v_axes) > 1:
        return _VocabXent.apply(logits, labels, ctx, v_axes, b_axes,
                                real_vocab)
    v = logits.shape[-1]
    if real_vocab < v:
        pad = torch.arange(v, device=logits.device) >= real_vocab
        logits = torch.where(pad, -1e30, logits)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.long().clamp(min=0)[..., None])[..., 0]
    nll = lse - gold
    ok = (labels >= 0).to(torch.float32)
    return ctx.reduce_from(torch.sum(nll * ok), b_axes) / torch.clamp(
        ctx.psum(torch.sum(ok), b_axes), min=1.0)


class _VocabXent(torch.autograd.Function):
    """Megatron's vocab-parallel cross-entropy.  Forward: the global row
    max (an ``all_gather`` of the row maxes), the ``psum`` of the local
    sums of exponentials, the gold logit through a masked local pick and a
    ``psum``; the mean over the valid labels summed over ``b_axes``.
    Backward: the local softmax minus the one-hot of the labels that fall
    in this rank's slice, over the global count."""

    @staticmethod
    def forward(fctx, logits, labels, sctx, v_axes, b_axes, real_vocab):
        vl = logits.shape[-1]
        lo = sctx.index(v_axes) * vl
        cols = lo + torch.arange(vl, device=logits.device)
        logits = torch.where(cols >= real_vocab, -1e30, logits.float())
        m = sctx.all_gather(logits.amax(dim=-1), v_axes).amax(dim=0)
        sumexp = sctx.psum(torch.exp(logits - m[..., None]).sum(dim=-1),
                           v_axes)
        lse = m + torch.log(sumexp)
        local = labels.long() - lo
        mine = (local >= 0) & (local < vl)
        pick = torch.gather(logits, -1, local.clamp(0, vl - 1)[..., None])
        gold = sctx.psum(torch.where(mine, pick[..., 0], 0.0), v_axes)
        ok = (labels >= 0).to(torch.float32)
        count = torch.clamp(sctx.psum(torch.sum(ok), b_axes), min=1.0)
        loss = sctx.psum(torch.sum((lse - gold) * ok), b_axes) / count
        fctx.save_for_backward(logits, lse, local, mine, ok, count)
        return loss

    @staticmethod
    def backward(fctx, g):
        logits, lse, local, mine, ok, count = fctx.saved_tensors
        grad = torch.exp(logits - lse[..., None])
        onehot = F.one_hot(local.clamp(0, logits.shape[-1] - 1),
                           logits.shape[-1]).to(grad.dtype)
        grad = grad - onehot * mine[..., None]
        grad = grad * (ok / count * g)[..., None]
        return grad, None, None, None, None, None


def rms_norm_sharded(x: torch.Tensor, w: torch.Tensor, *, eps: float,
                     ctx: Optional[ShardCtx], axes: Axes,
                     full_dim: int) -> torch.Tensor:
    """``rms_norm`` over a last dim split over ``axes`` (this rank holds
    its slice of x and of w): the sum of squares ``all_reduce``d, since
    each rank then normalises its own slice with it."""
    if ctx is None or ctx.size(axes) == 1:
        return rms_norm(x, w, eps=eps)
    x32 = x.float()
    ss = ctx.all_reduce(torch.sum(x32 * x32, dim=-1, keepdim=True), axes)
    y = x32 * torch.rsqrt(ss / full_dim + eps)
    return (y * w.float()).to(x.dtype)
