"""Ranky-GaLore: SVD-based low-rank gradient compression.

Every ``update_every`` steps, the left singular basis P (m x r) of each
eligible 2-D gradient is recomputed with the paper's machinery: the gram
of the gradient, then ``eigh`` (the gram-then-eigh merge of
``core/svd.py``).  Adam moments then live in the rank-r projected space
(r x n instead of m x n), so the optimizer state shrinks by m / r.

Rank repair's role here: moe expert slabs and padded attention heads give
gradients with structurally zero rows, whose gram null space makes the
eigh basis unstable across refreshes (the rank problem the paper fixes for
sparse matrices).  RandomChecker-style repair is applied to a COPY of the
gradient used for the basis only (one random column of each zero row set
to 1e-6); the true gradient is never modified.

The counterpart of ``repro.compression.galore`` on one device, semantics
kept: the gram is formed on the m side (``g g^T``, m x m) even when
m >> n, and the basis is the top r eigenvectors in descending order, up
to ``EIGH_MAX_ROWS`` rows.  Past that (an LM's embedding: 32,000 rows and
more) the card's ``eigh`` refuses the m-side gram, so the top r come from
the n-side gram ``g^T g``: its top eigenpairs mapped back as g v /
sqrt(lambda), the same subspace where the top eigenvalues are apart.
Leaves with leading dims (stacked layers, experts) take a batched
``torch.linalg.eigh``; as in the reference, every slice of a leaf repairs
with the same columns.  The gram stays a plain ``torch.matmul``, as the
reference computes it outside any kernel.

Randomness is an input: the repair columns of leaf i (in the reference's
leaf order, dict keys sorted) are drawn on the CPU from
``derive_seed(seed, i)``, so a run on the card and one on the CPU draw
the same columns; ``apply_updates(cols=)`` takes them by path instead
(tests inject the reference's draws), and ``apply_updates(bases=)`` takes
the refresh's bases by path.  State layout per eligible leaf: {"p": (..,
m, r), "m" / "v": (.., r, n)}, float32.

**On the model mesh** (``ctx``, ``models/layers.ShardCtx``, and the
parameters' ``specs``) a leaf's gradient is the rank's tensor-parallel
block, already summed over the batch axes, and the state is the rank's
block of the reference's ``state_shardings``: every state leaf (``p``,
``m``, ``v``) split over ``opt_shard`` alone, on the global shape
(``adamw.zero_spec``), with no tensor-parallel split.  The basis is the
whole gradient's (:func:`mesh_gram`): the rows are gathered over the
axes that split them (the vocab-parallel embedding and head), the gram
of the rank's column block is summed over the axes that split the
columns (the gram-allreduce merge of ``core/svd.py``: a column-split
gradient is Ranky's block decomposition), and a leading split (experts,
layers) needs no collective.  The repair sees the whole row: a row is
lonely when its non-zero count, summed over the column blocks, is 0; its
column is drawn over the global (m, n), and only the rank whose block
holds that column adds the 1e-6.  Every rank of a group then takes
``eigh`` of the same gram bits.  A rank gathers what its ZeRO slice needs
whole: P over ``opt_shard`` (and over a leading split), g_low = P^T g
summed over the row split and gathered over the column and leading
splits; it updates its slice of the moments, gathers d_low back, and its
parameter block takes its rows and columns of P d_low.  A leaf that is
not eligible takes plain AdamW on its ZeRO slice of the whole leaf.
Without a mesh the same code runs under ``ShardCtx()``, where every
collective, block and slice is the whole tensor: one device is the mesh
of one slot.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.ranky import derive_seed
from repro_torch.models.layers import ShardCtx
from repro_torch.optim import adamw, tree

REPAIR_EPS = 1e-6
# The most rows whose m-side gram takes ``eigh``; a taller leaf with fewer
# columns (an LM's embedding) takes the n-side gram.  cuSOLVER's eigh on
# an H100 takes a 26,000^2 float32 gram in 7.6 s and refuses a 32,000^2 one
# (float32 and float64; MAGMA's takes 98 s): PERF.md §6.
EIGH_MAX_ROWS = 16384


@dataclasses.dataclass(frozen=True)
class GaloreConfig:
    rank: int = 32
    update_every: int = 50
    min_dim: int = 64       # both matrix dims must reach this
    repair: bool = True     # Ranky rank repair for the basis gram
    scale: float = 1.0      # GaLore alpha


def eligible(gcfg: GaloreConfig, leaf) -> bool:
    """(.., m, n) leaves with both trailing dims >= min_dim and a rank
    below them; the trailing two dims are the matrix.  ``leaf``: a tensor
    or a shape (on a mesh: the leaf's global shape)."""
    shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
        else tuple(leaf)
    if len(shape) < 2:
        return False
    m, n = shape[-2:]
    return min(m, n) >= gcfg.min_dim and gcfg.rank < min(m, n)


def draw_cols(seed: int, index: int, m: int, n: int) -> torch.Tensor:
    """(m,) int64 repair columns in [0, n) of leaf ``index``, drawn on the
    CPU."""
    gen = torch.Generator().manual_seed(derive_seed(seed, index))
    return torch.randint(0, n, (m,), generator=gen)


def repair(g32: torch.Tensor, lonely: torch.Tensor, cols: torch.Tensor,
           col0: int = 0) -> torch.Tensor:
    """``g32`` (.., m, n_blk), the columns [col0, col0 + n_blk) of the
    gradient, with 1e-6 added at (i, cols[i]) for every lonely row i
    whose column lies in the block (a lonely row is zero, so the entry
    becomes exactly 1e-6)."""
    n_blk = g32.shape[-1]
    local = cols.to(g32.device).long() - col0
    inside = (local >= 0) & (local < n_blk)
    fill = F.one_hot(local.clamp(0, n_blk - 1), n_blk).to(torch.float32) \
        * (REPAIR_EPS * inside.to(torch.float32))[:, None]
    return g32 + lonely[..., None] * fill


def n_side(m: int, n: int) -> bool:
    """Whether a (.., m, n) leaf takes its basis from the n-side gram: m
    past ``EIGH_MAX_ROWS`` and n below m."""
    return m > EIGH_MAX_ROWS and n < m


def top_basis(gcfg: GaloreConfig, gram: torch.Tensor) -> torch.Tensor:
    """The top-r eigenvectors (.., m, r) of an m-side gram, descending."""
    _, vecs = torch.linalg.eigh(gram)                           # ascending
    return vecs.flip(-1)[..., : gcfg.rank]


def n_side_basis(gcfg: GaloreConfig, gram: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """The top-r left singular vectors (.., m_blk, r) of the rows ``rows``
    (.., m_blk, n) of a repaired gradient whose n-side gram (G^T G) is
    ``gram``: G v_i / sqrt(lambda_i) over its top r eigenpairs (a zero
    eigenvalue gives a zero column)."""
    vals, vecs = torch.linalg.eigh(gram)
    vals = vals.flip(-1)[..., : gcfg.rank]
    vecs = vecs.flip(-1)[..., : gcfg.rank]
    inv = torch.where(vals > 0, torch.rsqrt(vals.clamp_min(1e-38)), 0.0)
    return rows @ (vecs * inv[..., None, :])


def _full(spec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def global_shape(shape, spec, ctx) -> Tuple[int, ...]:
    """The whole leaf's shape from a rank's block of it under ``spec``."""
    return tuple(int(d) * ctx.size(ax)
                 for d, ax in zip(shape, _full(spec, len(shape))))


def mesh_gram(gcfg: GaloreConfig, g: torch.Tensor, spec=(), ctx=None,
              cols: Optional[torch.Tensor] = None):
    """The whole gradient's gram from the rank's block ``g`` of a leaf
    under ``spec``, for the matrices the rank holds (a leading split keeps
    its own): (gram, lonely (.., rows) or None, the repaired block it was
    formed from).  The m-side gram (.., m, m): the rows gathered over
    their axes, the repair at the global columns ``cols`` (m,), the gram of
    the column block summed over the column axes.  Past
    ``EIGH_MAX_ROWS`` rows (``n_side``) the n-side gram (.., n, n): the
    columns gathered, the rank's row block repaired, its gram summed over
    the row axes.  ``ctx`` None: ``ShardCtx()``, one device's gram."""
    ctx = ctx if ctx is not None else ShardCtx()
    sp = _full(spec, g.dim())
    lead = (None,) * (g.dim() - 2)
    m_ax, n_ax = sp[-2], sp[-1]
    m, n = global_shape(g.shape, sp, ctx)[-2:]
    if n_side(m, n):
        blk = ctx.gather(g.to(torch.float32), lead + (None, n_ax))
        row0, col0, count_ax = ctx.index(m_ax) * blk.shape[-2], 0, None
    else:
        blk = ctx.gather(g.to(torch.float32), lead + (m_ax, None))
        row0, col0, count_ax = 0, ctx.index(n_ax) * blk.shape[-1], n_ax
    lonely = None
    if gcfg.repair:
        lonely = ctx.psum(torch.count_nonzero(blk, dim=-1), count_ax) == 0
        blk = repair(blk, lonely, cols[row0: row0 + blk.shape[-2]], col0)
    if n_side(m, n):
        return ctx.psum(blk.transpose(-1, -2) @ blk, m_ax), lonely, blk
    return ctx.psum(blk @ blk.transpose(-1, -2), n_ax), lonely, blk


def mesh_basis(gcfg: GaloreConfig, g: torch.Tensor, spec=(), ctx=None,
               cols: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole gradient's top-r basis (.., m, r) for the matrices the
    rank holds, every row (``mesh_gram``, then ``eigh``); ``cols`` (m,)
    is needed when ``gcfg.repair``."""
    ctx = ctx if ctx is not None else ShardCtx()
    sp = _full(spec, g.dim())
    gram, _, blk = mesh_gram(gcfg, g, sp, ctx, cols)
    if n_side(*global_shape(g.shape, sp, ctx)[-2:]):
        return ctx.gather(n_side_basis(gcfg, gram, blk),
                          (None,) * (g.dim() - 2) + (sp[-2], None))
    return top_basis(gcfg, gram)


def _state_shapes(gcfg: GaloreConfig, shape) -> Dict[str, tuple]:
    if eligible(gcfg, shape):
        lead, (m, n) = tuple(shape[:-2]), shape[-2:]
        return {"p": lead + (m, gcfg.rank), "m": lead + (gcfg.rank, n),
                "v": lead + (gcfg.rank, n)}
    return {"m": tuple(shape), "v": tuple(shape)}


def _zero(shape, ctx):
    """(dim, axes) of a state leaf's ZeRO split (its spec in
    ``train.step.state_shardings``), or None where it splits nothing."""
    z = adamw.zero_split((), adamw.zero_spec((), shape, ctx))
    return z if z is not None and ctx.size(z[1]) > 1 else None


def _mesh_args(params, ctx, specs):
    """(ctx, one spec a leaf): ``ShardCtx()`` without a mesh, and every
    leaf whole where ``specs`` is not given."""
    ctx = ctx if ctx is not None else ShardCtx()
    if ctx.mesh is None or specs is None:
        return ctx, [()] * len(tree.leaves(params))
    return ctx, tree.leaves(specs, dicts_only=True)


def init_state(params, gcfg: GaloreConfig, *, ctx=None,
               specs=None) -> Dict[str, Any]:
    """Zero state; on a mesh (``ctx`` and the parameters' ``specs``) each
    leaf the rank's ZeRO slice of the whole leaf's state."""
    ctx, spec_list = _mesh_args(params, ctx, specs)

    def leaf_state(p, sp):
        out = {}
        for key, s in _state_shapes(
                gcfg, global_shape(p.shape, sp, ctx)).items():
            z = _zero(s, ctx)
            if z is not None:
                s = s[:z[0]] + (s[z[0]] // ctx.size(z[1]),) + s[z[0] + 1:]
            out[key] = torch.zeros(s, dtype=torch.float32, device=p.device)
        return out

    flat = tree.leaves(params)
    device = flat[0].device if flat else torch.device("cpu")
    return {"leaves": tree.unflatten(params, [
        leaf_state(p, sp) for p, sp in zip(flat, spec_list)]),
        "step": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def apply_updates(acfg: adamw.AdamWConfig, gcfg: GaloreConfig, params, grads,
                  state: Dict[str, Any], *, lr_scale=1.0, seed: int = 0,
                  cols: Optional[Dict[str, torch.Tensor]] = None,
                  bases: Optional[Dict[str, torch.Tensor]] = None,
                  ctx=None, specs=None):
    """One GaLore-AdamW step, in place (as ``adamw.apply_updates``).  The
    bases are refreshed when the step before it is a multiple of
    ``update_every``: ``bases[path]`` (the whole leaf's (.., m, r)) where
    given, else from the gradient; the repair columns of leaf i come from
    ``cols[path]`` or else ``draw_cols(seed, i, m, n)`` (m, n global).  On
    a mesh: ``ctx`` and the parameters' ``specs`` (see the module
    docstring).  Returns (params, state, {"grad_norm"})."""
    ctx, spec_list = _mesh_args(params, ctx, specs)
    gn = adamw.global_norm(grads, ctx=ctx, specs=specs)
    scale = adamw.clip_scale(gn, acfg.grad_clip)
    refresh = int(state["step"]) % gcfg.update_every == 0
    state["step"].add_(1)
    bc1, bc2 = adamw.bias_corrections(acfg, state["step"])
    for i, ((path, p), g) in enumerate(zip(tree.flatten(params),
                                           tree.leaves(grads))):
        shape = global_shape(p.shape, spec_list[i], ctx)
        c = None
        if refresh and gcfg.repair and eligible(gcfg, shape):
            c = cols[path] if cols is not None and path in cols \
                else draw_cols(seed, i, *shape[-2:])
        base = bases.get(path) if refresh and bases else None
        _leaf_update(acfg, gcfg, p, g.to(torch.float32) * scale,
                     _leaf_state(state["leaves"], path), spec_list[i], shape,
                     ctx, refresh, c, base, bc1, bc2, lr_scale)
    return params, state, {"grad_norm": gn}


def _gathered(x: torch.Tensor, split, ctx) -> torch.Tensor:
    """The whole state leaf from the rank's ZeRO slice ``x``."""
    if split is None:
        return x
    return ctx.all_gather(x.contiguous(), split[1], dim=split[0])


def _leaf_update(acfg, gcfg, p, g, st, spec, shape, ctx, refresh, cols,
                 base, bc1, bc2, lr_scale) -> None:
    """One leaf's update (see the module docstring): ``p`` and ``g`` the
    rank's blocks of a leaf of global ``shape`` under ``spec``, ``st`` its
    ZeRO slices of the state."""
    sp = _full(spec, p.dim())
    if not eligible(gcfg, shape):
        z = _zero(shape, ctx)
        p_c = adamw._chunk(ctx.gather(p, sp), z, ctx)
        delta = adamw.moments(acfg, st["m"], st["v"],
                              adamw._chunk(ctx.gather(g, sp), z, ctx),
                              bc1, bc2)
        if p.dim() >= 2:
            delta = delta + acfg.weight_decay * p_c.to(torch.float32)
        adamw.write_param(acfg, p_c, delta, lr_scale)
        if p_c is not p:        # the rank's slice back into its block
            p.copy_(ctx.local(_gathered(p_c, z, ctx), sp))
        return
    lead = sp[:-2]
    shapes = _state_shapes(gcfg, shape)
    z_p, z_m = _zero(shapes["p"], ctx), _zero(shapes["m"], ctx)
    if refresh:
        if base is not None:
            own = ctx.local(base.to(p.device, torch.float32),
                            lead + (None, None))
        else:
            own = mesh_basis(gcfg, g, sp, ctx, cols)    # (lead_blk, m, r)
        # contiguous, as the stored P one device multiplies by: the same
        # products, so a mesh of one slot gives one device's bits
        proj = ctx.gather(own, lead + (None, None)).contiguous()
        st["p"].copy_(adamw._chunk(proj, z_p, ctx))
    else:
        proj = _gathered(st["p"], z_p, ctx)
    p_use = ctx.local(proj, lead + (sp[-2], None))      # (lead, m_blk, r)
    g_low = ctx.psum(p_use.transpose(-1, -2) @ g, sp[-2])
    low_spec = lead + (None, sp[-1])
    g_low = ctx.gather(g_low, low_spec)                 # (.., r, n)
    d_low = adamw.moments(acfg, st["m"], st["v"],
                          adamw._chunk(g_low, z_m, ctx), bc1, bc2)
    d_use = ctx.local(_gathered(d_low, z_m, ctx), low_spec)
    delta = gcfg.scale * (p_use @ d_use)
    delta = delta + acfg.weight_decay * p.to(torch.float32)
    adamw.write_param(acfg, p, delta, lr_scale)


def _leaf_state(leaves, path: str) -> Dict[str, torch.Tensor]:
    node = leaves
    for part in path.split("/"):
        node = node[part]
    return node


def state_bytes(state) -> int:
    return sum(x.numel() * x.element_size()
               for x in tree.leaves(state["leaves"]))
