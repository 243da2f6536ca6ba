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
m >> n, and the basis is the top r eigenvectors in descending order.
Leaves with leading dims (stacked layers, experts) take a batched
``torch.linalg.eigh``; as in the reference, every slice of a leaf repairs
with the same columns.  The gram stays a plain ``torch.matmul``, as the
reference computes it outside any kernel.

Randomness is an input: the repair columns of leaf i (in the reference's
leaf order, dict keys sorted) are drawn on the CPU from
``derive_seed(seed, i)``, so a run on the card and one on the CPU draw
the same columns; ``apply_updates(cols=)`` takes them by path instead
(tests inject the reference's draws).  State layout per eligible leaf:
{"p": (.., m, r), "m" / "v": (.., r, n)}, float32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.ranky import derive_seed
from repro_torch.optim import adamw, tree

REPAIR_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class GaloreConfig:
    rank: int = 32
    update_every: int = 50
    min_dim: int = 64       # both matrix dims must reach this
    repair: bool = True     # Ranky rank repair for the basis gram
    scale: float = 1.0      # GaLore alpha


def eligible(gcfg: GaloreConfig, leaf) -> bool:
    """(.., m, n) leaves with both trailing dims >= min_dim and a rank
    below them; the trailing two dims are the matrix."""
    if leaf.ndim < 2:
        return False
    m, n = leaf.shape[-2:]
    return min(m, n) >= gcfg.min_dim and gcfg.rank < min(m, n)


def draw_cols(seed: int, index: int, m: int, n: int) -> torch.Tensor:
    """(m,) int64 repair columns in [0, n) of leaf ``index``, drawn on the
    CPU."""
    gen = torch.Generator().manual_seed(derive_seed(seed, index))
    return torch.randint(0, n, (m,), generator=gen)


def _basis(gcfg: GaloreConfig, g: torch.Tensor,
           cols: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Top-r left singular basis (.., m, r) of g (.., m, n) via the m-side
    gram and eigh, with the repair of zero rows (on a copy) at the (m,)
    columns ``cols`` (needed when ``gcfg.repair``)."""
    g32 = g.to(torch.float32)
    if gcfg.repair:
        lonely = ~torch.any(g32 != 0, dim=-1)                   # (.., m)
        fill = F.one_hot(cols.to(g.device).long(), g32.shape[-1]).to(
            torch.float32) * REPAIR_EPS
        g32 = g32 + lonely[..., None] * fill
    gram = g32 @ g32.transpose(-1, -2)                          # (.., m, m)
    _, vecs = torch.linalg.eigh(gram)                           # ascending
    return vecs.flip(-1)[..., : gcfg.rank]                      # (.., m, r)


def init_state(params, gcfg: GaloreConfig) -> Dict[str, Any]:
    def leaf_state(p):
        def zeros(shape):
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        if eligible(gcfg, p):
            lead, (m, n) = tuple(p.shape[:-2]), p.shape[-2:]
            return {"p": zeros(lead + (m, gcfg.rank)),
                    "m": zeros(lead + (gcfg.rank, n)),
                    "v": zeros(lead + (gcfg.rank, n))}
        return {"m": zeros(p.shape), "v": zeros(p.shape)}

    first = tree.leaves(params)
    device = first[0].device if first else torch.device("cpu")
    return {"leaves": tree.tree_map(leaf_state, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def apply_updates(acfg: adamw.AdamWConfig, gcfg: GaloreConfig, params, grads,
                  state: Dict[str, Any], *, lr_scale=1.0, seed: int = 0,
                  cols: Optional[Dict[str, torch.Tensor]] = None):
    """One GaLore-AdamW step, in place (as ``adamw.apply_updates``).  The
    bases are refreshed when the step before it is a multiple of
    ``update_every``; the repair columns of leaf i come from ``cols[path]``
    or else ``draw_cols(seed, i, m, n)``.  Returns (params, state,
    {"grad_norm"})."""
    gn = adamw.global_norm(grads)
    scale = adamw.clip_scale(gn, acfg.grad_clip)
    refresh = int(state["step"]) % gcfg.update_every == 0
    state["step"].add_(1)
    bc1, bc2 = adamw.bias_corrections(acfg, state["step"])
    for i, ((path, p), g) in enumerate(zip(tree.flatten(params),
                                           tree.leaves(grads))):
        st = _leaf_state(state["leaves"], path)
        g = g.to(torch.float32) * scale
        if not eligible(gcfg, p):
            delta = adamw.moments(acfg, st["m"], st["v"], g, bc1, bc2)
            if p.ndim >= 2:
                delta = delta + acfg.weight_decay * p.to(torch.float32)
            adamw.write_param(acfg, p, delta, lr_scale)
            continue
        if refresh:
            m, n = p.shape[-2:]
            c = None
            if gcfg.repair:
                c = cols[path] if cols is not None and path in cols \
                    else draw_cols(seed, i, m, n)
            st["p"].copy_(_basis(gcfg, g, c))
        proj = st["p"]
        g_low = proj.transpose(-1, -2) @ g                       # (.., r, n)
        d_low = adamw.moments(acfg, st["m"], st["v"], g_low, bc1, bc2)
        delta = gcfg.scale * (proj @ d_low)
        delta = delta + acfg.weight_decay * p.to(torch.float32)
        adamw.write_param(acfg, p, delta, lr_scale)
    return params, state, {"grad_norm": gn}


def _leaf_state(leaves, path: str) -> Dict[str, torch.Tensor]:
    node = leaves
    for part in path.split("/"):
        node = node[part]
    return node


def state_bytes(state) -> int:
    return sum(x.numel() * x.element_size()
               for x in tree.leaves(state["leaves"]))
