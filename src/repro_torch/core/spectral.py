"""Spectral diagnostics: per-parameter singular spectra computed with the
paper's machinery (a gram, then ``eigvalsh``).

Uses (wired into the train loop through ``spectra_hook``): monitor the
effective rank and spectral norm of weights and gradients during
training, choose GaLore ranks from measured gradient spectra, audit a
model at checkpoint time.  The counterpart of ``repro.core.spectral`` on
one device: each (.., m, n) leaf's gram on its smaller side, batched over
the leading dims (stacked layers, experts).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.optim import tree


def matrix_spectrum(w: torch.Tensor, top_k: int = 8) -> torch.Tensor:
    """Top-k singular values of a (.., m, n) matrix via gram + eigh,
    batched over leading dims, descending.  Uses the smaller gram side."""
    m, n = w.shape[-2:]
    w32 = w.to(torch.float32)
    if m <= n:
        gram = w32 @ w32.transpose(-1, -2)
    else:
        gram = w32.transpose(-1, -2) @ w32
    evals = torch.linalg.eigvalsh(gram)                  # ascending
    s = torch.sqrt(torch.clamp(evals.flip(-1), min=0.0))
    return s[..., : min(top_k, s.shape[-1])]


def effective_rank(s: torch.Tensor, *, eps: float = 1e-12) -> torch.Tensor:
    """exp(entropy) of the normalized spectrum: a soft rank measure."""
    p = s / torch.clamp(torch.sum(s, dim=-1, keepdim=True), min=eps)
    ent = -torch.sum(torch.where(p > 0, p * torch.log(torch.clamp(p, min=eps)),
                                 0.0), dim=-1)
    return torch.exp(ent)


@torch.no_grad()
def tree_spectra(params, *, top_k: int = 8, min_dim: int = 32
                 ) -> Dict[str, Dict[str, Any]]:
    """Spectra for every (.., m, n) leaf of a nested dict with both dims >=
    ``min_dim``: {path: {"top": (.., k) singular values, "erank": (..,)
    effective rank, "fro": (..,) Frobenius norm}}, stacked leading dims
    kept."""
    out: Dict[str, Dict[str, Any]] = {}
    for name, leaf in tree.flatten(params):
        if leaf.ndim < 2 or min(leaf.shape[-2:]) < min_dim:
            continue
        s = matrix_spectrum(leaf, top_k=top_k)
        out[name] = {
            "top": s,
            "erank": effective_rank(s),
            "fro": torch.sqrt(torch.sum(torch.square(
                leaf.to(torch.float32)), dim=(-2, -1))),
        }
    return out


def summarize(spectra: Dict[str, Dict[str, Any]]) -> str:
    lines = []
    for name, d in sorted(spectra.items()):
        top = d["top"].detach().cpu()
        er = d["erank"].detach().cpu()
        s1 = float(top.reshape(-1, top.shape[-1])[:, 0].max())
        lines.append(f"{name:48s} sigma1={s1:9.3f} "
                     f"erank(mean)={float(er.float().mean()):6.2f}")
    return "\n".join(lines)


def spectra_hook(state, *, top_k: int = 8,
                 include_grads: Optional[Any] = None) -> Dict[str, Any]:
    """Checkpoint-time hook: spectra of ``state["params"]`` (and of a
    gradient tree where given)."""
    report: Dict[str, Any] = {
        "params": tree_spectra(state["params"], top_k=top_k)}
    if include_grads is not None:
        report["grads"] = tree_spectra(include_grads, top_k=top_k)
    return report
