"""Mamba-2 (SSD) block: gated state-space layer with a depthwise causal
conv front end, the chunked scan (the ``ssd_scan`` kernel) for prefill and
an O(1)-state single-token decode.  The counterpart of
``repro.models.ssm``; where the reference reads the ``REPRO_PERF`` flag
``bf16_gate`` the port takes the default branch (the gate in float32).

On a mesh (``ctx``) a rank holds its slice of d_inner (``wz``, ``wx``,
``conv_x_*``, ``norm_w``, ``out_proj``: the ``mlp`` rule) and of the heads
(``wdt``, ``dt_bias``, ``a_log``, ``d_skip``: ``ssm_heads``); ``wbc`` and
``conv_bc_*`` are replicated.  ``ssd_scan`` runs on the local heads, the
gated norm over d_inner ``all_reduce``s its sum of squares
(``rms_norm_sharded``), and the out-projection ends in ``reduce_from``.
A rank's conv state holds its d_inner slice of the x channels, then every
B/C channel: (B, W-1, Di/m + 2GN).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import Axes, ShardCtx, rms_norm_sharded

_NO_MESH = ShardCtx()


def _conv_full(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over the sequence, float32 sums, SiLU.
    x (B, S, C), w (W, C), b (C,) -> (B, S, C) in x's dtype."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):
        out = out + xp[:, i: i + s].float() * w[i][None, None, :].float()
    out = out + b.float()
    return F.silu(out).to(x.dtype)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w.to(x.dtype))


def ssm_axes(cfg: ModelConfig, ctx: ShardCtx) -> Axes:
    """The axes d_inner and the heads split over (None: replicated); the
    two splits must agree (a rank's heads are its d_inner slice)."""
    ax = ctx.checked("mlp", cfg.ssm_inner)
    if ax != ctx.checked("ssm_heads", cfg.ssm_heads):
        raise ValueError(
            f"{cfg.name}: d_inner {cfg.ssm_inner} and {cfg.ssm_heads} heads "
            f"split differently over the mesh {ctx.mesh!r}")
    return ax


def _local_groups(cfg: ModelConfig, ctx: ShardCtx, ax: Axes, h_local: int,
                  x: torch.Tensor) -> torch.Tensor:
    """The B / C groups (dim 2) this rank's heads read, one a local head
    (every shipped config has one group, which every head reads)."""
    if ctx.size(ax) == 1 or cfg.ssm_groups == 1:
        return x
    rep = cfg.ssm_heads // cfg.ssm_groups
    idx = (ctx.index(ax) * h_local
           + torch.arange(h_local, device=x.device)) // rep
    return x.index_select(2, idx)


def ssm_block(cfg: ModelConfig, p: Dict, x: torch.Tensor, *,
              return_state: bool = False, ctx: ShardCtx = _NO_MESH):
    """Full-sequence Mamba-2 block (prefill).  x (B, S, D).  With
    ``return_state=True`` also returns (conv_state (B, W-1, Di+2GN) float32
    of pre-activation conv inputs, ssm_state (B, H, P, N) float32), on a
    mesh the rank's (see the module docstring)."""
    bsz, s, _ = x.shape
    g, n = cfg.ssm_groups, cfg.ssm_state
    hd = cfg.ssm_head_dim
    ax = ssm_axes(cfg, ctx)
    xc_in = ctx.copy_to(x, ax)

    z = _mm(xc_in, p["wz"])
    xc_raw = _mm(xc_in, p["wx"])
    # replicated B/C weights feed rank-local heads: psum their grads
    bc_raw = _mm(xc_in, ctx.copy_to(p["wbc"], ax))
    dt = _mm(xc_in, p["wdt"])
    di, h = z.shape[-1], dt.shape[-1]             # local d_inner, heads

    xc = _conv_full(xc_raw, p["conv_x_w"], p["conv_x_b"])
    bc = _conv_full(bc_raw, ctx.copy_to(p["conv_bc_w"], ax),
                    ctx.copy_to(p["conv_bc_b"], ax))
    b_mat, c_mat = bc[..., : g * n], bc[..., g * n:]

    dt = F.softplus(dt.float() + p["dt_bias"].float())       # (B, S, H)
    xh = xc.reshape(bsz, s, h, hd)
    bm = _local_groups(cfg, ctx, ax, h, b_mat.reshape(bsz, s, g, n))
    cm = _local_groups(cfg, ctx, ax, h, c_mat.reshape(bsz, s, g, n))
    a = -torch.exp(p["a_log"].float())                        # (H,)

    # dt is rounded to x's dtype before the scan, as the reference does
    y, h_fin = ops.ssd_scan(xh, dt.to(xh.dtype), a.contiguous(),
                            bm.contiguous(), cm.contiguous())
    y = y + xh * p["d_skip"].float().reshape(1, 1, h, 1).to(y.dtype)
    y = y.reshape(bsz, s, di)
    gate = F.silu(z.float()).to(y.dtype)
    y = rms_norm_sharded(y * gate, p["norm_w"], eps=cfg.norm_eps, ctx=ctx,
                         axes=ax, full_dim=cfg.ssm_inner)
    out = ctx.reduce_from(_mm(y, p["out_proj"]), ax)
    if not return_state:
        return out
    w = cfg.ssm_conv_width
    conv_in = torch.cat([xc_raw, bc_raw], dim=-1)
    conv_in = F.pad(conv_in, (0, 0, w - 1, 0))
    conv_state = conv_in[:, -(w - 1):].float()
    return out, conv_state, h_fin


def ssm_decode(cfg: ModelConfig, p: Dict, x: torch.Tensor,
               conv_state: torch.Tensor, ssm_state: torch.Tensor, *,
               ctx: ShardCtx = _NO_MESH
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode: O(1) state update, no KV growth.  x (B, 1, D),
    conv_state (B, W-1, Di+2GN), ssm_state (B, H, P, N) float32 (on a mesh
    the rank's).  Returns (y (B, 1, D), new conv_state, new ssm_state) as
    new tensors."""
    bsz = x.shape[0]
    g, n = cfg.ssm_groups, cfg.ssm_state
    hd = cfg.ssm_head_dim
    ax = ssm_axes(cfg, ctx)
    xi = ctx.copy_to(x, ax)

    z = _mm(xi, p["wz"])
    xc0 = _mm(xi, p["wx"])[:, 0]
    bc0 = _mm(xi, p["wbc"])[:, 0]
    dt = _mm(xi, p["wdt"])[:, 0]
    di, h = xc0.shape[-1], dt.shape[-1]           # local d_inner, heads

    conv_in = torch.cat([xc0, bc0], dim=-1)                   # (B, C)
    window = torch.cat([conv_state, conv_in[:, None, :].to(conv_state.dtype)],
                       dim=1)
    new_conv_state = window[:, 1:]
    w_cat = torch.cat([p["conv_x_w"], p["conv_bc_w"]], dim=1).float()
    b_cat = torch.cat([p["conv_x_b"], p["conv_bc_b"]], dim=0).float()
    conv_out = torch.einsum("bwc,wc->bc", window.float(), w_cat) + b_cat
    conv_out = F.silu(conv_out)
    xc, b_vec, c_vec = (conv_out[:, :di], conv_out[:, di: di + g * n],
                        conv_out[:, di + g * n:])

    dt = F.softplus(dt.float() + p["dt_bias"].float())       # (B, H)
    a = -torch.exp(p["a_log"].float())
    decay = torch.exp(dt * a[None, :])                        # (B, H)

    xh = xc.reshape(bsz, h, hd)
    rep = cfg.ssm_heads // g
    if ctx.size(ax) == 1:
        bv = b_vec.reshape(bsz, g, n).repeat_interleave(rep, dim=1)
        cv = c_vec.reshape(bsz, g, n).repeat_interleave(rep, dim=1)
    else:                                   # the groups of the local heads
        gidx = (ctx.index(ax) * h + torch.arange(h, device=x.device)) // rep
        bv = b_vec.reshape(bsz, g, n).index_select(1, gidx)
        cv = c_vec.reshape(bsz, g, n).index_select(1, gidx)

    upd = (dt[..., None] * xh)[..., :, None] * bv[..., None, :]  # (B,H,P,N)
    new_state = decay[..., None, None] * ssm_state + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, cv)
    y = y + xh * p["d_skip"].float()[None, :, None]
    y = y.reshape(bsz, 1, di).to(x.dtype)

    y = rms_norm_sharded(y * F.silu(z.float()).to(y.dtype), p["norm_w"],
                         eps=cfg.norm_eps, ctx=ctx, axes=ax,
                         full_dim=cfg.ssm_inner)
    out = ctx.reduce_from(_mm(y, p["out_proj"]), ax)
    return out, new_conv_state, new_state
