"""Mamba-2 (SSD) block: gated state-space layer with a depthwise causal
conv front end, the chunked scan (the ``ssd_scan`` kernel) for prefill and
an O(1)-state single-token decode.  The counterpart of
``repro.models.ssm`` on one device; where the reference reads the
``REPRO_PERF`` flag ``bf16_gate`` the port takes the default branch (the
gate in float32).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import rms_norm


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


def ssm_block(cfg: ModelConfig, p: Dict, x: torch.Tensor, *,
              return_state: bool = False):
    """Full-sequence Mamba-2 block (prefill).  x (B, S, D).  With
    ``return_state=True`` also returns (conv_state (B, W-1, Di+2GN) float32
    of pre-activation conv inputs, ssm_state (B, H, P, N) float32)."""
    bsz, s, _ = x.shape
    di, g, n = cfg.ssm_inner, cfg.ssm_groups, cfg.ssm_state
    h, hd = cfg.ssm_heads, cfg.ssm_head_dim

    z = _mm(x, p["wz"])
    xc_raw = _mm(x, p["wx"])
    bc_raw = _mm(x, p["wbc"])
    dt = _mm(x, p["wdt"])

    xc = _conv_full(xc_raw, p["conv_x_w"], p["conv_x_b"])
    bc = _conv_full(bc_raw, p["conv_bc_w"], p["conv_bc_b"])
    b_mat, c_mat = bc[..., : g * n], bc[..., g * n:]

    dt = F.softplus(dt.float() + p["dt_bias"].float())       # (B, S, H)
    xh = xc.reshape(bsz, s, h, hd)
    bm = b_mat.reshape(bsz, s, g, n).contiguous()
    cm = c_mat.reshape(bsz, s, g, n).contiguous()
    a = -torch.exp(p["a_log"].float())                        # (H,)

    # dt is rounded to x's dtype before the scan, as the reference does
    y, h_fin = ops.ssd_scan(xh, dt.to(xh.dtype), a.contiguous(), bm, cm)
    y = y + xh * p["d_skip"].float().reshape(1, 1, h, 1).to(y.dtype)
    y = y.reshape(bsz, s, di)
    gate = F.silu(z.float()).to(y.dtype)
    y = rms_norm(y * gate, p["norm_w"], eps=cfg.norm_eps)
    out = _mm(y, p["out_proj"])
    if not return_state:
        return out
    w = cfg.ssm_conv_width
    conv_in = torch.cat([xc_raw, bc_raw], dim=-1)
    conv_in = F.pad(conv_in, (0, 0, w - 1, 0))
    conv_state = conv_in[:, -(w - 1):].float()
    return out, conv_state, h_fin


def ssm_decode(cfg: ModelConfig, p: Dict, x: torch.Tensor,
               conv_state: torch.Tensor, ssm_state: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode: O(1) state update, no KV growth.  x (B, 1, D),
    conv_state (B, W-1, Di+2GN), ssm_state (B, H, P, N) float32.  Returns
    (y (B, 1, D), new conv_state, new ssm_state) as new tensors."""
    bsz = x.shape[0]
    di, g, n = cfg.ssm_inner, cfg.ssm_groups, cfg.ssm_state
    h, hd = cfg.ssm_heads, cfg.ssm_head_dim

    z = _mm(x, p["wz"])
    xc0 = _mm(x, p["wx"])[:, 0]
    bc0 = _mm(x, p["wbc"])[:, 0]
    dt = _mm(x, p["wdt"])[:, 0]

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
    rep = h // g
    bv = b_vec.reshape(bsz, g, n).repeat_interleave(rep, dim=1)  # (B, H, N)
    cv = c_vec.reshape(bsz, g, n).repeat_interleave(rep, dim=1)

    upd = (dt[..., None] * xh)[..., :, None] * bv[..., None, :]  # (B,H,P,N)
    new_state = decay[..., None, None] * ssm_state + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, cv)
    y = y + xh * p["d_skip"].float()[None, :, None]
    y = y.reshape(bsz, 1, di).to(x.dtype)

    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["norm_w"],
                 eps=cfg.norm_eps)
    out = _mm(y, p["out_proj"])
    return out, new_conv_state, new_state
