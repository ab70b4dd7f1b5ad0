"""Plain PyTorch twins of the Mamba-2 mixer's two kernels.

The mixer's elementwise work around the SSD (``repro/models/ssm.py``
``ssm_apply``: ``_causal_conv`` and the gate, softplus and gated norm
lines), as the port ran it before the kernels, moved here unchanged:

    ``front``      — the projection split into z / xBC / dt, the depthwise
                     causal conv of xBC + SiLU (``causal_conv``), SiLU(z)
                     and softplus(dt + dt_bias): the twin of
                     ``csrc/ssm_mixer.cu`` ``ssm_mixer_front_kernel``;
    ``gated_norm`` — the D skip ``y + x D`` and ``rmsnorm(y * gate)``: the
                     twin of ``ssm_mixer_gated_norm_kernel``.

The kernels round where this chain rounds (each product and partial sum of
the conv in the activation dtype, the norm's input three times), so the
CPU path, the model's plain engines (training differentiates through them)
and the card checks all run these.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.activation_sharding import pin
from repro_torch.models.layers import rmsnorm


def causal_conv(xbc, w, b, cache_tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv of width W; cache_tail holds the previous W-1 steps."""
    width = w.shape[0]
    if cache_tail is None:
        pad = torch.zeros(xbc.shape[:1] + (width - 1,) + xbc.shape[2:], dtype=xbc.dtype,
                          device=xbc.device)
    else:
        pad = cache_tail.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)  # [B, W-1+S, C]
    s = xbc.shape[1]
    wd = w.to(xbc.dtype)
    out = full[:, 0:s] * wd[0]
    for i in range(1, width):
        out = out + full[:, i:i + s] * wd[i]
    out = out + b.to(xbc.dtype)
    # a copy: a view of the tail would keep all of ``full`` alive with the cache
    new_tail = full[:, full.shape[1] - (width - 1):].clone()
    return F.silu(out), new_tail


def front(proj, conv_w, conv_b, dt_bias, d_inner: int, state_dim: int,
          cache_tail: Optional[torch.Tensor] = None):
    """proj [B, S, 2 di + 2 N + H] -> (xbc [B, S, di + 2 N] = SiLU(conv(xBC)),
    gate [B, S, di] = SiLU(z), both in proj's dtype; dt [B, S, H] f32 =
    softplus(dt_raw + dt_bias); the new conv tail [B, W-1, di + 2 N])."""
    di, n = d_inner, state_dim
    z, xbc, dt_raw = proj[..., :di], proj[..., di:2 * di + 2 * n], proj[..., 2 * di + 2 * n:]
    xbc, new_tail = causal_conv(xbc, conv_w, conv_b, cache_tail)
    dt = F.softplus(dt_raw.float() + dt_bias)
    return xbc, F.silu(z), dt, new_tail


def gated_norm(y, x_in, d_skip, gate, norm_w, eps: float):
    """y, x_in [B, S, H, P], d_skip [H], gate [B, S, H P] -> rmsnorm((y + x_in
    D) * gate, norm_w) [B, S, H P] in y's dtype."""
    bsz, seq, nh, p = y.shape
    y = y + x_in * d_skip.to(y.dtype)[None, None, :, None]
    y = pin(y.reshape(bsz, seq, nh * p))
    return rmsnorm(y * gate, norm_w, eps)

