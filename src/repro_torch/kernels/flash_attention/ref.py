"""Plain PyTorch twin of the flash-attention kernel (naive softmax(QK^T)V).

Port of ``repro/kernels/flash_attention/ref.py:reference_bhsd``: the same
masking (kv_len, causal, window, ``q_offset_from_kv_len``), f32 math, the
same ``l`` clamp (a row with no live key returns 0) and the output in q's
dtype.  The CPU path of ``ops.flash_attention`` and the card checks run it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def reference_bhsd(
    q: torch.Tensor,  # [BH, Sq, D]
    k: torch.Tensor,  # [BKV, Skv, D]
    v: torch.Tensor,  # [BKV, Skv, D]
    kv_len: torch.Tensor,  # [1] int32
    *,
    num_q_heads: int,
    num_kv_heads: int,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset_from_kv_len: bool = False,
) -> torch.Tensor:
    bh, sq, d = q.shape
    skv = k.shape[1]
    qpk = num_q_heads // num_kv_heads
    b = bh // num_q_heads
    k_e = k.reshape(b, num_kv_heads, skv, d).repeat_interleave(qpk, dim=1).reshape(bh, skv, d)
    v_e = v.reshape(b, num_kv_heads, skv, d).repeat_interleave(qpk, dim=1).reshape(bh, skv, d)
    s = torch.einsum("hqd,hkd->hqk", q.float(), k_e.float())
    s = s / math.sqrt(d)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    kl = kv_len.reshape(-1)[0].to(torch.int64)
    q_pos = torch.arange(sq, device=q.device)
    if q_offset_from_kv_len:
        q_pos = kl - sq + q_pos
    k_pos = torch.arange(skv, device=q.device)
    ok = (k_pos[None, :] < kl).expand(sq, skv)
    if causal:
        ok = ok & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        ok = ok & (k_pos[None, :] > q_pos[:, None] - window)
    s = torch.where(ok[None], s, -torch.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m)
    p = torch.where(ok[None], p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("hqk,hkd->hqd", p, v_e.float())
    out = out / torch.clamp_min(l, 1e-20)
    return out.to(q.dtype)
