"""Plain PyTorch twin of the split-KV decode kernel, the combine and an oracle.

Port of ``repro/kernels/decode_attention/kernel.py:decode_attention_partials``
(its function, f32 math), ``ops.py:combine_partials`` and
``ref.py:reference_decode``.  One query token per (batch, kv head) group
sits at position ``kv_len`` and attends to the keys ``k_pos < kv_len``
(and ``k_pos > kv_len - window`` under a window), so the TPU kernel's
partials for a split with no live key are ``m = NEG_INF``, ``l = 0``,
``acc = 0``, and ``kv_len = 0`` combines to 0, not NaN.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30  # the reference kernel's mask value (kernel.py:21)


def split_count(skv: int, num_splits: int) -> int:
    """The reference's rule: halve ``num_splits`` until it divides Skv."""
    while skv % num_splits:
        num_splits //= 2
    return num_splits


def decode_attention_partials(
    q: torch.Tensor,  # [BKV, G, D]
    k: torch.Tensor,  # [BKV, Skv, D]
    v: torch.Tensor,  # [BKV, Skv, D]
    kv_len: torch.Tensor,  # [1] int32
    *,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    num_splits: int = 8,
):
    """-> (m [BKV, ns, G] f32, l [BKV, ns, G] f32, acc [BKV, ns, G, D] f32)."""
    bkv, g, d = q.shape
    skv = k.shape[1]
    ns = split_count(skv, num_splits)
    ck = skv // ns
    kf = k.float().reshape(bkv, ns, ck, d)
    vf = v.float().reshape(bkv, ns, ck, d)
    s = torch.einsum("bgd,bnkd->bngk", q.float(), kf) * (1.0 / math.sqrt(d))
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    kl = kv_len.reshape(-1)[0].to(torch.int64)
    k_pos = torch.arange(skv, device=q.device).reshape(ns, 1, ck)
    ok = k_pos < kl
    if window is not None:
        ok = ok & (k_pos > kl - window)
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(dim=-1)  # [BKV, ns, G]
    p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bngk,bnkd->bngd", p, vf)
    return m, l, acc


def combine_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """Merge split partials: [.., ns, G], [.., ns, G], [.., ns, G, D] -> [.., G, D]."""
    m_g = m.amax(dim=-2, keepdim=True)
    w = torch.exp(m - m_g)
    l_g = (l * w).sum(dim=-2)
    num = (acc * w[..., None]).sum(dim=-3)
    return num / torch.clamp_min(l_g, 1e-20)[..., None]


def reference_decode(
    q: torch.Tensor,  # [B, 1, H, D]
    k: torch.Tensor,  # [B, Skv, KV, D]
    v: torch.Tensor,  # [B, Skv, KV, D]
    kv_len: torch.Tensor,  # [1] int32
    *,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Single-token softmax over the whole live cache -> [B, 1, H, D] in q's dtype."""
    b, _, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    qg = q[:, 0].reshape(b, kvh, h // kvh, d)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) / math.sqrt(d)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    kl = kv_len.reshape(-1)[0].to(torch.int64)
    pos = torch.arange(skv, device=q.device)
    ok = pos < kl
    if window is not None:
        ok = ok & (pos > kl - window)
    p = torch.softmax(torch.where(ok, s, -torch.inf), dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return out.reshape(b, 1, h, d).to(q.dtype)
