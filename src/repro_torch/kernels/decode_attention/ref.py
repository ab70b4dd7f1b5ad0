"""Plain PyTorch twins of the decode kernels, the combine and an oracle.

Port of ``repro/kernels/decode_attention/kernel.py:decode_attention_partials``
(its function, f32 math), ``ops.py:combine_partials`` and
``ref.py:reference_decode``; ``decode_attention_fused`` is the twin of the
fused kernel: the same partials over its splits of the LIVE keys
(``live_split_bounds``), then the combine.  One query token per (batch, kv head) group
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


def live_split_bounds(kv_len: int, skv: int, ns: int, window: Optional[int]) -> list:
    """The fused kernel's ``ns`` shares of the ``L`` live keys ``[lo, hi)``:
    ``[lo + floor(i*L/ns), lo + floor((i+1)*L/ns))`` with ``hi = min(kv_len,
    Skv)`` and ``lo = kv_len - window + 1`` (0 with no window).  The shares
    differ by at most one key; one is empty only when ``L < ns``."""
    hi = min(kv_len, skv)
    lo = 0 if window is None else max(0, kv_len - window + 1)
    live = max(hi - lo, 0)
    return [(lo + i * live // ns, lo + (i + 1) * live // ns) for i in range(ns)]


def live_partials(
    q: torch.Tensor,  # [BKV, G, D]
    k: torch.Tensor,  # [BKV, Skv, D]
    v: torch.Tensor,  # [BKV, Skv, D]
    kv_len: torch.Tensor,  # [1] int32
    *,
    num_splits: int,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
):
    """Partials over ``live_split_bounds`` -> (m [BKV, ns, G], l [BKV, ns, G],
    acc [BKV, ns, G, D]), f32; an empty share gives (-1e30, 0, 0)."""
    d = q.shape[2]
    skv = k.shape[1]
    s = torch.einsum("bgd,bkd->bgk", q.float(), k.float()) * (1.0 / math.sqrt(d))
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    bounds = torch.tensor(live_split_bounds(int(kv_len.reshape(-1)[0]), skv, num_splits, window),
                          device=q.device)
    pos = torch.arange(skv, device=q.device)
    ok = ((pos >= bounds[:, :1]) & (pos < bounds[:, 1:]))[None, :, None, :]  # [1, ns, 1, Skv]
    s = torch.where(ok, s[:, None], NEG_INF)  # [BKV, ns, G, Skv]
    m = s.amax(dim=-1)
    p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
    return m, p.sum(dim=-1), torch.einsum("bngk,bkd->bngd", p, v.float())


def decode_attention_fused(
    q: torch.Tensor,  # [B, 1, H, D]
    k: torch.Tensor,  # [B, Skv, KV, D]
    v: torch.Tensor,  # [B, Skv, KV, D]
    kv_len: torch.Tensor,  # [1] int32
    *,
    num_splits: int,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """The fused kernel's function -> [B, 1, H, D] in q's dtype."""
    b, _, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    qm = q.reshape(b * kvh, h // kvh, d)
    km, vm = (t.transpose(1, 2).reshape(b * kvh, skv, d) for t in (k, v))
    m, l, acc = live_partials(qm, km, vm, kv_len, num_splits=num_splits, softcap=softcap,
                              window=window)
    return combine_partials(m, l, acc).reshape(b, 1, h, d).to(q.dtype)


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
