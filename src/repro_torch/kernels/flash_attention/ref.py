"""Plain PyTorch twins of the flash-attention kernels (naive softmax(QK^T)V).

``reference_bhsd`` ports ``repro/kernels/flash_attention/ref.py:reference_bhsd``:
the same masking (kv_len, causal, window, ``q_offset_from_kv_len``), f32
math, the same ``l`` clamp (a row with no live key returns 0) and the output
in q's dtype.  The CPU path of ``ops.flash_attention`` and the card checks
run it.  ``split_bhsd`` is the split kernel's algebra
(``csrc/flash_attention_split.cu``): per-share partials (m, l, acc) over
``split_bounds``, the shares of the union of the rows' live keys, then the
decode kernels' combine; the tests hold it against the reference and the
card checks hold the split kernel against it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.decode_attention.ref import NEG_INF, combine_partials


def _live(sq, skv, kl, device, *, causal, window, q_offset_from_kv_len):
    """[Sq, Skv] bool: key j is live for query token i (the kernels' mask)."""
    q_pos = torch.arange(sq, device=device)
    if q_offset_from_kv_len:
        q_pos = kl - sq + q_pos
    k_pos = torch.arange(skv, device=device)
    ok = (k_pos[None, :] < kl).expand(sq, skv)
    if causal:
        ok = ok & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        ok = ok & (k_pos[None, :] > q_pos[:, None] - window)
    return ok


def split_bounds(kv_len: int, skv: int, sq: int, num_splits: int, *, causal: bool,
                 window: Optional[int], q_offset_from_kv_len: bool) -> list:
    """The split kernel's ``num_splits`` shares ``[lo + floor(i*L/ns), lo +
    floor((i+1)*L/ns))`` of ``[lo, hi)``, the union of the rows' live keys:
    ``lo`` the first query token's lowest live key, ``hi`` one past the last
    token's highest (both grow with the token), ``L = max(hi - lo, 0)``."""
    hi_all = min(kv_len, skv)
    off = kv_len - sq if q_offset_from_kv_len else 0
    lo = 0 if window is None else max(0, off - window + 1)
    hi = min(hi_all, off + sq) if causal else hi_all
    live = max(hi - lo, 0)
    return [(lo + i * live // num_splits, lo + (i + 1) * live // num_splits)
            for i in range(num_splits)]


def split_bhsd(
    q: torch.Tensor,  # [BH, Sq, D]
    k: torch.Tensor,  # [BKV, Skv, D]
    v: torch.Tensor,  # [BKV, Skv, D]
    kv_len: torch.Tensor,  # [1] int32
    *,
    num_q_heads: int,
    num_kv_heads: int,
    num_splits: int,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset_from_kv_len: bool = False,
) -> torch.Tensor:
    """The split kernel's function -> [BH, Sq, D] in q's dtype: partials
    over each share of ``split_bounds`` (an empty one gives m = -1e30, l =
    0, acc = 0), then ``combine_partials``; a row with no live key is 0."""
    bh, sq, d = q.shape
    skv = k.shape[1]
    qpk = num_q_heads // num_kv_heads
    b = bh // num_q_heads
    k_e = k.reshape(b, num_kv_heads, skv, d).repeat_interleave(qpk, dim=1).reshape(bh, skv, d)
    v_e = v.reshape(b, num_kv_heads, skv, d).repeat_interleave(qpk, dim=1).reshape(bh, skv, d)
    s = torch.einsum("hqd,hkd->hqk", q.float(), k_e.float()) / math.sqrt(d)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    kl = int(kv_len.reshape(-1)[0])
    ok = _live(sq, skv, kl, q.device, causal=causal, window=window,
               q_offset_from_kv_len=q_offset_from_kv_len)
    bounds = torch.tensor(split_bounds(kl, skv, sq, num_splits, causal=causal, window=window,
                                       q_offset_from_kv_len=q_offset_from_kv_len),
                          device=q.device)
    pos = torch.arange(skv, device=q.device)
    share = (pos >= bounds[:, :1]) & (pos < bounds[:, 1:])  # [ns, Skv]
    live = ok[None] & share[:, None]  # [ns, Sq, Skv]
    s = torch.where(live[None], s[:, None], NEG_INF)  # [BH, ns, Sq, Skv]
    m = s.amax(dim=-1)
    p = torch.where(live[None], torch.exp(s - m[..., None]), 0.0)
    acc = torch.einsum("hnqk,hkd->hnqd", p, v_e.float())
    return combine_partials(m, p.sum(dim=-1), acc).to(q.dtype)


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
    ok = _live(sq, skv, kv_len.reshape(-1)[0].to(torch.int64), q.device, causal=causal,
               window=window, q_offset_from_kv_len=q_offset_from_kv_len)
    s = torch.where(ok[None], s, -torch.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m)
    p = torch.where(ok[None], p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("hqk,hkd->hqd", p, v_e.float())
    out = out / torch.clamp_min(l, 1e-20)
    return out.to(q.dtype)
