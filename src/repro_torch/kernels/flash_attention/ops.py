"""Wrapper: [B, S, H, D] attention through the flash-attention kernel.

``flash_attention`` keeps the reference's signature
(``repro/kernels/flash_attention/ops.py``).  It routes by the device of its
tensors: on the CPU it runs the plain PyTorch twin (``ref.py``); on a CUDA
tensor it launches the hand-written kernel that ``kernel.route`` names from
the dtype and shape — "tc" (wgmma + TMA) for bf16 blocks of >= 64 query
rows at D 64 / 80 / 128 / 256; at D 64 / 128 for shorter bf16 blocks
"split" (the keys over a cluster of blocks) where at most 8 query rows a kv
head meet more than 64 keys, such as a cross-attention's one query at a
decode step, else "short" (mma.sync, one 16-row tile a warp), such as the
cascade's 8 tokens; "simt" for f32 and the rest — or raises: it never
falls back, to another kernel or to the twin, and reads no environment
switch.  The kernels have no backward pass: an input that requires grad
under grad mode is refused (``kernels.autograd``), on either device.  The
four kernels read the [B, S, H, D] layout in place, so the card path makes
no transposed copies.

``LAUNCHES`` counts kernel launches, ``ROUTES`` them by kernel and
``PLAIN_CALLS`` plain-path calls, so a run can show that its main path went
through the kernel it should (``reset_counts`` zeroes all three).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.autograd import refuse_grad
from repro_torch.kernels.flash_attention import kernel, ref

KERNEL = "flash_attention"
LAUNCHES = {KERNEL: 0}
PLAIN_CALLS = {KERNEL: 0}
ROUTES = dict.fromkeys(kernel.ROUTE_NAMES, 0)
DTYPES = (torch.float32, torch.bfloat16)


def reset_counts() -> None:
    LAUNCHES[KERNEL] = 0
    PLAIN_CALLS[KERNEL] = 0
    for r in ROUTES:
        ROUTES[r] = 0


def plain_bshd(q, k, v, kv_len, *, causal, window, logit_softcap, q_offset_from_kv_len,
               num_splits=None):
    """The plain twin in the [B, S, H, D] layout (not counted); with
    ``num_splits``, the split kernel's twin (``ref.split_bhsd``) over that
    many shares of the live keys."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if kv_len is None:
        kv_len = torch.tensor([skv], dtype=torch.int32, device=q.device)
    kw = dict(num_q_heads=h, num_kv_heads=kvh, causal=causal, window=window,
              softcap=logit_softcap, q_offset_from_kv_len=q_offset_from_kv_len)
    twin = ref.reference_bhsd
    if num_splits is not None:
        twin, kw["num_splits"] = ref.split_bhsd, num_splits
    out = twin(
        q.transpose(1, 2).reshape(b * h, sq, d),
        k.transpose(1, 2).reshape(b * kvh, skv, d),
        v.transpose(1, 2).reshape(b * kvh, skv, d),
        kv_len, **kw,
    )
    return out.reshape(b, h, sq, d).transpose(1, 2)


def _check(q, k, v, kv_len) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes q [B, Sq, H, D] and k, v [B, Skv, KV, D]")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, q has {q.dtype}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention takes {DTYPES}, got {q.dtype}")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"{h} query heads do not group over {k.shape[2]} kv heads")
    if kv_len is not None:
        if kv_len.device != q.device:
            raise ValueError(f"kv_len is on {kv_len.device}, q on {q.device}")
        if kv_len.dtype != torch.int32 or kv_len.numel() != 1:
            raise TypeError(f"kv_len must be one int32, got {kv_len.dtype} {tuple(kv_len.shape)}")


def flash_attention(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Skv, KV, D]
    v: torch.Tensor,  # [B, Skv, KV, D]
    kv_len: Optional[torch.Tensor] = None,  # int32 [1] (or []); None means Skv
    *,
    causal: bool = True,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    q_offset_from_kv_len: bool = False,
) -> torch.Tensor:
    """GQA attention -> [B, Sq, H, D] in q's dtype (f32 math inside)."""
    refuse_grad(KERNEL, q, k, v)
    _check(q, k, v, kv_len)
    if kv_len is not None:
        kv_len = kv_len.reshape(1)
    kw = dict(causal=causal, window=window, logit_softcap=logit_softcap,
              q_offset_from_kv_len=q_offset_from_kv_len)
    dev = q.device
    if dev.type == "cpu":
        PLAIN_CALLS[KERNEL] += 1
        return plain_bshd(q, k, v, kv_len, **kw)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {dev}")
    d = q.shape[3]
    if d % 16 or d > kernel.MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes head_dim a multiple of 16 up to "
                         f"{kernel.MAX_HEAD_DIM}, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    out = torch.empty_like(q)
    kind = kernel.route(q.dtype, q.shape[1], d, q.shape[2] // k.shape[2], k.shape[1])
    kernel.launch(q, k, v, kv_len, out, causal=causal, window=window,
                  softcap=logit_softcap, q_offset_from_kv_len=q_offset_from_kv_len, kind=kind)
    LAUNCHES[KERNEL] += 1
    ROUTES[kind] += 1
    return out
