"""Wrappers: one query token over a KV cache through the split-KV kernel.

``decode_attention_partials`` keeps the reference's signature
(``repro/kernels/decode_attention/kernel.py``: q ``[BKV, G, D]``, k / v
``[BKV, Skv, D]``); ``decode_attention`` is the ``[B, 1, H, D]`` /
``[B, Skv, KV, D]`` wrapper the model's decode route calls, with the
logsumexp combine (``ref.combine_partials``) in PyTorch, as the reference
combines in jnp.  They route by the device of their tensors: on the CPU the
partials come from the plain PyTorch twin (``ref.py``); on a CUDA tensor the
hand-written kernel launches or the call raises — it never falls back and
reads no environment switch.  On the card the kernel reads the cache in its
``[B, S, KV, D]`` layout in place.

The query sits at position ``kv_len`` and attends to keys ``< kv_len`` and,
under a window, ``> kv_len - window``: the reference kernel's convention.
A model whose new token is already in the cache at ``kv_len - 1`` and
whose window admits ``k > q - window`` passes ``window + 1``.

``num_splits=None`` picks ``default_num_splits``: at least the reference's
8, doubled while the (b * kv, split) blocks are fewer than four per SM of
an H100 (132 SMs) and a split keeps at least 64 keys; the reference's rule
(halve until it divides Skv) applies to any count.

``LAUNCHES`` counts kernel launches and ``PLAIN_CALLS`` plain-path calls
(``reset_counts`` zeroes both).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention import kernel, ref

KERNEL = "decode_attention_partials"
LAUNCHES = {KERNEL: 0}
PLAIN_CALLS = {KERNEL: 0}
DTYPES = (torch.float32, torch.bfloat16)
FILL_BLOCKS = 4 * 132
MIN_SPLIT_KEYS = 64


def reset_counts() -> None:
    LAUNCHES[KERNEL] = 0
    PLAIN_CALLS[KERNEL] = 0


def default_num_splits(bkv: int, skv: int) -> int:
    ns = 8
    while bkv * ns < FILL_BLOCKS and skv // (2 * ns) >= MIN_SPLIT_KEYS:
        ns *= 2
    return ns


def _check_kv_len(kv_len, dev) -> torch.Tensor:
    if kv_len.device != dev:
        raise ValueError(f"kv_len is on {kv_len.device}, q on {dev}")
    if kv_len.dtype != torch.int32 or kv_len.numel() != 1:
        raise TypeError(f"kv_len must be one int32, got {kv_len.dtype} {tuple(kv_len.shape)}")
    return kv_len.reshape(1)


def cache_partials(q, k, v, kv_len, ns, softcap, window):
    """The kernel's partials over a cache read in place (CUDA tensors only):
    q [BKV, G, D] contiguous, k / v [B, Skv, KV, D] with a unit innermost
    stride, ``ns`` splits -> (m, l, acc) as ``decode_attention_partials``."""
    bkv, g, d = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"cache_partials launches the CUDA kernel; q is on {q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"decode attention takes {DTYPES}, got {q.dtype}")
    if not kernel.supports(g, d):
        raise ValueError(f"the kernel takes head_dim a multiple of 16 up to 256 and at most 8 "
                         f"query rows per kv head with G * D <= 512; got G {g}, D {d}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    for name, t in (("k", k), ("v", v)):
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(s % 2 for s in t.stride()[:3]):
            raise ValueError(f"{name} needs a unit innermost stride and aligned rows")
    dev = q.device
    m = torch.empty((bkv, ns, g), dtype=torch.float32, device=dev)
    l = torch.empty((bkv, ns, g), dtype=torch.float32, device=dev)
    acc = torch.empty((bkv, ns, g, d), dtype=torch.float32, device=dev)
    kernel.launch(q, k, v, kv_len, m, l, acc, softcap=softcap, window=window)
    LAUNCHES[KERNEL] += 1
    return m, l, acc


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
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape or k.shape[0] != q.shape[0] or (
            k.shape[2] != q.shape[2]):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} do not "
                         "fit [BKV, G, D] / [BKV, Skv, D]")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, q has {q.dtype}")
    kv_len = _check_kv_len(kv_len, q.device)
    kw = dict(softcap=softcap, window=window)
    if q.device.type == "cpu":
        PLAIN_CALLS[KERNEL] += 1
        return ref.decode_attention_partials(q, k, v, kv_len, num_splits=num_splits, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"decode attention runs on cpu or cuda, not {q.device}")
    ns = ref.split_count(k.shape[1], num_splits)
    return cache_partials(q, k[:, :, None], v[:, :, None], kv_len, ns, **kw)


def decode_attention(
    q: torch.Tensor,  # [B, 1, H, D]
    k: torch.Tensor,  # [B, Skv, KV, D]
    v: torch.Tensor,  # [B, Skv, KV, D]
    kv_len: torch.Tensor,  # [1] int32 (tokens the query attends to)
    *,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    num_splits: Optional[int] = None,
) -> torch.Tensor:
    """One query token per batch row -> [B, 1, H, D] in q's dtype (f32 math)."""
    if q.ndim != 4 or q.shape[1] != 1 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention takes q [B, 1, H, D] and k, v [B, Skv, KV, D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % kvh:
        raise ValueError(f"k {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, q has {q.dtype}")
    kv_len = _check_kv_len(kv_len, q.device)
    g = h // kvh
    ns = ref.split_count(skv, default_num_splits(b * kvh, skv) if num_splits is None
                         else num_splits)
    qm = q.reshape(b * kvh, g, d)
    kw = dict(softcap=softcap, window=window)
    if q.device.type == "cpu":
        PLAIN_CALLS[KERNEL] += 1
        km = k.transpose(1, 2).reshape(b * kvh, skv, d)
        vm = v.transpose(1, 2).reshape(b * kvh, skv, d)
        m, l, acc = ref.decode_attention_partials(qm, km, vm, kv_len, num_splits=ns, **kw)
    elif q.device.type == "cuda":
        m, l, acc = cache_partials(qm.contiguous(), k, v, kv_len, ns, **kw)
    else:
        raise ValueError(f"decode attention runs on cpu or cuda, not {q.device}")
    return ref.combine_partials(m, l, acc).reshape(b, 1, h, d).to(q.dtype)
