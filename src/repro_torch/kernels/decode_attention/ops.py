"""Wrappers: one query token over a KV cache through the decode kernels.

``decode_attention`` is the ``[B, 1, H, D]`` / ``[B, Skv, KV, D]`` wrapper
the model's decode route calls: on the card ONE launch of the fused kernel
(``csrc/decode_attention_fused.cu``) splits the live keys over a cluster of
``num_splits <= 8`` blocks per (b, kv head) and merges them on chip, with
no PyTorch combine.  ``decode_attention_partials`` keeps the reference's
signature (``repro/kernels/decode_attention/kernel.py``: q ``[BKV, G, D]``,
k / v ``[BKV, Skv, D]``, splits over Skv, f32 partials out) on the partials
kernel, and ``decode_attention_split`` (the mesh decode's route over a
cache sharded on its rows) gives its partials over a ``[B, S, KV, D]``
cache.  The partials kernel runs in the form ``kernel.partials_route``
names: "tc" (bf16 at D 64 / 80 / 128 / 256, on the fused kernel's
tensor-core body) or "simt" (``csrc/decode_attention.cu``), each taking
every group of G <= 8 rows.  They route by the device of their
tensors: on the CPU the plain PyTorch twins (``ref.py``) run; on a CUDA
tensor the kernel launches or the call raises — it never falls back and
reads no environment switch.  The kernels have no backward pass: an input
that requires grad under grad mode is refused (``kernels.autograd``).  On the card the kernels read the cache in its
``[B, S, KV, D]`` layout in place.

The query sits at position ``kv_len`` and attends to keys ``< kv_len`` and,
under a window, ``> kv_len - window``: the reference kernel's convention.
A model whose new token is already in the cache at ``kv_len - 1`` and
whose window admits ``k > q - window`` passes ``window + 1``.

``decode_attention``'s ``num_splits=None`` picks ``fused_num_splits``: 8,
halved while a split would cover fewer than ``MIN_SPLIT_KEYS`` cache rows
or the (b * kv, split) blocks would outnumber what the 132 SMs of an H100
hold at once in the kernel's form (one a SM for the tensor-core form's
ring, 108 KB at D 128 and 203 KB at D 256, two for the simt form): at the
qwen3 decode shape, B 8 x KV 8, that is 2 splits for bf16 and 4 for f32,
the fastest on the card.
``default_num_splits`` is the partials kernel's count over the cache
length: at least the reference's 8, doubled while the blocks are fewer
than the SMs of an H100 (132) hold at once in the kernel's form — four a
SM in the simt form, two in the tc form (its 104 KB ring at D 128) — and a
split keeps at least 64 keys: at the qwen3 decode shape 8 splits in bf16
(the fastest of 4 / 8 / 16 / 32 on the card) and 16 in f32; the
reference's rule (halve until it divides Skv) applies to any count.

From ``SPLIT_FROM`` keys a fused block at the cluster's cap
(``decode_route``: a long cache over few (b, kv head) pairs, e.g. 524,288
keys at batch 1) ``decode_attention`` takes the "split" route instead: the
partials kernel's tc form over ``default_num_splits`` splits of the cache,
then ``ref.combine_partials`` — the fused kernel's cluster holds at most
``kernel.MAX_SPLITS`` blocks a (b, kv head), which leaves most SMs idle
there.  ``num_splits`` given keeps the fused route.

``LAUNCHES`` counts kernel launches and ``PLAIN_CALLS`` plain-path calls,
one key per kernel, ``ROUTES`` the mesh-free decode's card calls by route:
the fused kernel's launches by form ("tc" or "simt", ``kernel.fused_route``)
and "split"; ``PARTIAL_ROUTES`` counts the partials kernel's launches
(``kernel.partials_route``); ``reset_counts`` zeroes all four.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.autograd import refuse_grad
from repro_torch.kernels.decode_attention import kernel, ref

KERNEL = "decode_attention_partials"
FUSED = "decode_attention_fused"
LAUNCHES = {KERNEL: 0, FUSED: 0}
PLAIN_CALLS = {KERNEL: 0, FUSED: 0}
ROUTES = dict.fromkeys(kernel.FORMS + ("split",), 0)
PARTIAL_ROUTES = dict.fromkeys(kernel.FORMS, 0)
DTYPES = (torch.float32, torch.bfloat16)
SMS = 132  # streaming multiprocessors of an H100 SXM
FILL_BLOCKS = 4 * SMS  # the partials' simt form: blocks the SMs hold at once
TC_FILL_BLOCKS = 2 * SMS  # ... and its tc form
MIN_SPLIT_KEYS = 64
# Keys one block of the fused route would read (the live keys' bound known on
# the host — the cache length, or the window — over ``fused_num_splits``),
# from which ``decode_attention`` takes the split route where the fused
# cluster is at its cap: the split route ran 0.98x (hymba, G 5 D 64) and
# 0.84x (gemma2's global layer, D 256) the fused time at 8,192 keys a block
# and 1.31x / 1.02x at 4,096 (H100, tools/long_decode_timings.py, PERF.md §6).
SPLIT_FROM = 8192


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS, ROUTES, PARTIAL_ROUTES):
        for name in counts:
            counts[name] = 0


def default_num_splits(bkv: int, skv: int, route: str = "simt") -> int:
    fill = FILL_BLOCKS if route == "simt" else TC_FILL_BLOCKS
    ns = 8
    while bkv * ns < fill and skv // (2 * ns) >= MIN_SPLIT_KEYS:
        ns *= 2
    return ns


def fused_num_splits(bkv: int, skv: int, route: str) -> int:
    per_sm = 1 if route == "tc" else 2  # blocks an SM its shared memory leaves room for
    ns = kernel.MAX_SPLITS
    while ns > 1 and (skv < ns * MIN_SPLIT_KEYS or bkv * ns > per_sm * SMS):
        ns //= 2
    return ns


def decode_route(dtype: torch.dtype, d: int, bkv: int, skv: int, window: Optional[int]) -> str:
    """The mesh-free decode's route: "split" (the partials kernel's tc form
    at ``default_num_splits``, then the PyTorch combine) where the fused
    kernel's tc form runs its cluster at the cap of ``kernel.MAX_SPLITS``
    blocks per (b, kv head) — too few (b, kv head) pairs to fill the SMs —
    and each block would read ``SPLIT_FROM`` keys or more; else "fused"
    (which fills the card at qwen3's B 16 over 32,768 keys: one block a
    pair, 0.93x the split route's time).  It reads only host values:
    ``skv`` and ``window`` bound the live keys."""
    if kernel.fused_route(dtype, d) != "tc" or kernel.partials_route(dtype, d) != "tc":
        return "fused"
    ns = fused_num_splits(bkv, skv, "tc")
    live = skv if window is None else min(skv, window)
    return "split" if ns == kernel.MAX_SPLITS and live // ns >= SPLIT_FROM else "fused"


def _check_kv_len(kv_len, dev) -> torch.Tensor:
    if kv_len.device != dev:
        raise ValueError(f"kv_len is on {kv_len.device}, q on {dev}")
    if kv_len.dtype != torch.int32 or kv_len.numel() != 1:
        raise TypeError(f"kv_len must be one int32, got {kv_len.dtype} {tuple(kv_len.shape)}")
    return kv_len.reshape(1)


def _check_cache(k, v, row_align: Optional[int] = None) -> None:
    """Unit innermost stride, a 16-byte aligned base and rows whose strides
    keep ``row_align`` elements (default: 16 bytes) aligned."""
    align = row_align or 16 // k.element_size()
    for name, t in (("k", k), ("v", v)):
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(s % align for s in t.stride()[:3]):
            raise ValueError(f"{name} needs a unit innermost stride and aligned rows")


def cache_partials(q, k, v, kv_len, ns, softcap, window):
    """The kernel's partials over a cache read in place (CUDA tensors only):
    q [BKV, G, D] contiguous, k / v [B, Skv, KV, D] with a unit innermost
    stride, ``ns`` splits -> (m, l, acc) as ``decode_attention_partials``,
    in the form ``kernel.partials_route`` names."""
    refuse_grad(KERNEL, q, k, v)
    bkv, g, d = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"cache_partials launches the CUDA kernel; q is on {q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"decode attention takes {DTYPES}, got {q.dtype}")
    if not kernel.supports_partials(g, d, q.dtype):
        raise ValueError(f"the partials kernel takes head_dim a multiple of 16 up to 256 and "
                         f"at most 8 query rows per kv head; got G {g}, D {d}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    form = kernel.partials_route(q.dtype, d)
    if form == "tc" and (bkv > 65535 or (softcap is not None and not softcap > 0)):
        raise ValueError(f"the partials kernel's tc form takes at most 65535 (batch, kv head) "
                         f"groups and a positive softcap; got {bkv} groups, softcap {softcap}")
    _check_cache(k, v, row_align=None if form == "tc" else 2)  # tc: 16-byte cp.async rows
    dev = q.device
    m = torch.empty((bkv, ns, g), dtype=torch.float32, device=dev)
    l = torch.empty((bkv, ns, g), dtype=torch.float32, device=dev)
    acc = torch.empty((bkv, ns, g, d), dtype=torch.float32, device=dev)
    kernel.launch(q, k, v, kv_len, m, l, acc, softcap=softcap, window=window)
    LAUNCHES[KERNEL] += 1
    PARTIAL_ROUTES[form] += 1
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
    refuse_grad(KERNEL, q, k, v)
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


def decode_attention_split(
    q: torch.Tensor,  # [B, 1, H, D]
    k: torch.Tensor,  # [B, Skv, KV, D]
    v: torch.Tensor,  # [B, Skv, KV, D]
    kv_len: torch.Tensor,  # [1] int32; may be <= 0 or > Skv
    *,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    num_splits: Optional[int] = None,
):
    """The partials of one query token per batch row over a cache in its
    ``[B, S, KV, D]`` layout -> (m [B, KV, ns, G], l [B, KV, ns, G], acc
    [B, KV, ns, G, D]), f32: on the card the partials kernel reading the
    cache in place (``cache_partials``), on the CPU its twin.  A ``kv_len``
    past the cache's end admits every row (and bounds the window); one at or
    below 0 admits none.  ``num_splits=None`` picks ``default_num_splits`` for
    the form ``kernel.partials_route`` names, on either device."""
    b, _, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qm = q.reshape(b * kvh, g, d).contiguous()
    route = kernel.partials_route(q.dtype, d)
    ns = ref.split_count(skv, default_num_splits(b * kvh, skv, route) if num_splits is None
                         else num_splits)
    kw = dict(softcap=softcap, window=window)
    if q.device.type == "cpu":
        km, vm = (t.transpose(1, 2).reshape(b * kvh, skv, d) for t in (k, v))
        m, l, acc = decode_attention_partials(qm, km, vm, kv_len, num_splits=ns, **kw)
    else:
        m, l, acc = cache_partials(qm, k, v, _check_kv_len(kv_len, q.device), ns, **kw)
    return m.reshape(b, kvh, ns, g), l.reshape(b, kvh, ns, g), acc.reshape(b, kvh, ns, g, d)


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
    refuse_grad(FUSED, q, k, v)
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
    if num_splits is None and decode_route(q.dtype, d, b * kvh, skv, window) == "split":
        m, l, acc = decode_attention_split(q, k, v, kv_len, softcap=softcap, window=window)
        if q.device.type == "cuda":
            ROUTES["split"] += 1
        return ref.combine_partials(m, l, acc).reshape(b, 1, h, d).to(q.dtype)
    route = kernel.fused_route(q.dtype, d)
    ns = fused_num_splits(b * kvh, skv, route) if num_splits is None else num_splits
    if not 1 <= ns <= kernel.MAX_SPLITS:
        raise ValueError(f"the fused route takes 1 to {kernel.MAX_SPLITS} splits (one cluster "
                         f"per kv head), got {ns}")
    kw = dict(num_splits=ns, softcap=softcap, window=window)
    if q.device.type == "cpu":
        PLAIN_CALLS[FUSED] += 1
        return ref.decode_attention_fused(q, k, v, kv_len, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"decode attention runs on cpu or cuda, not {q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"decode attention takes {DTYPES}, got {q.dtype}")
    if not kernel.supports_fused(g, d, q.dtype):
        raise ValueError(f"the fused kernel takes head_dim a multiple of 16 up to 256 and at "
                         f"most 8 query rows per kv head, within {kernel.FUSED_VALUES} query "
                         f"values a thread in its simt form (G * D <= 512 in bf16); got G "
                         f"{g}, D {d}")
    if b * kvh > 65535:
        raise ValueError(f"the fused kernel takes at most 65535 (batch, kv head) groups, "
                         f"got {b * kvh}")
    _check_cache(k, v)
    qm = q.reshape(b * kvh, g, d).contiguous()
    out = torch.empty_like(qm)
    kernel.launch_fused(qm, k, v, kv_len, out, **kw)
    LAUNCHES[FUSED] += 1
    ROUTES[route] += 1
    return out.reshape(b, 1, h, d)
