"""GQA attention with RoPE, qk-norm, logit softcap, causal / sliding-window
/ non-causal (encoder, cross) masks and a KV cache (port of
``repro.models.attention``).

Score engines:
    dense   — materializes [.., Sq, Skv] scores (the reference's "dense");
    chunked — a loop over query blocks, each against the whole K / V with
              f32 scores (the reference's memory-efficient "chunked"
              engine): peak scores memory [B, H, cq, Skv] instead of
              [B, H, Sq, Skv]; under autograd each block is recomputed in
              the backward pass (``torch.utils.checkpoint``, the
              reference's ``jax.checkpoint(q_block)``), so its softmax
              residuals are never all alive at once;
    kernel  — the hand-written CUDA kernels on the card, their plain twins on
              the CPU (the reference's "pallas"): one query token over a
              cache (``Sq == 1``) goes to ``kernels/decode_attention``, any
              other call to ``kernels/flash_attention``.  The kernels have
              no backward: their wrappers refuse inputs that require grad.

``cfg.attn_impl``: "auto" (dense below ``CHUNK_THRESHOLD`` = Sq * Skv,
chunked from it, as the reference) | "dense" | "chunked" | "kernel".
``ENGINE_CALLS`` counts the calls of each plain engine (a block recomputed
in the backward pass counts again), so a run can show which one it took.

Cross-attention (``attn_apply(..., xk=enc_out)``, the encoder-decoder's
decoder blocks) takes K and V from ``xk``, applies no RoPE on either side,
reads and writes no cache and masks nothing: on the kernel route a
non-causal flash call with ``kv_len=None`` (``Sq != Skv``), at decode too.

The cache branch writes the new K/V rows into ``cache.k`` / ``cache.v`` at
``cache.length`` IN PLACE (``index_copy_`` at a device-side index: no host
read) and returns a ``KVCache`` over the same tensors with the new length;
the reference returns updated copies.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import _dense_init, apply_rope, rmsnorm, softcap

CHUNK_THRESHOLD = 2048 * 2048  # Sq * Skv from which "auto" takes the chunked engine
DEFAULT_Q_CHUNK = 256
ENGINE_CALLS = {"dense": 0, "chunked": 0}


def reset_counts() -> None:
    for name in ENGINE_CALLS:
        ENGINE_CALLS[name] = 0


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, S_max, KV, D]
    v: torch.Tensor  # [B, S_max, KV, D]
    length: torch.Tensor  # [] int32 — tokens already in cache


def attn_init(gen: torch.Generator, cfg) -> dict:
    """Projections (and qk-norm weights); a cross-attention's are the same."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    params = {
        "wq": _dense_init(gen, (d, h, hd)),
        "wk": _dense_init(gen, (d, kv, hd)),
        "wv": _dense_init(gen, (d, kv, hd)),
        "wo": _dense_init(gen, (h, hd, d), in_axis=(0, 1)),
    }
    if cfg.qk_norm:
        params["q_norm"] = torch.ones((hd,), dtype=torch.float32, device=gen.device)
        params["k_norm"] = torch.ones((hd,), dtype=torch.float32, device=gen.device)
    return params


def _block_bias(
    q_pos: torch.Tensor,  # [B, cq]
    kv_pos: torch.Tensor,  # [B, ckv]
    causal: bool,
    window: Optional[int],
    kv_len: Optional[torch.Tensor],  # [] valid cache length, or None
) -> torch.Tensor:
    """Additive bias [B, cq, ckv] from position blocks."""
    q = q_pos[:, :, None]
    k = kv_pos[:, None, :]
    ok = torch.ones((q_pos.shape[0], q_pos.shape[1], kv_pos.shape[1]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok = ok & (k <= q)
    if window is not None:
        ok = ok & (k > q - window)
    if kv_len is not None:
        ok = ok & (k < kv_len)
    return torch.where(ok, 0.0, -torch.inf)


def _dense_engine(q, k, v, q_pos, kv_pos, causal, window, kv_len, cap):
    ENGINE_CALLS["dense"] += 1
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float()
    scores = softcap(scores / math.sqrt(d), cap)
    bias = _block_bias(q_pos, kv_pos, causal, window, kv_len)
    scores = scores + bias[:, None, None, :, :]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, h, d)


def _q_block(qb, qpb, k, v, kv_pos, causal, window, kv_len, cap, scale):
    """One query block [B, cq, KV, G, D] against the whole K / V -> its
    output [B, cq, KV, G, D] in q's dtype; a row with no live key is 0."""
    ENGINE_CALLS["chunked"] += 1
    s = torch.einsum("bqkgd,bskd->bkgqs", qb, k).float()
    s = softcap(s * scale, cap)
    bias = _block_bias(qpb, kv_pos, causal, window, kv_len)
    s = s + bias[:, None, None, :, :]  # [B, KV, G, cq, Skv]
    m = torch.amax(s, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m)
    p = torch.where(torch.isfinite(s), p, 0.0)
    l = torch.sum(p, dim=-1, keepdim=True)
    pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(qb.dtype), v)
    out = pv.float() / torch.clamp(l, min=1e-20)
    return torch.movedim(out, 3, 1).to(qb.dtype)  # [B, cq, KV, G, D]


def _chunked_engine(q, k, v, q_pos, kv_pos, causal, window, kv_len, cap,
                    q_chunk: int = DEFAULT_Q_CHUNK):
    """Query blocks of ``q_chunk`` rows (the largest divisor of Sq up to it:
    a vision prefix makes Sq no power of two), each against the whole K / V.
    Only the query axis is blocked.  The causal upper triangle is computed
    and then masked, as in the reference."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    cq = min(q_chunk, sq)
    while sq % cq:
        cq -= 1
    scale = 1.0 / math.sqrt(d)
    qr = q.reshape(b, sq // cq, cq, kvh, h // kvh, d)
    qp = q_pos.reshape(b, sq // cq, cq)
    remat = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    outs = []
    for i in range(sq // cq):
        args = (qr[:, i], qp[:, i], k, v, kv_pos, causal, window, kv_len, cap, scale)
        outs.append(checkpoint(_q_block, *args, use_reentrant=False) if remat
                    else _q_block(*args))
    return torch.stack(outs, dim=1).reshape(b, sq, h, d)


def attention_engine(q, k, v, q_pos, kv_pos, *, causal, window, kv_len, cap, impl="auto"):
    if impl == "kernel":
        if kv_len is not None and q.shape[1] == 1:
            # One query token over the cache, already written at q = kv_len - 1.
            # The decode kernel admits k < kv_len and, under a window w,
            # k > kv_len - w; the model admits k > q - window = kv_len - 1 -
            # window, so the kernel gets w = window + 1.
            kl = kv_len.reshape(1).to(torch.int32)
            return da_ops.decode_attention(
                q, k, v, kl, softcap=cap, window=None if window is None else window + 1)
        # The kernel derives positions itself: queries sit at the end of the
        # valid cache (q_base = kv_len - Sq), which is how attn_apply builds
        # q_pos / kv_pos (contiguous aranges).  Cross-attention (Sq != Skv,
        # kv_len None) is neither causal nor windowed, so the offset the
        # kernels derive there (Skv - Sq) bounds no key.
        return fa_ops.flash_attention(
            q, k, v, None if kv_len is None else kv_len.reshape(1).to(torch.int32),
            causal=causal, window=window, logit_softcap=cap, q_offset_from_kv_len=True,
        )
    if impl not in ("auto", "dense", "chunked"):
        raise NotImplementedError(f"attention engine {impl!r}: the port runs 'auto', 'dense', "
                                  "'chunked' and 'kernel'")
    sq, skv = q.shape[1], k.shape[1]
    if impl == "chunked" or (impl == "auto" and sq > 1 and sq * skv >= CHUNK_THRESHOLD):
        return _chunked_engine(q, k, v, q_pos, kv_pos, causal, window, kv_len, cap)
    return _dense_engine(q, k, v, q_pos, kv_pos, causal, window, kv_len, cap)


def attn_apply(
    params: dict,
    cfg,
    x: torch.Tensor,  # [B, Sq, d]
    positions: torch.Tensor,  # [B, Sq]
    mixer: str,  # "global" | "local"
    cache: Optional[KVCache] = None,
    update_cache: bool = False,
    causal: bool = True,
    xk: Optional[torch.Tensor] = None,  # cross-attention source [B, Skv, d]
):
    """Self- or cross-attention -> (out [B, Sq, d], new_cache).  Projections
    run in x's dtype; a weight already stored in that dtype is used as it is."""
    dt = x.dtype
    b, sq, d = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    is_cross = xk is not None
    src = xk if is_cross else x
    skv = src.shape[1]
    q = (x @ params["wq"].to(dt).reshape(d, h * hd)).reshape(b, sq, h, hd)
    k = (src @ params["wk"].to(dt).reshape(d, kvh * hd)).reshape(b, skv, kvh, hd)
    v = (src @ params["wv"].to(dt).reshape(d, kvh * hd)).reshape(b, skv, kvh, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"], cfg.rmsnorm_eps)
        k = rmsnorm(k, params["k_norm"], cfg.rmsnorm_eps)
    if not is_cross:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    window = cfg.sliding_window if mixer == "local" else None
    kw = dict(window=window, cap=cfg.attn_logit_softcap, impl=cfg.attn_impl)
    new_cache = cache
    if cache is not None and not is_cross:
        if update_cache:
            rows = cache.length.to(torch.int64) + torch.arange(sq, device=x.device)
            cache.k.index_copy_(1, rows, k.to(cache.k.dtype))
            cache.v.index_copy_(1, rows, v.to(cache.v.dtype))
            new_cache = KVCache(cache.k, cache.v, cache.length + sq)
        k_all, v_all = new_cache.k.to(dt), new_cache.v.to(dt)
        s_max = k_all.shape[1]
        kv_pos = torch.arange(s_max, device=x.device)[None, :].expand(b, s_max)
        out = attention_engine(q, k_all, v_all, positions, kv_pos, causal=causal,
                               kv_len=new_cache.length, **kw)
    else:
        kv_pos = torch.arange(skv, device=x.device)[None, :].expand(b, skv)
        out = attention_engine(q, k, v, positions, kv_pos, causal=causal and not is_cross,
                               kv_len=None, **kw)
    out = out.reshape(b, sq, h * hd) @ params["wo"].to(dt).reshape(h * hd, d)
    return out, new_cache


def init_kv_cache(cfg, batch: int, max_len: int, dtype, device=None) -> KVCache:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=torch.zeros((), dtype=torch.int32, device=device))
