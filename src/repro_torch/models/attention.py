"""GQA attention with RoPE, qk-norm, logit softcap and causal / sliding-window
/ non-causal masks (port of ``repro.models.attention``, no KV cache yet).

Score engines:
    dense   — materializes [.., Sq, Skv] scores (the reference's "dense");
    kernel  — ``repro_torch.kernels.flash_attention``: the hand-written CUDA
              kernel on the card, its plain twin on the CPU (the reference's
              "pallas").

``cfg.attn_impl``: "auto" (dense here: the reference's chunked engine for
long sequences, the KV cache and ``init_kv_cache`` come with the decode
slice) | "dense" | "kernel".
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import _dense_init, apply_rope, rmsnorm, softcap


def attn_init(gen: torch.Generator, cfg) -> dict:
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


def attention_engine(q, k, v, q_pos, kv_pos, *, causal, window, kv_len, cap, impl="auto"):
    if impl == "kernel":
        # The kernel derives positions itself: queries sit at the end of the
        # valid cache (q_base = kv_len - Sq), which is how attn_apply builds
        # q_pos / kv_pos (contiguous aranges).
        return fa_ops.flash_attention(
            q, k, v, kv_len, causal=causal, window=window,
            logit_softcap=cap, q_offset_from_kv_len=True,
        )
    if impl not in ("auto", "dense"):
        raise NotImplementedError(
            f"attention engine {impl!r}: the port runs 'dense' and 'kernel' (the "
            "chunked engine waits for the model-zoo slice)"
        )
    return _dense_engine(q, k, v, q_pos, kv_pos, causal, window, kv_len, cap)


def attn_apply(
    params: dict,
    cfg,
    x: torch.Tensor,  # [B, Sq, d]
    positions: torch.Tensor,  # [B, Sq]
    mixer: str,  # "global" | "local"
    causal: bool = True,
) -> torch.Tensor:
    """Self-attention without a cache -> [B, Sq, d].  Projections run in x's
    dtype; a weight already stored in that dtype is used as it is."""
    dt = x.dtype
    b, sq, d = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ params["wq"].to(dt).reshape(d, h * hd)).reshape(b, sq, h, hd)
    k = (x @ params["wk"].to(dt).reshape(d, kvh * hd)).reshape(b, sq, kvh, hd)
    v = (x @ params["wv"].to(dt).reshape(d, kvh * hd)).reshape(b, sq, kvh, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"], cfg.rmsnorm_eps)
        k = rmsnorm(k, params["k_norm"], cfg.rmsnorm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    window = cfg.sliding_window if mixer == "local" else None
    kv_pos = torch.arange(sq, device=x.device)[None, :].expand(b, sq)
    out = attention_engine(
        q, k, v, positions, kv_pos, causal=causal, window=window, kv_len=None,
        cap=cfg.attn_logit_softcap, impl=cfg.attn_impl,
    )
    return out.reshape(b, sq, h * hd) @ params["wo"].to(dt).reshape(h * hd, d)
