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

Under a mesh (DTensor inputs inside ``activation_sharding``) every engine
runs on each rank's local batch rows and q heads (``_engine_on_mesh``):
the whole key sequence and head_dim there, the kv heads its q heads read.
On the kernel route one query token over a cache sharded on its rows takes
the split-KV partials kernel on each rank's rows and combines the
all-gathered partials (``_decode_partials_on_mesh``); each rank writes the
new rows it owns (``write_rows``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import activation_sharding as act_sh
from repro_torch.models.activation_sharding import shard_act
from repro_torch.models.layers import _dense_init, apply_rope, matmul, rmsnorm, softcap

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


def attn_axes(cfg) -> dict:
    """Logical axes of ``attn_init``'s tree."""
    axes = {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }
    if cfg.qk_norm:
        axes["q_norm"] = ("head_dim",)
        axes["k_norm"] = ("head_dim",)
    return axes


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


def write_rows(cache_t: torch.Tensor, length: torch.Tensor, new: torch.Tensor) -> None:
    """Write ``new`` [B, Sq, KV, D] into ``cache_t`` [B, S, KV, D] at rows
    ``length .. length + Sq`` in place (``length`` a device tensor: no host
    read).  A cache sharded over its rows (a DTensor with ``Shard(1)``) is
    written by each rank into its own rows: ``new`` is redistributed to the
    cache's placements with the rows whole, and a rank owning none of the
    rows writes back what it holds."""
    if not act_sh.is_dtensor(cache_t):
        rows = length.to(torch.int64) + torch.arange(new.shape[1], device=new.device)
        cache_t.index_copy_(1, rows, new.to(cache_t.dtype))
        return
    from torch.distributed.tensor import Replicate

    whole_rows = tuple(Replicate() if getattr(p, "dim", None) == 1 else p
                       for p in cache_t.placements)
    new = new.to(cache_t.dtype).redistribute(cache_t.device_mesh, whole_rows).to_local()
    local = cache_t.to_local()
    off, n = act_sh.shard_offset(cache_t, 1)
    if n == 0:
        return
    start = length.to(torch.int64) - off  # the first new row in this shard's numbering
    sq = new.shape[1]
    if sq == 1:  # decode: one row; a rank that does not own it rewrites its clamped row
        row = start.clamp(0, n - 1).reshape(1)
        owned = (start >= 0) & (start < n)
        local.index_copy_(1, row, torch.where(owned, new, local.index_select(1, row)))
        return
    src = torch.arange(n, device=local.device) - start  # the new row each local row takes
    live = ((src >= 0) & (src < sq))[None, :, None, None]
    local.copy_(torch.where(live, new.index_select(1, src.clamp(0, sq - 1)), local))


def _kv_heads_for(h0: int, hl: int, g: int):
    """The kv heads a rank's q heads ``h0 .. h0 + hl`` read, as a function of
    k / v [B, S, KV, D] -> their local k / v (with the q heads' own group
    size, or one kv head a q head where the groups straddle shards)."""
    if h0 % g == 0 and hl % g == 0:
        return lambda t: t[:, :, h0 // g:(h0 + hl) // g]
    if g % hl == 0:
        return lambda t: t[:, :, h0 // g:h0 // g + 1]
    return lambda t: t.index_select(2, (h0 + torch.arange(hl, device=t.device)) // g)


def _engine_on_mesh(q, k, v, q_pos, kv_pos, *, causal, window, kv_len, cap, impl):
    """An engine on DTensors: each rank runs it on its local batch rows and q
    heads (the kernel's wrapper takes plain tensors; the plain engines'
    5-d einsums run there too).  On the kernel route, decode over a cache
    sharded on its rows takes the split-KV partials route
    (``_decode_partials_on_mesh``); every other call gets the whole key
    sequence and ``head_dim`` on every rank (a redistribute: an all-gather
    where they were sharded) and the kv heads its q heads read."""
    if impl == "kernel" and kv_len is not None and q.shape[1] == 1 and act_sh.sharded_dims(
            k.placements, 1):
        return _decode_partials_on_mesh(q, k, v, kv_len, window=window, cap=cap)
    from torch.distributed.tensor import Replicate
    from repro_torch.models.sharding import local_box, place_whole

    mesh = q.device_mesh
    h, kvh = q.shape[2], k.shape[2]
    q_pl = act_sh.placements("batch", None, "act_heads", None)
    head_dims = act_sh.sharded_dims(q_pl, 2)
    n_heads = math.prod(mesh.size(i) for i in head_dims)
    kv_pl, select = q_pl, None
    if head_dims and kvh % n_heads:  # q heads sharded, kv heads not: slice them per rank
        kv_pl = tuple(Replicate() if i in head_dims else p for i, p in enumerate(q_pl))
        shape, offset = local_box(q.shape, mesh, q_pl)
        select = _kv_heads_for(offset[2], shape[2], h // kvh)

    def local(ql, kl, vl, qpl, kpl, kvl):
        if select is not None:
            kl, vl = select(kl).contiguous(), select(vl).contiguous()
        return attention_engine(ql, kl, vl, qpl, kpl, causal=causal, window=window,
                                kv_len=kvl, cap=cap, impl=impl)

    # the positions (aranges: alike on every rank) follow q's and k's batch rows
    pos_pl = tuple(p if getattr(p, "dim", None) == 0 else Replicate() for p in q_pl)
    q_pos, kv_pos = (place_whole(t, mesh, pos_pl) for t in (q_pos, kv_pos))
    return act_sh.on_local_shards(local, q_pl, (q_pl, kv_pl, kv_pl, pos_pl, pos_pl, None),
                                  q, k, v, q_pos, kv_pos, kv_len)


def _decode_partials_on_mesh(q, k, v, kv_len, *, window, cap):
    """One query token over a cache sharded on its rows: each rank computes
    the split-KV partials (m, l, acc) over its own rows — its ``kv_len`` and
    window offset by its first row — the partials are all-gathered over the
    rows' mesh dims and combined (a shard with no live key gives m = -inf,
    l = 0 and adds nothing).  q takes the cache's batch and kv-head
    placements."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = k.device_mesh
    b, _, h, d = q.shape
    c_pl = k.placements
    to_q = {0: Shard(0), 2: Shard(2)}  # the cache's batch and kv-head shards
    q_pl = tuple(to_q.get(getattr(p, "dim", None), Replicate()) for p in c_pl)
    part_dim = {0: Shard(0), 2: Shard(1), 1: Shard(2)}  # -> [B, KV, ns, G(, D)]
    part_pl = tuple(part_dim.get(getattr(p, "dim", None), Replicate()) for p in c_pl)
    off, _ = act_sh.shard_offset(k, 1)
    # The model admits k > q - window with q = kv_len - 1; the kernel k > kv_len - w.
    w = None if window is None else window + 1

    def local(ql, kl, vl, kvl):
        kv_here = (kvl.reshape(1).to(torch.int64) - off).to(torch.int32)
        return da_ops.decode_attention_split(ql, kl, vl, kv_here, softcap=cap, window=w)

    m, l, acc = act_sh.on_local_shards(local, (part_pl,) * 3, (q_pl, c_pl, c_pl, None),
                                       q, k, v, kv_len)
    whole = tuple(Replicate() if getattr(p, "dim", None) == 2 else p for p in part_pl)
    m, l, acc = (t.redistribute(mesh, whole) for t in (m, l, acc))  # the all-gather
    return da_ref.combine_partials(m, l, acc).reshape(b, h, d)[:, None].to(q.dtype)


def attention_engine(q, k, v, q_pos, kv_pos, *, causal, window, kv_len, cap, impl="auto"):
    if act_sh.is_dtensor(q):
        return _engine_on_mesh(q, k, v, q_pos, kv_pos, causal=causal, window=window,
                               kv_len=kv_len, cap=cap, impl=impl)
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
    # Under a mesh the projections take head_dim whole (an all-gather of the
    # weights where the rules shard it) and their (heads x head_dim) columns
    # come out split by heads only: a DTensor view cannot split a column
    # sharded any other way into heads.  No-ops without a mesh.
    wq = shard_act(params["wq"].to(dt), "embed", "heads", None)
    wk = shard_act(params["wk"].to(dt), "embed", "kv_heads", None)
    wv = shard_act(params["wv"].to(dt), "embed", "kv_heads", None)
    pin = act_sh.pin
    q = shard_act(matmul(x, pin(wq.reshape(d, h * hd))), "batch", "act_seq", "act_heads")
    k = shard_act(matmul(src, pin(wk.reshape(d, kvh * hd))), "batch", "act_seq", "kv_heads")
    v = shard_act(matmul(src, pin(wv.reshape(d, kvh * hd))), "batch", "act_seq", "kv_heads")
    q, k, v = q.reshape(b, sq, h, hd), k.reshape(b, skv, kvh, hd), v.reshape(b, skv, kvh, hd)
    q = shard_act(q, "batch", "act_seq", "act_heads", None)
    k = shard_act(k, "batch", "act_seq", "kv_heads", None)
    v = shard_act(v, "batch", "act_seq", "kv_heads", None)
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
            write_rows(cache.k, cache.length, k)
            write_rows(cache.v, cache.length, v)
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
    out = shard_act(out, "batch", "act_seq", "act_heads", None)
    wo = shard_act(params["wo"].to(dt), "heads", None, "embed")
    out = matmul(act_sh.pin(out.reshape(b, sq, h * hd)), act_sh.pin(wo.reshape(h * hd, d)))
    return shard_act(out, "batch", "act_seq", "act_embed"), new_cache


def init_kv_cache(cfg, batch: int, max_len: int, dtype, device=None) -> KVCache:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=torch.zeros((), dtype=torch.int32, device=device))
