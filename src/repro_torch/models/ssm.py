"""Mamba-2 (SSD, arXiv:2405.21060) mixer (port of ``repro.models.ssm``).

Chunk-parallel state-space duality: the intra-chunk quadratic term and the
inter-chunk state recurrence.  ``ssd_chunked`` has two engines, chosen by
``cfg.attn_impl`` like the attention engines:

    kernel       — ``repro_torch.kernels.ssd_scan``: the hand-written CUDA
                   intra-chunk and inter-chunk kernels on the card (their
                   plain twins on the CPU);
    auto / dense / chunked — the kernels' plain twins (``ssd_scan/ref.py``:
                   the recurrence a PyTorch loop over chunks) on any device
                   (the reference's jnp closed form, which it runs under
                   every attention engine): the route training
                   differentiates through (the kernels have no backward),
                   and the oracle the card checks hold the kernels against.

``ssd_step`` (decode, one token) stays plain PyTorch: no TPU kernel
computes it.  Single-group (G=1) B/C as in mamba2-370m; the state cache for
decode is (conv_tail [B, W-1, conv_channels], h [B, H, P, N]).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.models.activation_sharding import (is_dtensor, on_local_shards, pin,
                                                      placements, shard_act)
from repro_torch.models.layers import _dense_init, matmul, rmsnorm


class SSMCache(NamedTuple):
    conv: torch.Tensor  # [B, W-1, di + 2N]
    h: torch.Tensor  # [B, H, P, N]


def ssm_init(gen: torch.Generator, cfg) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.num_heads(d)
    n = s.state_dim
    conv_ch = di + 2 * n
    dev = gen.device
    u = torch.rand((nh,), generator=gen, device=dev)
    dt = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min)) + math.log(s.dt_min))
    dt_bias = dt + torch.log(-torch.expm1(-dt))  # inverse softplus
    return {
        "in_proj": _dense_init(gen, (d, 2 * di + 2 * n + nh)),
        "conv_w": _dense_init(gen, (s.conv_width, conv_ch), in_axis=0),
        "conv_b": torch.zeros((conv_ch,), dtype=torch.float32, device=dev),
        "A_log": torch.log(torch.arange(1, nh + 1, dtype=torch.float32, device=dev)),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "dt_bias": dt_bias.float(),
        "norm_w": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": _dense_init(gen, (di, d)),
    }


def ssm_axes() -> dict:
    """Logical axes of ``ssm_init``'s tree."""
    return {
        "in_proj": ("embed", "ssm_inner"),
        "conv_w": ("conv", "ssm_inner"),
        "conv_b": ("ssm_inner",),
        "A_log": ("ssm_heads",),
        "D": ("ssm_heads",),
        "dt_bias": ("ssm_heads",),
        "norm_w": ("ssm_inner",),
        "out_proj": ("ssm_inner", "embed"),
    }


def ssm_cache_axes() -> SSMCache:
    return SSMCache(conv=("batch", None, "ssm_inner"), h=("batch", "ssm_heads", None, "state"))


def _split_proj(cfg, proj: torch.Tensor):
    s = cfg.ssm
    d = cfg.d_model
    di, n = s.d_inner(d), s.state_dim
    return proj[..., :di], proj[..., di:2 * di + 2 * n], proj[..., 2 * di + 2 * n:]


def _causal_conv(xbc, w, b, cache_tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv of width W; cache_tail holds the previous W-1 steps."""
    width = w.shape[0]
    if cache_tail is None:
        pad = torch.zeros(xbc.shape[:1] + (width - 1,) + xbc.shape[2:], dtype=xbc.dtype,
                          device=xbc.device)
    else:
        pad = cache_tail.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)  # [B, W-1+S, C]
    s = xbc.shape[1]
    wd = w.to(xbc.dtype)
    out = full[:, 0:s] * wd[0]
    for i in range(1, width):
        out = out + full[:, i:i + s] * wd[i]
    out = out + b.to(xbc.dtype)
    # a copy: a view of the tail would keep all of ``full`` alive with the cache
    new_tail = full[:, full.shape[1] - (width - 1):].clone()
    return F.silu(out), new_tail


def ssd_chunked(
    x: torch.Tensor,  # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H]  (post-softplus, f32)
    a: torch.Tensor,  # [H]  (negative)
    b_mat: torch.Tensor,  # [B, S, N]
    c_mat: torch.Tensor,  # [B, S, N]
    h0: Optional[torch.Tensor] = None,  # [B, H, P, N]
    chunk: int = 256,
    impl: str = "auto",
    final_state: bool = True,
):
    """Chunk-parallel SSD -> (y [B, S, H, P] in x's dtype, h_final [B, H, P, N]
    f32, or None when ``final_state`` is False)."""
    s = x.shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"chunk {chunk} does not divide the sequence length {s}")
    if is_dtensor(x):  # each rank: its batch rows and SSM heads, either engine
        x_pl = placements("batch", None, "ssm_heads", None)
        h_pl = placements("batch", "ssm_heads", None, None)
        bn = placements("batch", None, None)

        def local(xl, dtl, al, bl, cl, hl):
            return ssd_chunked(xl, dtl, al, bl, cl, hl, chunk=chunk, impl=impl,
                               final_state=final_state)

        return on_local_shards(
            local, (x_pl, h_pl if final_state else None),
            (x_pl, placements("batch", None, "ssm_heads"), placements("ssm_heads"), bn, bn,
             None if h0 is None else h_pl), x, dt, a, b_mat, c_mat, h0)
    a_bh = a.float()[None, :].expand(x.shape[0], a.shape[0])  # batch stride 0
    kw = dict(chunk=chunk, final_state=final_state)
    if impl == "kernel":
        y, h = ssd_ops.ssd_bshp(x, dt.float(), a_bh, b_mat, c_mat, h0, **kw)
    elif impl in ("auto", "dense", "chunked"):  # the twins on any device: never a kernel
        y, h = ssd_ref.inter_chunk_bshp(
            *ssd_ref.intra_chunk_bshp(x, dt.float(), a_bh, b_mat, c_mat, **kw), c_mat, h0, **kw)
    else:
        raise NotImplementedError(f"SSD engine {impl!r}: the port runs 'auto', 'dense', "
                                  "'chunked' and 'kernel'")
    return y.to(x.dtype), h


def ssd_step(x, dt, a, b_vec, c_vec, h):
    """Single decode step of the recurrence: x [B, H, P], dt [B, H], a [H],
    b_vec / c_vec [B, N], h [B, H, P, N] -> (y [B, H, P], h_new); under a
    mesh on each rank's batch rows and SSM heads."""
    if is_dtensor(x):
        x_pl, h_pl = placements("batch", "ssm_heads", None), placements("batch", "ssm_heads",
                                                                         None, None)
        bn = placements("batch", None)
        return on_local_shards(ssd_step, (x_pl, h_pl),
                               (x_pl, placements("batch", "ssm_heads"), placements("ssm_heads"),
                                bn, bn, h_pl), x, dt, a, b_vec, c_vec, h)
    dtf = dt.float()
    decay = torch.exp(dtf * a)  # [B, H]
    h_new = h * decay[:, :, None, None] + torch.einsum(
        "bhp,bn,bh->bhpn", x.float(), b_vec.float(), dtf)
    y = torch.einsum("bhpn,bn->bhp", h_new, c_vec.float())
    return y.to(x.dtype), h_new


def ssm_apply(params: dict, cfg, x: torch.Tensor, cache: Optional[SSMCache] = None,
              update_cache: bool = False):
    """Full Mamba-2 mixer -> (y [B, S, d], new_cache).  Without a cache the
    final state is not computed (nothing would read it)."""
    s_cfg = cfg.ssm
    d = cfg.d_model
    di, n, nh = s_cfg.d_inner(d), s_cfg.state_dim, s_cfg.num_heads(d)
    p = s_cfg.head_dim
    dt_in = x.dtype
    bsz, seq, _ = x.shape

    proj = shard_act(matmul(x, params["in_proj"].to(dt_in)), "batch", "act_seq", "ssm_inner")
    z, xbc, dt_raw = _split_proj(cfg, proj)
    conv_tail = cache.conv if cache is not None else None
    xbc, new_tail = _causal_conv(xbc, params["conv_w"], params["conv_b"], conv_tail)
    x_in = xbc[..., :di].reshape(bsz, seq, nh, p)
    b_mat, c_mat = xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    a = -torch.exp(params["A_log"])
    # z is a view of the projection: its gate now, so the projection is freed
    # before the SSD (a prefill's largest activation; the values are the same)
    gate = F.silu(z)
    del proj, z, dt_raw

    h0 = cache.h if cache is not None else None
    if seq == 1 and cache is not None:
        y1, h_new = ssd_step(x_in[:, 0], dt[:, 0], a, b_mat[:, 0], c_mat[:, 0], h0)
        y = y1[:, None]
    else:
        y, h_new = ssd_chunked(x_in, dt, a, b_mat, c_mat, h0, chunk=s_cfg.chunk_size,
                               impl=cfg.attn_impl, final_state=cache is not None)
    y = y + x_in * params["D"].to(dt_in)[None, None, :, None]
    del xbc, x_in, b_mat, c_mat  # the conv output, before the norm's f32 passes
    y = pin(y.reshape(bsz, seq, di))
    y = rmsnorm(y * gate, params["norm_w"], cfg.rmsnorm_eps)
    out = shard_act(matmul(y, params["out_proj"].to(dt_in)), "batch", "act_seq", "act_embed")

    new_cache = cache
    if cache is not None and update_cache:
        new_cache = SSMCache(conv=new_tail.to(cache.conv.dtype), h=h_new)
    return out, new_cache


def init_ssm_cache(cfg, batch: int, dtype, device=None) -> SSMCache:
    s = cfg.ssm
    d = cfg.d_model
    di, n, nh = s.d_inner(d), s.state_dim, s.num_heads(d)
    return SSMCache(
        conv=torch.zeros((batch, s.conv_width - 1, di + 2 * n), dtype=dtype, device=device),
        h=torch.zeros((batch, nh, s.head_dim, n), dtype=torch.float32, device=device),
    )
