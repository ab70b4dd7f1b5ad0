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

The mixer's elementwise work on each side of the SSD — the causal conv +
SiLU, the gate and dt's softplus before it, the D skip and the gated RMSNorm
after it — goes the same way: under the kernel engine through
``repro_torch.kernels.ssm_mixer.ops`` (two hand-written CUDA kernels on the
card, their twins on the CPU), under the plain engines through the twins
themselves (``ssm_mixer/ref.py``, the eager chain).

``ssd_step`` (decode, one token) stays plain PyTorch: no TPU kernel
computes it.  Single-group (G=1) B/C as in mamba2-370m; the state cache for
decode is (conv_tail [B, W-1, conv_channels], h [B, H, P, N]).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.kernels.ssm_mixer import ops as mixer_ops
from repro_torch.kernels.ssm_mixer import ref as mixer_ref
from repro_torch.models.activation_sharding import (is_dtensor, on_local_shards, placements,
                                                      shard_act)
from repro_torch.models.layers import _dense_init, matmul


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
    conv_tail = cache.conv if cache is not None else None
    keep_tail = cache is not None and update_cache
    xbc, gate, dt, new_tail = _front(params, cfg, proj, conv_tail, keep_tail)
    # the projection is freed before the SSD (a prefill's largest activation)
    del proj
    x_in = xbc[..., :di].reshape(bsz, seq, nh, p)
    b_mat, c_mat = xbc[..., di:di + n], xbc[..., di + n:]
    a = -torch.exp(params["A_log"])

    h0 = cache.h if cache is not None else None
    if seq == 1 and cache is not None:
        y1, h_new = ssd_step(x_in[:, 0], dt[:, 0], a, b_mat[:, 0], c_mat[:, 0], h0)
        y = y1[:, None]
    else:
        y, h_new = ssd_chunked(x_in, dt, a, b_mat, c_mat, h0, chunk=s_cfg.chunk_size,
                               impl=cfg.attn_impl, final_state=cache is not None)
    del b_mat, c_mat, dt
    y = _gated_norm(params, cfg, y, xbc, gate)
    del xbc, x_in, gate  # the conv output and the gate, before the out-projection
    out = shard_act(matmul(y, params["out_proj"].to(dt_in)), "batch", "act_seq", "act_embed")

    new_cache = cache
    if keep_tail:
        new_cache = SSMCache(conv=new_tail.to(cache.conv.dtype), h=h_new)
    return out, new_cache


def _front(params: dict, cfg, proj, conv_tail, keep_tail: bool):
    """The mixer's front -> (xbc, gate, dt, the new conv tail or None):
    ``mixer_ops.front`` under the kernel engine (on a mesh on each rank's
    batch rows, the projection's channels gathered whole), else its twin."""
    s_cfg = cfg.ssm
    di, n = s_cfg.d_inner(cfg.d_model), s_cfg.state_dim
    w, b, dt_bias = params["conv_w"], params["conv_b"], params["dt_bias"]
    if cfg.attn_impl != "kernel":
        xbc, gate, dt, tail = mixer_ref.front(proj, w, b, dt_bias, di, n, conv_tail)
        return xbc, gate, dt, tail if keep_tail else None

    def local(pl, wl, bl, dbl, tl):
        return mixer_ops.front(pl, wl, bl, dbl, d_inner=di, state_dim=n, cache_tail=tl,
                               new_tail=keep_tail)

    if not is_dtensor(proj):
        return local(proj, w, b, dt_bias, conv_tail)
    rows = placements("batch", None, None)
    return on_local_shards(
        local, (rows, rows, rows, rows if keep_tail else None),
        (rows, placements(None, None), placements(None), placements(None),
         None if conv_tail is None else rows), proj, w, b, dt_bias, conv_tail)


def _gated_norm(params: dict, cfg, y, xbc, gate):
    """The D skip and the gated RMSNorm -> [B, S, di]: ``mixer_ops.gated_norm``
    under the kernel engine (on a mesh on each rank's batch rows, the rows
    whole), else its twin."""
    bsz, seq, nh, p = y.shape
    di = nh * p
    d_skip, norm_w, eps = params["D"], params["norm_w"], cfg.rmsnorm_eps
    if cfg.attn_impl != "kernel":
        return mixer_ref.gated_norm(y, xbc[..., :di].reshape(y.shape), d_skip, gate, norm_w, eps)

    def local(yl, xl, dl, gl, wl):
        return mixer_ops.gated_norm(yl, xl[..., :di].reshape(yl.shape), dl, gl, wl, eps)

    if not is_dtensor(y):
        return local(y, xbc, d_skip, gate, norm_w)
    rows = placements("batch", None, None)
    return on_local_shards(
        local, rows, (placements("batch", None, None, None), rows, placements(None), rows,
                      placements(None)), y, xbc, d_skip, gate, norm_w)


def init_ssm_cache(cfg, batch: int, dtype, device=None) -> SSMCache:
    s = cfg.ssm
    d = cfg.d_model
    di, n, nh = s.d_inner(d), s.state_dim, s.num_heads(d)
    return SSMCache(
        conv=torch.zeros((batch, s.conv_width - 1, di + 2 * n), dtype=dtype, device=device),
        h=torch.zeros((batch, nh, s.head_dim, n), dtype=torch.float32, device=device),
    )
