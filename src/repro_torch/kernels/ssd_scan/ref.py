"""Plain PyTorch twins of the SSD kernels and the naive recurrence.

Port of ``repro/kernels/ssd_scan/kernel.py:ssd_intra_chunk`` (its function,
f32 math), of the inter-chunk scan that ``repro/kernels/ssd_scan/ops.py:
ssd_scan`` runs after it, and of ``repro/kernels/ssd_scan/ref.py:
reference_ssd``.  The
cumulative sum is ``torch.cumsum`` (the reference kernel's tril-ones matmul
sums in another order), and the decay ``exp(cum_i - cum_j)`` is masked to
``j <= i`` BEFORE the exponential: for ``j > i`` it overflows to inf, and
inf * 0 would be NaN.

``intra_chunk_bshp`` works in the model's layout — x ``[B, S, H, P]``, dt
``[B, S, H]``, a ``[B, H]`` and single-group B / C ``[B, S, N]`` shared by
the H heads — which is the layout the CUDA kernel reads; ``ssd_intra_chunk``
is the reference kernel's ``[BH, ...]`` layout over the same function.
``inter_chunk_bshp`` is the recurrence over chunks as a Python loop, the
twin of ``csrc/ssd_inter_chunk.cu``.  The CPU path of ``ops``, the model's
plain engines and the card checks run them.
"""

from __future__ import annotations

from typing import Optional

import torch


def intra_chunk_bshp(
    x: torch.Tensor,  # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H]
    a: torch.Tensor,  # [B, H]
    b: torch.Tensor,  # [B, S, N]
    c: torch.Tensor,  # [B, S, N]
    *,
    chunk: int,
    final_state: bool = True,
):
    """-> (y_intra [B, S, H, P] f32, s_contrib [B, H, nc', P, N] f32,
    cumexp [B, H, S] f32), nc' = nc, or nc - 1 without the last chunk's
    state (``final_state=False``)."""
    bsz, s, nh, p = x.shape
    n = b.shape[-1]
    nc = s // chunk
    xf = x.float().reshape(bsz, nc, chunk, nh, p)
    dtf = dt.float().reshape(bsz, nc, chunk, nh)
    bf = b.float().reshape(bsz, nc, chunk, n)
    cf = c.float().reshape(bsz, nc, chunk, n)
    cum = torch.cumsum(dtf * a.float()[:, None, None, :], dim=2)  # [B, nc, Q, H]
    cb = torch.einsum("bcin,bcjn->bcij", cf, bf)  # [B, nc, Qi, Qj]
    live = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B, nc, Qi, Qj, H]
    decay = torch.exp(torch.where(live[:, :, None], diff, -torch.inf))
    w = decay * cb[..., None] * dtf[:, :, None, :, :]
    y = torch.einsum("bcijh,bcjhp->bcihp", w, xf).reshape(bsz, s, nh, p)
    cumexp = torch.exp(cum).permute(0, 3, 1, 2).reshape(bsz, nh, s)
    kept = nc if final_state else nc - 1
    if kept == 0:  # one chunk and no final state: no state leaves a chunk
        return y, torch.zeros((bsz, nh, 0, p, n), dtype=torch.float32, device=x.device), cumexp
    tail = torch.exp(cum[:, :kept, -1:, :] - cum[:, :kept])  # [B, nc', Q, H]
    xw = xf[:, :kept] * (dtf[:, :kept] * tail)[..., None]
    s_contrib = torch.einsum("bcqhp,bcqn->bhcpn", xw, bf[:, :kept])
    return y, s_contrib, cumexp


def inter_chunk_bshp(y_intra, s_contrib, cumexp, c, h0, *, chunk: int,
                     final_state: bool = True):
    """The inter-chunk recurrence: h_{i+1} = h_i exp(cum_last_i) + S_i, and
    y_t += cumexp_t C_t . h_i for t in chunk i -> (y [B, S, H, P] f32,
    h_final [B, H, P, N] f32, or None without ``final_state``).  y_intra
    [B, S, H, P], s_contrib [B, H, nc', P, N], cumexp [B, H, S], c [B, S, N],
    h0 [B, H, P, N] or None; y_intra is not written."""
    bsz, seq, heads, p = y_intra.shape
    n = c.shape[-1]
    nc = seq // chunk
    ce = cumexp.reshape(bsz, heads, nc, chunk)
    h = None if h0 is None else h0.float()
    entering = []  # the state entering each chunk
    for i in range(nc):
        entering.append(h)
        if i < s_contrib.shape[2]:
            s_i = s_contrib[:, :, i]
            h = s_i if h is None else h * ce[:, :, i, -1, None, None] + s_i
    if any(e is not None for e in entering):
        zero = torch.zeros((bsz, heads, p, n), dtype=torch.float32, device=y_intra.device)
        hs = torch.stack([zero if e is None else e for e in entering], dim=2)  # [B, H, nc, P, N]
        cr = c.float().reshape(bsz, nc, chunk, n)
        y_inter = torch.einsum("bcqn,bhcpn,bhcq->bcqhp", cr, hs, ce)
        y_intra = y_intra + y_inter.reshape(bsz, seq, heads, p)
    if not final_state:
        return y_intra, None
    if h is None:
        h = torch.zeros((bsz, heads, p, n), dtype=torch.float32, device=y_intra.device)
    return y_intra, h


def ssd_intra_chunk(
    x: torch.Tensor,  # [BH, S, P]
    dt: torch.Tensor,  # [BH, S]
    a: torch.Tensor,  # [BH]
    b: torch.Tensor,  # [BH, S, N]
    c: torch.Tensor,  # [BH, S, N]
    *,
    chunk: int = 256,
):
    """The reference kernel's layout -> (y_intra [BH, S, P] f32,
    s_contrib [BH, nc, P, N] f32, cumexp [BH, S] f32)."""
    chunk = min(chunk, x.shape[1])
    y, s, ce = intra_chunk_bshp(x[:, :, None], dt[:, :, None], a[:, None], b, c, chunk=chunk)
    return y[:, :, 0], s[:, 0], ce[:, 0]


def reference_ssd(
    x: torch.Tensor,  # [BH, S, P]
    dt: torch.Tensor,  # [BH, S]
    a: torch.Tensor,  # [BH]
    b: torch.Tensor,  # [BH, S, N]
    c: torch.Tensor,  # [BH, S, N]
    h0: Optional[torch.Tensor] = None,  # [BH, P, N]
):
    """y_t = C_t . h_t;  h_t = h_{t-1} exp(a dt_t) + dt_t x_t B_t^T
    -> (y [BH, S, P] f32, h_final [BH, P, N] f32)."""
    bh, s, p = x.shape
    n = b.shape[-1]
    h = torch.zeros((bh, p, n), dtype=torch.float32, device=x.device) if h0 is None else h0.float()
    dtf, af = dt.float(), a.float()
    ys = []
    for t in range(s):
        decay = torch.exp(af * dtf[:, t])[:, None, None]
        h = h * decay + torch.einsum("bp,bn,b->bpn", x[:, t].float(), b[:, t].float(), dtf[:, t])
        ys.append(torch.einsum("bpn,bn->bp", h, c[:, t].float()))
    return torch.stack(ys, dim=1), h
