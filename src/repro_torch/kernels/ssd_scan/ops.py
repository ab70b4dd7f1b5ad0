"""Wrappers: the Mamba-2 SSD scan through the hand-written kernels.

``intra_chunk`` computes the intra-chunk term in the model's layout (x
``[B, S, H, P]``, dt ``[B, S, H]``, a ``[B, H]``, single-group B / C
``[B, S, N]``); ``inter_chunk`` runs the recurrence over chunks (the
reference's jnp scan, ``repro/kernels/ssd_scan/ops.py``); ``ssd_bshp`` is
the two in turn and is the model's route; ``ssd_scan`` keeps the
reference's ``[BH, S, P]`` signature over the same two steps.  They route
by the device of their tensors: on the CPU each runs its plain PyTorch twin
(``ref.py``); on a CUDA tensor a hand-written kernel launches or the call
raises: it never falls back and reads no environment switch.  The
intra-chunk kernel is the one ``kernel.route`` names — "tc" (bf16 on the
tensor cores: the mamba2 and hymba prefills' chunks of 256, state dims 128
and 16), "packed" (chunks of 4 to 32: the cascade's 8 tokens) or "simt"
(f32 and the other shapes); the inter-chunk kernel
(``csrc/ssd_inter_chunk.cu``) takes every shape the intra-chunk kernels
give it with N <= 128, and adds into y_intra in place.  Where no state
enters any chunk (one chunk, no h0) the term is zero and y is y_intra:
nothing launches.  The kernels have no backward pass: an input that
requires grad under grad mode is refused (``kernels.autograd``).  The
kernels read strided views, so the model passes x, B and C as slices of
its projection and B / C with no H-fold copy.

``LAUNCHES`` counts kernel launches by kernel, ``ROUTES`` the intra-chunk
launches by route, and ``PLAIN_CALLS`` plain-path calls, so a run can show
that its main path went through the kernels (``reset_counts`` zeroes them).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.autograd import refuse_grad
from repro_torch.kernels.ssd_scan import kernel, ref

KERNEL = "ssd_intra_chunk"
INTER = "ssd_inter_chunk"
LAUNCHES = {KERNEL: 0, INTER: 0}
ROUTES = {"tc": 0, "simt": 0, "packed": 0}  # the intra-chunk kernel's
PLAIN_CALLS = {KERNEL: 0, INTER: 0}
DTYPES = (torch.float32, torch.bfloat16)


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS, ROUTES):
        for k in counts:
            counts[k] = 0


def _check(x, dt, a, b, c, chunk) -> None:
    if x.ndim != 4 or dt.ndim != 3 or a.ndim != 2 or b.ndim != 3 or c.ndim != 3:
        raise ValueError("intra_chunk takes x [B, S, H, P], dt [B, S, H], a [B, H], "
                         "b and c [B, S, N]")
    bsz, seq, heads, _ = x.shape
    if tuple(dt.shape) != (bsz, seq, heads) or tuple(a.shape) != (bsz, heads):
        raise ValueError(f"dt {tuple(dt.shape)} / a {tuple(a.shape)} do not fit x {tuple(x.shape)}")
    if b.shape != c.shape or tuple(b.shape[:2]) != (bsz, seq):
        raise ValueError(f"b {tuple(b.shape)} / c {tuple(c.shape)} do not fit x {tuple(x.shape)}")
    if chunk <= 0 or seq % chunk:
        raise ValueError(f"chunk {chunk} does not divide the sequence length {seq}")
    for name, t in (("dt", dt), ("a", a), ("b", b), ("c", c)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"x, b and c take one dtype of {DTYPES}, got {x.dtype}, {b.dtype}, "
                        f"{c.dtype}")


def _launch(x, dt, a, b, c, chunk, kept, kind):
    bsz, seq, heads, p = x.shape
    n = b.shape[2]
    if chunk > kernel.MAX_CHUNK or p > kernel.MAX_HEAD_DIM or p % 4 or n % 4:
        raise ValueError(f"the kernel takes chunk <= {kernel.MAX_CHUNK}, head_dim <= "
                         f"{kernel.MAX_HEAD_DIM} and head_dim, state_dim multiples of 4; got "
                         f"chunk {chunk}, P {p}, N {n}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"the kernel takes f32 dt and a, got {dt.dtype} and {a.dtype}")
    for name, t in (("x", x), ("b", b), ("c", c)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a unit innermost stride")
        if kind == "tc" and not kernel.rows_aligned(t):
            raise ValueError(f"the tc kernel reads 16-byte rows: {name} needs an aligned base "
                             "and strides")
    dev = x.device
    y = torch.empty((bsz, seq, heads, p), dtype=torch.float32, device=dev)
    s = torch.empty((bsz, heads, kept, p, n), dtype=torch.float32, device=dev)
    ce = torch.empty((bsz, heads, seq), dtype=torch.float32, device=dev)
    kernel.launch(x, dt, a, b, c, y, s, ce, chunk=chunk, kind=kind)
    return y, s, ce


def intra_chunk(x, dt, a, b, c, *, chunk: int, final_state: bool = True):
    """The intra-chunk term -> (y_intra [B, S, H, P] f32, s_contrib
    [B, H, nc', P, N] f32, cumexp [B, H, S] f32); ``final_state=False``
    leaves out the last chunk's state (nc' = nc - 1)."""
    refuse_grad(KERNEL, x, dt, a, b, c)
    _check(x, dt, a, b, c, chunk)
    dev = x.device
    if dev.type == "cpu":
        PLAIN_CALLS[KERNEL] += 1
        return ref.intra_chunk_bshp(x, dt, a, b, c, chunk=chunk, final_state=final_state)
    if dev.type != "cuda":
        raise ValueError(f"intra_chunk runs on cpu or cuda, not {dev}")
    nc = x.shape[1] // chunk
    kind = kernel.route(x.dtype, chunk, x.shape[3], b.shape[2])
    out = _launch(x, dt, a, b, c, chunk, nc if final_state else nc - 1, kind)
    LAUNCHES[KERNEL] += 1
    ROUTES[kind] += 1
    return out


def _check_inter(y_intra, s_contrib, cumexp, c, h0, chunk, final_state) -> None:
    if y_intra.ndim != 4 or s_contrib.ndim != 5 or cumexp.ndim != 3 or c.ndim != 3:
        raise ValueError("inter_chunk takes y_intra [B, S, H, P], s_contrib [B, H, nc', P, N], "
                         "cumexp [B, H, S] and c [B, S, N]")
    bsz, seq, heads, p = y_intra.shape
    n = c.shape[2]
    if chunk <= 0 or seq % chunk:
        raise ValueError(f"chunk {chunk} does not divide the sequence length {seq}")
    nc = seq // chunk
    kept = nc if final_state else nc - 1
    if tuple(s_contrib.shape) != (bsz, heads, kept, p, n):
        raise ValueError(f"s_contrib {tuple(s_contrib.shape)} is not {(bsz, heads, kept, p, n)}")
    if tuple(cumexp.shape) != (bsz, heads, seq) or tuple(c.shape[:2]) != (bsz, seq):
        raise ValueError(f"cumexp {tuple(cumexp.shape)} / c {tuple(c.shape)} do not fit y_intra "
                         f"{tuple(y_intra.shape)}")
    if h0 is not None and tuple(h0.shape) != (bsz, heads, p, n):
        raise ValueError(f"h0 {tuple(h0.shape)} is not {(bsz, heads, p, n)}")
    for name, t in (("s_contrib", s_contrib), ("cumexp", cumexp), ("c", c), ("h0", h0)):
        if t is not None and t.device != y_intra.device:
            raise ValueError(f"{name} is on {t.device}, y_intra on {y_intra.device}")


def _launch_inter(y_intra, s_contrib, cumexp, c, h0, chunk, final_state):
    bsz, seq, heads, p = y_intra.shape
    n = c.shape[2]
    if p % 4 or n % 4 or n > kernel.INTER_MAX_STATE_DIM:
        raise ValueError(f"the inter-chunk kernel takes head_dim and state_dim multiples of 4 "
                         f"and state_dim <= {kernel.INTER_MAX_STATE_DIM}; got P {p}, N {n}")
    for name, t in (("y_intra", y_intra), ("s_contrib", s_contrib), ("cumexp", cumexp)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"the inter-chunk kernel takes a contiguous f32 {name}")
    if c.dtype not in DTYPES or c.stride(-1) != 1:
        raise ValueError(f"the inter-chunk kernel takes a bf16 or f32 c with a unit innermost "
                         f"stride, got {c.dtype} with strides {c.stride()}")
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
    dev = y_intra.device
    hf = torch.empty((bsz, heads, p, n), dtype=torch.float32, device=dev) if final_state else None
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    kernel.launch_inter(y_intra, s_contrib, cumexp, c, h0, hf, chunk=chunk,
                        layout=kernel.inter_layout(bsz, heads, p, sms))
    return y_intra, hf


def inter_chunk(y_intra, s_contrib, cumexp, c, h0, *, chunk: int, final_state: bool = True):
    """The inter-chunk recurrence: h_{i+1} = h_i exp(cum_last_i) + S_i, and
    y_t += cumexp_t C_t . h_i for t in chunk i -> (y [B, S, H, P] f32,
    h_final [B, H, P, N] f32, or None without ``final_state``).  On the card
    y is y_intra, updated in place; on the CPU (the twin) a new tensor."""
    refuse_grad(INTER, y_intra, s_contrib, cumexp, c, h0)
    _check_inter(y_intra, s_contrib, cumexp, c, h0, chunk, final_state)
    dev = y_intra.device
    if dev.type == "cpu":
        PLAIN_CALLS[INTER] += 1
        return ref.inter_chunk_bshp(y_intra, s_contrib, cumexp, c, h0, chunk=chunk,
                                    final_state=final_state)
    if dev.type != "cuda":
        raise ValueError(f"inter_chunk runs on cpu or cuda, not {dev}")
    if h0 is None and y_intra.shape[1] == chunk:  # no state enters the one chunk
        return y_intra, s_contrib[:, :, 0] if final_state else None
    out = _launch_inter(y_intra, s_contrib, cumexp, c, h0, chunk, final_state)
    LAUNCHES[INTER] += 1
    return out


def ssd_bshp(x, dt, a, b, c, h0: Optional[torch.Tensor] = None, *, chunk: int = 256,
             final_state: bool = True):
    """Full SSD in the model's layout: x [B, S, H, P], dt [B, S, H], a [B, H],
    b / c [B, S, N], h0 [B, H, P, N] -> (y [B, S, H, P] f32, h_final
    [B, H, P, N] f32 or None)."""
    chunk = min(chunk, x.shape[1])
    y_intra, s_contrib, cumexp = intra_chunk(x, dt, a, b, c, chunk=chunk, final_state=final_state)
    return inter_chunk(y_intra, s_contrib, cumexp, c, h0, chunk=chunk, final_state=final_state)


def ssd_scan(
    x: torch.Tensor,  # [BH, S, P]
    dt: torch.Tensor,  # [BH, S]
    a: torch.Tensor,  # [BH]
    b: torch.Tensor,  # [BH, S, N]
    c: torch.Tensor,  # [BH, S, N]
    h0: Optional[torch.Tensor] = None,  # [BH, P, N]
    *,
    chunk: int = 256,
):
    """The reference's signature -> (y [BH, S, P] f32, h_final [BH, P, N] f32)."""
    y, h = ssd_bshp(x[:, :, None], dt.float()[:, :, None], a.float()[:, None], b, c,
                    None if h0 is None else h0[:, None], chunk=chunk)
    return y[:, :, 0], h[:, 0]
