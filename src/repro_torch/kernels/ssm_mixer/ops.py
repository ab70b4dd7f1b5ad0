"""Wrappers: the Mamba-2 mixer's front and gated norm through the kernels.

``front`` takes the in-projection ``[B, S, 2 di + 2 N + H]`` (and the conv
cache's tail) to the conv output xbc, the gate and dt (and the new tail);
``gated_norm`` takes the SSD's output, x (a view of xbc) and the gate to the
normed rows the out-projection reads.  They route by the device of their
tensors: on the CPU each runs its plain PyTorch twin (``ref.py``, the
mixer's eager chain); on a CUDA tensor ``csrc/ssm_mixer.cu`` launches or
the call raises: it never falls back and reads no environment switch.  The
kernels have no backward pass: an input that requires grad under grad mode
is refused (``kernels.autograd``).  Only the model's kernel engine calls
them; the plain engines call the twins themselves.

``LAUNCHES`` counts kernel launches, ``PLAIN_CALLS`` plain-path calls, so a
run can show that its main path went through the kernels (``reset_counts``
zeroes them).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.autograd import refuse_grad
from repro_torch.kernels.ssm_mixer import kernel, ref

FRONT = "ssm_mixer_front"
NORM = "ssm_mixer_gated_norm"
LAUNCHES = {FRONT: 0, NORM: 0}
PLAIN_CALLS = {FRONT: 0, NORM: 0}


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for k in counts:
            counts[k] = 0


def _device(name: str, first: torch.Tensor, **others) -> torch.device:
    dev = first.device
    for key, t in others.items():
        if t is not None and t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, the activations on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    return dev


def _params(*tensors):
    """Small f32 parameters as the kernels read them (no copy where they are)."""
    return [t.float().contiguous() for t in tensors]


def front(proj, conv_w, conv_b, dt_bias, *, d_inner: int, state_dim: int,
          cache_tail: Optional[torch.Tensor] = None, new_tail: bool = False):
    """proj [B, S, 2 di + 2 N + H] -> (xbc [B, S, di + 2 N] and gate
    [B, S, di] in proj's dtype, dt [B, S, H] f32, the new conv tail
    [B, W-1, di + 2 N] in proj's dtype when ``new_tail``, else None)."""
    refuse_grad(FRONT, proj, conv_w, conv_b, dt_bias, cache_tail)
    di, n = d_inner, state_dim
    if proj.ndim != 3 or conv_w.ndim != 2 or conv_b.ndim != 1 or dt_bias.ndim != 1:
        raise ValueError("front takes proj [B, S, L], conv_w [W, C], conv_b [C], dt_bias [H]")
    bsz, seq, width = proj.shape
    c, heads = di + 2 * n, dt_bias.shape[0]
    if width != 2 * di + 2 * n + heads or tuple(conv_w.shape[1:]) != (c,) or conv_b.shape[0] != c:
        raise ValueError(f"proj {tuple(proj.shape)}, conv_w {tuple(conv_w.shape)}, conv_b "
                         f"{tuple(conv_b.shape)} and dt_bias {tuple(dt_bias.shape)} do not fit "
                         f"d_inner {di} and state_dim {n}")
    conv = conv_w.shape[0]
    if cache_tail is not None and tuple(cache_tail.shape) != (bsz, conv - 1, c):
        raise ValueError(f"cache_tail {tuple(cache_tail.shape)} is not {(bsz, conv - 1, c)}")
    if proj.dtype not in kernel.DTYPES:
        raise TypeError(f"front takes proj in one dtype of {kernel.DTYPES}, got {proj.dtype}")
    dev = _device(FRONT, proj, conv_w=conv_w, conv_b=conv_b, dt_bias=dt_bias,
                  cache_tail=cache_tail)
    if dev.type == "cpu":
        PLAIN_CALLS[FRONT] += 1
        xbc, gate, dt, tail = ref.front(proj, conv_w, conv_b, dt_bias, di, n, cache_tail)
        return xbc, gate, dt, tail if new_tail else None
    if conv != kernel.WIDTH or seq == 0 or bsz == 0:
        raise ValueError(f"the front kernel takes a conv width of {kernel.WIDTH} and a non-empty "
                         f"batch; got width {conv}, proj {tuple(proj.shape)}")
    if proj.stride(-1) != 1:
        raise ValueError("the front kernel reads proj with a unit innermost stride")
    conv_w, conv_b, dt_bias = _params(conv_w, conv_b, dt_bias)
    if cache_tail is not None:  # the eager chain's cast; a no-op in the cache's own dtype
        cache_tail = cache_tail.to(proj.dtype)
        if cache_tail.stride(-1) != 1:
            cache_tail = cache_tail.contiguous()
    if not kernel.front_fits(proj, cache_tail, di, c):
        raise ValueError(f"the front kernel loads {kernel.FRONT_VEC} values at a time: proj's and "
                         f"the tail's bases and strides, d_inner and d_inner + 2 N must be "
                         f"multiples of it; got proj {tuple(proj.shape)} strides {proj.stride()}")
    xbc = torch.empty((bsz, seq, c), dtype=proj.dtype, device=dev)
    gate = torch.empty((bsz, seq, di), dtype=proj.dtype, device=dev)
    dt = torch.empty((bsz, seq, heads), dtype=torch.float32, device=dev)
    tail = torch.empty((bsz, conv - 1, c), dtype=proj.dtype, device=dev) if new_tail else None
    kernel.launch_front(proj, cache_tail, conv_w, conv_b, dt_bias, xbc, gate, dt, tail,
                        d_inner=di)
    LAUNCHES[FRONT] += 1
    return xbc, gate, dt, tail


def gated_norm(y, x_in, d_skip, gate, norm_w, eps: float):
    """y, x_in [B, S, H, P] (x_in may be a strided view), d_skip [H], gate
    [B, S, H P], norm_w [H P] -> rmsnorm((y + x_in D) * gate, norm_w)
    [B, S, H P] in y's dtype."""
    refuse_grad(NORM, y, x_in, d_skip, gate, norm_w)
    if y.ndim != 4 or x_in.shape != y.shape:
        raise ValueError(f"gated_norm takes y and x_in [B, S, H, P], got {tuple(y.shape)} and "
                         f"{tuple(x_in.shape)}")
    bsz, seq, heads, p = y.shape
    di = heads * p
    if (tuple(gate.shape) != (bsz, seq, di) or tuple(d_skip.shape) != (heads,)
            or tuple(norm_w.shape) != (di,)):
        raise ValueError(f"gate {tuple(gate.shape)}, d_skip {tuple(d_skip.shape)} and norm_w "
                         f"{tuple(norm_w.shape)} do not fit y {tuple(y.shape)}")
    if y.dtype not in kernel.DTYPES or x_in.dtype != y.dtype or gate.dtype != y.dtype:
        raise TypeError(f"y, x_in and gate take one dtype of {kernel.DTYPES}, got {y.dtype}, "
                        f"{x_in.dtype}, {gate.dtype}")
    dev = _device(NORM, y, x_in=x_in, d_skip=d_skip, gate=gate, norm_w=norm_w)
    if dev.type == "cpu":
        PLAIN_CALLS[NORM] += 1
        return ref.gated_norm(y, x_in, d_skip, gate, norm_w, eps)
    if seq == 0 or bsz == 0 or di > kernel.NORM_MAX_WIDTH:
        raise ValueError(f"the norm kernel takes a non-empty batch and d_inner <= "
                         f"{kernel.NORM_MAX_WIDTH}; got y {tuple(y.shape)}")
    for name, t in (("y", y), ("x_in", x_in)):
        if t.stride(3) != 1 or t.stride(2) != p:
            raise ValueError(f"the norm kernel reads {name}'s heads as one row of H P values")
    if gate.stride(2) != 1:
        raise ValueError("the norm kernel reads the gate with a unit innermost stride")
    d_skip, norm_w = _params(d_skip, norm_w)
    if not kernel.norm_fits(y, x_in, gate, norm_w, p):
        raise ValueError(f"the norm kernel loads {kernel.NORM_BYTES} bytes at a time: every row's "
                         f"base and stride, norm_w's base and the head dim must be multiples of "
                         f"it; got y {tuple(y.shape)}, x_in strides {x_in.stride()}")
    out = torch.empty((bsz, seq, di), dtype=y.dtype, device=dev)
    kernel.launch_gated_norm(y, x_in, gate, d_skip, norm_w, out, eps=eps)
    LAUNCHES[NORM] += 1
    return out
