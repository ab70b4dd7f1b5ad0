"""Build and bind the Mamba-2 mixer's hand-written CUDA kernels.

``csrc/ssm_mixer.cu`` holds the mixer's front (the causal conv + SiLU, the
gate and dt's softplus from the in-projection) and its back (the D skip and
the gated RMSNorm), each behind one ``extern "C"`` launcher, compiled with
``nvcc`` for ``sm_90a`` into one shared library at first use
(``kernels/build.py``) and loaded with ``ctypes``.  The source rounds with
``__fmul_rn`` / ``__fadd_rn``, so it needs no ``--fmad=false``, and its
``expf`` / ``log1pf`` / ``rsqrtf`` are built as PyTorch's own kernels build
them.  Each kernel is built for one load width: the front two values a
thread (4 bytes in bf16, which hymba's rows of 6,482 values keep), the norm
16 bytes; ``front_fits`` / ``norm_fits`` say whether operands fit it.

Nothing here touches CUDA or nvcc at import time: the CPU test suite imports
this module on machines with neither.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.build import BASE_FLAGS, build_library, check_launch

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssm_mixer.cu"
WIDTH = 4  # the conv width the front kernel is built for (every Mamba-2 configuration's)
FRONT_VEC = 2  # values a front load (kFrontVec)
NORM_BYTES = 16  # bytes a norm load
NORM_MAX_WIDTH = 8 * 1024 * 4  # d_inner the norm takes: 8 loads of 1,024 threads (f32's 4 values)
DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def build() -> tuple[Path, str, float]:
    """Compile both kernels if needed -> (library path, nvcc log, seconds)."""
    return build_library(SOURCE, BASE_FLAGS, "ssm_mixer")


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.ssm_mixer_front_fwd.argtypes = ([_P, _L, _L] * 2 + [_P, _L] + [_P] * 6
                                        + [_I] * 7 + [_P])
    lib.ssm_mixer_front_fwd.restype = _I
    lib.ssm_mixer_gated_norm_fwd.argtypes = ([_P, _L, _L] * 3 + [_P] * 3 + [_I] * 4
                                             + [ctypes.c_float, _I, _P])
    lib.ssm_mixer_gated_norm_fwd.restype = _I
    return lib


def _fits(vec: int, tensors, counts) -> bool:
    """Every tensor's base on a ``vec``-value boundary, its strides but the
    innermost and every count a multiple of ``vec``."""
    return (all(t.data_ptr() % (vec * t.element_size()) == 0
                and all(s % vec == 0 for s in t.stride()[:-1]) for t in tensors)
            and all(n % vec == 0 for n in counts))


def front_fits(proj: torch.Tensor, tail: Optional[torch.Tensor], d_inner: int, c: int) -> bool:
    """Whether the front kernel's loads of ``FRONT_VEC`` values fit proj's
    base and strides, the tail's, and the z / xBC boundaries (every
    Mamba-2 configuration's do, hymba's rows of 6,482 values included)."""
    tensors = [proj] + ([] if tail is None else [tail])
    return _fits(FRONT_VEC, tensors, (d_inner, c))


def norm_fits(y, x, gate, norm_w, p: int) -> bool:
    """Whether the norm kernel's loads of ``NORM_BYTES`` fit every row's
    base, norm_w's, d_inner and the head dim."""
    return _fits(NORM_BYTES // y.element_size(), (y, x, gate, norm_w), (y.shape[2] * p, p))


def launch_front(proj, tail, conv_w, conv_b, dt_bias, xbc, gate, dt, new_tail, *,
                 d_inner: int) -> None:
    """Launch the front kernel on the current stream (the caller validated
    operands, ``front_fits``): proj [B, S, L] and tail [B, W-1, C] (or None)
    with a unit innermost stride, conv_w [W, C] with a unit innermost
    stride, conv_b [C], dt_bias [H] contiguous f32; xbc [B, S, C], gate
    [B, S, di], dt [B, S, H] f32 and new_tail [B, W-1, C] (or None)
    contiguous."""
    bsz, seq, _ = proj.shape
    width, c = conv_w.shape
    stream = torch.cuda.current_stream(proj.device).cuda_stream
    err = library().ssm_mixer_front_fwd(
        proj.data_ptr(), proj.stride(0), proj.stride(1),
        None if tail is None else tail.data_ptr(), 0 if tail is None else tail.stride(0),
        0 if tail is None else tail.stride(1),
        conv_w.data_ptr(), conv_w.stride(0), conv_b.data_ptr(), dt_bias.data_ptr(),
        xbc.data_ptr(), gate.data_ptr(), dt.data_ptr(),
        None if new_tail is None else new_tail.data_ptr(),
        bsz, seq, d_inner, c, dt.shape[2], width, int(proj.dtype == torch.bfloat16), stream)
    check_launch(err, "ssm_mixer_front")


def launch_gated_norm(y, x, gate, d_skip, norm_w, out, *, eps: float) -> None:
    """Launch the gated-norm kernel on the current stream (the caller
    validated operands, ``norm_fits``): y and x [B, S, H, P] with heads and P contiguous
    within a row, gate [B, S, di] with a unit innermost stride, d_skip [H]
    and norm_w [di] contiguous f32, out [B, S, di] contiguous."""
    bsz, seq, heads, p = y.shape
    stream = torch.cuda.current_stream(y.device).cuda_stream
    err = library().ssm_mixer_gated_norm_fwd(
        y.data_ptr(), y.stride(0), y.stride(1), x.data_ptr(), x.stride(0), x.stride(1),
        gate.data_ptr(), gate.stride(0), gate.stride(1), d_skip.data_ptr(), norm_w.data_ptr(),
        out.data_ptr(), bsz, seq, heads * p, p, eps, int(y.dtype == torch.bfloat16), stream)
    check_launch(err, "ssm_mixer_gated_norm")
