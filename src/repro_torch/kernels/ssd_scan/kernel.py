"""Build and bind the hand-written CUDA SSD intra-chunk kernel.

``csrc/ssd_scan.cu`` exposes one ``extern "C"`` launcher (templated inside
on f32 / bf16 x, B and C).  It is compiled with ``nvcc`` for ``sm_90a`` into
a shared library at first use (``kernels/build.py``) and loaded with
``ctypes``.

Nothing here touches CUDA or nvcc at import time: the CPU test suite imports
this module on machines with neither.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import BASE_FLAGS, build_library, check_launch

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
MAX_CHUNK = 256
MAX_HEAD_DIM = 128

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def build() -> tuple[Path, str, float]:
    """Compile the kernel if needed -> (library path, nvcc log, seconds)."""
    return build_library(SOURCE, BASE_FLAGS, "ssd_scan")


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.ssd_intra_chunk_fwd.argtypes = [_P] * 8 + [_I] * 7 + [_L] * 12 + [_I, _P]
    lib.ssd_intra_chunk_fwd.restype = _I
    return lib


def launch(x, dt, a, b, c, y, s, ce, *, chunk: int) -> None:
    """Launch on the current stream (the caller validated operands).

    x [B, S, H, P], dt [B, S, H], a [B, H], b / c [B, S, N] as strided
    views; y [B, S, H, P], s [B, H, nc', P, N] and ce [B, H, S] contiguous
    f32 outputs; nc' = s.shape[2] chunks keep their state."""
    bsz, seq, heads, p = x.shape
    n = b.shape[2]
    err = library().ssd_intra_chunk_fwd(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        y.data_ptr(), s.data_ptr(), ce.data_ptr(),
        bsz, seq, heads, p, n, chunk, s.shape[2],
        x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1), dt.stride(2),
        a.stride(0), a.stride(1), b.stride(0), b.stride(1), c.stride(0), c.stride(1),
        int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_launch(err, "ssd_intra_chunk")
