"""Build and bind the hand-written CUDA split-KV decode-attention kernel.

``csrc/decode_attention.cu`` exposes one ``extern "C"`` launcher (templated
inside on f32 / bf16 and on the per-thread head-dim slice and group size).
It is compiled with ``nvcc`` for ``sm_90a`` into a shared library at first
use (``kernels/build.py``) and loaded with ``ctypes``.

Nothing here touches CUDA or nvcc at import time: the CPU test suite imports
this module on machines with neither.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.build import BASE_FLAGS, build_library, check_launch

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
# (pairs a thread holds, query rows) instantiated in the source
INSTANTIATED = {(2, 2), (2, 4), (2, 8), (4, 2), (4, 4), (4, 8), (8, 2), (8, 4), (16, 2)}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


def supports(g: int, d: int) -> bool:
    """Whether the kernel takes a group of ``g`` query rows of head dim ``d``."""
    if d % 16 or not 16 <= d <= 256 or not 1 <= g <= 8 or g * d > 512:
        return False
    np_ = d // 16
    maxp = 2 if np_ <= 2 else 4 if np_ <= 4 else 8 if np_ <= 8 else 16
    maxg = 2 if g <= 2 else 4 if g <= 4 else 8
    return (maxp, maxg) in INSTANTIATED


def build() -> tuple[Path, str, float]:
    """Compile the kernel if needed -> (library path, nvcc log, seconds)."""
    return build_library(SOURCE, BASE_FLAGS, "decode_attention")


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.decode_attention_partials_fwd.argtypes = (
        [_P] * 7 + [_L] + [_I] * 5 + [_L] * 6 + [_I, _I, _F, _F, _I, _P])
    lib.decode_attention_partials_fwd.restype = _I
    return lib


def launch(
    q: torch.Tensor,  # [BKV, G, D] contiguous
    k: torch.Tensor,  # [B, Skv, KV, D], innermost stride 1
    v: torch.Tensor,  # [B, Skv, KV, D], innermost stride 1
    kv_len: torch.Tensor,  # int32 [1] on the same device
    m: torch.Tensor,  # [BKV, ns, G] f32, preallocated
    l: torch.Tensor,  # [BKV, ns, G] f32
    acc: torch.Tensor,  # [BKV, ns, G, D] f32
    *,
    softcap: Optional[float],
    window: Optional[int],
) -> None:
    """Launch on the current stream (the caller validated operands)."""
    bkv, g, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    err = library().decode_attention_partials_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        m.data_ptr(), l.data_ptr(), acc.data_ptr(),
        bkv, kvh, g, d, skv, m.shape[1],
        k.stride(0), k.stride(1), k.stride(2), v.stride(0), v.stride(1), v.stride(2),
        -1 if window is None else int(window),
        int(softcap is not None), 0.0 if softcap is None else float(softcap),
        1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_launch(err, "decode_attention_partials")
