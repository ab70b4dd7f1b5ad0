"""Build and bind the hand-written CUDA flash-attention kernel.

``csrc/flash_attention.cu`` exposes one ``extern "C"`` launcher (templated
inside on f32 / bf16 and on the per-thread head-dim slice).  It is compiled
with ``nvcc`` for ``sm_90a`` into a shared library at first use
(``kernels/build.py``) and loaded with ``ctypes``.

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

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
MAX_HEAD_DIM = 256

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def build() -> tuple[Path, str, float]:
    """Compile the kernel if needed -> (library path, nvcc log, seconds)."""
    return build_library(SOURCE, BASE_FLAGS, "flash_attention")


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.flash_attention_fwd.argtypes = [_P] * 5 + [_I] * 9 + [_F, _F, _I, _I, _P]
    lib.flash_attention_fwd.restype = _I
    return lib


def launch(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Skv, KV, D]
    v: torch.Tensor,  # [B, Skv, KV, D]
    kv_len: Optional[torch.Tensor],  # int32 [1] on the same device, or None (= Skv)
    out: torch.Tensor,  # [B, Sq, H, D], q's dtype, preallocated
    *,
    causal: bool,
    window: Optional[int],
    softcap: Optional[float],
    q_offset_from_kv_len: bool,
) -> None:
    """Launch the kernel on the current stream (the caller validated operands)."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    err = library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if kv_len is None else kv_len.data_ptr(),
        b, sq, skv, h, kvh, d,
        int(causal), -1 if window is None else int(window),
        int(softcap is not None), 0.0 if softcap is None else float(softcap),
        1.0 / math.sqrt(d), int(q_offset_from_kv_len),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_launch(err, "flash_attention")
