"""Build and bind the two hand-written CUDA decode-attention kernels.

``csrc/decode_attention_fused.cu`` ("fused": splits over the live keys,
their combine through a thread-block cluster, one launch from the query to
the output rows; Q.K^T and P.V on the tensor cores for bf16 at head dim 64,
80, 128 or 256, ``fused_route``) serves the model's decode route.  The
partials kernel (the reference's signature, splits over the cache length,
f32 partials out) serves ``decode_attention_partials`` and the mesh
decode's ``decode_attention_split`` in two forms, ``partials_route``: "tc"
(bf16 at those head dims, on the fused kernel's tensor-core body in
``decode_attention_fused.cu``) and "simt" (``csrc/decode_attention.cu``:
f32 and the other head dims).  Each source exposes ``extern "C"``
launchers (templated inside on f32 / bf16 and on the per-thread head-dim
slice and group size), is compiled with ``nvcc`` for ``sm_90a`` into a
shared library of its own at first use (``kernels/build.py``) and is
loaded with ``ctypes``.

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
SOURCE_FUSED = Path(__file__).resolve().parent / "csrc" / "decode_attention_fused.cu"
MAX_SPLITS = 8  # the fused kernel's cluster: the portable cluster size
FUSED_VALUES = 64  # query values a thread of the fused simt form holds, at most
TC_HEAD_DIMS = (64, 80, 128, 256)  # the tensor-core forms (fused, partials): bf16 at these
FORMS = ("tc", "simt")


def fused_route(dtype: torch.dtype, d: int) -> str:
    """The fused kernel's form for a call: "tc" (Q.K^T and P.V on the tensor
    cores) for bf16 at a head dim in ``TC_HEAD_DIMS``, else "simt"."""
    return "tc" if dtype == torch.bfloat16 and d in TC_HEAD_DIMS else "simt"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


def partials_route(dtype: torch.dtype, d: int) -> str:
    """The partials kernel's form for a call: "tc" (the fused kernel's
    tensor-core body, ``decode_partials_tc_kernel``) for bf16 at a head dim
    in ``TC_HEAD_DIMS``, else "simt" (``decode_partials_kernel``)."""
    return "tc" if dtype == torch.bfloat16 and d in TC_HEAD_DIMS else "simt"


def supports_partials(g: int, d: int, dtype: torch.dtype) -> bool:
    """Whether the partials kernel takes a group of ``g`` query rows of head
    dim ``d`` in ``dtype``: every group the fused route takes, G <= 8 and D a
    multiple of 16 up to 256, in f32 or bf16.  Both forms take them all (the
    simt form runs a group's rows in sub-groups that fit its registers)."""
    return dtype in (torch.float32, torch.bfloat16) and d % 16 == 0 and 16 <= d <= 256 and (
        1 <= g <= 8)


def supports_fused(g: int, d: int, dtype: torch.dtype) -> bool:
    """Whether the fused kernel takes a group of ``g`` <= 8 query rows of head
    dim ``d`` in the form ``fused_route`` names: the tc form takes them all,
    the simt form those ``fits_simt`` admits."""
    if d % 16 or not 16 <= d <= 256 or not 1 <= g <= 8:
        return False
    return fused_route(dtype, d) == "tc" or fits_simt(g, d, dtype)


def fits_simt(g: int, d: int, dtype: torch.dtype) -> bool:
    """Whether the simt form holds the group: a thread holds 16-byte chunks
    of each row (one in eight of them, rounded up to a power of two) for the
    rows rounded up to 2, 4 or 8, at most ``FUSED_VALUES``."""
    vec = 16 // (2 if dtype == torch.bfloat16 else 4)
    chunks = d // vec
    nch = 1 if chunks <= 8 else 2 if chunks <= 16 else 4 if chunks <= 32 else 8
    maxg = 2 if g <= 2 else 4 if g <= 4 else 8
    return nch * maxg * vec <= FUSED_VALUES


def build() -> tuple[Path, str, float]:
    """Compile the partials kernel if needed -> (library path, nvcc log, seconds)."""
    return build_library(SOURCE, BASE_FLAGS, "decode_attention")


def build_fused() -> tuple[Path, str, float]:
    """Compile the fused kernel if needed -> (library path, nvcc log, seconds)."""
    return build_library(SOURCE_FUSED, BASE_FLAGS, "decode_attention_fused")


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.decode_attention_partials_fwd.argtypes = (
        [_P] * 7 + [_L] + [_I] * 5 + [_L] * 6 + [_I, _I, _F, _F, _I, _P])
    lib.decode_attention_partials_fwd.restype = _I
    return lib


@functools.lru_cache(maxsize=1)
def library_fused() -> ctypes.CDLL:
    """The loaded fused kernel library, with the partials' tc form (built on
    first use)."""
    path, _, _ = build_fused()
    lib = ctypes.CDLL(str(path))
    lib.decode_attention_fused_fwd.argtypes = (
        [_P] * 5 + [_L] + [_I] * 5 + [_L] * 6 + [_I, _I, _F, _F, _I, _I, _P])
    lib.decode_attention_fused_fwd.restype = _I
    lib.decode_attention_partials_tc_fwd.argtypes = (
        [_P] * 7 + [_L] + [_I] * 5 + [_L] * 6 + [_I, _I, _F, _F, _P])
    lib.decode_attention_partials_tc_fwd.restype = _I
    return lib


def launch_fused(
    q: torch.Tensor,  # [BKV, G, D] contiguous
    k: torch.Tensor,  # [B, Skv, KV, D], innermost stride 1
    v: torch.Tensor,  # [B, Skv, KV, D], innermost stride 1
    kv_len: torch.Tensor,  # int32 [1] on the same device
    out: torch.Tensor,  # [BKV, G, D] contiguous, q's dtype, preallocated
    *,
    num_splits: int,
    softcap: Optional[float],
    window: Optional[int],
    form: Optional[str] = None,
) -> None:
    """Launch the fused kernel on the current stream (the caller validated
    operands): ``num_splits`` blocks, one cluster, per (b, kv head), in the
    ``form`` given ("simt" takes every dtype and head dim the wrapper
    allows; chip_smoke.py times it on the tc form's inputs) or, by default,
    the one ``fused_route`` names."""
    form = fused_route(q.dtype, q.shape[2]) if form is None else form
    if form not in FORMS or (form == "tc" and fused_route(q.dtype, q.shape[2]) != "tc"):
        raise ValueError(f"the fused kernel has no {form!r} form for {q.dtype} at D {q.shape[2]}")
    bkv, g, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    err = library_fused().decode_attention_fused_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        bkv, kvh, g, d, skv, num_splits,
        k.stride(0), k.stride(1), k.stride(2), v.stride(0), v.stride(1), v.stride(2),
        -1 if window is None else int(window),
        int(softcap is not None), 0.0 if softcap is None else float(softcap),
        1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16),
        int(form == "tc"), torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_launch(err, "decode_attention_fused")


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
    form: Optional[str] = None,
) -> None:
    """Launch the partials kernel on the current stream (the caller validated
    operands) in the ``form`` given ("simt" takes every dtype and head dim the
    wrapper allows; chip_smoke.py times it on the tc form's inputs) or, by
    default, the one ``partials_route`` names."""
    route = partials_route(q.dtype, q.shape[2])
    form = route if form is None else form
    if form not in FORMS or (form == "tc" and route != "tc"):
        raise ValueError(f"the partials kernel has no {form!r} form for {q.dtype} at D "
                         f"{q.shape[2]}")
    bkv, g, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    args = [
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        m.data_ptr(), l.data_ptr(), acc.data_ptr(),
        bkv, kvh, g, d, skv, m.shape[1],
        k.stride(0), k.stride(1), k.stride(2), v.stride(0), v.stride(1), v.stride(2),
        -1 if window is None else int(window),
        int(softcap is not None), 0.0 if softcap is None else float(softcap),
        1.0 / math.sqrt(d),
    ]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if form == "tc":
        err = library_fused().decode_attention_partials_tc_fwd(*args, stream)
    else:
        err = library().decode_attention_partials_fwd(*args, int(q.dtype == torch.bfloat16),
                                                      stream)
    check_launch(err, f"decode_attention_partials ({form})")
