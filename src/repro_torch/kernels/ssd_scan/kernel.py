"""Build and bind the hand-written CUDA SSD kernels.

``csrc/ssd_scan_tc.cu`` ("tc": Hopper tensor cores, mma.sync on bf16 x, B
and C, chunks of 64 / 128 / 256, P of 64 or 128, N of 16, 64 or 128) and
``csrc/ssd_scan.cu`` ("simt": f32 CUDA-core products for any other chunk up
to 256 and for f32 inputs; "packed": chunks of 4 to 32, one block a lane
over all heads) each expose one ``extern "C"`` launcher, compiled with
``nvcc`` for ``sm_90a`` into a shared library of its own at first use
(``kernels/build.py``) and loaded with ``ctypes``.  ``route`` picks the
kernel from the dtype and shape alone: it is not a fallback.
``csrc/ssd_inter_chunk.cu`` is the inter-chunk recurrence (one block walks
a batch row, head and group of P columns through every chunk, its state in
registers; the products on the tensor cores for a bf16 or f32 C), in a
library of its own (``launch_inter``, its block layout by ``inter_layout``
from the shape alone).

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

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
SOURCE_TC = Path(__file__).resolve().parent / "csrc" / "ssd_scan_tc.cu"
SOURCE_INTER = Path(__file__).resolve().parent / "csrc" / "ssd_inter_chunk.cu"
MAX_CHUNK = 256
MAX_HEAD_DIM = 128
PACKED_CHUNKS = (4, 8, 16, 32)
TC_CHUNKS = (64, 128, 256)
TC_DIMS = (64, 128)  # the tc kernel's head dims P
TC_STATE_DIMS = (16, 64, 128)  # and its state dims N (16: hymba's SSD heads)
INTER_MAX_STATE_DIM = 128  # the inter-chunk kernel's N (padded to 16, 32, 64 or 128)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def route(dtype: torch.dtype, chunk: int, p: int, n: int) -> str:
    """The kernel for a call: "packed" for chunks in ``PACKED_CHUNKS``, "tc"
    (tensor cores) for bf16 with a chunk in ``TC_CHUNKS``, P in ``TC_DIMS``
    and N in ``TC_STATE_DIMS``, else "simt"."""
    if chunk in PACKED_CHUNKS:
        return "packed"
    if dtype == torch.bfloat16 and chunk in TC_CHUNKS and p in TC_DIMS and n in TC_STATE_DIMS:
        return "tc"
    return "simt"


def build() -> tuple[Path, str, float]:
    """Compile the simt / packed kernels if needed -> (library path, nvcc log, seconds)."""
    return build_library(SOURCE, BASE_FLAGS, "ssd_scan")


def build_tc(heads_n16: Optional[int] = None) -> tuple[Path, str, float]:
    """Compile the tensor-core kernel if needed -> (library path, nvcc log,
    seconds).  ``heads_n16`` (1, 2 or 4) builds it with that many heads a
    block at N 16 in place of the shipped choice: ``tools/ssd_tc_heads.py``
    times the three, on no main path."""
    if heads_n16 is not None:
        return build_library(SOURCE_TC, (*BASE_FLAGS, f"-DSSD_TC_HEADS_N16={int(heads_n16)}"),
                             f"ssd_scan_tc_heads{int(heads_n16)}")
    return build_library(SOURCE_TC, BASE_FLAGS, "ssd_scan_tc")


def build_inter() -> tuple[Path, str, float]:
    """Compile the inter-chunk kernel if needed -> (library path, nvcc log, seconds)."""
    return build_library(SOURCE_INTER, BASE_FLAGS, "ssd_inter_chunk")


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded simt / packed kernel library (built on first use)."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.ssd_intra_chunk_fwd.argtypes = [_P] * 8 + [_I] * 7 + [_L] * 12 + [_I, _I, _P]
    lib.ssd_intra_chunk_fwd.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def library_tc(heads_n16: Optional[int] = None) -> ctypes.CDLL:
    """The loaded tensor-core kernel library (built on first use)."""
    path, _, _ = build_tc(heads_n16)
    lib = ctypes.CDLL(str(path))
    lib.ssd_intra_chunk_tc_fwd.argtypes = [_P] * 8 + [_I] * 7 + [_L] * 12 + [_P]
    lib.ssd_intra_chunk_tc_fwd.restype = _I
    return lib


@functools.lru_cache(maxsize=1)
def library_inter() -> ctypes.CDLL:
    """The loaded inter-chunk kernel library (built on first use)."""
    path, _, _ = build_inter()
    lib = ctypes.CDLL(str(path))
    lib.ssd_inter_chunk_fwd.argtypes = [_P] * 6 + [_I] * 7 + [_L] * 2 + [_I] * 4 + [_P]
    lib.ssd_inter_chunk_fwd.restype = _I
    return lib


def inter_layout(bsz: int, heads: int, p: int, sms: int) -> tuple[int, int]:
    """(warps a block, of them row warps) for the inter-chunk kernel: 4 or 2
    warps of 16 columns of P each, the most that P's columns fill and that
    still give two blocks an SM; else 4 warps over the same 16 columns, each
    multiplying a quarter of a tile's rows (small batches)."""
    tiles = -(-p // 16)  # P's 16-column tiles
    for warps in (4, 2):
        if warps <= tiles and bsz * heads * -(-tiles // warps) >= 2 * sms:
            return warps, 1
    return 4, 4


def rows_aligned(t: torch.Tensor) -> bool:
    """16-byte aligned base and strides (all but the innermost, which is 1)."""
    step = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(s % step == 0 for s in t.stride()[:-1])


def launch(x, dt, a, b, c, y, s, ce, *, chunk: int, kind: str,
           heads_n16: Optional[int] = None) -> None:
    """Launch the ``kind`` kernel ("tc", "simt" or "packed", see ``route``)
    on the current stream (the caller validated operands); "tc" from its
    ``build_tc(heads_n16)`` library.

    x [B, S, H, P], dt [B, S, H], a [B, H], b / c [B, S, N] as strided
    views; y [B, S, H, P], s [B, H, nc', P, N] and ce [B, H, S] contiguous
    f32 outputs; nc' = s.shape[2] chunks keep their state."""
    if kind not in ("tc", "simt", "packed"):
        raise ValueError(f"no SSD kernel {kind!r}: 'tc', 'simt' or 'packed'")
    if kind != "tc" and (kind == "packed") != (chunk in PACKED_CHUNKS):
        raise ValueError(f"the {kind} kernel does not take chunk {chunk}")
    bsz, seq, heads, p = x.shape
    n = b.shape[2]
    args = [
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        y.data_ptr(), s.data_ptr(), ce.data_ptr(),
        bsz, seq, heads, p, n, chunk, s.shape[2],
        x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1), dt.stride(2),
        a.stride(0), a.stride(1), b.stride(0), b.stride(1), c.stride(0), c.stride(1),
    ]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if kind == "tc":
        err = library_tc(heads_n16).ssd_intra_chunk_tc_fwd(*args, stream)
    else:
        vec_x = rows_aligned(x) and p % (16 // x.element_size()) == 0
        err = library().ssd_intra_chunk_fwd(*args, int(x.dtype == torch.bfloat16), int(vec_x),
                                            stream)
    check_launch(err, f"ssd_intra_chunk ({kind})")


def launch_inter(y, s, ce, c, h0, hf, *, chunk: int, layout: tuple[int, int]) -> None:
    """Launch the inter-chunk kernel on the current stream (the caller
    validated operands) with ``layout`` = (warps a block, row warps; see
    ``inter_layout``): y [B, S, H, P] f32 (y_intra, updated in place), s
    [B, H, nc', P, N], ce [B, H, S], h0 and hf [B, H, P, N] (or None), all
    contiguous f32; c [B, S, N] bf16 or f32 with a unit innermost stride."""
    bsz, seq, heads, p = y.shape
    n = c.shape[2]
    is_bf16 = c.dtype == torch.bfloat16
    vec = is_bf16 and n % 8 == 0 and rows_aligned(c)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    err = library_inter().ssd_inter_chunk_fwd(
        y.data_ptr(), s.data_ptr(), ce.data_ptr(), c.data_ptr(),
        None if h0 is None else h0.data_ptr(), None if hf is None else hf.data_ptr(),
        bsz, seq, heads, p, n, chunk, s.shape[2], c.stride(0), c.stride(1), int(is_bf16),
        int(vec), *layout, stream)
    check_launch(err, "ssd_inter_chunk")
