"""Build and bind the four hand-written CUDA flash-attention kernels.

``csrc/flash_attention.cu`` ("simt": f32 FMAs, 8 threads a query row,
templated on f32 / bf16 and on the per-thread head-dim slice),
``csrc/flash_attention_tc.cu`` ("tc": Hopper tensor cores, wgmma and TMA,
bf16 with >= 64 query rows and D 64, 80, 128 or 256),
``csrc/flash_attention_short.cu`` ("short": mma.sync over one 16-row tile
a warp, bf16 with fewer query rows and D 64 or 128) and
``csrc/flash_attention_split.cu`` ("split": mma.sync, the keys split over
a cluster of blocks per (b, kv head), bf16 with at most 8 query rows a kv
head over more than 64 keys, D 64 or 128) each expose one
``extern "C"`` launcher.  Each is compiled with ``nvcc`` for ``sm_90a`` into
a shared library of its own at first use (``kernels/build.py``) and loaded
with ``ctypes``.  ``route``
picks the kernel from the dtype and shape alone: it is not a fallback.

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
from repro_torch.kernels.decode_attention.ops import fused_num_splits

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
SOURCE_TC = Path(__file__).resolve().parent / "csrc" / "flash_attention_tc.cu"
SOURCE_SHORT = Path(__file__).resolve().parent / "csrc" / "flash_attention_short.cu"
SOURCE_SPLIT = Path(__file__).resolve().parent / "csrc" / "flash_attention_split.cu"
MAX_HEAD_DIM = 256
TC_HEAD_DIMS = (64, 80, 128, 256)  # the "tc" kernel's head dims
SHORT_HEAD_DIMS = (64, 128)  # the "short" and "split" kernels' head dims
TC_MIN_SQ = 64  # one consumer warpgroup's rows: shorter bf16 query blocks go "short"
SPLIT_MAX_ROWS = 8  # G * Sq of the "split" kernel: the top half of one m16 A tile
SPLIT_MIN_KEYS = 64  # the "split" kernel takes more keys than this; "short" the rest
ROUTE_NAMES = ("tc", "short", "split", "simt")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def route(dtype: torch.dtype, sq: int, d: int, g: int, skv: int) -> str:
    """The kernel for a call of ``sq`` query tokens, ``g`` query heads a kv
    head and ``skv`` keys: for bf16, "tc" (wgmma + TMA) with at least
    ``TC_MIN_SQ`` query rows and D in ``TC_HEAD_DIMS``; with fewer rows and D
    in ``SHORT_HEAD_DIMS``, "split" (the keys over a cluster of blocks) when
    the ``g * sq`` rows of a kv head number at most ``SPLIT_MAX_ROWS`` over
    more than ``SPLIT_MIN_KEYS`` keys, else "short" (mma.sync, one 16-row
    tile a warp); else "simt"."""
    if dtype == torch.bfloat16:
        if sq >= TC_MIN_SQ and d in TC_HEAD_DIMS:
            return "tc"
        if sq < TC_MIN_SQ and d in SHORT_HEAD_DIMS:
            if g * sq <= SPLIT_MAX_ROWS and skv > SPLIT_MIN_KEYS:
                return "split"
            return "short"
    return "simt"


def split_num_splits(bkv: int, skv: int) -> int:
    """The split kernel's blocks per (b, kv head): the fused decode kernel's
    rule (``decode_attention.ops.fused_num_splits`` for its tensor-core
    form, whose ring of 64-key tiles this kernel shares): 8, halved while a
    split would cover fewer than 64 keys or the blocks outnumber the SMs."""
    return fused_num_splits(bkv, skv, "tc")


def build() -> tuple[Path, str, float]:
    """Compile the simt kernel if needed -> (library path, nvcc log, seconds)."""
    return build_library(SOURCE, BASE_FLAGS, "flash_attention")


def build_tc(tanhf: bool = False) -> tuple[Path, str, float]:
    """Compile the tensor-core kernel if needed -> (library path, nvcc log,
    seconds).  With ``tanhf`` its softcap runs libdevice's accurate tanhf in
    place of tanh.approx.f32: chip_smoke.py's comparison, on no main path."""
    if tanhf:
        return build_library(SOURCE_TC, (*BASE_FLAGS, "-DFLASH_TC_TANHF"),
                             "flash_attention_tc_tanhf")
    return build_library(SOURCE_TC, BASE_FLAGS, "flash_attention_tc")


def build_short() -> tuple[Path, str, float]:
    """Compile the short-block kernel if needed -> (library path, nvcc log, seconds)."""
    return build_library(SOURCE_SHORT, BASE_FLAGS, "flash_attention_short")


def build_split() -> tuple[Path, str, float]:
    """Compile the split-key kernel if needed -> (library path, nvcc log, seconds)."""
    return build_library(SOURCE_SPLIT, BASE_FLAGS, "flash_attention_split")


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded simt kernel library (built on first use)."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.flash_attention_fwd.argtypes = [_P] * 5 + [_I] * 9 + [_F, _F, _I, _I, _P]
    lib.flash_attention_fwd.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def library_tc(tanhf: bool = False) -> ctypes.CDLL:
    """The loaded tensor-core kernel library (built on first use)."""
    path, _, _ = build_tc(tanhf)
    lib = ctypes.CDLL(str(path))
    lib.flash_attention_tc_fwd.argtypes = [_P] * 5 + [_I] * 9 + [_F, _F, _I, _P, _P]
    lib.flash_attention_tc_fwd.restype = _I
    return lib


@functools.lru_cache(maxsize=1)
def library_short() -> ctypes.CDLL:
    """The loaded short-block kernel library (built on first use)."""
    path, _, _ = build_short()
    lib = ctypes.CDLL(str(path))
    lib.flash_attention_short_fwd.argtypes = [_P] * 5 + [_I] * 9 + [_F, _F, _I, _P]
    lib.flash_attention_short_fwd.restype = _I
    return lib


@functools.lru_cache(maxsize=1)
def library_split() -> ctypes.CDLL:
    """The loaded split-key kernel library (built on first use)."""
    path, _, _ = build_split()
    lib = ctypes.CDLL(str(path))
    lib.flash_attention_split_fwd.argtypes = [_P] * 5 + [_I] * 9 + [_F, _F, _I, _I, _P]
    lib.flash_attention_split_fwd.restype = _I
    return lib


_TC_COUNTS: dict = {}


def _tc_counts(device: torch.device, stream: int) -> int:
    """The tc kernel's item counts on ``stream`` (two int32, zero between
    launches: each launch counts the items its blocks take and sets them back
    to 0 at its end) -> their device address.  One pair a stream, so that
    only launches that run in order share one."""
    key = (device.index, stream)
    if key not in _TC_COUNTS:
        _TC_COUNTS[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return _TC_COUNTS[key].data_ptr()


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
    kind: str,
    tanhf: bool = False,
) -> None:
    """Launch the ``kind`` kernel ("tc", "short", "split" or "simt", see
    ``route``) on the current stream (the caller validated operands); "tc"
    from its ``build_tc(tanhf)`` library, "split" over
    ``split_num_splits`` blocks a (b, kv head)."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    args = [
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if kv_len is None else kv_len.data_ptr(),
        b, sq, skv, h, kvh, d,
        int(causal), -1 if window is None else int(window),
        int(softcap is not None), 0.0 if softcap is None else float(softcap),
        1.0 / math.sqrt(d), int(q_offset_from_kv_len),
    ]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if kind == "tc":
        err = library_tc(tanhf).flash_attention_tc_fwd(*args, _tc_counts(q.device, stream),
                                                       stream)
    elif kind == "short":
        err = library_short().flash_attention_short_fwd(*args, stream)
    elif kind == "split":
        ns = split_num_splits(b * kvh, skv)
        err = library_split().flash_attention_split_fwd(*args, ns, stream)
    elif kind == "simt":
        err = library().flash_attention_fwd(*args, int(q.dtype == torch.bfloat16), stream)
    else:
        raise ValueError(f"no flash-attention kernel {kind!r}: one of {ROUTE_NAMES}")
    check_launch(err, f"flash_attention ({kind})")
