"""Build and bind the hand-written CUDA ``enrich_score`` kernels.

``csrc/enrich_score.cu`` exposes two ``extern "C"`` launchers (table and
best mode, each templated on f32 / bf16 probabilities).  They are compiled
with ``nvcc`` for ``sm_90a`` into a shared library at first use and loaded
with ``ctypes`` — no PyTorch headers, so a build takes seconds.  The library
lands in ``build/repro_torch/`` at the repository root, keyed on the hash of
the source and flags; a failed build raises with nvcc's stderr.

Nothing here touches CUDA or nvcc at import time: the CPU test suite imports
this module on machines with neither.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "enrich_score.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "--fmad=false", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills of each kernel, in the log
)
SMEM_LIMIT = 232_448  # bytes of shared memory one Hopper block may use

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int


class KernelBuildError(RuntimeError):
    """nvcc failed; the message carries its stderr."""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise KernelBuildError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def build() -> tuple[Path, str, float]:
    """Compile the kernels if needed -> (library path, nvcc log, seconds);
    the log and seconds are empty / 0 when the library was already built."""
    flags = NVCC_FLAGS
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"enrich_score_{digest}.so"
    if lib.exists():
        return lib, "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *flags, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}) building {SOURCE.name}:\n{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
    return lib, proc.stderr, seconds


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.enrich_score_table.argtypes = [_P] * 12 + [_I64] + [_I] * 7 + [_P]
    lib.enrich_score_table.restype = _I
    lib.enrich_score_best.argtypes = [_P] * 11 + [_I64] + [_I] * 7 + [_P]
    lib.enrich_score_best.restype = _I
    return lib


def table_smem_bytes(p: int, s: int, b: int, f: int, lut_bins: int) -> int:
    return 4 * (p * s * b * 2 + p * f + lut_bins)


def best_smem_bytes(p: int, s: int, b: int, f: int, lut_bins: int) -> int:
    return 4 * (p * s * b * f + p * f + lut_bins)


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaGetLastError() == {err}")


def launch_table(pred_prob, unc, state_id, joint, delta_tab, next_tab, costs, lut, out):
    """Launch the table-mode kernel on the current stream; ``out`` is the
    (benefit, next_fn, est_joint, cost) tuple of preallocated [Q, C, P]."""
    c, p = pred_prob.shape
    _, s, b = delta_tab.shape
    err = library().enrich_score_table(
        pred_prob.data_ptr(), unc.data_ptr(), state_id.data_ptr(), joint.data_ptr(),
        delta_tab.data_ptr(), next_tab.data_ptr(), costs.data_ptr(), lut.data_ptr(),
        *(t.data_ptr() for t in out),
        c, p, joint.shape[0], s, b, costs.shape[1], lut.shape[0],
        int(pred_prob.dtype == torch.bfloat16),
        torch.cuda.current_stream(pred_prob.device).cuda_stream,
    )
    _check(err, "enrich_score_table")


def launch_best(pred_prob, unc, state_id, joint, delta_all, costs, lut, out):
    """Launch the best-mode kernel on the current stream."""
    c, p = pred_prob.shape
    _, s, b, f = delta_all.shape
    err = library().enrich_score_best(
        pred_prob.data_ptr(), unc.data_ptr(), state_id.data_ptr(), joint.data_ptr(),
        delta_all.data_ptr(), costs.data_ptr(), lut.data_ptr(),
        *(t.data_ptr() for t in out),
        c, p, joint.shape[0], s, b, f, lut.shape[0],
        int(pred_prob.dtype == torch.bfloat16),
        torch.cuda.current_stream(pred_prob.device).cuda_stream,
    )
    _check(err, "enrich_score_best")
