"""Compile a hand-written CUDA source into a shared library at first use.

Each kernel family keeps its sources under ``csrc/`` with a plain
``extern "C"`` interface (no PyTorch headers, so a build takes seconds) and
binds the library with ``ctypes``.  ``build_library`` runs ``nvcc`` into
``build/repro_torch/`` at the repository root, keyed on the hash of every
file under the source's ``csrc/`` and the flags, so a changed header or
sibling source rebuilds; a failed build raises with nvcc's stderr.

Nothing here touches CUDA or nvcc at import time: the CPU test suite imports
this module on machines with neither.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
BASE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills of each kernel, in the log
)


class KernelBuildError(RuntimeError):
    """nvcc failed; the message carries its stderr."""


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise KernelBuildError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def build_library(source: Path, flags: tuple, stem: str) -> tuple[Path, str, float]:
    """Compile ``source`` if needed -> (library path, nvcc log, seconds); the
    log is kept beside the library, so a library already built returns its
    build's log and 0 seconds."""
    h = hashlib.sha256(" ".join(flags).encode())
    for f in sorted(p for p in source.parent.rglob("*") if p.is_file()):
        h.update(f.relative_to(source.parent).as_posix().encode() + b"\0" + f.read_bytes())
    digest = h.hexdigest()[:16]
    lib = BUILD_DIR / f"{stem}_{digest}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        return lib, log.read_text() if log.exists() else "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc(), *flags, "-o", str(tmp), str(source)],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}) building {source.name}:\n{proc.stderr}"
        )
    log.write_text(proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
    return lib, proc.stderr, seconds


def check_launch(err: int, name: str) -> None:
    """Raise when a launcher returned a non-zero ``cudaGetLastError()``."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaGetLastError() == {err}")
