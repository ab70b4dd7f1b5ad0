"""Build and bind the hand-written CUDA ``enrich_score`` kernels.

``csrc/enrich_score.cu`` exposes three ``extern "C"`` launchers: the
batched table and best modes (each templated on f32 / bf16 probabilities)
and the single-query table mode with a candidate mask (f32).  Each takes
the table route that ``table_route`` picks from the shapes alone: "smem"
(the decision table staged in shared memory) below the mode's measured
crossover (``GLOBAL_FROM``) and, in best mode, at F <= 8; "global" (the
table read from device memory) for every larger table.  They are compiled
with ``nvcc`` for ``sm_90a`` into a shared library at first use
(``kernels/build.py``) and loaded with ``ctypes``.

Nothing here touches CUDA or nvcc at import time: the CPU test suite imports
this module on machines with neither.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import BASE_FLAGS, build_library, check_launch

SOURCE = Path(__file__).resolve().parent / "csrc" / "enrich_score.cu"
# every f32 op rounds on its own, as in the plain version: bitwise agreement
NVCC_FLAGS = BASE_FLAGS + ("--fmad=false",)
SMEM_LIMIT = 232_448  # bytes of shared memory one Hopper block may use
ROUTES = ("smem", "global")
MODES = ("table", "best", "single")
SMEM_MAX_FUNCTIONS = 8  # best mode's smem kernels are unrolled for F 1..8
LANE_MAX_FUNCTIONS = 10  # best mode's global lane kernels: F 1..10, unrolled
WIDE_MAX_FUNCTIONS = 32  # the wide kernel keeps a lane's remaining functions in 32 bits
WIDE_THREADS = 256  # the wide kernel's block: two columns of F floats a thread
# From these bytes of the smem route's shared memory (``*_smem_bytes``: the
# tables, the costs, the LUT) the "global" route runs the same inputs in
# less time: a block staging a large table holds its SM with few warps.
# Each is the smallest rung of ``tools/scoring_route_timings.py``'s ladder
# (10 bins, ~4M lanes and Q 8; the single-query kernel N 1M) from which the
# global route was the faster at every rung, with f32 and with bf16 rows
# alike, on an H100 80GB HBM3 at 700 W (PERF.md section 6; f32 / bf16):
# best P 1 F 7 (global 0.900x / 0.990x the smem time; P 2 F 6, 47,200 B:
# 1.186x / 1.231x), table P 5 F 6 (0.983x / 0.995x; P 4 F 6, 36,960 B:
# 1.009x / 1.006x), single P 3 F 6 (f32 only: 0.929x; P 4 F 5, 26,704 B:
# 1.007x).
GLOBAL_FROM = {"best": 52_280, "table": 42_104, "single": 31_816}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int


def build() -> tuple[Path, str, float]:
    """Compile the kernels if needed -> (library path, nvcc log, seconds)."""
    return build_library(SOURCE, NVCC_FLAGS, "enrich_score")


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.enrich_score_table.argtypes = [_P] * 12 + [_I64] + [_I] * 8 + [_P]
    lib.enrich_score_table.restype = _I
    lib.enrich_score_best.argtypes = [_P] * 11 + [_I64] + [_I] * 8 + [_P]
    lib.enrich_score_best.restype = _I
    lib.enrich_score_single.argtypes = [_P] * 13 + [_I64] + [_I] * 6 + [_P]
    lib.enrich_score_single.restype = _I
    return lib


def table_smem_bytes(p: int, s: int, b: int, f: int, lut_bins: int) -> int:
    return 4 * (p * s * b * 2 + p * f + lut_bins)


def best_smem_bytes(p: int, s: int, b: int, f: int, lut_bins: int) -> int:
    """The smem route's tables, [P, F] costs (and, in the lane kernel, their
    reciprocals) and the LUT."""
    return 4 * (p * s * b * f + 2 * p * f + lut_bins)


def global_smem_bytes(p: int, f: int, lut_bins: int) -> int:
    """Shared memory of the "global" route at most: the [P, F] costs and
    their reciprocals, the LUT and, past F 10 (best mode's wide kernel), two
    columns of F floats a thread (p_hat, the reciprocal costs)."""
    rows = 2 * WIDE_THREADS * f if f > LANE_MAX_FUNCTIONS else 0
    return 4 * (2 * p * f + lut_bins + rows)


def table_route(mode: str, p: int, num_states: int, num_bins: int, f: int,
                lut_bins: int) -> str:
    """"smem" where the mode's tables take fewer bytes of a block's shared
    memory than ``GLOBAL_FROM[mode]`` (and, in best mode, F <= 8), else
    "global".  ``mode``: "table", "best" or "single"."""
    if mode not in MODES:
        raise ValueError(f"unknown scoring mode: {mode!r}")
    if mode == "best":
        smem = (best_smem_bytes(p, num_states, num_bins, f, lut_bins)
                if f <= SMEM_MAX_FUNCTIONS else SMEM_LIMIT + 1)
    else:
        smem = table_smem_bytes(p, num_states, num_bins, f, lut_bins)
    return ROUTES[smem >= GLOBAL_FROM[mode]]


def launch_table(pred_prob, unc, state_id, joint, delta_tab, next_tab, costs, lut, out, route):
    """Launch the table-mode kernel on the current stream on ``route`` (one
    of ``ROUTES``); ``out`` is the (benefit, next_fn, est_joint, cost) tuple
    of preallocated [Q, C, P]."""
    c, p = pred_prob.shape
    _, s, b = delta_tab.shape
    err = library().enrich_score_table(
        pred_prob.data_ptr(), unc.data_ptr(), state_id.data_ptr(), joint.data_ptr(),
        delta_tab.data_ptr(), next_tab.data_ptr(), costs.data_ptr(), lut.data_ptr(),
        *(t.data_ptr() for t in out),
        c, p, joint.shape[0], s, b, costs.shape[1], lut.shape[0],
        int(pred_prob.dtype == torch.bfloat16), ROUTES.index(route),
        torch.cuda.current_stream(pred_prob.device).cuda_stream,
    )
    check_launch(err, "enrich_score_table")


def launch_best(pred_prob, unc, state_id, joint, delta_all, costs, lut, out, route):
    """Launch the best-mode kernel on the current stream on ``route``."""
    c, p = pred_prob.shape
    _, s, b, f = delta_all.shape
    err = library().enrich_score_best(
        pred_prob.data_ptr(), unc.data_ptr(), state_id.data_ptr(), joint.data_ptr(),
        delta_all.data_ptr(), costs.data_ptr(), lut.data_ptr(),
        *(t.data_ptr() for t in out),
        c, p, joint.shape[0], s, b, f, lut.shape[0],
        int(pred_prob.dtype == torch.bfloat16), ROUTES.index(route),
        torch.cuda.current_stream(pred_prob.device).cuda_stream,
    )
    check_launch(err, "enrich_score_best")


def launch_single(pred_prob, unc, state_id, joint, cand, delta_tab, next_tab, costs, lut, out,
                  route):
    """Launch the single-query kernel on the current stream on ``route``;
    ``out`` is the (benefit, next_fn, est_joint, cost) tuple of preallocated
    [N, P]."""
    n, p = pred_prob.shape
    _, s, b = delta_tab.shape
    err = library().enrich_score_single(
        pred_prob.data_ptr(), unc.data_ptr(), state_id.data_ptr(), joint.data_ptr(),
        cand.data_ptr(), delta_tab.data_ptr(), next_tab.data_ptr(), costs.data_ptr(),
        lut.data_ptr(), *(t.data_ptr() for t in out),
        n, p, s, b, costs.shape[1], lut.shape[0], ROUTES.index(route),
        torch.cuda.current_stream(pred_prob.device).cuda_stream,
    )
    check_launch(err, "enrich_score_single")
