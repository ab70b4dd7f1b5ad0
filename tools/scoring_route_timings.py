"""Time the scoring kernels' two table routes on the same inputs over a ladder
of table sizes, and best mode's global route at chip_smoke.py's shapes, from
one checkout's sources.

    python3 tools/scoring_route_timings.py [--root DIR] [--reps N]
                                           [--cases ladder,global,sass]
                                           [--dtypes bfloat16,float32] [--match A,B]

``--root`` is the checkout whose ``src/repro_torch`` and ``chip_smoke.py``
are used (default: this one), so two versions are compared by running the
script once against each, in turns, on the same card.  The cases:

* ``ladder``: for each mode both routes (``kernel.launch_*`` with the route
  named, uncounted) on one set of rows in each of ``--dtypes`` (the
  single-query kernel: f32 only) and the analytic fallback table at 10
  bins, outputs equal, at the tables of ``LADDER`` (best mode Q 8, table
  mode Q 8, each with about 4M lanes; the single-query kernel at N 1M, Q
  1).  The size of a rung is the smem route's shared memory
  (``kernel.best_smem_bytes`` / ``table_smem_bytes``): the crossover is the
  smallest size from which the global route is the faster;
* ``global``: best mode's global route at phase 2's shapes (C 1M, P 4, Q 8,
  F 8, 10 and 11, rows in each of ``--dtypes``, the fallback table), through
  ``ops.fused_benefits_batched``, and the number of benefit divisions the
  lane kernels do on these inputs (``ref.best_screen``, where the checkout
  has it) beside the functions that remain (what the unscreened fold
  divides);
* ``sass``: per scoring kernel instantiation, its instruction count and
  the count of a few opcodes in ``cuobjdump -sass`` of the built library
  (the toolkit's ``cuobjdump``).

The JSON line also carries nvcc's seconds and, per best-mode instantiation,
ptxas's register and spill summary (``ptxas``), where this run built the
library.

``--match`` keeps the ladder rungs and global cases whose key (e.g. ``best
P4 F4 bfloat16``) holds one of the given strings.  A ladder rung's two
routes are timed in turns, ``--reps`` times each, as soon as its inputs are
made, and its tensors are freed before the next rung; each rep of the
global cases times every case once.  A time is chip_smoke's ``_time_ms``
(the median of 25 CUDA-event runs of 10 calls, behind a device sleep).  Prints one JSON
line: the card (``nvidia-smi`` name and power limit), the root, per case the
reps' times in ms.  Needs one GPU and nvcc.
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

# (P, F) rungs by mode (the main paths' P 3 F 3, P 4 F 4, P 2 F 4 first); sizes at
# 10 bins and a 4,096-bin LUT
LADDER = {
    "best": ((3, 3), (4, 4), (1, 6), (2, 6), (1, 7), (3, 6), (4, 6), (1, 8), (3, 7), (4, 7),
             (2, 8)),
    "table": ((3, 3), (4, 4), (4, 5), (4, 6), (5, 6), (6, 6), (7, 6), (4, 7), (4, 8), (6, 8),
              (8, 8), (10, 8)),
    "single": ((2, 4), (2, 5), (4, 5), (3, 6), (4, 6), (5, 6), (4, 7), (4, 8), (6, 8), (8, 8),
               (10, 8)),
}
LANES = 1 << 22  # best and table mode: C = LANES // P rows
N_SINGLE = 1 << 20  # the operator's objects
Q = 8
GLOBAL_SHAPES = ((1 << 20, 4, 8), (1 << 20, 4, 10), (1 << 20, 4, 11))  # C, P, F
OPCODES = ("MUFU.RCP", "FCHK", "CALL.REL", "BRA", "LDG", "LDS", "STG", "FMUL", "FSETP",
           "FSEL", "FMNMX", "F2F", "PRMT", "IMAD")


def _inputs(chip_smoke, dev, dtype, c, p, f, q):
    import numpy as np
    import torch

    from repro_torch.core.decision_table import fallback_decision_table

    table = fallback_decision_table(p, f, torch.linspace(0.6, 0.9, f)).to(dev)
    costs = torch.tensor(np.tile(np.linspace(0.05, 0.9, f), (p, 1)), dtype=torch.float32,
                         device=dev)
    rows = chip_smoke._kernel_inputs(dev, dtype, False, 41, c, p, f, q)
    return table, costs, rows


def ladder_case(chip_smoke, mode, p, f, lut, dtype):
    """-> (smem bytes, {route: call}) on one set of inputs, outputs equal."""
    import torch

    from repro_torch.kernels.enrich_score import kernel

    dev = lut.device
    c, q = (N_SINGLE, 1) if mode == "single" else (LANES // p, Q)
    table, costs, (pp, unc, sid, joint) = _inputs(chip_smoke, dev, dtype, c, p, f, q)
    nbytes = (kernel.best_smem_bytes if mode == "best" else kernel.table_smem_bytes)(
        p, 2**f, 10, f, 4096)
    shape = (c, p) if mode == "single" else (q, c, p)
    outs = {r: tuple(torch.empty(shape, dtype=dt, device=dev) for dt in
                     (torch.float32, torch.int32, torch.float32, torch.float32))
            for r in kernel.ROUTES}
    cand = torch.rand((c,), generator=torch.Generator(device=dev).manual_seed(5),
                      device=dev) > 0.3

    def call(route):
        if mode == "best":
            kernel.launch_best(pp, unc, sid, joint, table.delta_h_all, costs, lut, outs[route],
                               route)
        elif mode == "table":
            kernel.launch_table(pp, unc, sid, joint, table.delta_h, table.next_fn, costs, lut,
                                outs[route], route)
        else:
            kernel.launch_single(pp, unc, sid, joint[0], cand, table.delta_h, table.next_fn,
                                 costs, lut, outs[route], route)

    for route in kernel.ROUTES:
        call(route)
    torch.cuda.synchronize()
    for a, b in zip(*outs.values()):
        assert torch.equal(a, b), f"{mode}: the two routes differ at P {p} F {f}"
    return nbytes, {r: functools.partial(call, r) for r in kernel.ROUTES}


def global_case(chip_smoke, dtype, c, p, f, lut):
    """-> (call, divisions or None, remaining functions summed over tenants)."""
    import torch

    from repro_torch.kernels.enrich_score import ops, ref

    table, costs, (pp, unc, sid, joint) = _inputs(chip_smoke, lut.device, dtype, c, p, f, Q)
    call = functools.partial(ops.fused_benefits_batched, pp, unc, sid, joint, table, costs, "best")
    got = call()
    want = ref.enrich_score_best_ref(pp, unc, sid, joint, table.delta_h_all, costs, lut)
    for a, b in zip(got, want):
        assert torch.equal(a, b), f"best F {f} {dtype}: the global route differs from plain"
    divisions = None
    if hasattr(ref, "best_screen"):
        out, divisions = ref.best_screen(pp, unc, sid, joint, table.delta_h_all, costs, lut)
        for a, b in zip(out, want):
            assert torch.equal(a, b), f"best F {f} {dtype}: the screen's twin differs"
    bins = ref._bins(unc.float(), 10)
    rows = table.delta_h_all[torch.arange(p, device=lut.device)[None, :], sid.long(), bins]
    remaining = int(torch.isfinite(rows).sum()) * Q
    return call, divisions, remaining


def sass_counts(lib: Path) -> dict:
    """{kernel instantiation: {"instructions": n, opcode: n}} of ``lib``."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = shutil.which("cuobjdump") or str(Path(CUDA_HOME or "/usr/local/cuda") / "bin"
                                            / "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                         check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = collections.Counter()
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            op = line.split("*/", 1)[1].strip().split(";")[0].split()
            if not op:
                continue
            op = op[1] if op[0].startswith("@") and len(op) > 1 else op[0]
            counts[name]["instructions"] += 1
            for want in OPCODES:
                if op.startswith(want):
                    counts[name][want] += 1
    demangled = subprocess.run(["c++filt"], input="\n".join(counts), capture_output=True,
                               text=True).stdout.splitlines() if shutil.which("c++filt") else []
    names = demangled if len(demangled) == len(counts) else list(counts)
    return {n: dict(c) for n, c in zip(names, counts.values()) if "best" in n}


def ptxas_summary(log: str) -> dict:
    """{mangled best-mode kernel: [ptxas -v summary lines]} of an nvcc log."""
    out, name = {}, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line.strip()
        elif "best" in name and ("spill stores" in line or "Used" in line):
            out.setdefault(name, []).append(line.split(" : ")[-1].strip())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cases", default="ladder,global,sass")
    ap.add_argument("--dtypes", default="bfloat16,float32")
    ap.add_argument("--match", default="", help="comma-separated parts of case keys to keep")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    which = set(args.cases.split(","))
    parts = [m for m in args.match.split(",") if m]

    def wanted(key):
        return not parts or any(m in key for m in parts)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels.enrich_score import kernel, ops

    assert Path(kernel.__file__).resolve().is_relative_to(root), kernel.__file__
    lib, log, nvcc_s = kernel.build()
    kernel.library()
    dev = torch.device("cuda")
    lut = ops._lut(4096, dev)
    dtypes = [getattr(torch, d) for d in args.dtypes.split(",")]
    calls, times = {}, {}
    result = {"card": chip_smoke._nvidia_smi(), "root": str(root), "nvcc_s": nvcc_s,
              "ptxas": ptxas_summary(log)}
    if "ladder" in which:
        result["ladder"] = {}
        for mode, rungs in LADDER.items():
            for dtype in [torch.float32] if mode == "single" else dtypes:
                for p, f in rungs:
                    key = f"{mode} P{p} F{f} {str(dtype)[6:]}"
                    if not wanted(key):
                        continue
                    nbytes, by_route = ladder_case(chip_smoke, mode, p, f, lut, dtype)
                    result["ladder"][key] = {"smem_bytes": nbytes, "route_now": kernel.table_route(
                        mode, p, 2**f, 10, f, 4096)}
                    for _ in range(args.reps):
                        for route, call in by_route.items():
                            times.setdefault(f"{key} {route}", []).append(
                                chip_smoke._time_ms(call))
                    del by_route
                    torch.cuda.empty_cache()
    if "global" in which:
        result["global"] = {}
        for c, p, f in GLOBAL_SHAPES:
            for dtype in dtypes:
                key = f"best global P{p} F{f} {str(dtype)[6:]}"
                if not wanted(key):
                    continue
                calls[key], divisions, remaining = global_case(chip_smoke, dtype, c, p, f, lut)
                result["global"][key] = {"divisions": divisions, "remaining": remaining,
                                         "lane_tenants": Q * c * p}
    for _ in range(args.reps):
        for key, call in calls.items():
            times.setdefault(key, []).append(chip_smoke._time_ms(call))
    result["ms"] = times
    if "sass" in which:
        result["sass"] = sass_counts(lib)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
