"""Where one session epoch spends its time on the card.

    python -m repro_torch.launch.profile [--epochs 8] [--mode best|table]

Builds the main-path session (524,288 rows grown to 1,048,576 by one ingest,
8 tenant slots, bf16 substrate), admits the tenants and grows the state as
``chip_smoke.py``'s main path does, then runs ``--epochs`` supersteps under
``torch.profiler`` and prints: the wall time per epoch, the device-busy
share of that wall time (sum of kernel times over wall time; kernels on one
stream do not overlap), and the kernels with the most device time.  Needs a
GPU; it has no CPU mode.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import torch

from repro_torch.core.executor import EngineConfig
from repro_torch.core.query import conjunction
from repro_torch.core.session import EngineSession
from repro_torch.launch import serve


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--mode", default="best", choices=("best", "table"))
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile needs a GPU (torch.cuda.is_available() is False)")

    session, state, pool, preds = serve.build_session_server(
        num_objects=524288, capacity=524288, max_capacity=1 << 20, num_preds=4,
        max_tenants=8, substrate_dtype="bfloat16", device="cuda",
    )
    for cols in ((0, 1), (1, 2, 3), (0, 2), (2, 3), (0, 1, 2, 3), (1, 3), (0, 3), (1, 2)):
        state, _ = session.admit(state, conjunction(*[preds[c] for c in cols]))
    state = session.ingest(state, pool)
    prog = EngineSession(
        session.global_predicates, session.table, session.combine_params, session.costs,
        capacity=state.capacity, max_tenants=8, device="cuda",
        config=EngineConfig(plan_size=64, function_selection=args.mode,
                            substrate_dtype="bfloat16"),
    ).program
    state, _ = prog.run_scan(state, 2, stop_when_exhausted=False)  # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, _ = prog.run_scan(state, args.epochs, stop_when_exhausted=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernel records only: the aten:: operator records repeat their kernels' time
    events = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0
    ]
    busy_us = sum(_device_us(e) for e in events)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"[profile] {smi}")
    print(f"[profile] {args.mode} mode, 8 tenants, {state.capacity} rows (bf16): "
          f"{args.epochs} epochs in {wall * 1e3:.3f} ms wall = "
          f"{wall * 1e3 / args.epochs:.3f} ms/epoch; device busy "
          f"{busy_us / 1e3:.3f} ms = {busy_us / 1e6 / wall:.1%} of wall"
          if busy_us else "[profile] the profiler recorded no device time: not measured")
    for e in sorted(events, key=_device_us, reverse=True)[: args.top]:
        print(f"[profile]   {_device_us(e) / 1e3 / args.epochs:9.4f} ms/epoch  "
              f"{e.count // max(args.epochs, 1):5d} calls/epoch  {e.key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
