"""Time the fused decode kernel's tensor-core form at chip_smoke.py's bf16
decode shapes, repeatedly, from one checkout's sources.

    python3 tools/decode_tc_timings.py [--root DIR] [--reps N]

``--root`` is the checkout whose ``src/repro_torch`` and ``chip_smoke.py``
are used (default: this one), so two versions are compared by running the
script once against each, in turns, on the same card.  The shapes are
chip_smoke's ``DA_CASES`` in bf16 (the qwen3-1.7b decode and the zoo's,
each on the form ``kernel.fused_route`` names).  Each rep times every shape
once with chip_smoke's ``_time_ms`` (the median of 25 CUDA-event runs of
10 calls, behind a device sleep).  Prints one JSON line: the card, the
root, per shape the reps' times in ms and the output's largest distance
from ``reference_decode``.  Needs one GPU and nvcc.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels.decode_attention import kernel, ops, ref

    assert Path(kernel.__file__).resolve().is_relative_to(root), kernel.__file__
    kernel.library_fused()  # build before timing
    dev = torch.device("cuda")
    calls, errs = {}, {}
    for case in chip_smoke.DA_CASES:
        b, skv, h, kv, d, kv_len, window, cap, dtype = case
        if dtype != "bfloat16":
            continue
        g = torch.Generator(device=dev).manual_seed(kv_len + d)
        q = torch.randn((b, 1, h, d), generator=g, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((b, skv, kv, d), generator=g, device=dev).to(torch.bfloat16)
                for _ in range(2))
        kl = torch.full((1,), kv_len, dtype=torch.int32, device=dev)
        name = (f"B {b} H {h} KV {kv} D {d} kv_len {kv_len} window {window} softcap {cap} "
                f"({kernel.fused_route(q.dtype, d)})")
        calls[name] = functools.partial(ops.decode_attention, q, k, v, kl, softcap=cap,
                                         window=window)
        want = ref.reference_decode(q, k, v, kl, softcap=cap, window=window)
        errs[name] = (calls[name]().float() - want.float()).abs().max().item()
    times = {name: [] for name in calls}
    for _ in range(args.reps):
        for name, call in calls.items():
            times[name].append(chip_smoke._time_ms(call))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "root": str(root), "ms": times, "max_abs_err": errs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
