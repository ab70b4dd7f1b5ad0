"""Time the tc flash-attention kernel at chip_smoke.py's timed D 64 / 128
shapes, repeatedly, from one checkout's sources.

    python3 tools/flash_tc_timings.py [--root DIR] [--reps N]

``--root`` is the checkout whose ``src/repro_torch`` and ``chip_smoke.py``
are used (default: this one), so two commits are compared by running the
script once against each, in turns, on the same card.  Each rep times every
shape once with chip_smoke's ``_time_ms`` (the median of 25 CUDA-event runs
of 10 calls).  Prints one JSON line: the card, the root and, per shape, the
reps' times in ms.  Needs one GPU and nvcc.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
from pathlib import Path

# b, sq, skv, h, kv, d, causal, kv_len, q_offset_from_kv_len
SHAPES = {
    "qwen3 prefill (B 8, Sq 2,048 over 4,096, kv_len 2,048)":
        (8, 2048, 4096, 16, 8, 128, True, 2048, True),
    "causal S 4,096 (B 1, H 16, KV 8)": (1, 4096, 4096, 16, 8, 128, True, None, False),
    "hymba prefill (D 64, G 5)": (1, 2048, 2080, 25, 5, 64, True, 2048, True),
}


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
    from repro_torch.kernels.flash_attention import kernel, ops

    assert Path(kernel.__file__).resolve().is_relative_to(root), kernel.__file__
    kernel.library_tc()  # build before timing
    dev = torch.device("cuda")
    calls = {}
    for name, (b, sq, skv, h, kv, d, causal, kv_len, q_off) in SHAPES.items():
        assert kernel.route(torch.bfloat16, sq, d, h // kv, skv) == "tc"
        g = torch.Generator(device=dev).manual_seed(sq * 131 + d)
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                   for shape in ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d)))
        kl = None if kv_len is None else torch.full((1,), kv_len, dtype=torch.int32, device=dev)
        calls[name] = functools.partial(ops.flash_attention, q, k, v, kl, causal=causal,
                                         q_offset_from_kv_len=q_off)
    times = {name: [] for name in calls}
    for _ in range(args.reps):
        for name, call in calls.items():
            times[name].append(chip_smoke._time_ms(call))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "root": str(root), "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
