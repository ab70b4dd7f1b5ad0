"""Time kernel 6's inter-chunk recurrence: the PyTorch loop over chunks
(``ssd_scan.ref.inter_chunk_bshp``, the model's route before the kernel)
against the hand-written kernel (``csrc/ssd_inter_chunk.cu``) on the same
inputs, repeatedly, from one checkout's sources.

    python3 tools/ssd_inter_timings.py [--root DIR] [--reps N] [--match KEY ...]

``--root`` is the checkout whose ``src/repro_torch`` and ``chip_smoke.py``
are used (default: this one).  The cases (chip_smoke's ``INTER_CASES``
shapes, each with h0 and the final state, as a prefill into a cache runs
it): the mamba2-370m ``prefill_32k`` layer (B 16, S 32,768, H 32, P 64, N
128, chunk 256: 128 chunks), the mamba2-370m prefill of chip_smoke's phase 7
(B 2, S 4,096) and hymba-1.5b's prefill (B 1, S 2,048, H 50, N 16).  The
inputs are the intra-chunk kernel's outputs on chip_smoke's ``_ssd_inputs``.
Each rep times the loop and the kernel once with chip_smoke's ``_time_ms``
(the median of CUDA-event runs behind a device sleep; a call of 1 ms or more
runs alone).  The kernel adds into its y in place, so it is timed on a copy
of y_intra that the repeated calls keep adding into.  Prints one JSON line:
the card and its power limit, per case the reps' times in ms of both, the
bound (chip_smoke's ``_inter_bound``) and the kernel's median share of it.
Runs on no main path.  Needs one GPU and nvcc.
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics
import subprocess
import sys
from pathlib import Path

# label -> b, s, chunk, heads, state dim
CASES = {"mamba2 prefill_32k": (16, 32768, 256, 32, 128),
         "mamba2 prefill 2 x 4096": (2, 4096, 256, 32, 128),
         "hymba prefill": (1, 2048, 256, 50, 16)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--match", nargs="*", default=None, help="cases whose label holds a key")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels.ssd_scan import kernel, ops, ref

    assert Path(kernel.__file__).resolve().is_relative_to(root), kernel.__file__
    for build in (kernel.build_tc, kernel.build_inter):
        build()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for label, (b, s, chunk, h, n) in CASES.items():
        if args.match and not any(k in label for k in args.match):
            continue
        x, dt, a, bm, cm = chip_smoke._ssd_inputs(b, s, h, n, dev, seed=s + n)
        y_intra, s_contrib, cumexp = ops.intra_chunk(x, dt, a, bm, cm, chunk=chunk)
        del x, dt, bm
        h0 = torch.randn((b, h, chip_smoke.SSD_P, n), generator=torch.Generator(
            device=dev).manual_seed(s), device=dev)
        y = y_intra.clone()
        hf = torch.empty_like(h0)
        layout = kernel.inter_layout(b, h, chip_smoke.SSD_P, sms)
        kernel_call = functools.partial(kernel.launch_inter, y, s_contrib, cumexp, cm, h0, hf,
                                        chunk=chunk, layout=layout)
        loop_call = functools.partial(ref.inter_chunk_bshp, y_intra, s_contrib, cumexp, cm, h0,
                                      chunk=chunk)
        times = {"loop": [], "kernel": []}
        for _ in range(args.reps):  # in turns: loop, kernel
            times["loop"].append(chip_smoke._time_ms(loop_call, reps=5, warmup=1))
            times["kernel"].append(chip_smoke._time_ms(kernel_call))
        (bound_ms, bound_by), nbytes = chip_smoke._inter_bound(b, s, chunk, h, n, True, True,
                                                               c_bytes=2)
        out[label] = dict(shape=dict(b=b, s=s, chunk=chunk, h=h, p=chip_smoke.SSD_P, n=n),
                          layout=layout, ms=times, bound_ms=bound_ms, bound_by=bound_by,
                          bytes=nbytes,
                          share_of_bound=bound_ms / statistics.median(times["kernel"]))
        del y_intra, s_contrib, cumexp, cm, h0, y, hf, kernel_call, loop_call
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "root": str(root), "cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
