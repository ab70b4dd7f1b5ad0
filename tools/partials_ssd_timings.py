"""Time kernel 5's partials forms and kernel 6's SSD routes at chip_smoke.py's
main-path shapes, repeatedly, from one checkout's sources.

    python3 tools/partials_ssd_timings.py [--root DIR] [--reps N]

``--root`` is the checkout whose ``src/repro_torch`` and ``chip_smoke.py``
are used (default: this one), so two versions are compared by running the
script once against each, in turns, on the same card; a case the
checkout's kernels do not have (the partials' tc form, the SSD build with
another head group at N 16) is left out.  The cases:

* the partials kernel at chip_smoke's ``DA_ROW`` (the qwen3-1.7b decode:
  B 8, KV 8, G 2, D 128, kv_len 2,048 of 4,096, bf16): the tc form at 4, 8,
  16 and 32 splits over the cache length, the simt form at 16 (its
  ``default_num_splits``); the fused kernel (the mesh-free route) beside;
* the SSD intra-chunk kernel at hymba-1.5b's prefill (S 2,048, H 50, P 64,
  N 16, chunk 256): "tc" built with 4, 2 and 1 heads a block
  (``ssd_scan.kernel.build_tc(heads_n16)``), and "simt";
* the SSD "tc" route at the mamba2-370m prefill (B 2, S 4,096, H 32, N 128).

Each rep times every case once with chip_smoke's ``_time_ms`` (the median of
25 CUDA-event runs of 10 calls, behind a device sleep).  Prints one JSON
line: the card, the root, per case the reps' times in ms, and the cases
that failed with their error.  Needs one GPU and nvcc.
"""

from __future__ import annotations

import argparse
import functools
import inspect
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel

    assert Path(da_kernel.__file__).resolve().is_relative_to(root), da_kernel.__file__
    heads = "heads_n16" in inspect.signature(ssd_kernel.launch).parameters
    builds = [da_kernel.build, da_kernel.build_fused, ssd_kernel.build, ssd_kernel.build_tc]
    builds += [functools.partial(ssd_kernel.build_tc, hg) for hg in (4, 2, 1) if heads]
    with ThreadPoolExecutor(len(builds)) as pool:  # one nvcc per library, all at once
        [f.result() for f in [pool.submit(b) for b in builds]]
    dev = torch.device("cuda")
    calls = {}

    # kernel 5 at the qwen3-1.7b decode
    b, skv, h, kv, d, kv_len, window, cap, dtype = chip_smoke.DA_ROW
    g = torch.Generator(device=dev).manual_seed(kv_len + d)
    q = torch.randn((b, 1, h, d), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b, skv, kv, d), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    kl = torch.full((1,), kv_len, dtype=torch.int32, device=dev)
    qm = q.reshape(b * kv, h // kv, d)
    calls["fused tc"] = functools.partial(da_ops.decode_attention, q, k, v, kl)
    ns = da_ref.split_count(skv, 16)  # the simt form's default_num_splits at this shape
    out = [torch.empty((b * kv, ns, h // kv), device=dev) for _ in range(2)]
    out.append(torch.empty((b * kv, ns, h // kv, d), device=dev))
    simt = {"form": "simt"} if hasattr(da_kernel, "partials_route") else {}
    calls[f"partials simt ns {ns}"] = functools.partial(da_kernel.launch, qm, k, v, kl, *out,
                                                        softcap=None, window=None, **simt)
    if simt:
        for n in (4, 8, 16, 32):
            calls[f"partials tc ns {n}"] = functools.partial(da_ops.cache_partials, qm, k, v, kl,
                                                             n, None, None)

    # kernel 6 at the hymba-1.5b and mamba2-370m prefills
    for label, (sb, s, chunk, final, nh, n) in (("hymba", chip_smoke.SSD_CASES[3]),
                                               ("mamba2", chip_smoke.SSD_CASES[0])):
        x = chip_smoke._ssd_inputs(sb, s, nh, n, dev, seed=s + n)
        nc = s // chunk
        outs = [torch.empty((sb, s, nh, chip_smoke.SSD_P), device=dev),
                torch.empty((sb, nh, nc if final else nc - 1, chip_smoke.SSD_P, n), device=dev),
                torch.empty((sb, nh, s), device=dev)]
        launch = functools.partial(ssd_kernel.launch, *x, *outs, chunk=chunk)
        if label == "mamba2":
            calls["ssd mamba2 tc"] = functools.partial(launch, kind="tc")
            continue
        calls["ssd hymba simt"] = functools.partial(launch, kind="simt")
        if heads:
            for hg in (4, 2, 1):
                calls[f"ssd hymba tc heads {hg}"] = functools.partial(launch, kind="tc",
                                                                      heads_n16=hg)
    errors = {}
    for name, call in list(calls.items()):  # warm up before timing; a case that fails is left out
        try:
            call()
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001  (reported in the JSON line, not timed)
            errors[name] = f"{type(e).__name__}: {e}"
            del calls[name]
    times = {name: [] for name in calls}
    for _ in range(args.reps):
        for name, call in calls.items():
            times[name].append(chip_smoke._time_ms(call))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "root": str(root), "ms": times, "errors": errors,
                      "ssd_kernel": ssd_kernel.__file__}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
