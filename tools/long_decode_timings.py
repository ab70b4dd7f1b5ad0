"""Time kernel 5's two mesh-free decode forms at long caches: the fused
route and the split route, on the same inputs, over a ladder of cache
lengths, to place ``decode_attention.ops.SPLIT_FROM``.

    python3 tools/long_decode_timings.py [--root DIR] [--reps N]

``--root`` is the checkout whose ``src/repro_torch`` and ``chip_smoke.py``
are used (default: this one).  For each case (batch, cache rows, heads, kv
heads, head dim, window, softcap; the query at the last row, every row
live up to the window) it times, with chip_smoke's ``_time_ms`` (the median
of 25 CUDA-event runs of 10 calls behind a device sleep):

* "fused": the fused kernel's tc form at ``fused_num_splits`` (one launch,
  at most 8 blocks a (b, kv head));
* "split": ``ops.decode_attention_split`` (the partials kernel's tc form at
  ``default_num_splits`` splits of the cache) and ``ref.combine_partials``
  — what ``decode_attention`` runs on its split route; "partials" is the
  kernel alone;

holds both against ``ref.reference_decode`` (bf16: 2e-2), and prints the
keys a fused block reads.  The cases: hymba-1.5b's decode (B 1, H 25 / KV
5, D 64) and gemma2-9b's global layer (H 16 / KV 8, D 256, softcap 50)
from 4,096 to 524,288 keys, qwen3-1.7b's (H 16 / KV 8, D 128) at B 16 from
4,096 to 32,768 keys and at B 8 x 4,096 (phase 7), and h2o-danube-1.8b's
window (H 32 / KV 8, D 80, 4,097 live keys) at 524,288 rows.  Prints one
JSON line: the card, per case the reps' times.  Needs one GPU and nvcc.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HYMBA = [(1, 1 << e, 25, 5, 64, None, None) for e in range(12, 20)]
GEMMA2 = [(1, 1 << e, 16, 8, 256, None, 50.0) for e in range(12, 20)]
QWEN3 = [(16, 1 << e, 16, 8, 128, None, None) for e in range(12, 16)] + [
    (8, 4096, 16, 8, 128, None, None)]
DANUBE = [(1, 524288, 32, 8, 80, 4097, None)]
CASES = HYMBA + GEMMA2 + QWEN3 + DANUBE
TOL = 2e-2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels.decode_attention import kernel, ops, ref

    with ThreadPoolExecutor(2) as pool:
        [f.result() for f in [pool.submit(kernel.build), pool.submit(kernel.build_fused)]]
    dev = torch.device("cuda")
    rows = []
    for case in CASES:
        b, skv, h, kv, d, window, cap = case
        gen = torch.Generator(device=dev).manual_seed(skv + d)
        q = torch.randn((b, 1, h, d), generator=gen, device=dev, dtype=torch.bfloat16)
        k, v = (torch.randn((b, skv, kv, d), generator=gen, device=dev, dtype=torch.bfloat16)
                for _ in range(2))
        kl = torch.full((1,), skv, dtype=torch.int32, device=dev)
        kw = dict(softcap=cap, window=window)
        fns = ops.fused_num_splits(b * kv, skv, "tc")
        pns = ref.split_count(skv, ops.default_num_splits(b * kv, skv, "tc"))

        def fused():
            return ops.decode_attention(q, k, v, kl, num_splits=fns, **kw)

        def partials():
            return ops.decode_attention_split(q, k, v, kl, **kw)

        def split():
            return ref.combine_partials(*partials()).reshape(b, 1, h, d).to(q.dtype)

        oracle = ref.reference_decode(q, k, v, kl, **kw).float()
        errs = {name: (fn().float() - oracle).abs().max().item()
                for name, fn in (("fused", fused), ("split", split))}
        torch.cuda.synchronize()
        assert all(e <= TOL for e in errs.values()), (case, errs)
        live = skv if window is None else min(skv, window)
        row = dict(case=dict(b=b, skv=skv, h=h, kv=kv, d=d, window=window, softcap=cap),
                   fused_splits=fns, keys_a_fused_block=live // fns, partials_splits=pns,
                   route=ops.decode_route(q.dtype, d, b * kv, skv, window), max_abs_err=errs,
                   ms={"fused": [], "split": [], "partials": []})
        for _ in range(args.reps):
            for name, fn in (("fused", fused), ("split", split), ("partials", partials)):
                row["ms"][name].append(chip_smoke._time_ms(fn))
        print(f"[long-decode] {row}", flush=True)
        rows.append(row)
        del q, k, v, oracle
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "root": str(root), "split_from": ops.SPLIT_FROM,
                      "cases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
