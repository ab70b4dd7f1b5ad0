"""Time the tc flash-attention kernel at the shapes the main paths give it,
repeatedly, from one checkout's sources, beside the library call.

    python3 tools/flash_tc_timings.py [--root DIR] [--reps N] [--match TEXT ...]

``--root`` is the checkout whose ``src/repro_torch`` and ``chip_smoke.py``
are used (default: this one), so two commits are compared by running the
script once against each, in turns, on the same card.  ``--match`` keeps the
shapes whose name holds one of the TEXTs.  The shapes: the qwen3-1.7b prefill of the
main path, a causal S 4,096, the qwen3 ``prefill_32k`` layer, and every tc
shape of the model zoo (D 64 / 128, h2o-danube's D 80, gemma2's D 256).
Each shape's kernel output is first held against the library call within
2e-2 (a check that the build computes attention, not the contract's: that
is ``chip_smoke.py`` phase 2).  Each rep times every shape once with
chip_smoke's ``_time_ms`` (the median of 25 CUDA-event runs of 10 calls, one
call a run from 1 ms), kernel then library: ``scaled_dot_product_attention``
over the live keys (a window as a mask), or the compiled ``flex_attention``
where there is a softcap.  Prints the tc build's ptxas lines (registers,
spills, warnings) and one JSON line: the card and its power limit, the
root, and per shape the reps' kernel and library times in ms.  Needs one GPU
and nvcc.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

# b, sq, skv, h, kv, d, causal, window, softcap, kv_len, q_offset_from_kv_len
SHAPES = {
    "qwen3 prefill (B 8, Sq 2,048 over 4,096, kv_len 2,048)":
        (8, 2048, 4096, 16, 8, 128, True, None, None, 2048, True),
    "causal S 4,096 (B 1, H 16, KV 8)": (1, 4096, 4096, 16, 8, 128, True, None, None, None, False),
    "qwen3 prefill_32k layer (B 8 x 32,768, causal)":
        (8, 32768, 32768, 16, 8, 128, True, None, None, 32768, True),
    "hymba prefill (D 64, G 5)": (1, 2048, 2080, 25, 5, 64, True, None, None, 2048, True),
    "seamless encoder (D 64, S 1,024, non-causal)":
        (1, 1024, 1024, 16, 16, 64, False, None, None, None, True),
    "seamless cross prefill (D 64, 512 over 1,024)":
        (1, 512, 1024, 16, 16, 64, False, None, None, None, True),
    "seamless decoder self-attention (D 64, 512, G 1)":
        (1, 512, 544, 16, 16, 64, True, None, None, 512, True),
    "nemotron prefill (G 6, 2,048)": (1, 2048, 2080, 48, 8, 128, True, None, None, 2048, True),
    "llava prefill (G 4, 3,392)": (1, 3392, 3424, 32, 8, 128, True, None, None, 3392, True),
    "grok-1 prefill (G 6, 512)": (1, 512, 544, 48, 8, 128, True, None, None, 512, True),
    "arctic prefill (G 7, 512)": (1, 512, 544, 56, 8, 128, True, None, None, 512, True),
    "h2o-danube prefill (D 80, 4,608, window 4,096)":
        (1, 4608, 4640, 32, 8, 80, True, 4096, None, 4608, True),
    "gemma2 local (D 256, 4,608, window 4,096, softcap 50)":
        (1, 4608, 4640, 16, 8, 256, True, 4096, 50.0, 4608, True),
    "gemma2 global (D 256, 4,608, softcap 50)":
        (1, 4608, 4640, 16, 8, 256, True, None, 50.0, 4608, True),
}
TOL = 2e-2


def _ptxas_lines(log: str) -> list[str]:
    """The tc build's ptxas -v summary: each instantiation's registers,
    spills, any warning, and any note that ptxas serialized the wgmma
    products or injected a wait for their accumulators (C7514, C7517:
    "info" lines, not warnings)."""
    lines, name = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line.strip()
        elif ("spill stores" in line or "Used" in line or "arning" in line
              or "(C75" in line):
            lines.append(f"{name}: {line.split(' : ')[-1].strip()}")
    return lines


def _library_call(chip_smoke, q, k, v, causal, window, cap, live):
    """SDPA over the ``live`` keys (a window as a boolean mask), or the
    compiled flex_attention with the softcap: [B, Sq, H, D] out."""
    import torch
    import torch.nn.functional as tnf

    if cap is not None:
        call = chip_smoke._flex_call(q, k[:, :live], v[:, :live], causal=causal, window=window,
                                     cap=cap, q_base=0)
        return lambda: call().transpose(1, 2)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k[:, :live], v[:, :live]))
    mask = None
    if window is not None:
        pos = torch.arange(live, device=q.device)
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    return lambda: tnf.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True).transpose(1, 2)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--match", nargs="*", default=[""])
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
    _, log, nvcc_s = kernel.build_tc()  # build before timing
    kernel.library_tc()
    print(f"[build] {root}: nvcc {nvcc_s:.2f} s", flush=True)
    for line in _ptxas_lines(log):
        print(f"[ptxas] {line}", flush=True)
    dev = torch.device("cuda")
    calls = {}
    for name, (b, sq, skv, h, kv, d, causal, window, cap, kv_len, q_off) in SHAPES.items():
        if not any(m in name for m in args.match):
            continue
        assert kernel.route(torch.bfloat16, sq, d, h // kv, skv) == "tc"
        g = torch.Generator(device=dev).manual_seed(sq * 131 + d)
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                   for shape in ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d)))
        kl = None if kv_len is None else torch.full((1,), kv_len, dtype=torch.int32, device=dev)
        live = skv if kv_len is None else kv_len
        assert not causal or not q_off or live == sq  # the library's queries start at key 0

        def kernel_call(q=q, k=k, v=v, kl=kl, causal=causal, window=window, cap=cap,
                        q_off=q_off):
            return ops.flash_attention(q, k, v, kl, causal=causal, window=window,
                                       logit_softcap=cap, q_offset_from_kv_len=q_off)

        library_call = _library_call(chip_smoke, q, k, v, causal, window, cap, live)
        got, want = kernel_call(), library_call()
        err = (got.float() - want.float()).abs().max().item()
        if not torch.allclose(got.float(), want.float(), rtol=TOL, atol=TOL):
            raise AssertionError(f"{name}: the tc kernel differs from the library call by {err}")
        print(f"[check] {name}: max abs diff from the library call {err:.3g} (tol {TOL})",
              flush=True)
        del got, want
        calls[name] = (kernel_call, library_call)
    times = {name: {"ms": [], "library_ms": []} for name in calls}
    for _ in range(args.reps):
        for name, (kernel_call, library_call) in calls.items():
            times[name]["ms"].append(chip_smoke._time_ms(kernel_call))
            times[name]["library_ms"].append(chip_smoke._time_ms(library_call))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    for name, t in times.items():
        ms, lib = statistics.median(t["ms"]), statistics.median(t["library_ms"])
        print(f"[time] {name}: tc {ms:.4f} ms, library {lib:.4f} ms ({ms / lib:.3f}x)",
              flush=True)
    print(json.dumps({"card": smi, "root": str(root), "ptxas": _ptxas_lines(log),
                      "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
