"""Where one epoch spends its time on the card.

    python -m repro_torch.launch.profile [--path session|operator|prefill|decode|train]
        [--bank simulated|cascade] [--backbone ARCH] [--epochs 8] [--mode best|table]
        [--shape prefill_32k|decode_32k|long_500k] [--batch B] [--ranges]

``--bank simulated`` (default) builds the main-path session (524,288 rows
grown to 1,048,576 by one ingest, 8 tenant slots, bf16 substrate), admits
the tenants and grows the state as ``chip_smoke.py``'s main path does.
``--bank cascade`` builds the cascade server at full width (the
``--backbone`` trunk: 28-layer qwen3-1.7b by default, the 48-layer
mamba2-370m, the 32-layer hymba-1.5b, ...; 2,048 objects, 3 predicates, 8
tenant slots, f32 substrate, best mode), admits 8 tenants and runs epochs
until the planner selects backbone lanes.  ``--path operator`` builds the paper's
single-query operator on the quickstart query and corpus at 1,048,576
objects (``repro_torch.quickstart``: 2 predicates, 4 functions, the
``preprocess_cheapest`` warm start, ``OperatorConfig()`` defaults) scoring
through ``ops.fused_benefits`` (the single-query kernel), and runs 2
warm-up epochs.  ``--path prefill`` and ``--path decode`` build the
``--backbone`` model at its published width with random weights
(``models.model.random_model``, the kernel route) at its serve shape
(``MODEL_SHAPES``: qwen3-1.7b 8 x 2,048 prompt tokens; mamba2-370m 2 x
4,096; gemma2-9b and h2o-danube-1.8b 1 x 4,608, past their 4,096-token
window; llava-next-mistral-7b 2,880 random image embeds + 512 tokens;
seamless-m4t-large-v2 512 tokens over 1,024 random frames; grok-1-314b and
arctic-480b at full width cut to the depth one 80 GB card holds,
``ONE_CARD_LAYERS``) and profile whole prefills, or decode steps after one
prefill; an "epoch" below is then one prefill or one decode step.  With
``--shape prefill_32k|decode_32k|long_500k`` they build the reference's
serve cell instead (``launch.cells.one_card_cell``: the batch and depth one
80 GB card holds) and run it through ``launch.steps.build_prefill_step`` /
``build_decode_step`` without a mesh: whole prefills of the cell's
length, or decode steps from a ``fill_cache``d cache at ``seq_len - 1``
(each step writes its last free row and attends over every row); ``--batch``
runs the cell at another batch (a measurement of the peak memory of a batch
that the reckoning does not admit yet).  ``--ranges`` times the Mamba-2
mixer's parts on the device (``SSM_RANGES``: CUDA events around every call
of the named functions) and prints each part's device time a prefill, so
the elementwise work can be split between the SSD's recurrence and the
mixer's conv, gates and norm.  ``--path
train`` builds the ``--backbone`` model at its published width with random
f32 weights and AdamW (``launch.steps.build_train_step``, the chunked
attention engine and remat) and profiles whole train steps over
``TRAIN_SHAPE`` (qwen3-1.7b: 4,096 tokens, a batch of 8 as 2 microbatches
of 4; ``SyntheticTokenStream``'s batch); an "epoch" is one step, and it also
times, with CUDA events, one cross-entropy chunk (forward and backward, at
the step's [4, 1,024] positions) and one optimiser update alone.  Then
``--epochs`` epochs run under ``torch.profiler`` and it prints: the wall
time per epoch, the device-busy share of that wall time (sum of kernel
times over wall time; kernels on one stream do not overlap), the device
time by kind (attention, scoring, matmuls, sorts and scans, elementwise
work, the rest), the kernels with the most device time and, for the
cascade, the device idle right after each bank-boundary host
read (from the end of its device-to-host copy to the start of the next
kernel).  Needs a GPU; it has no CPU mode.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import subprocess
import sys
import time
from typing import Optional

import torch

from repro_torch.configs.archs import ARCHS, get_config
from repro_torch.core.executor import EngineConfig
from repro_torch.core.query import conjunction
from repro_torch.core.session import EngineSession
from repro_torch.launch import serve
from repro_torch.quickstart import quickstart_operator, quickstart_world

TENANTS = ((0, 1), (1, 2, 3), (0, 2), (2, 3), (0, 1, 2, 3), (1, 3), (0, 3), (1, 2))
CASCADE_TENANTS = ((0, 1), (1, 2), (0, 2), (0,), (1,), (2,), (0, 1, 2), (0, 1))
KINDS = (  # (label, substrings of the kernel name), first match wins
    ("attention (flash kernel)", ("flash_attention",)),
    ("attention (decode kernel)", ("decode_partials", "decode_fused")),
    ("SSD kernels (intra, inter)", ("ssd_intra_chunk", "ssd_inter_chunk")),
    ("Mamba-2 mixer kernels", ("ssm_mixer",)),
    ("scoring (enrich_score)", ("enrich_score",)),
    ("matmuls (cuBLAS)", ("nvjet", "gemm", "sm90_xmma", "cutlass", "cublas")),
    ("sorts and scans", ("RadixSort", "scan", "Scan", "sort")),
    ("elementwise, copies, reductions", ("elementwise", "reduce_kernel", "CatArray", "Memcpy",
                                         "Memset", "index", "gather", "scatter")),
)

# --ranges: the Mamba-2 mixer's parts (module, function, label), each call
# timed on the device; the mixer's time less its parts' is its reshapes and
# casts.  The kernel engine (the serve paths) runs the two mixer kernels'
# wrappers; the plain engines run their twins, whose conv and norm are named
# here too (the twins' gates, softplus and D skip fall in the remainder).
SSM_RANGES = (
    ("repro_torch.models.ssm", "ssm_apply", "mixer, all of it"),
    ("repro_torch.models.ssm", "matmul", "in / out projections"),
    ("repro_torch.kernels.ssm_mixer.ops", "front", "mixer front kernel"),
    ("repro_torch.kernels.ssm_mixer.ops", "gated_norm", "mixer gated-norm kernel"),
    ("repro_torch.kernels.ssm_mixer.ref", "causal_conv", "twin: conv + SiLU"),
    ("repro_torch.kernels.ssm_mixer.ref", "rmsnorm", "twin: norm"),
    ("repro_torch.models.ssm", "ssd_chunked", "SSD, all of it"),
    ("repro_torch.kernels.ssd_scan.ops", "intra_chunk", "SSD intra-chunk"),
    ("repro_torch.kernels.ssd_scan.ops", "inter_chunk", "SSD inter-chunk"),
)

OPERATOR_OBJECTS = 1 << 20
MODEL_SHAPES = {  # batch, prompt tokens (after a vision model's image embeds)
    "qwen3-1.7b": (8, 2048), "mamba2-370m": (2, 4096), "nemotron-4-15b": (1, 2048),
    "gemma2-9b": (1, 4608), "h2o-danube-1.8b": (1, 4608), "hymba-1.5b": (1, 2048),
    "llava-next-mistral-7b": (1, 512), "seamless-m4t-large-v2": (1, 512),
    "grok-1-314b": (1, 512), "arctic-480b": (1, 512),
}
# full width, depth cut to what one 80 GB card holds in bf16: grok-1 ~9.8 GB a
# layer (8 experts of 3 x 6144 x 32768), arctic ~27 GB (128 of 3 x 7168 x 4864)
ONE_CARD_LAYERS = {"grok-1-314b": 4, "arctic-480b": 2}
# --path train: seq_len, global batch, microbatches (train_4k's 4,096 tokens;
# its batch of 256 cut to 8)
TRAIN_SHAPE = (4096, 8, 2)


def model_config(arch: str):
    """The published config, depth cut to ``ONE_CARD_LAYERS`` where given."""
    cfg = get_config(arch)
    if arch in ONE_CARD_LAYERS:
        cfg = dataclasses.replace(cfg, num_layers=ONE_CARD_LAYERS[arch])
    return cfg


def model_batch(cfg, batch: int, prompt: int, gen: torch.Generator) -> dict:
    """Random prompt tokens on the generator's device, plus random image
    embeds (vision) or frames (an encoder's input) at their published counts."""
    dev = gen.device
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen,
                                   device=dev)}
    if cfg.frontend == "vision":
        out["image_embeds"] = torch.randn((batch, cfg.num_image_tokens, cfg.d_model),
                                          generator=gen, device=dev)
    if cfg.encoder is not None:
        out["frames"] = torch.randn((batch, cfg.encoder.seq_len, cfg.d_model), generator=gen,
                                    device=dev)
    return out


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


@contextlib.contextmanager
def timed_ranges(ranges):
    """Each (module, function, label) of ``ranges`` patched, for the block,
    with a wrapper that records CUDA events around every call -> {label:
    [(start, end), ...]}."""
    spans = {label: [] for _, _, label in ranges}
    saved = []
    for mod_name, attr, label in ranges:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)

        def wrapped(*args, _fn=fn, _label=label, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = _fn(*args, **kwargs)
            end.record()
            spans[_label].append((start, end))
            return out

        saved.append((mod, attr, fn))
        setattr(mod, attr, wrapped)
    try:
        yield spans
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _kind(name: str) -> str:
    for label, keys in KINDS:
        if any(k in name for k in keys):
            return label
    return "other"


def _simulated(mode: str):
    session, state, pool, preds = serve.build_session_server(
        num_objects=524288, capacity=524288, max_capacity=1 << 20, num_preds=4,
        max_tenants=8, substrate_dtype="bfloat16", device="cuda",
    )
    for cols in TENANTS:
        state, _ = session.admit(state, conjunction(*[preds[c] for c in cols]))
    state = session.ingest(state, pool)
    prog = EngineSession(
        session.global_predicates, session.table, session.combine_params, session.costs,
        capacity=state.capacity, max_tenants=8, device="cuda",
        config=EngineConfig(plan_size=64, function_selection=mode, substrate_dtype="bfloat16"),
    ).program
    state, _ = prog.run_scan(state, 2, stop_when_exhausted=False)  # warm-up
    return prog.run_scan, state, None, f"{mode} mode, 8 tenants, {state.capacity} rows (bf16)"


def _operator():
    world = quickstart_world(OPERATOR_OBJECTS, device="cuda")
    op, state = quickstart_operator(world, fused=True, device="cuda")

    def run(st, n, stop_when_exhausted):
        return op.run(OPERATOR_OBJECTS, n, state=st, stop_when_exhausted=stop_when_exhausted)

    state, _ = run(state, 2, stop_when_exhausted=False)  # warm-up
    return run, state, None, (f"operator, kernel route (fused_benefits), quickstart query, "
                              f"{OPERATOR_OBJECTS} objects, OperatorConfig() defaults")


def _cascade(backbone: str):
    session, state, preds, _ = serve.build_cascade_session_server(
        num_objects=2048, num_preds=3, max_tenants=8, backbone_arch=backbone,
        plan_size=64, substrate_dtype="float32", smoke=False, device="cuda",
    )
    for cols in CASCADE_TENANTS:
        state, _ = session.admit(state, conjunction(*[preds[c] for c in cols]))
    bank, warm = session.bank, 0
    while bank.trunk_runs == 0 and warm < 300:  # until the planner picks backbone lanes
        state, _ = session.run(state, 1, stop_when_exhausted=False)
        warm += 1
    if bank.trunk_runs == 0:
        raise SystemExit(f"no backbone lane in {warm} epochs: nothing to profile")
    return session.program.run_scan, state, bank, (
        f"cascade at full width ({backbone} trunk), 8 tenants, 2048 objects, best mode, "
        f"after {warm} warm-up epochs")


def _model(backbone: str, decode: bool):
    from repro_torch.models.model import random_model

    b, prompt = MODEL_SHAPES[backbone]
    cfg = model_config(backbone)
    model, params = random_model(cfg, seed=0, device="cuda")
    batch = model_batch(cfg, b, prompt, torch.Generator(device="cuda").manual_seed(1))
    n_img = cfg.num_image_tokens if "image_embeds" in batch else 0
    max_len = n_img + prompt + 512

    def prefill(st, n, stop_when_exhausted):
        for _ in range(n):
            st = model.prefill(params, batch, max_len)
        return st, None

    def step(st, n, stop_when_exhausted):
        logits, cache = st
        for _ in range(n):
            logits, cache = model.decode_step(params, logits.argmax(-1), cache)
        return (logits, cache), None

    state, _ = prefill(None, 1, False)  # warm-up
    if decode:
        state, _ = step(state, 2, False)
    kind = "decode step" if decode else "prefill"
    extra = "".join(f", {batch[k].shape[1]} {k}" for k in ("image_embeds", "frames") if k in batch)
    return step if decode else prefill, state, None, (
        f"{backbone} at full width ({cfg.num_layers} layers), {kind}s at B={b}, prompt "
        f"{prompt} tokens{extra} (bf16, kernel route; an 'epoch' is one {kind})")


def _cell(backbone: str, shape: str, decode: bool, batch: Optional[int] = None):
    from repro_torch.launch import cells, steps
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import random_model

    cell = cells.one_card_cell(backbone, shape)
    spec, b = cell.shape, batch or cell.batch
    if (spec.kind == "decode") != decode:
        raise SystemExit(f"--shape {shape} is a {spec.kind} cell: use --path {spec.kind}")
    model, params = random_model(cell.cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    if decode:
        step = steps.build_decode_step(model.cfg, spec)
        cache = tf.init_model_cache(model.cfg, b, spec.seq_len, model.cfg.activation_dtype,
                                    device="cuda")
        cache = cells.fill_cache(cache, gen, spec.seq_len - 1)
        token = torch.randint(0, cell.cfg.vocab_size, (b, 1), generator=gen, device="cuda")

        def run(logits, n, stop_when_exhausted):
            for _ in range(n):  # from the cache at seq_len - 1 each time
                logits, _ = step.fn(params, token if logits is None else logits.argmax(-1),
                                    cache)
            return logits, None
    else:
        step = steps.build_prefill_step(model.cfg, spec)
        batch = {"tokens": torch.randint(0, cell.cfg.vocab_size, (b, spec.seq_len),
                                         generator=gen, device="cuda")}

        def run(logits, n, stop_when_exhausted):
            for _ in range(n):  # keeps no cache between prefills
                logits = step.fn(params, batch)[0]
            return logits, None

    state, _ = run(None, 1, False)  # warm-up
    kind = "decode step" if decode else "prefill"
    return run, state, None, (
        f"{backbone} x {shape} at full width ({cell.cfg.num_layers} layers; reduced: "
        f"{'; '.join(cell.reduced) or 'nothing'}"
        f"{'' if b == cell.batch else f'; run at B={b}, not the reckoned {cell.batch}'}), "
        f"{kind}s at B={b} over {spec.seq_len} "
        f"{'keys' if decode else 'tokens'} (bf16, kernel route; an 'epoch' is one {kind})")


def _train(backbone: str):
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.pipeline import SyntheticTokenStream, TokenStreamConfig, to_device
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.model import Model

    seq, batch_rows, mb = TRAIN_SHAPE
    cfg = model_config(backbone)
    built = build_train_step(cfg, ShapeSpec("train_4k-cut", "train", seq, batch_rows),
                             num_microbatches=mb)
    params = Model(cfg).init_params(torch.Generator(device="cuda").manual_seed(0))
    opt_state = built.optimizer.init(params)
    batch = to_device(SyntheticTokenStream(TokenStreamConfig(cfg.vocab_size, seq, batch_rows))
                      .batch(0), "cuda")

    def run(st, n, stop_when_exhausted):
        p, o = st
        for _ in range(n):
            p, o, _ = built.fn(p, o, batch)
        return (p, o), None

    state, _ = run((params, opt_state), 1, False)  # warm-up
    return run, state, None, (
        f"{backbone} train step at full width ({cfg.num_layers} layers), {batch_rows} x {seq} "
        f"tokens as {mb} microbatches, f32 params + AdamW, {cfg.dtype} activations, chunked "
        f"attention, remat (an 'epoch' is one step)")


def _train_parts(backbone: str, state) -> None:
    """One cross-entropy chunk (forward + backward) and one optimiser update,
    each alone, timed with CUDA events (median of 5 after a warm-up)."""
    from repro_torch.models import model as model_lib
    from repro_torch.optim.adamw import AdamW

    cfg = model_config(backbone)
    params, opt_state = state
    seq, batch_rows, mb = TRAIN_SHAPE
    rows, chunk = batch_rows // mb, min(1024, seq)
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((rows, chunk, cfg.d_model), generator=gen, device="cuda").to(
        cfg.activation_dtype).requires_grad_(True)
    tgt = torch.randint(0, cfg.vocab_size, (rows, chunk), generator=gen, device="cuda")
    w = (params["embed"] if cfg.tie_embeddings else params["unembed"]).detach().requires_grad_(True)

    def ce():
        model_lib._ce_sum(w, x, tgt, cfg.final_logit_softcap).backward()

    def opt():  # the parameters stand in for the gradients: same shapes, timing only
        AdamW().update(params, opt_state, params, donate=True)

    for name, fn, per_step in (("cross-entropy chunk (fwd + bwd)", ce, mb * seq // chunk),
                               ("optimiser update (AdamW, in place)", opt, 1)):
        fn()
        times = []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        ms = sorted(times)[2]
        print(f"[profile]   alone: {name} {ms:.3f} ms, x {per_step} a step = "
              f"{ms * per_step:.3f} ms/epoch")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", default="session",
                    choices=("session", "operator", "prefill", "decode", "train"))
    ap.add_argument("--bank", default="simulated", choices=("simulated", "cascade"),
                    help="the session path's bank")
    ap.add_argument("--backbone", default="qwen3-1.7b", choices=sorted(ARCHS),
                    help="the cascade bank's backbone, or the model of --path prefill / "
                         "decode / train, at its published width")
    ap.add_argument("--shape", default=None, choices=("prefill_32k", "decode_32k", "long_500k"),
                    help="with --path prefill / decode: the reference's serve cell, sized to "
                         "one card (launch/cells.py)")
    ap.add_argument("--batch", type=int, default=None,
                    help="with --shape: run the cell at this batch")
    ap.add_argument("--ranges", action="store_true",
                    help="time the Mamba-2 mixer's parts on the device (SSM_RANGES)")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--mode", default="best", choices=("best", "table"),
                    help="scoring mode of the simulated bank (the cascade serves best mode)")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile needs a GPU (torch.cuda.is_available() is False)")

    if args.path == "operator":
        run, state, bank, label = _operator()
    elif args.path in ("prefill", "decode") and args.shape:
        run, state, bank, label = _cell(args.backbone, args.shape, args.path == "decode",
                                        args.batch)
    elif args.path in ("prefill", "decode"):
        run, state, bank, label = _model(args.backbone, args.path == "decode")
    elif args.path == "train":
        run, state, bank, label = _train(args.backbone)
    elif args.bank == "cascade":
        run, state, bank, label = _cascade(args.backbone)
    else:
        run, state, bank, label = _simulated(args.mode)
    trunk0 = 0 if bank is None else bank.trunk_runs
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ranges = timed_ranges(SSM_RANGES if args.ranges else ())
    with torch.profiler.profile(activities=acts) as prof, ranges as spans:
        t0 = time.perf_counter()
        state, _ = run(state, args.epochs, stop_when_exhausted=False)
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
    if not busy_us:
        print("[profile] the profiler recorded no device time: not measured")
        return 1
    n = args.epochs
    trunk = "" if bank is None else f" ({bank.trunk_runs - trunk0} of them ran the trunk)"
    print(f"[profile] {label}: {n} epochs{trunk} in {wall * 1e3:.3f} ms wall = "
          f"{wall * 1e3 / n:.3f} ms/epoch; device busy {busy_us / 1e3:.3f} ms = "
          f"{busy_us / 1e6 / wall:.1%} of wall")
    by_kind: dict = {}
    for e in events:
        by_kind[_kind(e.key)] = by_kind.get(_kind(e.key), 0.0) + _device_us(e)
    for kind, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {kind:26s} {us / 1e3 / n:9.4f} ms/epoch  {us / busy_us:6.1%} of busy")
    for e in sorted(events, key=_device_us, reverse=True)[: args.top]:
        print(f"[profile]   {_device_us(e) / 1e3 / n:9.4f} ms/epoch  "
              f"{e.count // max(n, 1):5d} calls/epoch  {e.key[:110]}")
    for label, pairs in spans.items():  # --ranges
        ms = sum(a.elapsed_time(b) for a, b in pairs)
        print(f"[profile]   range {label:26s} {ms / n:9.4f} ms/epoch  {len(pairs) // n:5d} "
              f"calls/epoch  {ms * 1e3 / busy_us:6.1%} of busy (CUDA events)")
    if args.path == "train" or args.shape:
        peak = torch.cuda.max_memory_allocated()
        print(f"[profile] peak memory {peak / 2**30:.3f} GiB ({peak / 1e9:.2f} GB)")
    if args.path == "train":
        _train_parts(args.backbone, state)
    if bank is not None:
        # device idle right after each host read: end of its DtoH copy -> next kernel start
        kernels = sorted(
            (e.time_range.start, e.time_range.end, e.name) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
        gaps = []
        for i, (_, end, name) in enumerate(kernels):
            if "DtoH" in name and i + 1 < len(kernels):
                gaps.append(max(kernels[i + 1][0] - end, 0.0))
        if gaps:
            print(f"[profile] bank-boundary host reads: {len(gaps)} device-to-host copies, "
                  f"device idle after them {sum(gaps) / 1e3 / n:.4f} ms/epoch = "
                  f"{sum(gaps) / 1e6 / wall:.1%} of wall (median gap {sorted(gaps)[len(gaps) // 2]:.1f} us)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
