"""Multi-pod dry run (port of ``repro.launch.dryrun``): every (architecture
x input-shape) cell's step built over the production meshes — (16, 16)
single-pod and (2, 16, 16) multi-pod — and called once on meta-device
stand-ins, in one process over a fake process group of 256 / 512 ranks
(``FakeStore``, backend "fake").  Nothing is allocated and no card is
touched; the numbers are rank 0's view of the sharded step, not a card's
times.

    python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape decode_32k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results/dryrun_torch]

Per cell the JSON records:

  * memory — per-device argument and output bytes, from the local shard
    shapes of the step's arguments and results.  Temp bytes are NOT
    estimated (``temp_bytes: null``): nothing is compiled, so there is no
    buffer assignment to read them from.  The fit check is the argument and
    output bytes against one H100's 80 GB (``fits``, with ``fit_device``
    naming it), not the reference's v5e 16 GiB;
  * flops — ``torch.utils.flop_counter.FlopCounterMode`` over the call:
    the ops DTensor propagates count at their global shapes
    (``dtensor_ops``), the ops run on local shards (the attention and SSD
    engines, the MoE routing and experts) at rank 0's shard
    (``local_regions``);
  * collectives — count and per-device operand bytes by kind, under the
    reference's names (``all-gather``, ``all-reduce``, ``reduce-scatter``,
    ``all-to-all``, ``collective-permute``), from the functional
    collectives the call issues (a redistribute's all-to-all may run as an
    all-gather and a slice on a group without one);
  * the parameter counts.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
from pathlib import Path

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")
_KIND_OF = (("all_gather", "all-gather"), ("reduce_scatter", "reduce-scatter"),
            ("all_reduce", "all-reduce"), ("all_to_all", "all-to-all"),
            ("permute", "collective-permute"))
H100_BYTES = 80e9


def _fake_group(world: int) -> None:
    """A fake default process group of ``world`` ranks (this process is rank
    0), made once; another size replaces it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _leaves(tree):
    import dataclasses

    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree) for x in _leaves(getattr(tree, f.name))]
    return [tree]


def local_bytes(tree) -> int:
    """Bytes of rank 0's shards (a plain tensor counts whole)."""
    total = 0
    for t in _leaves(tree):
        local = t.to_local() if hasattr(t, "to_local") else t
        total += local.numel() * local.element_size()
    return total


def _counter():
    """A dispatch mode that counts the call's functional collectives (count
    and operand bytes by kind) and its FLOPs by
    ``torch.utils.flop_counter``'s formulas: an op with a DTensor argument
    at its global shapes, an op on plain tensors (a local region) at the
    shapes it got."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import FlopCounterMode

    registry = FlopCounterMode(display=False).flop_registry

    class Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.counts = dict.fromkeys(COLLECTIVE_OPS, 0)
            self.bytes = dict.fromkeys(COLLECTIVE_OPS, 0)
            self.flops = {"dtensor_ops": 0, "local_regions": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if "c10d" in str(func):
                kind = next((k for key, k in _KIND_OF if key in func.__name__), None)
                operand = next((a for a in args if hasattr(a, "numel")), None)
                if kind is not None:
                    self.counts[kind] += 1
                    if operand is not None:
                        self.bytes[kind] += operand.numel() * operand.element_size()
            packet = func._overloadpacket
            if packet in registry:
                where = "dtensor_ops" if any(isinstance(a, DTensor) for a in args) \
                    else "local_regions"
                self.flops[where] += int(registry[packet](*args, **kwargs, out_val=out))
            return out

    return Counter()


def _fake_args(tree, fake):
    """The step's meta stand-ins as fake CPU tensors (shapes, dtypes and
    strides, no storage): the model makes its plain tensors on its inputs'
    device, and a DTensor over the fake group's CPU mesh takes plain CPU
    tensors for replicated ones, never meta ones."""
    import dataclasses

    import torch
    from torch.distributed.tensor import DTensor

    def one(t):
        if t is None:
            return None
        local = t.to_local() if isinstance(t, DTensor) else t
        with fake:
            f = torch.empty_strided(local.shape, local.stride(), dtype=local.dtype, device="cpu")
        if not isinstance(t, DTensor):
            return f
        return DTensor.from_local(f, t.device_mesh, t.placements, run_check=False,
                                  shape=t.shape, stride=t.stride())

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(type(x), "_fields"):
            return type(x)(*(walk(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(walk(v) for v in x)
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{f.name: walk(getattr(x, f.name))
                                             for f in dataclasses.fields(x)})
        return one(x)

    return walk(tree)


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir, smoke: bool = False) -> dict:
    """Build the cell's step over the production mesh, call it on its
    stand-ins and write ``<arch>__<shape>__<mesh>.json`` -> the result."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.archs import get_config
    from repro_torch.configs.shapes import SHAPES, shape_applicable
    from repro_torch.launch.mesh import make_production_mesh, production_shape
    from repro_torch.launch.steps import build_step

    cfg = get_config(arch, smoke=smoke)
    spec = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape_name)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "smoke": smoke,
              "runnable": ok, "reason": reason, "status": "skipped" if not ok else None}
    if not ok:
        return result
    _fake_group(math.prod(production_shape(multi_pod)[0]))
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="meta")
    t0 = time.time()
    built = build_step(cfg, spec, mesh)
    t_build = time.time()
    counter = _counter()
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    args = _fake_args(built.args, fake)
    with fake, counter:
        out = built.fn(*args)
    t_call = time.time()
    arg_bytes = local_bytes(built.args)
    out_bytes = local_bytes(out)
    counts = cfg.param_counts()
    result.update(
        status="ok",
        times=dict(build_s=round(t_build - t0, 2), call_s=round(t_call - t_build, 2)),
        memory=dict(argument_bytes=arg_bytes, output_bytes=out_bytes, temp_bytes=None,
                    per_device_total=arg_bytes + out_bytes,
                    fits=bool(arg_bytes + out_bytes < H100_BYTES),
                    fit_device="one H100 (80 GB); temp bytes not estimated"),
        flops=dict(counter.flops, total=sum(counter.flops.values())),
        collectives=dict(bytes_by_kind=counter.bytes, count_by_kind=counter.counts,
                         total_bytes=int(sum(counter.bytes.values())),
                         total_count=int(sum(counter.counts.values()))),
        params_total=counts["total"], params_active=counts["active"],
        sharded_args=sum(isinstance(t, DTensor) for t in _leaves(built.args)),
        device_count=math.prod(production_shape(multi_pod)[0]),
        torch_version=torch.__version__,
    )
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{arch}__{shape_name}__{mesh_name}.json"
    path.write_text(json.dumps(result, indent=2))
    print(f"[dryrun] wrote {path}")
    return result


def main(argv=None) -> int:
    from repro_torch.configs.archs import ARCHS
    from repro_torch.configs.shapes import SHAPES

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--smoke", action="store_true", help="the architectures' smoke widths")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(arch, shape) for arch in ARCHS for shape in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]
    failures = 0
    for arch, shape in cells:
        try:
            r = run_cell(arch, shape, args.multi_pod, Path(args.out), smoke=args.smoke)
            if r["status"] == "ok":
                m = r["memory"]
                print(f"[dryrun] {arch} x {shape} x {r['mesh']}: OK call={r['times']['call_s']}s "
                      f"per-dev args+outs={m['per_device_total'] / 2**30:.2f}GiB "
                      f"fits={m['fits']} flops={r['flops']['total']:.3g} "
                      f"coll={r['collectives']['total_bytes'] / 2**20:.1f}MiB")
            else:
                print(f"[dryrun] {arch} x {shape}: SKIP ({r['reason']})")
        except Exception as e:  # noqa: BLE001 - one cell's failure is reported, the rest run
            failures += 1
            print(f"[dryrun] {arch} x {shape}: FAIL {type(e).__name__}: {e}")
            traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
