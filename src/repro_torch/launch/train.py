"""The train loop with checkpoint / restart, preemption and straggler
accounting, on one device or over a mesh (port of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch qwen3-1.7b --smoke --steps 12 --device cpu
    python -m repro_torch.launch.train --arch qwen3-1.7b --smoke --mesh 1,1
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --smoke --mesh 2,2 --device cpu

``--device`` defaults to ``cuda`` and raises without a GPU.  The
parameters are drawn from ``--seed`` with a ``torch.Generator`` on the
device; the batches are the reference's ``SyntheticTokenStream`` (numpy,
bitwise the reference's) copied to the device.  A checkpoint is
``(params, opt_state)`` in the reference's on-disk format, so a JAX train
checkpoint restores here and the reverse.

``--mesh data,model`` trains over a ``("data", "model")`` mesh: under
``torchrun`` on its process group, else on a one-process group (NCCL on
the card, gloo with ``--device cpu``).  Every rank draws the parameters
whole from the seed (the one-device run's draws) and keeps its shards in
the placements ``rules_for_cell`` gives (``steps.distribute_params``); the
optimiser state follows them; each rank keeps its shard of every batch; a
checkpoint is gathered whole and written by rank 0, and restores onto the
current mesh whatever mesh wrote it.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.store import (latest_step, prune_old, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.configs.archs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data.pipeline import SyntheticTokenStream, TokenStreamConfig, to_device
from repro_torch.device import resolve_device
from repro_torch.launch.steps import (build_train_step, cast_params, distribute_batch,
                                      distribute_params)
from repro_torch.models.model import Model
from repro_torch.optim.tree import tree_map
from repro_torch.runtime.fault_tolerance import PreemptionHandler, StragglerMonitor


def extra_inputs(cfg):
    """The modality fields a batch of ``cfg`` carries, drawn from the
    stream's generator as the reference draws them (None for text)."""
    if cfg.frontend == "text":
        return None

    def extra_fn(rng, b):
        out = {}
        if cfg.frontend == "vision":
            out["image_embeds"] = rng.normal(
                size=(b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
        if cfg.frontend == "audio":
            out["frames"] = rng.normal(size=(b, cfg.encoder.seq_len, cfg.d_model)).astype(
                np.float32)
        return out

    return extra_fn


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def train_loop(cfg, shape: ShapeSpec, steps: int, ckpt_dir: Optional[str] = None,
               ckpt_every: int = 20, resume: bool = True,
               preemption: Optional[PreemptionHandler] = None, log_every: int = 10,
               seed: int = 0, device=None, num_microbatches: Optional[int] = None, mesh=None):
    """Train ``cfg`` from step 0 (or the latest checkpoint under
    ``ckpt_dir``) to ``steps`` -> (params, opt_state, history: one dict of
    step, loss, host seconds per step).  A requested preemption saves a
    checkpoint at the step it lands on and stops.  With a ``mesh`` the
    parameters, optimiser state and batches are DTensors on it (``device``
    is the mesh's)."""
    dev = resolve_device(device) if mesh is None else _mesh_device(mesh)
    built = build_train_step(cfg, shape, num_microbatches=num_microbatches, mesh=mesh)
    model = Model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed))
    if built.recipe.big:  # the >= 300B recipe trains bf16 parameters
        params = cast_params(params, built.recipe.param_dtype)
    if mesh is not None:
        params = distribute_params(params, model.param_axes(), built.rules, mesh)
    opt_state = built.optimizer.init(params)
    log = print if mesh is None or torch.distributed.get_rank() == 0 else (lambda *a: None)

    start = 0
    if ckpt_dir and resume and latest_step(ckpt_dir) is not None:
        like = (params, opt_state)
        sh = None if mesh is None else tree_map(lambda t: getattr(t, "placements", None), like)
        (params, opt_state), start = restore_checkpoint(ckpt_dir, None, like, device=dev,
                                                        shardings=sh, mesh=mesh)
        log(f"[train] resumed from step {start}")

    stream = SyntheticTokenStream(
        TokenStreamConfig(cfg.vocab_size, shape.seq_len, shape.global_batch), extra_inputs(cfg))
    monitor = StragglerMonitor(num_shards=1)
    history = []
    for step in range(start, steps):
        if preemption is not None and preemption.should_stop:
            if ckpt_dir:
                save_checkpoint(ckpt_dir, step, (params, opt_state))
                log(f"[train] preempted; checkpointed at step {step}")
            break
        batch = to_device(stream.batch(step), dev)
        if mesh is not None:
            batch = distribute_batch(batch, cfg, shape, mesh, built.rules)
        t0 = time.perf_counter()
        params, opt_state, metrics = built.fn(params, opt_state, batch)
        loss = float(metrics["loss"])  # waits for the step
        dt = time.perf_counter() - t0
        monitor.record(0, dt)
        history.append(dict(step=step, loss=loss, sec=dt))
        if step % log_every == 0:
            log(f"[train] step {step}: loss={loss:.4f} ({dt:.2f}s)")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, step + 1, (params, opt_state))
            prune_old(ckpt_dir, keep=3)
    return params, opt_state, history


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None, help="cuda (the default; raises without a GPU) "
                                                   "or cpu")
    ap.add_argument("--mesh", default=None, help="data,model: train over a mesh of that shape")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    shape = ShapeSpec("cli", "train", args.seq_len, args.batch)
    mesh = None if args.mesh is None else _cli_mesh(args.mesh, dev)
    lead = mesh is None or torch.distributed.get_rank() == 0
    handler = PreemptionHandler().install()
    try:
        _, _, hist = train_loop(cfg, shape, args.steps, ckpt_dir=args.ckpt, preemption=handler,
                                device=dev, mesh=mesh)
    finally:
        handler.uninstall()
        if mesh is not None:
            torch.distributed.destroy_process_group()
    if len(hist) >= 2 and lead:
        print(f"[train] loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    return 0


def _cli_mesh(spec: str, dev: torch.device):
    """``data,model`` -> the mesh, over ``torchrun``'s group or a
    one-process group on a free local port."""
    import os
    import socket

    from repro_torch.launch.mesh import make_host_mesh

    data, model = (int(n) for n in spec.split(","))
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and not torch.distributed.is_nccl_available():
        raise RuntimeError("a card mesh needs NCCL")
    if "RANK" in os.environ:  # torchrun
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        torch.distributed.init_process_group(backend)
    else:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        torch.distributed.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                             rank=0, world_size=1)
    mesh = make_host_mesh(model=model, device_type=dev.type)
    if tuple(mesh.shape) != (data, model):
        raise ValueError(f"--mesh {spec} does not fit a world of "
                         f"{torch.distributed.get_world_size()}")
    return mesh


if __name__ == "__main__":
    raise SystemExit(main())
