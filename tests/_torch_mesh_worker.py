"""The rank side of ``test_torch_mesh_steps.py`` and
``test_torch_mesh_steps_4.py``: one gloo group of 1, 2 or 4 CPU ranks (a
``FileStore``, so parallel test workers never race for a port), every
mesh check of the slice in one spawn, and the checks themselves.

Each rank loads smoke parameters (numpy, written by the test), runs the
port's one-device path and the mesh step builders on the same inputs, and
rank 0 writes what it measured (logits, losses, parameters after the train
steps, restored checkpoints) for the test to compare.  ``gloo_checks``
runs the 2- and 4-rank checks in one call (``chip_smoke.py`` runs it on
the card's machine, which has no JAX).  It imports nothing of JAX.  Not a
test module (no ``test_`` prefix).
"""

import dataclasses
import pickle

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import interop
from repro_torch.checkpoint.store import restore_checkpoint, save_checkpoint
from repro_torch.configs.archs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data.pipeline import PrefetchIterator
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.rules import rules_for_cell
from repro_torch.models.model import Model
from repro_torch.optim.tree import leaves

ARCHS = ("qwen3-1.7b", "mamba2-370m", "grok-1-314b", "seamless-m4t-large-v2", "hymba-1.5b")
KERNEL_ARCHS = ("qwen3-1.7b", "mamba2-370m", "hymba-1.5b")  # GQA, SSD, both
BATCH, PROMPT, STEPS, MAX_LEN = 2, 16, 3, 32  # MAX_LEN: rows of the cache
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 16, 2  # two microbatches of two rows
LOGIT_TOL = 2e-5  # of the logits' largest magnitude, more than one rank
LOSS_RTOL = 1e-5
LR = 3e-4  # AdamW's default


def batches(cfg, seed: int):
    """numpy inputs from ``seed``: the serve batch (tokens [BATCH, PROMPT +
    STEPS], frames for an encoder) and TRAIN_STEPS train batches."""
    rng = np.random.default_rng(seed)

    def one(rows, seq):
        out = {"tokens": rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32)}
        if cfg.encoder is not None:
            out["frames"] = rng.standard_normal(
                (rows, cfg.encoder.seq_len, cfg.d_model)).astype(np.float32)
        return out

    serve = one(BATCH, PROMPT + STEPS)
    train = []
    for _ in range(TRAIN_STEPS):
        b = one(TRAIN_BATCH, TRAIN_SEQ)
        b["targets"] = rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)
        train.append(b)
    return serve, train


def spawn(fn, world: int, *args) -> None:
    import torch.multiprocessing as mp

    mp.spawn(fn, nprocs=world, args=(world, *args))


def config(arch: str, impl: str = "dense"):
    return dataclasses.replace(get_config(arch, smoke=True), dtype="float32", attn_impl=impl)


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _serve(cfg, params, batch, mesh):
    """Prefill of ``batch["tokens"][:, :PROMPT]`` then STEPS teacher-forced
    decode steps, on one device (mesh None) or through the mesh step
    builders -> the logits of each, plain [B, 1, V] tensors."""
    tokens = batch["tokens"]
    extra = {k: v for k, v in batch.items() if k != "tokens"}
    prompt = {"tokens": tokens[:, :PROMPT], **extra}
    model = Model(cfg)
    if mesh is None:
        logits, cache = model.prefill(params, prompt, MAX_LEN)
        out = [logits]
        for t in range(PROMPT, PROMPT + STEPS):
            logits, cache = model.decode_step(params, tokens[:, t:t + 1], cache)
            out.append(logits)
        return out
    p_shape = ShapeSpec("p", "prefill", MAX_LEN, BATCH)
    d_shape = ShapeSpec("d", "decode", MAX_LEN, BATCH)
    prefill = steps.build_prefill_step(cfg, p_shape, mesh)
    decode = steps.build_decode_step(cfg, d_shape, mesh)
    logits, cache = prefill.fn(params, steps.distribute_batch(prompt, cfg, p_shape, mesh))
    out = [_full(logits)]
    for t in range(PROMPT, PROMPT + STEPS):
        tok = steps.distribute_batch({"token": tokens[:, t:t + 1]}, cfg, d_shape, mesh)["token"]
        logits, cache = decode.fn(params, tok, cache)
        out.append(_full(logits))
    return out


def _train(cfg, params, train_batches, mesh):
    """TRAIN_STEPS AdamW steps (2 microbatches) -> (losses, every parameter
    leaf after, plain, and the parameters)."""
    shape = ShapeSpec("t", "train", TRAIN_SEQ, TRAIN_BATCH)
    built = steps.build_train_step(cfg, shape, num_microbatches=2, mesh=mesh)
    state = built.optimizer.init(params)
    losses = []
    if mesh is not None:  # each batch placed by the prefetch thread, in the input placements
        train_batches = PrefetchIterator(
            iter([{k: v.numpy() for k, v in b.items()} for b in train_batches]), device="cpu",
            shardings=steps.input_placements(cfg, shape, mesh), mesh=mesh)
    for b in train_batches:
        params, state, metrics = built.fn(params, state, b)
        losses.append(float(metrics["loss"]))
    return losses, [_full(t).detach().clone() for t in leaves(params)], params


def run(rank: int, world: int, store_path: str, model_axis: int, in_path: str,
        out_path: str, ckpt_dir: str, ckpt: str, kernel_route: bool) -> None:
    """Every check on this mesh; ``ckpt`` "save" writes the trained qwen3
    parameters to ``ckpt_dir``, "restore" places the checkpoint there onto
    this mesh, "" does neither."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        mesh = make_host_mesh(model=model_axis, device_type="cpu")
        with open(in_path, "rb") as f:
            given = pickle.load(f)
        out = {"mesh": tuple(mesh.shape)}
        for arch in (a for a in ARCHS if a in given):
            j_params, serve_batch, train_batches = given[arch]
            cfg = config(arch)
            axes = Model(cfg).param_axes()
            one = interop.params_from_numpy(j_params)
            sb = {k: interop.to_torch(v) for k, v in serve_batch.items()}
            out[(arch, "serve", "one")] = _serve(cfg, one, sb, None)
            rules = rules_for_cell(cfg, mesh, "prefill", BATCH)
            on_mesh = interop.params_from_numpy(j_params, mesh=mesh, rules=rules, axes=axes)
            out[(arch, "serve", "mesh")] = _serve(cfg, on_mesh, sb, mesh)
            if kernel_route and arch in KERNEL_ARCHS:  # the plain twins on local shards
                kcfg = config(arch, "kernel")
                da_ops.reset_counts()
                out[(arch, "kernel", "one")] = _serve(kcfg, one, sb, None)
                fused = dict(da_ops.PLAIN_CALLS)
                da_ops.reset_counts()
                out[(arch, "kernel", "mesh")] = _serve(kcfg, on_mesh, sb, mesh)
                out[(arch, "kernel", "calls")] = (fused, dict(da_ops.PLAIN_CALLS))
            tb = [{k: interop.to_torch(v) for k, v in b.items()} for b in train_batches]
            out[(arch, "train", "one")] = _train(cfg, interop.params_from_numpy(j_params), tb,
                                                 None)[:2]
            t_rules = rules_for_cell(cfg, mesh, "train", TRAIN_BATCH)
            trained = interop.params_from_numpy(j_params, mesh=mesh, rules=t_rules, axes=axes)
            losses, after, trained = _train(cfg, trained, tb, mesh)
            out[(arch, "train", "mesh")] = (losses, after)
            if arch == "qwen3-1.7b" and ckpt:
                _checkpoint(trained, cfg, axes, t_rules, mesh, ckpt_dir, ckpt, out)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def save_only(rank: int, world: int, store_path: str, in_path: str, ckpt_dir: str) -> None:
    """The qwen3 parameters of ``in_path`` placed on a (1, world) mesh by
    the train rules and saved to ``ckpt_dir``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        mesh = make_host_mesh(model=world, device_type="cpu")
        with open(in_path, "rb") as f:
            j_params = pickle.load(f)["qwen3-1.7b"][0]
        cfg = config("qwen3-1.7b")
        rules = rules_for_cell(cfg, mesh, "train", TRAIN_BATCH)
        placed = interop.params_from_numpy(j_params, mesh=mesh, rules=rules,
                                           axes=Model(cfg).param_axes())
        save_checkpoint(ckpt_dir, 1, placed)
    finally:
        dist.destroy_process_group()


def _checkpoint(trained, cfg, axes, rules, mesh, ckpt_dir, mode, out):
    """Save this run's trained qwen3 parameters, or restore the saved ones
    onto this mesh (the restored leaves, whole, and their placements into
    ``out``)."""
    if mode == "save":
        save_checkpoint(ckpt_dir, 1, trained)
        return
    like = steps.abstract_params_and_axes(Model(cfg))[0]
    placed = steps.shardings_for_axes(axes, rules, mesh)
    restored, _ = restore_checkpoint(ckpt_dir, None, like, device="cpu", shardings=placed,
                                     mesh=mesh)
    out["restored"] = [_full(t).clone() for t in leaves(restored)]
    out["restored_placements"] = [tuple(t.placements) for t in leaves(restored)]


# ------------------------------------------------------------ the checks --

def close(got, want, tol, what):
    scale = max(float(want.abs().max()), 1e-12)
    err = float((got - want).abs().max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def held(got_list, want_list, bitwise, what):
    for i, (g, w) in enumerate(zip(got_list, want_list)):
        assert g.shape == w.shape, (what, i)
        if bitwise:
            assert torch.equal(g, w), f"{what} step {i}: not bitwise on one rank"
        else:
            close(g, w, LOGIT_TOL, f"{what} step {i}")
        assert torch.equal(g.argmax(-1), w.argmax(-1)), f"{what} step {i}: greedy tokens"


def check_serve(out, arch, world, model_axis):
    assert out["mesh"] == (world // model_axis, model_axis)
    held(out[(arch, "serve", "mesh")], out[(arch, "serve", "one")], world == 1, arch)


def check_kernel_route(out, arch):
    held(out[(arch, "kernel", "mesh")], out[(arch, "kernel", "one")], False, f"{arch} kernel")
    fused, on_mesh = out[(arch, "kernel", "calls")]
    if arch != "mamba2-370m":  # attention decodes: the fused twin alone, then partials alone
        assert fused[da_ops.FUSED] > 0 and fused[da_ops.KERNEL] == 0, fused
        assert on_mesh[da_ops.KERNEL] > 0 and on_mesh[da_ops.FUSED] == 0, on_mesh


def check_train(out, arch, world):
    (m_losses, m_params), (o_losses, o_params) = (out[(arch, "train", k)]
                                                  for k in ("mesh", "one"))
    if world == 1:
        assert m_losses == o_losses
        assert all(torch.equal(a, b) for a, b in zip(m_params, o_params))
        return
    np.testing.assert_allclose(m_losses, o_losses, rtol=LOSS_RTOL)
    far = max(float((a - b).abs().max()) for a, b in zip(m_params, o_params))
    loose = sum(int(((a - b).abs() > 0.01 * LR).sum()) for a, b in zip(m_params, o_params))
    total = sum(a.numel() for a in m_params)
    assert far <= 2 * LR * len(m_losses) and loose <= 1e-3 * total, (arch, far / LR, loose)


def check_all(out: dict, world: int, model_axis: int, kernel_route: bool) -> None:
    for arch in ARCHS:
        check_serve(out, arch, world, model_axis)
        check_train(out, arch, world)
        if kernel_route and arch in KERNEL_ARCHS:
            check_kernel_route(out, arch)


def gloo_checks(d) -> dict:
    """The suite's 2- and 4-rank CPU checks in one go (for a machine without
    JAX): the port's own parameters, a 2-rank run that saves its trained
    qwen3 parameters, a 4-rank run that restores them; every check held ->
    the seconds each spawn took."""
    import time
    from pathlib import Path

    d = Path(d)
    given = {}
    for arch in ARCHS:
        cfg = config(arch)
        params = interop.tree_to_numpy(Model(cfg).init_params(torch.Generator().manual_seed(0)))
        given[arch] = (params, *batches(cfg, seed=11))
    with open(d / "given.pkl", "wb") as f:
        pickle.dump(given, f)
    seconds, outs = {}, {}
    for world, model_axis, ckpt in ((2, 2, "save"), (4, 2, "restore")):
        t0 = time.perf_counter()
        spawn(run, world, str(d / f"store{world}"), model_axis, str(d / "given.pkl"),
              str(d / f"out{world}.pkl"), str(d / "ckpt"), ckpt, True)
        seconds[world] = time.perf_counter() - t0
        with open(d / f"out{world}.pkl", "rb") as f:
            outs[world] = pickle.load(f)
        check_all(outs[world], world, model_axis, True)
    saved = outs[2][("qwen3-1.7b", "train", "mesh")][1]
    assert all(torch.equal(a, b) for a, b in zip(outs[4]["restored"], saved))
    return seconds
