"""Step builders (port of ``repro.launch.steps``): the train, prefill and
decode steps on one device or over a mesh, the mesh forms with
``input_specs`` / ``cache_specs`` stand-ins for the dry run.

``train_recipe`` is the one place that decides how a configuration
trains: above 2e11 parameters (grok-1, Arctic) the reference's >= 300B
recipe — bf16 parameters, Adafactor, bf16 gradient accumulation — else f32
parameters, AdamW and f32 accumulation.  ``build_train_step`` and
``launch.train.train_loop`` both read it, and it allocates nothing, so it
can be checked on the full configurations.

The train step differentiates ``Model.loss_fn`` with autograd, one
microbatch at a time: each microbatch's gradients accumulate in the
parameters' ``.grad`` (the recipe's accumulation dtype is the parameters'
dtype), their sum is divided by the count, clipped to ``grad_clip`` by
global norm, and the optimiser takes one update — with ``donate`` (the
reference's default) in place, into the parameter and optimiser-state
tensors it was given.  Metrics are the loss function's, averaged over the
microbatches, plus ``grad_norm`` (before clipping).

Over a mesh (a ``DeviceMesh`` with the reference's axis names) the step
runs the same code on DTensors: the parameters, optimiser state, inputs
and the KV / SSM cache in the placements ``rules_for_cell`` gives their
logical axes (``Model.param_axes``, ``transformer.model_cache_axes``,
``input_specs``), inside ``activation_sharding(mesh, rules)`` so the
model's ``shard_act`` annotations redistribute its activations; the
kernels run on local shards (``models/attention.py``, ``ssm.py``).  Each
microbatch's inputs are redistributed to the batch placements after they
are cut, and the metrics come back as plain tensors.  ``BuiltStep.args``
holds meta-device DTensor stand-ins of the step's arguments (the
reference's ShapeDtypeStructs): the dry run calls the step on them, which
allocates nothing.  Without a mesh each builder gives the one-device
step: the prefill and decode steps run on the card unless ``device="cpu"``
is passed (they raise with no GPU; nothing falls back), with no DTensor
dispatch (a (1, 1) mesh's host cost).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.device import resolve_device
from repro_torch.launch.rules import rules_for_cell
from repro_torch.models import transformer as tf
from repro_torch.models.activation_sharding import activation_sharding
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.models.sharding import (FSDP_AXES, ShardingRules, map_axes, mesh_axis_sizes,
                                         local_box, place_whole, spec_tree_for_params)
from repro_torch.optim.adafactor import Adafactor
from repro_torch.optim.adamw import AdamW, clip_by_global_norm
from repro_torch.optim.tree import leaves, tree_map, unflatten

BIG_MODEL_PARAMS = 2e11


@dataclasses.dataclass(frozen=True)
class TrainRecipe:
    big: bool  # above BIG_MODEL_PARAMS parameters
    param_dtype: torch.dtype  # the trained parameters' dtype
    accum_dtype: torch.dtype  # the microbatch gradient sum's dtype
    optimizer: Any  # AdamW() or Adafactor()


def train_recipe(cfg: ModelConfig) -> TrainRecipe:
    """The reference's recipe for ``cfg`` (from its parameter count alone)."""
    big = cfg.param_counts()["total"] > BIG_MODEL_PARAMS
    dt = torch.bfloat16 if big else torch.float32
    return TrainRecipe(big=big, param_dtype=dt, accum_dtype=dt,
                       optimizer=Adafactor() if big else AdamW())


def cast_params(params, dtype: torch.dtype):
    """Every floating leaf in ``dtype`` (the big recipe's bf16 parameters)."""
    return tree_map(lambda p: p.to(dtype) if p.is_floating_point() else p, params)


def default_microbatches(shape: ShapeSpec, cfg: Optional[ModelConfig] = None,
                         act_budget_bytes: float = 4e9, mesh=None) -> int:
    """Gradient-accumulation factor bounding live activations: the layer
    stack's residuals cost rows * S * d * L * 2 bytes per shard, so the rows
    of one microbatch a shard are sized against ``act_budget_bytes`` (the
    batch splits over the mesh's data axes; one device: no split)."""
    dp = 1
    if mesh is not None:
        sizes = mesh_axis_sizes(mesh)
        dp = math.prod(sizes[a] for a in FSDP_AXES if a in sizes)
    rows = max(shape.global_batch // max(dp, 1), 1)
    if cfg is not None:
        per_row = 2.0 * shape.seq_len * cfg.d_model * max(cfg.num_layers, 1)
        target_rows = int(max(1, min(8, act_budget_bytes // max(per_row, 1))))
    else:
        target_rows = 4
    m = max(1, rows // target_rows)
    while shape.global_batch % m != 0:
        m -= 1
    return m


@dataclasses.dataclass
class BuiltStep:
    fn: Callable  # train: (params, opt_state, batch) -> (params, opt_state, metrics);
    #               prefill: (params, batch) -> (logits, cache); decode: (params, token, cache)
    optimizer: Any = None  # train steps
    num_microbatches: int = 1
    recipe: Optional[TrainRecipe] = None  # train steps
    # over a mesh: meta-device DTensor stand-ins of fn's arguments, the
    # parameters' placements tree, the rules and the mesh
    args: Optional[tuple] = None
    param_shardings: Any = None
    rules: Optional[ShardingRules] = None
    mesh: Any = None


def build_train_step(cfg: ModelConfig, shape: ShapeSpec, optimizer=None, grad_clip: float = 1.0,
                     num_microbatches: Optional[int] = None, donate: bool = True,
                     mesh=None) -> BuiltStep:
    """-> a ``BuiltStep`` whose ``fn(params, opt_state, batch)`` runs on the
    device of its tensors.  ``batch`` holds [B, ...] tensors with B the
    shape's global batch, split into ``num_microbatches`` row blocks.  With
    a ``mesh`` the step takes DTensors in the placements of ``args`` (see
    ``distribute_params``, ``distribute_batch``)."""
    if mesh is not None:
        return _build_mesh_train_step(cfg, shape, mesh, optimizer, grad_clip, num_microbatches,
                                      donate)
    model = Model(cfg)
    recipe = train_recipe(cfg)
    opt = recipe.optimizer if optimizer is None else optimizer
    mb = num_microbatches or default_microbatches(shape, cfg)
    if shape.global_batch % mb:
        raise ValueError(f"{mb} microbatches do not divide the batch of {shape.global_batch}")

    def train_step(params, opt_state, batch):
        train = tree_map(lambda p: p.detach().requires_grad_(True), params)
        flat = leaves(train)
        per_mb = []
        for i in range(mb):
            mbatch = {k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:])[i]
                      for k, v in batch.items()}
            loss, metrics = model.loss_fn(train, mbatch)
            loss.backward()
            per_mb.append({k: v.detach() for k, v in metrics.items()})
        with torch.no_grad():
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in flat]
            if mb > 1:
                grads = [g.div_(mb) for g in grads]
            grads, gnorm = clip_by_global_norm(unflatten(params, grads), grad_clip)
            new_params, new_state = opt.update(grads, opt_state, params, donate=donate)
            metrics = {k: torch.stack([m[k] for m in per_mb]).mean() for k in per_mb[0]}
        return new_params, new_state, dict(metrics, grad_norm=gnorm)

    return BuiltStep(fn=train_step, optimizer=opt, num_microbatches=mb, recipe=recipe)


# ------------------------------------------------------------- the mesh ----


def shardings_for_axes(axes_tree, rules: ShardingRules, mesh):
    """A tree of logical-axes tuples -> the same tree of DTensor placements
    (a tuple of only Nones is a container, not a leaf)."""
    return spec_tree_for_params(axes_tree, rules, mesh)


class _OnMeta(TorchFunctionMode):
    """Every factory call that names a device makes its tensor on "meta"."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if "device" in kwargs:
            kwargs = dict(kwargs, device="meta")
        return func(*args, **kwargs)


def abstract_params_and_axes(model: Model, dtype: Optional[torch.dtype] = None):
    """(the parameter tree on the meta device, its logical axes) with ZERO
    allocation: ``init_params`` runs with every tensor it makes on "meta"."""
    with _OnMeta():
        params = model.init_params(torch.Generator(), dtype=dtype)
    return params, model.param_axes()


def _meta_dtensor(shape, dtype: torch.dtype, mesh, placements):
    """A DTensor of global ``shape`` whose local shard is a meta tensor."""
    from torch.distributed.tensor import DTensor

    local, _ = local_box(shape, mesh, placements)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(torch.empty(local, dtype=dtype, device="meta"), mesh, placements,
                              run_check=False, shape=torch.Size(shape), stride=stride)


def _serve_dtype(tree, dtype=torch.bfloat16):
    """Serving stores params in bf16 (the reference casts at load)."""
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, tree)


def _place_meta(tree, placements_tree, mesh):
    """Meta tensors -> meta DTensors in the given placements."""
    return tree_map(lambda t, pl: _meta_dtensor(t.shape, t.dtype, mesh, pl), tree,
                    _as_leaves(placements_tree, tree))


def _as_leaves(placements_tree, like):
    """A placements tree whose tuples of placements are leaves, shaped like ``like``."""
    if isinstance(like, dict):
        return {k: _as_leaves(placements_tree[k], like[k]) for k in like}
    if isinstance(like, (tuple, list)):
        return tuple(_as_leaves(p, t) for p, t in zip(placements_tree, like))
    return placements_tree


def distribute_params(params, axes, rules: ShardingRules, mesh):
    """A parameter tree (plain tensors, the same on every rank) -> DTensors
    in the placements the rules give their logical axes."""
    pl = shardings_for_axes(axes, rules, mesh)
    return tree_map(lambda t, p: place_whole(t, mesh, p), params, _as_leaves(pl, params))


# ------------------------------------------------------------- input specs --

def input_axes(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """The logical axes of each input of this cell."""
    tok = ("batch", "seq")
    emb = ("batch", "seq", "act_embed")
    if shape.kind == "decode":
        return {"token": tok}
    axes = {"tokens": tok}
    if shape.kind == "train":
        axes["targets"] = tok
    if cfg.frontend == "vision":
        axes["image_embeds"] = emb
    if cfg.frontend == "audio":
        axes["frames"] = emb
    return axes


def input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh, rules=None) -> dict:
    """Meta-device DTensor stand-ins for every model input of this cell."""
    rules = rules or rules_for_cell(cfg, mesh, shape.kind, shape.global_batch)
    b = shape.global_batch
    act_dt = cfg.activation_dtype
    # Vision archs spend part of the context budget on anyres patch tokens:
    # text length shrinks so prefix + text == the assigned seq_len.
    text_len = shape.seq_len
    if cfg.frontend == "vision" and shape.kind == "prefill":
        text_len = shape.seq_len - cfg.num_image_tokens
        assert text_len > 0
    shapes = {"tokens": ((b, text_len), torch.int32),
              "targets": ((b, shape.seq_len), torch.int32),
              "token": ((b, 1), torch.int32),
              "image_embeds": ((b, cfg.num_image_tokens, cfg.d_model), act_dt)}
    if cfg.encoder is not None:
        shapes["frames"] = ((b, cfg.encoder.seq_len, cfg.d_model), act_dt)
    if shape.kind == "train":
        shapes["tokens"] = ((b, shape.seq_len), torch.int32)
    return {k: _meta_dtensor(*shapes[k], mesh, rules.placements(mesh, ax))
            for k, ax in input_axes(cfg, shape).items()}


def distribute_batch(batch: dict, cfg: ModelConfig, shape: ShapeSpec, mesh, rules=None) -> dict:
    """A batch of plain tensors (the same on every rank) -> DTensors in the
    placements of ``input_specs``."""
    pl = input_placements(cfg, shape, mesh, rules)
    return {k: place_whole(v, mesh, pl[k]) for k, v in batch.items()}


def input_placements(cfg: ModelConfig, shape: ShapeSpec, mesh, rules=None) -> dict:
    """The placements of each input of this cell (``PrefetchIterator``'s
    ``shardings``)."""
    rules = rules or rules_for_cell(cfg, mesh, shape.kind, shape.global_batch)
    return {k: rules.placements(mesh, ax) for k, ax in input_axes(cfg, shape).items()}


def cache_placements(cfg: ModelConfig, rules: ShardingRules, mesh) -> tf.ModelCache:
    """The placements of every cache leaf (the decode layout: ``kv_seq``
    sharded), a ``ModelCache`` of placement tuples."""
    return map_axes(lambda ax: rules.placements(mesh, ax),
                    tf.model_cache_axes(cfg, shard_kv_seq=True))


def cache_specs(cfg: ModelConfig, shape: ShapeSpec, mesh, rules=None) -> tf.ModelCache:
    """Meta-device DTensor stand-ins for the KV / SSM cache of a decode cell."""
    rules = rules or rules_for_cell(cfg, mesh, shape.kind, shape.global_batch)
    b = shape.global_batch
    with _OnMeta():
        enc_out = None
        if cfg.encoder is not None:
            enc_out = torch.zeros((b, cfg.encoder.seq_len, cfg.d_model),
                                  dtype=cfg.activation_dtype, device="meta")
        abstract = tf.init_model_cache(cfg, b, shape.seq_len, cfg.activation_dtype,
                                       device="meta", enc_out=enc_out)
    pl = cache_placements(cfg, rules, mesh)

    def place(t, p):
        return None if t is None else _meta_dtensor(t.shape, t.dtype, mesh, p)

    return tf.ModelCache(
        kv_k=tuple(map(place, abstract.kv_k, pl.kv_k)),
        kv_v=tuple(map(place, abstract.kv_v, pl.kv_v)),
        ssm_conv=tuple(map(place, abstract.ssm_conv, pl.ssm_conv)),
        ssm_h=tuple(map(place, abstract.ssm_h, pl.ssm_h)),
        length=torch.zeros((), dtype=torch.int32, device="meta"),
        enc_out=place(abstract.enc_out, pl.enc_out))


def redistribute_cache(cache: tf.ModelCache, cfg: ModelConfig, rules: ShardingRules,
                       mesh) -> tf.ModelCache:
    """The cache in the rules' decode placements (a no-op where it is)."""
    pl = cache_placements(cfg, rules, mesh)

    def move(t, p):
        return None if t is None else t.redistribute(mesh, p)

    return tf.ModelCache(
        kv_k=tuple(map(move, cache.kv_k, pl.kv_k)), kv_v=tuple(map(move, cache.kv_v, pl.kv_v)),
        ssm_conv=tuple(map(move, cache.ssm_conv, pl.ssm_conv)),
        ssm_h=tuple(map(move, cache.ssm_h, pl.ssm_h)), length=cache.length,
        enc_out=move(cache.enc_out, pl.enc_out))


def _plain(x):
    """A DTensor's whole value as a plain tensor (metrics)."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


# -------------------------------------------------------------- step fns ----

def _build_mesh_train_step(cfg, shape, mesh, optimizer, grad_clip, num_microbatches,
                           donate) -> BuiltStep:
    model = Model(cfg)
    rules = rules_for_cell(cfg, mesh, shape.kind, shape.global_batch)
    recipe = train_recipe(cfg)
    opt = recipe.optimizer if optimizer is None else optimizer
    mb = num_microbatches or default_microbatches(shape, cfg, mesh=mesh)
    if shape.global_batch % mb:
        raise ValueError(f"{mb} microbatches do not divide the batch of {shape.global_batch}")
    abstract, axes = abstract_params_and_axes(model)
    if recipe.big:  # the >= 300B recipe trains bf16 parameters
        abstract = cast_params(abstract, recipe.param_dtype)
    param_sh = shardings_for_axes(axes, rules, mesh)
    in_axes = input_axes(cfg, shape)

    def train_step(params, opt_state, batch):
        with activation_sharding(mesh, rules):
            train = tree_map(lambda p: p.detach().requires_grad_(True), params)
            flat = leaves(train)
            per_mb = []
            rows = shape.global_batch // mb
            for i in range(mb):
                # microbatch i is the row block i, each input back in its placements
                mbatch = {k: v[i * rows:(i + 1) * rows].redistribute(
                    mesh, rules.placements(mesh, in_axes[k])) for k, v in batch.items()}
                loss, metrics = model.loss_fn(train, mbatch)
                loss.backward()
                per_mb.append({k: v.detach() for k, v in metrics.items()})
            with torch.no_grad():
                grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in flat]
                if mb > 1:
                    grads = [g.div_(mb) for g in grads]
                grads, gnorm = clip_by_global_norm(unflatten(params, grads), grad_clip)
                new_params, new_state = opt.update(grads, opt_state, params, donate=donate)
                metrics = {k: _plain(torch.stack([m[k] for m in per_mb]).mean())
                           for k in per_mb[0]}
        return new_params, new_state, dict(metrics, grad_norm=_plain(gnorm))

    params_args = _place_meta(abstract, param_sh, mesh)
    with _OnMeta():
        opt_args = opt.init(params_args)
    args = (params_args, opt_args, input_specs(cfg, shape, mesh, rules))
    return BuiltStep(fn=train_step, optimizer=opt, num_microbatches=mb, recipe=recipe, args=args,
                     param_shardings=param_sh, rules=rules, mesh=mesh)


def build_prefill_step(cfg: ModelConfig, shape: ShapeSpec, mesh=None, device=None) -> BuiltStep:
    """``fn(params, batch)`` -> (logits of the last position, the cache sized
    ``shape.seq_len``): over ``mesh``, the cache in the decode placements;
    without one, on ``device`` (``None``: the card, raising with no GPU;
    ``"cpu"`` runs the plain path), where the batch is moved and the cache
    allocated (the parameters must already be there)."""
    model = Model(cfg)
    if mesh is None:
        dev = resolve_device(device)

        def prefill_local(params, batch):
            with torch.no_grad():
                return model.prefill(params, {k: v.to(dev) for k, v in batch.items()},
                                     max_len=shape.seq_len)

        return BuiltStep(fn=prefill_local)
    rules = rules_for_cell(cfg, mesh, shape.kind, shape.global_batch)
    abstract, axes = abstract_params_and_axes(model)
    param_sh = shardings_for_axes(axes, rules, mesh)

    def prefill(params, batch):
        with activation_sharding(mesh, rules), torch.no_grad():
            return model.prefill(params, batch, max_len=shape.seq_len)

    args = (_place_meta(_serve_dtype(abstract), param_sh, mesh),
            input_specs(cfg, shape, mesh, rules))
    return BuiltStep(fn=prefill, args=args, param_shardings=param_sh, rules=rules, mesh=mesh)


def build_decode_step(cfg: ModelConfig, shape: ShapeSpec, mesh=None, device=None) -> BuiltStep:
    """``fn(params, token, cache)`` -> (logits, the cache one token longer).
    Over ``mesh`` the cache is moved into the decode rules' placements first
    (a no-op for a prefill step's cache of the same cell's mesh) and written
    in place.  Without one it runs on ``device`` (as ``build_prefill_step``)
    over a cache of ``shape.seq_len`` rows — the reference's decode cell
    takes one at length ``seq_len - 1`` and attends over all its rows — and
    writes the new token's row in place."""
    model = Model(cfg)
    if mesh is None:
        dev = resolve_device(device)

        def decode_local(params, token, cache):
            rows = {t.shape[2] for t in cache.kv_k if t is not None}
            if rows and rows != {shape.seq_len}:
                raise ValueError(f"the {shape.name} decode step takes a cache of "
                                 f"{shape.seq_len} rows, got {sorted(rows)}")
            with torch.no_grad():
                return model.decode_step(params, token.to(dev), cache)

        return BuiltStep(fn=decode_local)
    rules = rules_for_cell(cfg, mesh, shape.kind, shape.global_batch)
    abstract, axes = abstract_params_and_axes(model)
    param_sh = shardings_for_axes(axes, rules, mesh)

    def decode(params, token, cache):
        with activation_sharding(mesh, rules), torch.no_grad():
            return model.decode_step(params, token, redistribute_cache(cache, cfg, rules, mesh))

    args = (_place_meta(_serve_dtype(abstract), param_sh, mesh),
            input_specs(cfg, shape, mesh, rules)["token"], cache_specs(cfg, shape, mesh, rules))
    return BuiltStep(fn=decode, args=args, param_shardings=param_sh, rules=rules, mesh=mesh)


def build_step(cfg: ModelConfig, shape: ShapeSpec, mesh) -> BuiltStep:
    if shape.kind == "train":
        return build_train_step(cfg, shape, mesh=mesh)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, mesh)
    if shape.kind == "decode":
        return build_decode_step(cfg, shape, mesh)
    raise ValueError(shape.kind)
