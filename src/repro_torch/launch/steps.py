"""The train step on one device (port of ``repro.launch.steps``'
``build_train_step`` and ``default_microbatches``; the mesh, its sharding
rules and the prefill / decode steps are the mesh slice's).

``train_recipe`` is the one place that decides how a configuration
trains: above 2e11 parameters (grok-1, Arctic) the reference's >= 300B
recipe — bf16 parameters, Adafactor, bf16 gradient accumulation — else f32
parameters, AdamW and f32 accumulation.  ``build_train_step`` and
``launch.train.train_loop`` both read it, and it allocates nothing, so it
can be checked on the full configurations.

The step differentiates ``Model.loss_fn`` with autograd, one microbatch at
a time: each microbatch's gradients accumulate in the parameters' ``.grad``
(the recipe's accumulation dtype is the parameters' dtype), their sum is
divided by the count, clipped to ``grad_clip`` by global norm, and the
optimiser takes one update — with ``donate`` (the reference's default) in
place, into the parameter and optimiser-state tensors it was given.  Metrics are the loss function's, averaged over
the microbatches, plus ``grad_norm`` (before clipping).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
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
                         act_budget_bytes: float = 4e9) -> int:
    """Gradient-accumulation factor bounding live activations: the layer
    stack's residuals cost rows * S * d * L * 2 bytes, so the rows of one
    microbatch are sized against ``act_budget_bytes`` (one device: no
    data-parallel split of the batch)."""
    rows = max(shape.global_batch, 1)
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
    fn: Callable  # (params, opt_state, batch) -> (params, opt_state, metrics)
    optimizer: Any
    num_microbatches: int
    recipe: TrainRecipe


def build_train_step(cfg: ModelConfig, shape: ShapeSpec, optimizer=None, grad_clip: float = 1.0,
                     num_microbatches: Optional[int] = None, donate: bool = True) -> BuiltStep:
    """-> a ``BuiltStep`` whose ``fn(params, opt_state, batch)`` runs on the
    device of its tensors.  ``batch`` holds [B, ...] tensors with B the
    shape's global batch, split into ``num_microbatches`` row blocks."""
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
