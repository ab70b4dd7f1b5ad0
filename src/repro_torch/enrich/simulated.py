"""Simulated tagging bank: function outputs are pre-materialized tensors.

Port of ``repro.enrich.simulated``.  Executing a plan is a gather — the
paper-scale reproduction path (its tagging functions are classifiers whose
outputs ``data.synthetic`` models with AUC-calibrated synthetic scores).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.plan import Plan


@dataclasses.dataclass
class SimulatedBank:
    """Bank backed by a dense [N, P, F] tensor of function outputs."""

    outputs: torch.Tensor  # [N, P, F]
    costs: torch.Tensor  # [P, F]

    # execute() is a pure gather, so whole epochs can run inside the
    # session superstep.  Banks that batch real inference per epoch on the
    # host must leave this False.
    supports_scan = True

    def to(self, device) -> "SimulatedBank":
        return dataclasses.replace(self, outputs=self.outputs.to(device),
                                   costs=self.costs.to(device))

    def execute(self, plan: Plan) -> torch.Tensor:
        obj = torch.clamp(plan.object_idx, 0, self.outputs.shape[0] - 1)
        fn = torch.clamp_min(plan.func_idx, 0)
        return self.outputs[obj, plan.pred_idx, fn]


def subset_columns(bank: SimulatedBank, cols) -> SimulatedBank:
    """Restrict a bank to a subset of predicate columns (the independent-
    operators baseline of the multi-query engine: each operator sees only
    its own query's predicates)."""
    cols = torch.as_tensor(cols, dtype=torch.int64, device=bank.outputs.device)
    return dataclasses.replace(bank, outputs=bank.outputs[:, cols], costs=bank.costs[cols])


def preprocess_cheapest(outputs: torch.Tensor, costs: torch.Tensor):
    """Paper section 6.1 "Initialization Step": the cheapest function of
    every tag type runs on all objects before any query arrives.

    Returns (cached_probs [N, P, F], cached_mask [N, P, F], cheapest_fn [P])
    for ``ProgressiveQueryOperator.warm_start`` and the baselines.
    """
    n, p, f = outputs.shape
    cheapest = torch.argmin(costs, dim=-1)  # [P], first minimum as jnp.argmin
    mask = torch.nn.functional.one_hot(cheapest, f).to(torch.bool)[None]  # [1, P, F]
    return outputs, mask.expand(n, p, f), cheapest


@dataclasses.dataclass
class LatencyModelBank(SimulatedBank):
    """SimulatedBank + a wall-clock latency model (straggler experiments):
    ``shard_slowdown`` multiplies the modeled cost of objects on given
    shards."""

    shard_of_object: Optional[torch.Tensor] = None  # [N] int
    shard_slowdown: Optional[torch.Tensor] = None  # [S] f32 multiplier

    def modeled_plan_time(self, plan: Plan) -> torch.Tensor:
        base = torch.where(plan.valid, plan.cost, 0.0)
        if self.shard_of_object is None or self.shard_slowdown is None:
            return base.sum()
        obj = torch.clamp(plan.object_idx, 0, self.shard_of_object.shape[0] - 1)
        shards = self.shard_of_object[obj].long()
        mult = self.shard_slowdown[shards]
        # epoch time = max over shards of that shard's work (bulk-synchronous)
        per_shard = torch.zeros(self.shard_slowdown.shape[0], dtype=base.dtype,
                                device=base.device).index_add_(0, shards, base * mult)
        return per_shard.max()
