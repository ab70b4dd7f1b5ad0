"""Baseline evaluation strategies (paper section 6.1 "Approaches" + Fig. 1).

Port of ``repro.core.baselines``.

* ``baseline1`` (function-based): functions ordered by quality / cost
  descending; each function runs over all objects ordered by initial joint
  probability.
* ``baseline2`` (object-based): objects ordered by initial joint
  probability; all required functions run per object before moving on.
* ``traditional``: Baseline 1's order, but the answer set is withheld until
  every triple has executed (Fig. 1 left).
* ``incremental``: cheapest-function-first sweeps over all objects (Fig. 1
  middle).

All are static orders fixed at t = 0; they reuse the operator's execution
and answer-selection machinery, so a comparison isolates the scheduling
policy.  The orders are built on the host with numpy's stable argsort.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import plan as plan_lib
from repro_torch.core import state as state_lib
from repro_torch.core import threshold as threshold_lib
from repro_torch.core.combine import CombineParams
from repro_torch.core.metrics import true_f_alpha
from repro_torch.core.operator import EpochStats, OperatorConfig
from repro_torch.core.query import CompiledQuery
from repro_torch.device import resolve_device


def build_static_order(
    strategy: str,
    init_state: state_lib.EnrichmentState,
    query: CompiledQuery,
    combine_params: CombineParams,
    costs: np.ndarray,  # [P, F]
    quality: np.ndarray,  # [P, F] (AUC)
    exclude_pairs: Optional[set] = None,  # (pred, fn) already pre-executed
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (object_order, pred_of_slot, func_of_slot), each [N * pairs]."""
    n = init_state.num_objects
    p, f = costs.shape
    joint = init_state.joint_prob.cpu().numpy()
    obj_order = np.argsort(-joint, kind="stable")  # [N], by initial joint probability

    exclude_pairs = exclude_pairs or set()
    pairs = [(pi, fi) for pi in range(p) for fi in range(f) if (pi, fi) not in exclude_pairs]
    if strategy in ("baseline1", "traditional", "incremental"):
        if strategy == "incremental":  # cheapest first, sweeping uniformly
            pairs.sort(key=lambda t: costs[t[0], t[1]])
        else:  # functions by quality / cost descending (paper Baseline1)
            pairs.sort(key=lambda t: -(quality[t[0], t[1]] / max(costs[t[0], t[1]], 1e-9)))
        slots_obj = [obj_order] * len(pairs)
        slots_pred = [np.full(n, pi, np.int32) for pi, _ in pairs]
        slots_fn = [np.full(n, fi, np.int32) for _, fi in pairs]
    elif strategy == "baseline2":
        # object-major: all (pred, fn) per object, functions best-quality first
        pairs.sort(key=lambda t: -quality[t[0], t[1]])
        slots_obj = [np.repeat(obj_order, len(pairs))]
        slots_pred = [np.tile(np.array([pi for pi, _ in pairs], np.int32), n)]
        slots_fn = [np.tile(np.array([fi for _, fi in pairs], np.int32), n)]
    else:
        raise ValueError(f"unknown baseline strategy: {strategy}")
    return (
        np.concatenate(slots_obj).astype(np.int32),
        np.concatenate(slots_pred).astype(np.int32),
        np.concatenate(slots_fn).astype(np.int32),
    )


class StaticOrderEvaluator:
    """Runs a static execution order through the same epoch machinery."""

    def __init__(
        self,
        strategy: str,
        query: CompiledQuery,
        combine_params: CombineParams,
        costs,
        quality,
        bank,  # on the evaluator's device
        config: OperatorConfig = OperatorConfig(),
        truth_mask: Optional[torch.Tensor] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.strategy = strategy
        self.query = query
        self.combine_params = combine_params.to(self.device)
        self.costs = torch.as_tensor(costs, dtype=torch.float32).to(self.device)
        self.quality = np.asarray(quality)
        self.bank = bank
        self.config = config
        self.truth_mask = None if truth_mask is None else torch.as_tensor(truth_mask).to(
            self.device)

    def _apply_and_select(self, state, plan, outputs):
        state = state_lib.apply_function_outputs(
            state, self.query, self.combine_params,
            plan.object_idx, plan.pred_idx, plan.func_idx, outputs, plan.cost, plan.valid,
        )
        if self.config.answer_mode == "approx":
            sel = threshold_lib.select_answer_approx(state.joint_prob, self.config.alpha)
        else:
            sel = threshold_lib.select_answer(state.joint_prob, self.config.alpha)
        return dataclasses.replace(state, in_answer=sel.mask), sel

    def run(self, num_objects: int, num_epochs: int, cached_probs=None, cached_mask=None):
        st = state_lib.init_state(
            num_objects, self.query.num_predicates, self.costs.shape[1],
            prior=self.config.prior, device=self.device,
        )
        st = state_lib.refresh_derived(st, self.query, self.combine_params,
                                       prior=self.config.prior)
        exclude: set = set()
        if cached_probs is not None and cached_mask is not None:
            cached_mask = torch.as_tensor(cached_mask).to(self.device)
            st = state_lib.with_cached_state(
                st, self.query, self.combine_params,
                torch.as_tensor(cached_probs).to(self.device), cached_mask,
            )
            # pairs pre-executed on ALL objects need not run again
            full = cached_mask.all(0).cpu().numpy()  # [P, F]
            exclude = {(pi, fi) for pi, fi in zip(*np.nonzero(full))}
        order, preds, fns = build_static_order(
            "baseline1" if self.strategy == "traditional" else self.strategy,
            st, self.query, self.combine_params,
            self.costs.cpu().numpy(), self.quality, exclude_pairs=exclude,
        )
        order_t, preds_t, fns_t = (torch.from_numpy(x).to(self.device)
                                   for x in (order, preds, fns))
        total = order.shape[0]
        history: list[EpochStats] = []
        offset = 0
        for e in range(num_epochs):
            if offset >= total:
                break
            t0 = time.perf_counter()
            plan = plan_lib.static_plan_from_order(
                order_t, preds_t, fns_t, self.costs, offset, self.config.plan_size
            )
            outputs = self.bank.execute(plan)
            st, sel = self._apply_and_select(st, plan, outputs)
            offset += self.config.plan_size
            done = offset >= total
            # Traditional withholds any useful answer until fully enriched.
            if self.strategy == "traditional" and not done:
                ef, size, mask = 0.0, 0, torch.zeros_like(sel.mask)
            else:
                ef, size, mask = float(sel.expected_f), int(sel.size), sel.mask
            tf1 = (
                float(true_f_alpha(mask, self.truth_mask, self.config.alpha))
                if self.truth_mask is not None
                else None
            )
            history.append(
                EpochStats(
                    epoch=e,
                    cost_spent=float(st.cost_spent),
                    expected_f=ef,
                    answer_size=size,
                    true_f1=tf1,
                    plan_cost=float(plan.total_cost()),
                    plan_valid=int(plan.num_valid()),
                    wall_time_s=time.perf_counter() - t0,
                )
            )
        return st, history
