"""Plan generation + selection (paper sections 4.4, 3.2).

Port of ``repro.core.plan``.  A plan is a fixed-capacity top-k over the
dense benefit matrix, ordered by benefit descending with ties broken by
ascending flat (object * P + predicate) index — the order ``jax.lax.top_k``
gives.  ``torch.topk`` promises no order among ties, so every top-k here is
a stable descending sort sliced to k, and every ``lexsort`` is a chain of
stable sorts, least significant key first.

Triple keys are int64 (the reference's int32 keys needed an N*P*F < 2**31
guard); want-bit words are int64 holding 32 bits each, in the reference's
``[M, ceil(S/32)]`` layout, because CUDA has no uint32 scatter-add.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.benefit import TripleBenefits

_I64_MAX = torch.iinfo(torch.int64).max


class Plan(NamedTuple):
    """A fixed-capacity epoch plan (paper Plan_i), sorted by descending benefit."""

    object_idx: torch.Tensor  # [..., K] int64
    pred_idx: torch.Tensor  # [..., K] int64
    func_idx: torch.Tensor  # [..., K] int64
    benefit: torch.Tensor  # [..., K] f32
    cost: torch.Tensor  # [..., K] f32
    valid: torch.Tensor  # [..., K] bool (within budget and finite benefit)

    @property
    def capacity(self) -> int:
        return self.object_idx.shape[-1]

    def num_valid(self) -> torch.Tensor:
        return self.valid.sum(-1)

    def total_cost(self) -> torch.Tensor:
        return torch.where(self.valid, self.cost, 0.0).sum(-1)

    def map(self, fn) -> "Plan":
        return Plan(*(fn(x) for x in self))


def _top_k(values: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lower index (``lax.top_k``)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _lexsort(keys) -> torch.Tensor:
    """``jnp.lexsort`` for 1-D keys: the LAST key is primary."""
    order = torch.argsort(keys[0], stable=True)
    for key in keys[1:]:
        order = order[torch.argsort(key[order], stable=True)]
    return order


def canonicalize_plan(plan: Plan) -> Plan:
    """Mask don't-care invalid lanes to fixed sentinels, so plans from
    equivalent selection paths compare with ``torch.equal``."""
    v = plan.valid
    return Plan(
        object_idx=torch.where(v, plan.object_idx, -1),
        pred_idx=torch.where(v, plan.pred_idx, -1),
        func_idx=torch.where(v, plan.func_idx, -1),
        benefit=torch.where(v, plan.benefit, float("-inf")),
        cost=torch.where(v, plan.cost, 0.0),
        valid=v,
    )


def quarantine_filter(plan: Plan, quarantined: torch.Tensor) -> Plan:
    """Invalidate lanes whose (pred, func) is quarantined ([P, F] bool), so
    execution and attribution can never run or bill a quarantined triple."""
    dead = quarantined[plan.pred_idx, torch.clamp_min(plan.func_idx, 0)]
    dead = dead & (plan.func_idx >= 0)
    return plan._replace(valid=plan.valid & ~dead)


def gather_object_idx(plan: Plan, num_objects: int) -> torch.Tensor:
    """[K] object indices safe for row gathers: invalid lanes route to row 0
    (clipping alone would alias them onto row num_objects - 1, a real row
    once a padded session fills up); ``valid`` keeps them inert."""
    safe = torch.clamp(plan.object_idx, 0, num_objects - 1)
    return torch.where(plan.valid, safe, 0)


def select_plan(
    benefits: TripleBenefits,  # [..., N, P] leaves
    plan_size: int,
    cost_budget=None,
) -> Plan:
    """Top-``plan_size`` triples by benefit, optionally cost-budget-masked.

    Batched over any leading axes.  Order: descending benefit, ties by
    ascending flat (object * P + predicate) index.
    """
    *lead, n, p = benefits.benefit.shape
    flat = benefits.benefit.reshape(*lead, n * p)
    k = min(plan_size, n * p)
    top_vals, top_idx = _top_k(flat, k)
    fn = torch.gather(benefits.next_fn.reshape(*lead, n * p), -1, top_idx).long()
    cost = torch.gather(benefits.cost.reshape(*lead, n * p), -1, top_idx)
    valid = torch.isfinite(top_vals) & (fn >= 0)
    if cost_budget is not None:
        # executed in benefit order until the epoch's budget is consumed
        csum = torch.cumsum(torch.where(valid, cost, 0.0), dim=-1)
        valid = valid & (csum <= cost_budget)
    return Plan(
        object_idx=top_idx // p,
        pred_idx=top_idx % p,
        func_idx=fn,
        benefit=top_vals,
        cost=cost,
        valid=valid,
    )


def merge_sharded_plans(plans: Plan, plan_size: int) -> Plan:
    """Reduce per-shard plans [S, K] -> the global top-k plan (hierarchical
    top-k).  Top-k-equivalent to the unsharded plan but not order-identical
    on ties; ``merge_sharded_plans_exact`` is."""
    flat = plans.map(lambda x: x.reshape(-1))
    score = torch.where(flat.valid, flat.benefit, float("-inf"))
    _, idx = _top_k(score, min(plan_size, score.shape[0]))
    return flat.map(lambda x: x[idx])


def merge_sharded_plans_exact(plans: Plan, plan_size: int, num_predicates: int) -> Plan:
    """Reduce per-shard plans [S, K] -> the plan ``select_plan`` would produce
    on the unsharded benefit matrix, identical on every valid lane.  Object
    indices must already be global."""
    flat = plans.map(lambda x: x.reshape(-1))
    score = torch.where(flat.valid, flat.benefit, float("-inf"))
    tie = flat.object_idx * num_predicates + flat.pred_idx
    tie = torch.where(flat.valid, tie, _I64_MAX)
    order = _lexsort((tie, -score))
    k = min(plan_size, score.shape[0])
    return flat.map(lambda x: x[order[:k]])


def _triple_keys(plan: Plan, num_predicates: int, num_functions: int, num_objects=None):
    """int64 (object, predicate, function) keys; invalid lanes get the sentinel.

    int64 keys cover every realistic corpus; the guard remains only for a
    key space past int64 itself.
    """
    if num_objects is not None:
        key_space = int(num_objects) * int(num_predicates) * int(num_functions)
        if key_space >= 2**63:
            raise ValueError(
                f"triple key space N*P*F = {key_space} >= 2**63 overflows the "
                "int64 dedup keys in merge_plans_dedup; shard the object axis "
                "before merging"
            )
    key = (plan.object_idx * num_predicates + plan.pred_idx) * num_functions + plan.func_idx
    return torch.where(plan.valid, key, _I64_MAX), _I64_MAX


def _dedup_merge_core(flat: Plan, key, sentinel, capacity, cost_budget):
    """Lexsort-dedup-compact pass -> (merged, order, first, top_idx)."""
    # primary: key ascending; secondary: benefit descending, so the first
    # occurrence of each key is its max-benefit copy
    order = _lexsort((-flat.benefit, key))
    k_sorted = key[order]
    first = torch.ones_like(k_sorted, dtype=torch.bool)
    first[1:] = k_sorted[1:] != k_sorted[:-1]
    uniq = first & (k_sorted != sentinel)
    score = torch.where(uniq, flat.benefit[order], float("-inf"))
    top_vals, top_idx = _top_k(score, capacity)
    sel = order[top_idx]
    merged = flat.map(lambda x: x[sel])
    valid = torch.isfinite(top_vals)
    if cost_budget is not None:
        csum = torch.cumsum(torch.where(valid, merged.cost, 0.0), dim=-1)
        valid = valid & (csum <= cost_budget)
    return merged._replace(valid=valid), order, first, top_idx


def merge_plans_dedup(
    plans: Plan,
    num_predicates: int,
    num_functions: int,
    capacity=None,
    cost_budget=None,
    num_objects=None,
) -> Plan:
    """Merge per-query plans (any leading axes) into one deduplicated plan:
    each (object, predicate, function) triple survives once, at the highest
    benefit any query gave it; order is benefit desc, key asc."""
    flat = plans.map(lambda x: x.reshape(-1))
    total = flat.object_idx.shape[0]
    capacity = total if capacity is None else min(capacity, total)
    key, sentinel = _triple_keys(flat, num_predicates, num_functions, num_objects)
    return _dedup_merge_core(flat, key, sentinel, capacity, cost_budget)[0]


def merge_plans_dedup_wants(
    plans: Plan,  # [Q, K]: leading axis MUST be the tenant-slot axis
    num_predicates: int,
    num_functions: int,
    num_slots=None,
    capacity=None,
    cost_budget=None,
    num_objects=None,
) -> tuple[Plan, torch.Tensor]:
    """``merge_plans_dedup`` that also reports WHICH tenants wanted each triple.

    Returns ``(merged, want_bits)``; ``want_bits`` is ``[M, W]`` int64 words
    holding 32 bits each, ``W = ceil(num_slots / 32)``: bit ``q`` (little-
    endian across words) of row ``m`` is set iff slot ``q``'s plan held merged
    triple ``m`` as a valid lane.  Built with a scatter-add over (key group,
    word), exact because one slot's plan never holds a triple twice.
    """
    if plans.object_idx.ndim != 2:
        raise ValueError(
            "merge_plans_dedup_wants requires [Q, K] plans (slot-major); got "
            f"shape {tuple(plans.object_idx.shape)}"
        )
    q, k = plans.object_idx.shape
    if num_slots is None:
        num_slots = q
    if q > num_slots:
        raise ValueError(f"plans carry {q} slots > num_slots={num_slots}")
    flat = plans.map(lambda x: x.reshape(-1))
    total = flat.object_idx.shape[0]
    capacity = total if capacity is None else min(capacity, total)
    key, sentinel = _triple_keys(flat, num_predicates, num_functions, num_objects)
    merged, order, first, top_idx = _dedup_merge_core(flat, key, sentinel, capacity, cost_budget)
    words = (num_slots + 31) // 32
    slot = (torch.arange(total, device=key.device) // k)[order]
    bit = torch.where(key[order] != sentinel, torch.ones_like(slot) << (slot % 32), 0)
    group = torch.cumsum(first.to(torch.int64), 0) - 1  # key-group id per sorted position
    acc = torch.zeros((total, words), dtype=torch.int64, device=key.device)
    acc.index_put_((group, slot // 32), bit, accumulate=True)
    want_bits = torch.where(merged.valid[:, None], acc[group[top_idx]], 0)
    return merged, want_bits


def merge_plans_dedup_sharded(
    plans: Plan,
    num_predicates: int,
    num_functions: int,
    capacity=None,
    cost_budget=None,
    num_objects=None,
) -> Plan:
    """Hierarchical dedup merge: ``merge_plans_dedup`` inside every shard
    (leading axis, lossless), then once more across the shards' survivors.
    Exact because dedup is associative and the output order (benefit desc,
    key asc) does not depend on the partition: with ``capacity`` equal to
    the flat entry count it equals ``merge_plans_dedup`` on every valid lane.
    """
    stage1 = [
        merge_plans_dedup(plans.map(lambda x: x[i]), num_predicates, num_functions,
                          num_objects=num_objects)
        for i in range(plans.object_idx.shape[0])
    ]
    stacked = Plan(*(torch.stack(leaves) for leaves in zip(*stage1)))  # [S, K_local]
    if capacity is None:
        capacity = plans.object_idx.numel()
    return merge_plans_dedup(
        stacked, num_predicates, num_functions, capacity=capacity,
        cost_budget=cost_budget, num_objects=num_objects,
    )


def static_plan_from_order(
    object_order: torch.Tensor,  # [M] object indices in execution order
    pred_of_slot: torch.Tensor,  # [M]
    func_of_slot: torch.Tensor,  # [M]
    costs: torch.Tensor,  # [P, F]
    offset: int,  # how many triples were already executed
    plan_size: int,
) -> Plan:
    """A window of a precomputed static execution order (the baselines).

    The benefit carries a descending global rank (M - slot), so earlier
    slots outrank later ones should these plans ever feed a dedup merge.
    """
    m = object_order.shape[0]
    sl = offset + torch.arange(plan_size, device=object_order.device)
    in_range = sl < m
    rank = (m - sl).to(torch.float32)  # descending across and within windows
    sl = torch.clamp_max(sl, m - 1)
    obj, prd, fn = object_order[sl].long(), pred_of_slot[sl].long(), func_of_slot[sl].long()
    cost = costs[prd, torch.clamp_min(fn, 0)]
    valid = in_range & (fn >= 0)
    return Plan(
        object_idx=obj,
        pred_idx=prd,
        func_idx=fn,
        benefit=torch.where(valid, rank, float("-inf")),
        cost=cost,
        valid=valid,
    )
