"""Benefit estimation (paper section 4.3, Lemma 4 / Theorem 2 / Eq. 11).

Port of ``repro.core.benefit``.  For every candidate (object, predicate)
pair: look up the decision table, form the estimated uncertainty ``h_hat``,
invert binary entropy (optimistic upper root), update the joint (the O(1)
conjunctive update or a general AST re-evaluated with one column
substituted), and score ``Benefit = P * P_hat / cost`` (Eq. 11).

``compute_benefits`` (one query) and ``compute_benefits_batched`` (Q
queries over one substrate) are the step-by-step versions; the session
scores through ``kernels.enrich_score.ops.fused_benefits_batched`` and the
operator's kernel route through ``ops.fused_benefits`` (the CUDA kernels
on the card, their plain twins on the CPU).  ``benefit_exact_slow`` is the
paper's §6.3.3 "default strategy".  The candidate helpers broadcast over
any leading slot axes.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import entropy as entropy_lib
from repro_torch.core import threshold as threshold_lib
from repro_torch.core.combine import _fold_sum
from repro_torch.core.decision_table import DecisionTable
from repro_torch.core.query import conjunctive_joint_update

NEG_INF = float("-inf")


class TripleBenefits(NamedTuple):
    benefit: torch.Tensor  # [..., N, P] f32; -inf where no candidate triple exists
    next_fn: torch.Tensor  # [..., N, P] int32; -1 where exhausted
    est_joint: torch.Tensor  # [..., N, P] f32; estimated joint prob if executed
    cost: torch.Tensor  # [..., N, P] f32; cost of the selected function


def _masked_median(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Median over the valid entries of ``values`` along the last axis.

    Invalid entries sort to +inf and the middle indices come from the valid
    count, so the result needs no host sync.  The middle pair is averaged
    as ``(s[lo] + s[hi]) / 2`` (``torch.median`` would return the lower).
    """
    valid = valid.expand_as(values)
    s = torch.sort(torch.where(valid, values, float("inf")), dim=-1).values
    nv = torch.clamp_min(valid.sum(-1), 1)
    lo = torch.gather(s, -1, ((nv - 1) // 2)[..., None])[..., 0]
    hi = torch.gather(s, -1, (nv // 2)[..., None])[..., 0]
    return (lo + hi) / 2


def candidate_mask(
    uncertainty: torch.Tensor,  # [N, P]
    in_answer: torch.Tensor,  # [..., N] bool
    strategy: str,
    pred_mask: Optional[torch.Tensor] = None,  # [..., P] bool
    row_valid: Optional[torch.Tensor] = None,  # [N] bool
    gather: Optional[Callable] = None,
) -> torch.Tensor:
    """[..., N] bool candidate restriction (§4.1 + the "auto" widening).

    ``"auto"`` additionally admits inside-answer objects whose mean
    entropy over the query's own predicate columns is at least the median
    over valid rows (floored at 0.35), so precision errors inside a diffuse
    early answer set can still be fixed.  ``gather`` takes the rows given
    here to all rows (a session on a mesh: the median is over every rank's).
    """
    if strategy == "all":
        return torch.ones_like(in_answer)
    if strategy == "auto":
        if pred_mask is None:
            mean_h = _fold_sum(uncertainty) / uncertainty.shape[-1]
        else:
            denom = torch.clamp_min(pred_mask.sum(-1), 1)
            mean_h = _fold_sum(torch.where(pred_mask[..., None, :], uncertainty, 0.0))
            mean_h = mean_h / denom[..., None]
        if row_valid is None:
            row_valid = torch.ones(mean_h.shape[-1], dtype=torch.bool, device=mean_h.device)
        if gather is None:
            med = _masked_median(mean_h, row_valid)
        else:
            med = _masked_median(gather(mean_h), gather(row_valid))
        return (~in_answer) | (mean_h >= torch.clamp_min(med, 0.35)[..., None])
    return ~in_answer  # "outside_answer" — paper section 4.1


def restrict_benefits(
    benefit: torch.Tensor,  # [..., N, P]
    cand: torch.Tensor,  # [..., N] bool
    plan_size: int,
    reduce: Optional[Callable] = None,
) -> torch.Tensor:
    """Apply the candidate restriction with a starvation guard: never leave
    fewer valid triples than one plan; widen back to all objects when the
    restriction would.  ``reduce`` sums the counts of the rows given here
    over all rows (a session on a mesh)."""
    restricted = torch.where(cand[..., None], benefit, NEG_INF)
    counts = torch.stack(
        [torch.isfinite(restricted).sum((-2, -1)), torch.isfinite(benefit).sum((-2, -1))])
    n_valid, n_all = counts if reduce is None else reduce(counts)
    use = n_valid >= torch.clamp_max(n_all, plan_size)
    return torch.where(use[..., None, None], restricted, benefit)


def estimate_pred_prob_after(pred_prob: torch.Tensor, delta_h: torch.Tensor):
    """Steps 2-3: (h_hat, p_hat) with the optimistic (upper) entropy root."""
    h = entropy_lib.binary_entropy(pred_prob)
    h_hat = torch.clamp(h + delta_h, 0.0, 1.0)
    return h_hat, entropy_lib.inverse_entropy_upper(h_hat)


def compute_benefits(
    state,  # EnrichmentState
    query,  # CompiledQuery
    table: DecisionTable,
    costs: torch.Tensor,  # [P, F] per-(predicate, function) cost
    candidate_mask: Optional[torch.Tensor] = None,  # [N] bool; default ~in_answer (§4.1)
    load_cost: Optional[torch.Tensor] = None,  # [N] per-object load cost (Eq. 12)
    function_selection: str = "table",  # "table" (paper §4.2) | "best" (beyond-paper)
) -> TripleBenefits:
    """Eq. 11 over all (object, predicate) pairs of one query -> [N, P] leaves.

    ``"best"`` (with a table that has ``delta_h_all``) prices every
    remaining function and keeps the first maximum of Eq. 11 instead of the
    table's function choice.  Conjunctive queries use the O(1) joint
    update; general ASTs re-evaluate with one substituted column.
    """
    n, p = state.pred_prob.shape
    state_id = state.state_id()
    pred_idx = torch.arange(p, device=state.pred_prob.device)[None, :].expand(n, p)
    if candidate_mask is None:
        candidate_mask = ~state.in_answer

    if function_selection == "best" and table.delta_h_all is not None:
        dh_all = table.lookup_all(pred_idx, state_id, state.uncertainty)  # [N, P, F]
        finite = torch.isfinite(dh_all)
        _, p_hat_all = estimate_pred_prob_after(
            state.pred_prob[..., None], torch.where(finite, dh_all, 0.0)
        )
        cost = torch.clamp_min(costs[None].expand(dh_all.shape), 1e-9)
        if load_cost is not None:
            cost = cost + load_cost[:, None, None]
        if query.is_conjunctive:
            est_all = query.conjunctive_update(
                state.joint_prob[:, None, None], state.pred_prob[..., None], p_hat_all
            )
        else:
            est_all = torch.stack([
                torch.stack([
                    query.evaluate_with_column(state.pred_prob, c, p_hat_all[:, c, f])
                    for f in range(dh_all.shape[-1])
                ], dim=-1)
                for c in range(p)
            ], dim=1)  # [N, P, F]
        est_all = torch.clamp(est_all, 0.0, 1.0)
        ben_all = state.joint_prob[:, None, None] * est_all / cost  # Eq. 11 per f
        ben_all = torch.where(finite, ben_all, NEG_INF)
        benefit, nf = torch.max(ben_all, dim=-1)  # first maximum, as jnp.argmax
        est_joint = torch.gather(est_all, -1, nf[..., None])[..., 0]
        cost = torch.gather(cost, -1, nf[..., None])[..., 0]
        nf = torch.where(torch.isfinite(benefit), nf, -1).to(torch.int32)
        valid = (nf >= 0) & candidate_mask[:, None]
        benefit = torch.where(valid, benefit, NEG_INF)
        return TripleBenefits(benefit=benefit, next_fn=nf, est_joint=est_joint, cost=cost)

    nf, dh = table.lookup(pred_idx, state_id, state.uncertainty)  # [N, P] each
    _, p_hat = estimate_pred_prob_after(state.pred_prob, dh)
    if query.is_conjunctive:
        est_joint = query.conjunctive_update(state.joint_prob[:, None], state.pred_prob, p_hat)
    else:
        est_joint = torch.stack(
            [query.evaluate_with_column(state.pred_prob, c, p_hat[:, c]) for c in range(p)],
            dim=-1,
        )
    est_joint = torch.clamp(est_joint, 0.0, 1.0)
    cost = costs[pred_idx, torch.clamp_min(nf, 0).long()]  # [N, P]
    if load_cost is not None:
        cost = cost + load_cost[:, None]  # Eq. 12: c_load + c_fn
    cost = torch.clamp_min(cost, 1e-9)
    benefit = state.joint_prob[:, None] * est_joint / cost  # Eq. 11
    valid = (nf >= 0) & candidate_mask[:, None]
    benefit = torch.where(valid, benefit, NEG_INF)
    return TripleBenefits(benefit=benefit, next_fn=nf, est_joint=est_joint, cost=cost)


def compute_benefits_batched(
    pred_prob: torch.Tensor,  # [N, P] shared predicate probabilities (f32)
    uncertainty: torch.Tensor,  # [N, P] shared binary entropy of pred_prob
    state_id: torch.Tensor,  # [N, P] int32 shared decision-table key
    joint_prob: torch.Tensor,  # [Q, N] per-query joint probabilities
    table: DecisionTable,
    costs: torch.Tensor,  # [P, F]
    function_selection: str = "table",  # "table" | "best"
) -> TripleBenefits:
    """Multi-query Eq. 11 over a shared substrate: [Q, N, P] leaves.

    The step-by-step oracle: table lookup, p_hat inversion and costs are
    computed once at [N, P(, F)] and broadcast onto the Q axis; ``"best"``
    materializes the full [Q, N, P, F] tensor the kernel avoids.
    """
    n, p = pred_prob.shape
    q = joint_prob.shape[0]
    pred_idx = torch.arange(p, device=pred_prob.device)[None, :].expand(n, p)
    if function_selection == "best":
        dh_all = table.lookup_all(pred_idx, state_id, uncertainty)  # [N, P, F]
        finite = torch.isfinite(dh_all)
        _, p_hat_all = estimate_pred_prob_after(
            pred_prob[..., None], torch.where(finite, dh_all, 0.0)
        )
        cost = torch.clamp_min(costs[None].expand(dh_all.shape), 1e-9)
        est_all = torch.clamp(
            conjunctive_joint_update(
                joint_prob[:, :, None, None], pred_prob[None, :, :, None], p_hat_all[None]
            ),
            0.0,
            1.0,
        )  # [Q, N, P, F]
        ben_all = joint_prob[:, :, None, None] * est_all / cost[None]
        ben_all = torch.where(finite[None], ben_all, NEG_INF)
        benefit, nf = torch.max(ben_all, dim=-1)  # first maximum, as jnp.argmax
        est_joint = torch.gather(est_all, -1, nf[..., None])[..., 0]
        cost_q = torch.gather(cost[None].expand(est_all.shape), -1, nf[..., None])[..., 0]
        nf = torch.where(torch.isfinite(benefit), nf, -1).to(torch.int32)
        return TripleBenefits(benefit=benefit, next_fn=nf, est_joint=est_joint, cost=cost_q)

    nf, dh = table.lookup(pred_idx, state_id, uncertainty)  # [N, P] each
    _, p_hat = estimate_pred_prob_after(pred_prob, dh)
    est_joint = torch.clamp(
        conjunctive_joint_update(joint_prob[:, :, None], pred_prob[None], p_hat[None]),
        0.0,
        1.0,
    )  # [Q, N, P]
    cost = torch.clamp_min(costs[pred_idx, torch.clamp_min(nf, 0).long()], 1e-9)
    benefit = joint_prob[:, :, None] * est_joint / cost[None]
    return TripleBenefits(
        benefit=benefit,
        next_fn=nf[None].expand(q, n, p),
        est_joint=est_joint,
        cost=cost[None].expand(q, n, p),
    )


def benefit_exact_slow(
    state,  # EnrichmentState
    query,  # CompiledQuery
    table: DecisionTable,
    costs: torch.Tensor,
    alpha: float = 1.0,
    candidate_mask: Optional[torch.Tensor] = None,
    chunk_elements: int = 1 << 22,
) -> TripleBenefits:
    """The paper's §6.3.3 "default strategy": per-triple threshold re-selection.

    Benefit = (E(F_a) after re-running Theorem-1 selection with one
    object's joint set to its estimate - E(F_a) of Answer_{i-1}) / cost
    (Eq. 7 computed literally).  A loop over the P columns, objects batched
    ``chunk_elements // N`` at a time: still O(N^2 P log N) work, for the
    Fig. 8 comparison at small N only.
    """
    base = threshold_lib.select_answer(state.joint_prob, alpha)
    fast = compute_benefits(state, query, table, costs, candidate_mask)
    n, p = state.pred_prob.shape
    chunk = max(1, chunk_elements // max(n, 1))
    ef = torch.empty((n, p), dtype=torch.float32, device=state.joint_prob.device)
    for c in range(p):
        for lo in range(0, n, chunk):
            objs = torch.arange(lo, min(lo + chunk, n), device=state.joint_prob.device)
            jp = state.joint_prob[None, :].repeat(objs.shape[0], 1)  # [chunk, N]
            jp[torch.arange(objs.shape[0], device=jp.device), objs] = fast.est_joint[objs, c]
            ef[objs, c] = threshold_lib.select_answer(jp, alpha).expected_f
    benefit = (ef - base.expected_f) / fast.cost
    benefit = torch.where(torch.isfinite(fast.benefit), benefit, NEG_INF)
    return TripleBenefits(
        benefit=benefit, next_fn=fast.next_fn, est_joint=fast.est_joint, cost=fast.cost
    )
