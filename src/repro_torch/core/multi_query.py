"""Multi-query batched PIQUE engine: Q concurrent queries, one shared corpus.

Port of ``repro.core.multi_query``.  Q queries run in lockstep epochs over
one ``SharedSubstrate`` with cross-query plan dedup: a triple is executed
and charged once however many queries want it.  ``MultiQueryEngine`` is a
facade over ``EngineSession`` at ``capacity == N`` with ``max_tenants ==
Q`` (each conjunctive query one tenant slot): ``run`` / ``run_scan``
convert ``MultiQueryState`` at the boundary and run the session superstep.
The per-epoch legacy path (``run_epoch``: ``_plan_epoch``, the bank,
``_apply_and_select``) serves general (non-conjunctive) ASTs and the
serving layer's per-epoch API.

``MultiQueryConfig`` is ``EngineConfig``.  There is no backend knob:
conjunctive query sets score through ``ops.fused_benefits_batched`` — the
CUDA kernels on the card, their plain twins on the CPU.  The engine runs on
the card unless ``device="cpu"`` is passed; the bank must live on the
engine's device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import ledger as ledger_lib
from repro_torch.core import plan as plan_lib
from repro_torch.core import query as query_lib
from repro_torch.core import state as state_lib
from repro_torch.core import threshold as threshold_lib
from repro_torch.core.benefit import (
    NEG_INF,
    TripleBenefits,
    candidate_mask,
    estimate_pred_prob_after,
    restrict_benefits,
)
from repro_torch.core.combine import CombineParams, combine_probabilities
from repro_torch.core.decision_table import DecisionTable
from repro_torch.core.entropy import binary_entropy
from repro_torch.core.executor import (
    EngineConfig,
    SessionDerived,
    SessionState,
    facade_bank_state,
    resolve_deprecated_driver,
    scan_capable,
    select_plans_batched,
    superstep_bank,
)
from repro_torch.core.metrics import true_f_alpha
from repro_torch.core.query import CompiledQuery
from repro_torch.core.state import PerQueryState, SharedSubstrate
from repro_torch.device import resolve_device
from repro_torch.kernels.enrich_score import ops as es_ops

MultiQueryConfig = EngineConfig  # one config type for every engine


# --------------------------------------------------------------- query set --


@dataclasses.dataclass(frozen=True)
class QuerySet:
    """Q compiled queries re-homed onto one global predicate space.

    ``pred_mask[q, j]`` says query q references global predicate column j.
    ``unique_rows`` / ``unique_index`` group tenants whose reindexed query
    is identical, so answer selection and candidate restriction run once
    per distinct query and fan out by gather.  Tensors live on the CPU; the
    engine moves them to its device.
    """

    queries: tuple  # tuple[CompiledQuery] — original, local predicate spaces
    reindexed: tuple  # tuple[CompiledQuery] — global predicate space
    global_predicates: tuple  # tuple[Predicate]
    pred_mask: torch.Tensor  # [Q, P] bool
    all_conjunctive: bool
    unique_rows: torch.Tensor  # [U] int64: first tenant row of each distinct query
    unique_index: torch.Tensor  # [Q] int64: tenant row -> distinct-query group

    @property
    def num_queries(self) -> int:
        return len(self.queries)

    @property
    def num_predicates(self) -> int:
        return len(self.global_predicates)

    @property
    def num_unique(self) -> int:
        return self.unique_rows.shape[0]

    def evaluate_batched(self, pred_prob: torch.Tensor) -> torch.Tensor:
        """[Q, ..., P] predicate probabilities -> [Q, ...] joint probabilities
        (conjunctive sets: a masked product folded left to right)."""
        if self.all_conjunctive:
            shape = (self.num_queries,) + (1,) * (pred_prob.ndim - 2) + (-1,)
            mask = self.pred_mask.to(pred_prob.device).reshape(shape)
            terms = torch.where(mask, pred_prob, 1.0)
            out = terms[..., 0]
            for i in range(1, terms.shape[-1]):
                out = out * terms[..., i]
            return out
        return torch.stack([q.evaluate(pred_prob[i]) for i, q in enumerate(self.reindexed)])

    def add(self, query: CompiledQuery) -> "QuerySet":
        """Extend with one query whose predicates already exist in the space
        (the substrate's P axis is fixed at engine construction)."""
        self.check_admissible(query)
        return build_query_set(self.queries + (query,), global_predicates=self.global_predicates)

    def check_admissible(self, query: CompiledQuery) -> None:
        """Reject queries the compiled predicate space cannot serve, loudly."""
        missing = [p for p in query.predicates if p not in self.global_predicates]
        if missing:
            raise ValueError(
                f"query references {len(missing)} predicate(s) outside the "
                f"compiled global space (num_predicates={self.num_predicates}): "
                f"{missing}; the substrate's P axis is fixed at engine "
                "construction — build the initial QuerySet over the full "
                "corpus schema (global_predicates=...) to admit this query"
            )


def build_query_set(
    queries: Sequence[CompiledQuery],
    global_predicates: Optional[Sequence] = None,
) -> QuerySet:
    queries = tuple(queries)
    if global_predicates is None:
        global_predicates = query_lib.global_predicate_space(queries)
    global_predicates = tuple(global_predicates)
    reindexed = tuple(query_lib.reindex_query(q, global_predicates) for q in queries)
    index = {pred: j for j, pred in enumerate(global_predicates)}
    mask = torch.zeros((len(queries), len(global_predicates)), dtype=torch.bool)
    for i, q in enumerate(queries):
        mask[i, [index[pred] for pred in q.predicates]] = True
    groups: dict = {}  # reindexed AST (frozen dataclasses: hashable) -> group
    unique_rows: list = []
    unique_index: list = []
    for i, rq in enumerate(reindexed):
        g = groups.get(rq.ast)
        if g is None:
            g = groups[rq.ast] = len(unique_rows)
            unique_rows.append(i)
        unique_index.append(g)
    return QuerySet(
        queries=queries,
        reindexed=reindexed,
        global_predicates=global_predicates,
        pred_mask=mask,
        all_conjunctive=all(q.is_conjunctive for q in queries),
        unique_rows=torch.tensor(unique_rows, dtype=torch.int64),
        unique_index=torch.tensor(unique_index, dtype=torch.int64),
    )


# ------------------------------------------------------------ engine state --


@dataclasses.dataclass
class MultiQueryState:
    substrate: SharedSubstrate
    per_query: PerQueryState

    @property
    def num_queries(self) -> int:
        return self.per_query.num_queries

    @property
    def cost_spent(self) -> torch.Tensor:
        return self.substrate.cost_spent


@dataclasses.dataclass
class MultiEpochStats:
    epoch: int
    cost_spent: float  # cumulative substrate spend (shared across queries)
    epoch_cost: float  # cost newly charged this epoch (post-dedup)
    requested_cost: float  # sum of per-query plan costs before dedup
    expected_f: list  # [Q] per-query E(F_alpha)
    answer_size: list  # [Q]
    true_f: Optional[list]  # [Q] against ground truth, when available
    plan_valid: list  # [Q] valid triples each query requested
    merged_valid: int  # unique triples actually executed
    wall_time_s: float  # superstep runs: total wall / epochs (amortized)
    answer_mask: Optional[np.ndarray] = None  # [Q, N] when collect_masks

    @property
    def dedup_savings(self) -> float:
        """Cost the cross-query merge avoided this epoch."""
        return self.requested_cost - self.epoch_cost

    @property
    def mean_expected_f(self) -> float:
        return sum(self.expected_f) / max(len(self.expected_f), 1)


# ------------------------------------------------------------------ engine --


class MultiQueryEngine:
    """Lockstep progressive evaluation of Q queries over one shared corpus."""

    def __init__(
        self,
        query_set: QuerySet,
        table: DecisionTable,
        combine_params: CombineParams,
        costs,  # [P, F] over the GLOBAL predicate space
        bank,  # .execute(plan) -> [K] probabilities, on the engine's device
        config: EngineConfig = EngineConfig(),
        truth_masks: Optional[torch.Tensor] = None,  # [Q, N] bool (metrics only)
        device=None,
    ):
        if config.function_selection == "best" and not query_set.all_conjunctive:
            raise NotImplementedError(
                "function_selection='best' requires an all-conjunctive query set"
            )
        if config.num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        self.device = resolve_device(device)
        self.query_set = query_set
        self.table = table.to(self.device)
        self.combine_params = combine_params.to(self.device)
        self.costs = torch.as_tensor(costs, dtype=torch.float32).to(self.device).contiguous()
        self.bank = bank
        self.config = config
        self.truth_masks = None if truth_masks is None else torch.as_tensor(truth_masks).to(
            self.device)
        self._session = None  # lazily built (num_objects, EngineSession)

    def _qs(self):
        """(pred_mask, unique_rows, unique_index) on the engine's device."""
        qs = self.query_set
        return (qs.pred_mask.to(self.device), qs.unique_rows.to(self.device),
                qs.unique_index.to(self.device))

    # ---- session facade ------------------------------------------------------

    def _session_for(self, num_objects: int):
        from repro_torch.core.session import EngineSession

        if self._session is None or self._session[0] != num_objects:
            self._session = (
                num_objects,
                EngineSession(
                    self.query_set.global_predicates,
                    self.table,
                    self.combine_params,
                    self.costs,
                    capacity=num_objects,
                    max_tenants=self.query_set.num_queries,
                    config=self.config,
                    truth_masks=self.truth_masks,
                    device=self.device,
                    bank=superstep_bank(self.bank),
                ),
            )
        return self._session[1]

    def _to_session_state(self, state: MultiQueryState) -> SessionState:
        """MultiQueryState -> SessionState at capacity == N, every slot
        active: the substrate passes through, the Q-broadcast derived leaves
        collapse to their shared [N, P] row, the query set's predicate masks
        become the slot masks."""
        q = self.query_set.num_queries
        n = state.substrate.num_objects
        dev = self.device
        outputs, quarantined = facade_bank_state(
            self.bank, (n, self.query_set.num_predicates, self.costs.shape[1]),
            self.config.prior, dev)
        return SessionState(
            substrate=state.substrate,
            derived=SessionDerived(
                pred_prob=state.per_query.pred_prob[0],
                uncertainty=state.per_query.uncertainty[0],
                joint_prob=state.per_query.joint_prob,
                in_answer=state.per_query.in_answer,
            ),
            bank_outputs=outputs,
            pred_mask=self._qs()[0],
            active=torch.ones((q,), dtype=torch.bool, device=dev),
            num_rows=torch.tensor(n, dtype=torch.int32, device=dev),
            ledger=ledger_lib.init_ledger(q, device=dev),
            quarantined=quarantined,
        )

    def _from_session_state(self, sst: SessionState) -> MultiQueryState:
        q = self.query_set.num_queries
        shape = (q,) + tuple(sst.derived.pred_prob.shape)
        return MultiQueryState(
            substrate=sst.substrate,
            per_query=PerQueryState(
                pred_prob=sst.derived.pred_prob[None].expand(shape),
                uncertainty=sst.derived.uncertainty[None].expand(shape),
                joint_prob=sst.derived.joint_prob,
                in_answer=sst.derived.in_answer,
            ),
        )

    @staticmethod
    def _stats_from_session(hist, collect_masks: bool) -> list:
        return [
            MultiEpochStats(
                epoch=h.epoch,
                cost_spent=h.cost_spent,
                epoch_cost=h.epoch_cost,
                requested_cost=h.requested_cost,
                expected_f=h.expected_f,
                answer_size=h.answer_size,
                true_f=h.true_f,
                plan_valid=h.plan_valid,
                merged_valid=h.merged_valid,
                wall_time_s=h.wall_time_s,
                answer_mask=h.answer_mask if collect_masks else None,
            )
            for h in hist
        ]

    # ---- derived-state maintenance (legacy per-epoch path) -------------------

    def _derive(self, substrate: SharedSubstrate):
        """Shared recombination + batched joint: ``pred_prob`` /
        ``uncertainty`` are query-independent, computed once and broadcast
        onto the Q axis; only the joint differs per query."""
        q = self.query_set.num_queries
        pred_prob = combine_probabilities(
            self.combine_params, substrate.func_probs, substrate.exec_mask,
            prior=self.config.prior,
        )  # [N, P]
        shape = (q,) + tuple(pred_prob.shape)
        pp_q = pred_prob[None].expand(shape)
        unc_q = binary_entropy(pred_prob)[None].expand(shape)
        return pp_q, unc_q, self.query_set.evaluate_batched(pp_q)

    def _select_answers(self, joint_prob: torch.Tensor) -> threshold_lib.AnswerSelection:
        """Theorem-1 selection once per DISTINCT query, fanned out to tenants."""
        _, rows, index = self._qs()
        joint_u = joint_prob[rows]
        if self.config.answer_mode == "approx":
            sels = [threshold_lib.select_answer_approx(j, self.config.alpha) for j in joint_u]
            sel_u = threshold_lib.AnswerSelection(*(torch.stack(x) for x in zip(*sels)))
        else:
            sel_u = threshold_lib.select_answer(joint_u, self.config.alpha)
        return threshold_lib.AnswerSelection(*(x[index] for x in sel_u))

    def _state_from(self, sub: SharedSubstrate) -> tuple[MultiQueryState, object]:
        pp, unc, joint = self._derive(sub)
        sel = self._select_answers(joint)
        per = PerQueryState(pred_prob=pp, uncertainty=unc, joint_prob=joint, in_answer=sel.mask)
        return MultiQueryState(substrate=sub, per_query=per), sel

    def init_state(self, num_objects: int) -> MultiQueryState:
        if self.config.num_shards > 1 and num_objects % self.config.num_shards:
            raise ValueError(
                f"num_objects={num_objects} must divide evenly over "
                f"num_shards={self.config.num_shards}"
            )
        sub = state_lib.init_substrate(
            num_objects, self.query_set.num_predicates, self.costs.shape[1],
            prior=self.config.prior, device=self.device,
        )
        return self._state_from(sub)[0]

    def warm_start(self, state: MultiQueryState, cached_probs, cached_mask) -> MultiQueryState:
        """Merge a pre-executed cache into the substrate (paper §6.1
        Initialization Step / §5 caching) and re-derive every query's state."""
        sub = state.substrate
        cached_mask = torch.as_tensor(cached_mask).to(self.device)
        cached_probs = torch.as_tensor(cached_probs).to(self.device)
        sub = SharedSubstrate(
            func_probs=torch.where(cached_mask, cached_probs, sub.func_probs),
            exec_mask=sub.exec_mask | cached_mask,
            cost_spent=sub.cost_spent,
        )
        return self._state_from(sub)[0]

    def admit(
        self,
        state: MultiQueryState,
        query: CompiledQuery,
        truth_mask: Optional[torch.Tensor] = None,
    ) -> MultiQueryState:
        """Admit a new tenant mid-flight, warm-started from the substrate
        (paper §5: its first answer set reflects every enrichment earlier
        tenants paid for).  Q grows by one."""
        self.query_set.check_admissible(query)
        if self.config.function_selection == "best" and not query.is_conjunctive:
            raise NotImplementedError(
                "function_selection='best' requires an all-conjunctive query set"
            )
        if (self.truth_masks is not None) != (truth_mask is not None):
            raise ValueError(
                "admit(): truth_mask must be provided iff the engine tracks "
                "truth_masks (construct the engine without them to opt out)"
            )
        rq = query_lib.reindex_query(query, self.query_set.global_predicates)
        sub = state.substrate
        fresh = state_lib.init_state(
            sub.num_objects, self.query_set.num_predicates, sub.num_functions,
            prior=self.config.prior, device=self.device,
        )
        warm = state_lib.with_cached_state(
            fresh, rq, self.combine_params, sub.func_probs, sub.exec_mask,
            prior=self.config.prior,
        )
        if self.config.answer_mode == "approx":
            sel = threshold_lib.select_answer_approx(warm.joint_prob, self.config.alpha)
        else:
            sel = threshold_lib.select_answer(warm.joint_prob, self.config.alpha)
        self.query_set = self.query_set.add(query)
        per = state.per_query
        new_per = PerQueryState(
            pred_prob=torch.cat([per.pred_prob, warm.pred_prob[None]]),
            uncertainty=torch.cat([per.uncertainty, warm.uncertainty[None]]),
            joint_prob=torch.cat([per.joint_prob, warm.joint_prob[None]]),
            in_answer=torch.cat([per.in_answer, sel.mask[None]]),
        )
        if self.truth_masks is not None:
            truth = torch.as_tensor(truth_mask).to(self.device)
            self.truth_masks = torch.cat([self.truth_masks, truth[None]])
        self._session = None  # the Q-shaped facade session is stale
        return MultiQueryState(substrate=sub, per_query=new_per)

    # ---- legacy per-epoch stages (general ASTs + per-epoch serving API) ------

    def _benefits_batched(self, state: MultiQueryState) -> TripleBenefits:
        """Eq. 11 with [Q, N, P] leaves over the global space.

        The decision table keys on the SHARED exec bitmask (a triple run for
        query A is "already run" for query B); columns outside a query's
        ``pred_mask`` earn -inf.  Conjunctive sets score through the fused
        kernels; general ASTs re-evaluate per query with one column
        substituted.
        """
        cfg = self.config
        sub, per = state.substrate, state.per_query
        n, p = sub.num_objects, sub.num_predicates
        state_id = sub.state_id()  # [N, P] shared
        pred_mask, rows, index = self._qs()
        if self.query_set.all_conjunctive:
            mode = (
                "best"
                if cfg.function_selection == "best" and self.table.delta_h_all is not None
                else "table"
            )
            benefit, nf, est_joint, cost = es_ops.fused_benefits_batched(
                per.pred_prob[0].contiguous(), per.uncertainty[0].contiguous(), state_id,
                per.joint_prob.contiguous(), self.table, self.costs, function_selection=mode,
            )
        else:
            pred_idx = torch.arange(p, device=self.device)[None, :].expand(n, p)
            nf, dh = self.table.lookup(pred_idx, state_id, per.uncertainty)  # [Q, N, P]
            _, p_hat = estimate_pred_prob_after(per.pred_prob, dh)
            est_joint = torch.stack([
                torch.stack([rq.evaluate_with_column(per.pred_prob[i], c, p_hat[i, :, c])
                             for c in range(p)], dim=-1)
                for i, rq in enumerate(self.query_set.reindexed)
            ])
            est_joint = torch.clamp(est_joint, 0.0, 1.0)
            cost = torch.clamp_min(self.costs[pred_idx, torch.clamp_min(nf, 0).long()], 1e-9)
            benefit = per.joint_prob[..., None] * est_joint / cost  # Eq. 11

        valid = (nf >= 0) & pred_mask[:, None, :]
        avail = getattr(self.bank, "available", None)
        if avail is not None:
            # ragged cascade bank: a missing (pred, level) pair carries a
            # sentinel cost, but benefit / cost is finite — mask it out
            pi = torch.arange(p, device=self.device)
            ok = torch.as_tensor(avail, dtype=torch.bool).to(self.device)
            valid = valid & ok[pi, torch.clamp_min(nf, 0).long()]
        benefit = torch.where(valid, benefit, NEG_INF)
        # candidate restriction per DISTINCT query, fanned back out by gather
        cand_u = candidate_mask(
            per.uncertainty[0], per.in_answer[rows], cfg.candidate_strategy,
            pred_mask=pred_mask[rows],
        )  # [U, N]
        benefit = restrict_benefits(benefit, cand_u[index], cfg.plan_size)
        return TripleBenefits(benefit=benefit, next_fn=nf, est_joint=est_joint, cost=cost)

    def _plan_epoch(self, state: MultiQueryState):
        """-> (per-query plans [Q, K], merged deduplicated plan [M])."""
        cfg = self.config
        plans = select_plans_batched(
            self._benefits_batched(state), cfg.plan_size, cfg.num_shards,
            self.query_set.num_predicates,
        )
        merged = plan_lib.merge_plans_dedup(
            plans, self.query_set.num_predicates, self.costs.shape[1],
            capacity=cfg.merged_capacity, cost_budget=cfg.epoch_cost_budget,
            num_objects=state.substrate.num_objects,
        )
        return plans, merged

    def _apply_and_select(self, state: MultiQueryState, merged: plan_lib.Plan, outputs):
        sub = state_lib.apply_outputs_to_substrate(
            state.substrate, merged.object_idx, merged.pred_idx, merged.func_idx,
            outputs, merged.cost, merged.valid,
        )
        return self._state_from(sub)

    # ---- public drivers ------------------------------------------------------

    def run_epoch(self, state: MultiQueryState):
        """One legacy epoch -> (state, sel, plans, merged, wall s, prev cost)."""
        t0 = time.perf_counter()
        plans, merged = self._plan_epoch(state)
        outputs = self.bank.execute(merged)
        prev_cost = float(state.substrate.cost_spent)
        state, sel = self._apply_and_select(state, merged, outputs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return state, sel, plans, merged, time.perf_counter() - t0, prev_cost

    def run_scan(
        self,
        num_objects: int,
        num_epochs: int,
        state: Optional[MultiQueryState] = None,
        stop_when_exhausted: bool = True,
        collect_masks: bool = False,
        chunk_size: Optional[int] = None,
    ) -> tuple[MultiQueryState, list]:
        """All epochs through the session superstep (stats cross to the host
        once).  Non-conjunctive query sets and banks that cannot run inside
        the superstep keep the per-epoch loop.  Post-exhaustion epochs are
        trimmed; ``wall_time_s`` is amortized."""
        if state is None:
            state = self.init_state(num_objects)
        if not self.query_set.all_conjunctive or not scan_capable(self.bank):
            return self._run_legacy_loop(state, num_epochs, stop_when_exhausted,
                                         collect_masks=collect_masks)
        session = self._session_for(num_objects)
        sst, hist = session.program.run_scan(
            self._to_session_state(state), num_epochs, collect_masks=collect_masks,
            stop_when_exhausted=stop_when_exhausted, chunk_size=chunk_size,
        )
        return self._from_session_state(sst), self._stats_from_session(hist, collect_masks)

    def _run_legacy_loop(
        self,
        state: MultiQueryState,
        num_epochs: int,
        stop_when_exhausted: bool,
        collect_masks: bool = False,
    ) -> tuple[MultiQueryState, list]:
        history: list[MultiEpochStats] = []
        for e in range(num_epochs):
            state, sel, plans, merged, wall, prev_cost = self.run_epoch(state)
            tf = None
            if self.truth_masks is not None:
                tf = [float(x) for x in
                      true_f_alpha(sel.mask, self.truth_masks, self.config.alpha).cpu()]
            merged_valid = int(merged.num_valid())
            cost = float(state.substrate.cost_spent)
            history.append(
                MultiEpochStats(
                    epoch=e,
                    cost_spent=cost,
                    epoch_cost=cost - prev_cost,
                    requested_cost=float(torch.where(plans.valid, plans.cost, 0.0).sum()),
                    expected_f=[float(x) for x in sel.expected_f.cpu()],
                    answer_size=[int(x) for x in sel.size.cpu()],
                    true_f=tf,
                    plan_valid=[int(x) for x in plans.num_valid().cpu()],
                    merged_valid=merged_valid,
                    wall_time_s=wall,
                    answer_mask=sel.mask.cpu().numpy() if collect_masks else None,
                )
            )
            if stop_when_exhausted and merged_valid == 0:
                break
        return state, history

    def run(
        self,
        num_objects: int,
        num_epochs: int,
        state: Optional[MultiQueryState] = None,
        stop_when_exhausted: bool = True,
        driver: Optional[str] = None,  # DEPRECATED: run() routes itself
        chunk_size: Optional[int] = None,
    ) -> tuple[MultiQueryState, list]:
        """Progressive evaluation for ``num_epochs`` epochs: the session
        superstep for all-conjunctive sets, the legacy per-epoch loop
        otherwise.  ``driver`` is a deprecated shim."""
        forced = resolve_deprecated_driver(driver)
        if forced == "loop" or not self.query_set.all_conjunctive:
            if state is None:
                state = self.init_state(num_objects)
            return self._run_legacy_loop(state, num_epochs, stop_when_exhausted)
        return self.run_scan(
            num_objects, num_epochs, state=state,
            stop_when_exhausted=stop_when_exhausted, chunk_size=chunk_size,
        )
