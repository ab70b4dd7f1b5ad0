"""The progressive integrated query operator (paper section 3).

Port of ``repro.core.operator``.  ``ProgressiveQueryOperator`` keeps the
paper-era API (``EnrichmentState`` in, ``EpochStats`` out) as a facade over
the session executor: a conjunctive query scored the default way is ONE
tenant slot of an ``EngineSession`` at ``capacity == N``, so ``run`` /
``run_scan`` convert the state at the boundary and run the session's
superstep (``core.executor.EpochProgram``).  The per-epoch legacy path
(``run_epoch``: ``_plan_epoch``, the bank, ``_apply_and_select``) serves
what the session's masked slots cannot express: non-conjunctive queries,
``benefit_mode="exact_slow"`` (the paper's §6.3.3 default strategy) and a
custom ``benefit_fn`` — ``kernels.enrich_score.ops.fused_benefits``, the
single-query scoring kernel, is the one the repo passes.

The operator runs on the card unless ``device="cpu"`` is passed; without a
GPU and without an explicit ``"cpu"`` it raises.  The bank must live on the
operator's device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.core import benefit as benefit_lib
from repro_torch.core import ledger as ledger_lib
from repro_torch.core import plan as plan_lib
from repro_torch.core import state as state_lib
from repro_torch.core import threshold as threshold_lib
from repro_torch.core.benefit import candidate_mask, restrict_benefits
from repro_torch.core.combine import CombineParams
from repro_torch.core.decision_table import DecisionTable
from repro_torch.core.executor import (
    EngineConfig,
    SessionDerived,
    SessionState,
    facade_bank_state,
    resolve_deprecated_driver,
    scan_capable,
    superstep_bank,
)
from repro_torch.core.metrics import true_f_alpha
from repro_torch.core.query import CompiledQuery
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class OperatorConfig:
    plan_size: int = 256
    epoch_cost_budget: Optional[float] = None  # None: plan_size alone bounds epochs
    alpha: float = 1.0
    answer_mode: str = "exact"  # "exact" | "approx"  (threshold selection)
    candidate_strategy: str = "auto"  # "outside_answer" (§4.1) | "all" | "auto"
    # Read nowhere, as in the reference: the kernel route is benefit_fn=
    # kernels.enrich_score.ops.fused_benefits.
    use_fused_kernel: bool = False
    benefit_mode: str = "fast"  # "fast" (Eq. 11) | "exact_slow" (§6.3.3 default)
    function_selection: str = "table"  # "table" (paper) | "best" (beyond-paper)
    prior: float = 0.5
    chunk_size: Optional[int] = None  # epochs per dispatched chunk (see executor)


@dataclasses.dataclass
class EpochStats:
    epoch: int
    cost_spent: float
    expected_f: float
    answer_size: int
    true_f1: Optional[float]
    plan_cost: float
    plan_valid: int
    wall_time_s: float


class ProgressiveQueryOperator:
    """Drives progressive evaluation of one query over one object corpus."""

    def __init__(
        self,
        query: CompiledQuery,
        table: DecisionTable,
        combine_params: CombineParams,
        costs,  # [P, F]
        bank,  # .execute(plan) -> [K] probabilities, on the operator's device
        config: OperatorConfig = OperatorConfig(),
        truth_mask: Optional[torch.Tensor] = None,  # [N] bool ground truth (metrics only)
        benefit_fn: Optional[Callable] = None,  # scoring override (e.g. ops.fused_benefits)
        device=None,
    ):
        self.device = resolve_device(device)
        self.query = query
        self.table = table.to(self.device)
        self.combine_params = combine_params.to(self.device)
        self.costs = torch.as_tensor(costs, dtype=torch.float32).to(self.device).contiguous()
        self.bank = bank
        self.config = config
        self.truth_mask = None if truth_mask is None else torch.as_tensor(truth_mask).to(
            self.device)
        self._benefit_fn = benefit_fn
        self._session = None  # lazily built (num_objects, EngineSession)

    # ---- session facade ------------------------------------------------------

    @property
    def _legacy_only(self) -> bool:
        """Query shapes the session's data-masked slots cannot express."""
        return (
            self._benefit_fn is not None
            or self.config.benefit_mode == "exact_slow"
            or not self.query.is_conjunctive
        )

    def _engine_config(self) -> EngineConfig:
        cfg = self.config
        return EngineConfig(
            plan_size=cfg.plan_size,
            epoch_cost_budget=cfg.epoch_cost_budget,
            alpha=cfg.alpha,
            answer_mode=cfg.answer_mode,
            candidate_strategy=cfg.candidate_strategy,
            function_selection=cfg.function_selection,
            prior=cfg.prior,
            chunk_size=cfg.chunk_size,
        )

    def _session_for(self, num_objects: int):
        from repro_torch.core.session import EngineSession

        if self._session is None or self._session[0] != num_objects:
            self._session = (
                num_objects,
                EngineSession(
                    self.query.predicates,
                    self.table,
                    self.combine_params,
                    self.costs,
                    capacity=num_objects,
                    max_tenants=1,
                    config=self._engine_config(),
                    truth_masks=None if self.truth_mask is None else self.truth_mask[None],
                    device=self.device,
                    bank=superstep_bank(self.bank),
                ),
            )
        return self._session[1]

    def _to_session_state(self, st: state_lib.EnrichmentState) -> SessionState:
        """EnrichmentState -> one-tenant SessionState (a re-labelling:
        capacity == N, the single slot covers every predicate column)."""
        n, p = st.pred_prob.shape
        dev = st.device
        outputs, quarantined = facade_bank_state(
            self.bank, (n, p, self.costs.shape[1]), self.config.prior, dev)
        return SessionState(
            substrate=st.substrate,
            derived=SessionDerived(
                pred_prob=st.pred_prob,
                uncertainty=st.uncertainty,
                joint_prob=st.joint_prob[None],
                in_answer=st.in_answer[None],
            ),
            bank_outputs=outputs,
            pred_mask=torch.ones((1, p), dtype=torch.bool, device=dev),
            active=torch.ones((1,), dtype=torch.bool, device=dev),
            num_rows=torch.tensor(n, dtype=torch.int32, device=dev),
            ledger=ledger_lib.init_ledger(1, device=dev),
            quarantined=quarantined,
        )

    @staticmethod
    def _from_session_state(sst: SessionState) -> state_lib.EnrichmentState:
        sub = sst.substrate
        return state_lib.EnrichmentState(
            func_probs=sub.func_probs,
            exec_mask=sub.exec_mask,
            pred_prob=sst.derived.pred_prob,
            uncertainty=sst.derived.uncertainty,
            joint_prob=sst.derived.joint_prob[0],
            in_answer=sst.derived.in_answer[0],
            cost_spent=sub.cost_spent,
        )

    @staticmethod
    def _stats_from_session(hist) -> list:
        """One-slot session stats -> the operator's scalar EpochStats
        (``plan_cost`` / ``plan_valid`` are the charge and the merged lanes:
        for one tenant every planned triple is new)."""
        return [
            EpochStats(
                epoch=h.epoch,
                cost_spent=h.cost_spent,
                expected_f=h.expected_f[0],
                answer_size=h.answer_size[0],
                true_f1=None if h.true_f is None else h.true_f[0],
                plan_cost=h.epoch_cost,
                plan_valid=h.merged_valid,
                wall_time_s=h.wall_time_s,
            )
            for h in hist
        ]

    # ---- legacy per-epoch stages (general ASTs / exact_slow / benefit_fn) ----

    def _select_answer(self, joint_prob: torch.Tensor) -> threshold_lib.AnswerSelection:
        if self.config.answer_mode == "approx":
            return threshold_lib.select_answer_approx(joint_prob, self.config.alpha)
        return threshold_lib.select_answer(joint_prob, self.config.alpha)

    def _plan_epoch(self, state: state_lib.EnrichmentState) -> plan_lib.Plan:
        cfg = self.config
        every = torch.ones((state.num_objects,), dtype=torch.bool, device=state.device)
        if self._benefit_fn is not None:
            benefits = self._benefit_fn(
                state, self.query, self.table, self.costs, candidate_mask=every
            )
        elif cfg.benefit_mode == "exact_slow":
            benefits = benefit_lib.benefit_exact_slow(
                state, self.query, self.table, self.costs, cfg.alpha, every
            )
        else:
            benefits = benefit_lib.compute_benefits(
                state, self.query, self.table, self.costs, every,
                function_selection=cfg.function_selection,
            )
        avail = getattr(self.bank, "available", None)
        if avail is not None:
            # ragged cascade bank: a missing (pred, level) pair carries a
            # sentinel cost, but benefit / cost stays finite — mask it out
            pi = torch.arange(benefits.next_fn.shape[-1], device=state.device)
            ok = torch.as_tensor(avail, dtype=torch.bool).to(state.device)[
                pi, torch.clamp_min(benefits.next_fn, 0).long()]
            benefits = benefits._replace(
                benefit=torch.where(ok, benefits.benefit, benefit_lib.NEG_INF)
            )
        cand = candidate_mask(state.uncertainty, state.in_answer, cfg.candidate_strategy)
        benefits = benefits._replace(
            benefit=restrict_benefits(benefits.benefit, cand, cfg.plan_size)
        )
        return plan_lib.select_plan(benefits, cfg.plan_size, cfg.epoch_cost_budget)

    def _apply_and_select(
        self,
        state: state_lib.EnrichmentState,
        plan: plan_lib.Plan,
        outputs: torch.Tensor,  # [K] raw probabilities from the bank
    ):
        state = state_lib.apply_function_outputs(
            state, self.query, self.combine_params,
            plan.object_idx, plan.pred_idx, plan.func_idx, outputs, plan.cost, plan.valid,
        )
        sel = self._select_answer(state.joint_prob)
        return dataclasses.replace(state, in_answer=sel.mask), sel

    # ---- public driver ------------------------------------------------------

    def init_state(self, num_objects: int) -> state_lib.EnrichmentState:
        st = state_lib.init_state(
            num_objects, self.query.num_predicates, self.costs.shape[1],
            prior=self.config.prior, device=self.device,
        )
        return state_lib.refresh_derived(st, self.query, self.combine_params,
                                         prior=self.config.prior)

    def warm_start(self, state, cached_probs, cached_mask):
        """Apply a previous query's cache (paper section 5 / Fig. 11)."""
        st = state_lib.with_cached_state(
            state, self.query, self.combine_params,
            torch.as_tensor(cached_probs).to(state.device),
            torch.as_tensor(cached_mask).to(state.device),
            prior=self.config.prior,
        )
        return dataclasses.replace(st, in_answer=self._select_answer(st.joint_prob).mask)

    def run_epoch(self, state: state_lib.EnrichmentState):
        """One legacy epoch -> (state, selection, plan, wall seconds)."""
        t0 = time.perf_counter()
        plan = self._plan_epoch(state)
        outputs = self.bank.execute(plan)
        state, sel = self._apply_and_select(state, plan, outputs)
        if state.device.type == "cuda":
            torch.cuda.synchronize(state.device)
        return state, sel, plan, time.perf_counter() - t0

    def run_scan(
        self,
        num_objects: int,
        num_epochs: int,
        state: Optional[state_lib.EnrichmentState] = None,
        stop_when_exhausted: bool = True,
        chunk_size: Optional[int] = None,
    ) -> tuple[state_lib.EnrichmentState, list[EpochStats]]:
        """All epochs through the session superstep (one tenant at capacity
        == N, stats cross to the host once).  Query shapes outside the
        session's scope (general ASTs, exact_slow, a custom benefit_fn) and
        banks that cannot run inside the superstep keep the per-epoch loop.
        Post-exhaustion epochs are trimmed; ``wall_time_s`` is amortized."""
        if state is None:
            state = self.init_state(num_objects)
        if self._legacy_only or not scan_capable(self.bank):
            return self._run_legacy_loop(state, num_epochs, stop_when_exhausted)
        session = self._session_for(num_objects)
        sst, hist = session.program.run_scan(
            self._to_session_state(state),
            num_epochs,
            stop_when_exhausted=stop_when_exhausted,
            chunk_size=chunk_size,
        )
        return self._from_session_state(sst), self._stats_from_session(hist)

    def _run_legacy_loop(
        self, state, num_epochs: int, stop_when_exhausted: bool
    ) -> tuple[state_lib.EnrichmentState, list[EpochStats]]:
        history: list[EpochStats] = []
        for e in range(num_epochs):
            state, sel, plan, wall = self.run_epoch(state)
            tf1 = None
            if self.truth_mask is not None:
                tf1 = float(true_f_alpha(sel.mask, self.truth_mask, self.config.alpha))
            n_valid = int(plan.num_valid())
            history.append(
                EpochStats(
                    epoch=e,
                    cost_spent=float(state.cost_spent),
                    expected_f=float(sel.expected_f),
                    answer_size=int(sel.size),
                    true_f1=tf1,
                    plan_cost=float(plan.total_cost()),
                    plan_valid=n_valid,
                    wall_time_s=wall,
                )
            )
            if stop_when_exhausted and n_valid == 0:
                break
        return state, history

    def run(
        self,
        num_objects: int,
        num_epochs: int,
        state: Optional[state_lib.EnrichmentState] = None,
        stop_when_exhausted: bool = True,
        driver: Optional[str] = None,  # DEPRECATED: run() routes itself
        chunk_size: Optional[int] = None,
    ) -> tuple[state_lib.EnrichmentState, list[EpochStats]]:
        """Progressive evaluation for ``num_epochs`` epochs: the session
        superstep whenever the facade can serve the query (conjunctive,
        default scoring), the legacy per-epoch loop otherwise.  ``driver``
        is a deprecated shim."""
        forced = resolve_deprecated_driver(driver)
        if forced == "loop" or self._legacy_only:
            if state is None:
                state = self.init_state(num_objects)
            return self._run_legacy_loop(state, num_epochs, stop_when_exhausted)
        return self.run_scan(
            num_objects, num_epochs, state=state,
            stop_when_exhausted=stop_when_exhausted, chunk_size=chunk_size,
        )
