"""The epoch executor: ONE superstep for the session main path.

Port of ``repro.core.executor``.  ``EpochProgram`` owns the fused
plan -> execute -> apply superstep over the session-shaped state
(capacity-padded substrate, tenant slots, ledger, optionally sharded plan
merge) and its chunked driver:

1. derive ``pred_prob``, entropy and the per-slot joint (``_derive``);
2. Eq. 11 scoring through ``kernels.enrich_score`` — the CUDA kernels when
   the state lives on the card, their plain PyTorch twins on the CPU;
3. per-slot top-k plans (``select_plans_batched``);
4. cross-tenant dedup with want-bits;
5. the bank boundary: gather from the capacity-padded bank buffer, or run
   an attached bank's ``execute`` (the model-cascade bank) on the merged
   plan;
6. write-once charge and apply;
7. ledger attribution;
8. Theorem-1 answer selection.

A state placed on a device mesh (``durability.shard_session_state``) runs
the same superstep as a per-rank program over its own rows
(``core.shard_program``): each method takes the state's layout, which is
``OneDevice`` for a plain state, and every read across rows goes through
it.  ``program_runs`` counts the chunks each program ran.

``lax.scan`` becomes a per-chunk Python loop.  The superstep makes no host
sync (no ``.item()``, no boolean-mask indexing, no ``nonzero``): its stats
stay on the device and cross to the host once per run.  ``superstep_traces``
counts the per-(capacity, chunk length, collect_masks) programs built — the
reference's bounded-recompile witness, and the unit a later CUDA-graph
capture would key on.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch.core import benefit as benefit_lib
from repro_torch.core import ledger as ledger_lib
from repro_torch.core import plan as plan_lib
from repro_torch.core import shard_program
from repro_torch.core import state as state_lib
from repro_torch.core import threshold as threshold_lib
from repro_torch.core.benefit import NEG_INF, TripleBenefits
from repro_torch.core.combine import CombineParams, combine_probabilities
from repro_torch.core.decision_table import DecisionTable
from repro_torch.core.entropy import binary_entropy
from repro_torch.core.ledger import CostLedger
from repro_torch.core.metrics import true_f_alpha
from repro_torch.core.state import SharedSubstrate
from repro_torch.kernels.enrich_score import ops as es_ops


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine configuration (the reference's, minus its backend knobs: the
    port routes scoring by the state's device)."""

    plan_size: int = 256  # per-query plan capacity
    merged_capacity: Optional[int] = None  # None: Q * plan_size (lossless merge)
    epoch_cost_budget: Optional[float] = None  # applied to the merged plan
    alpha: float = 1.0
    answer_mode: str = "exact"  # "exact" | "approx"
    candidate_strategy: str = "auto"  # "outside_answer" | "all" | "auto"
    function_selection: str = "table"  # "table" (paper) | "best" (beyond-paper)
    prior: float = 0.5
    # >1: plan selection runs over this many object shards (per-shard top-k +
    # exact cross-shard merge), identical to the unsharded path
    num_shards: int = 1
    # epochs per dispatched chunk (None: the whole run in one chunk)
    chunk_size: Optional[int] = None
    # storage dtype of func_probs / bank_outputs / derived state; arithmetic
    # is f32 regardless, cost_spent and the ledger are always f32
    substrate_dtype: str = "float32"


_SUBSTRATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_substrate_dtype(name: str) -> torch.dtype:
    """Map ``EngineConfig.substrate_dtype`` to a torch dtype (typed rejection)."""
    try:
        return _SUBSTRATE_DTYPES[name]
    except KeyError:
        raise ValueError(
            f"substrate_dtype must be one of {sorted(_SUBSTRATE_DTYPES)}, got {name!r}"
        ) from None


def scan_capable(bank) -> bool:
    """Can this bank's ``execute`` run inside the superstep?"""
    return bool(getattr(bank, "supports_scan", False))


def superstep_bank(bank):
    """The bank a facade's session runs inside its superstep: a traceable
    bank with no precomputed ``.outputs`` buffer (the model-cascade bank);
    None when outputs are gathered from the state's buffer."""
    return bank if scan_capable(bank) and not hasattr(bank, "outputs") else None


def facade_bank_state(bank, shape, prior: float, device):
    """(bank_outputs, quarantined) of a facade's session state: the bank's
    ``outputs`` [N, P, F] (or a prior-filled buffer that is never gathered
    when the bank runs inside the superstep), and a ragged bank's missing
    levels as the [P, F] quarantine (None for a full bank)."""
    if hasattr(bank, "outputs"):
        outputs = bank.outputs.to(torch.float32)
    else:
        outputs = torch.full(shape, prior, dtype=torch.float32, device=device)
    avail = getattr(bank, "available", None)
    quarantined = None if avail is None else ~torch.as_tensor(avail, dtype=torch.bool).to(device)
    return outputs, quarantined


def resolve_deprecated_driver(driver: Optional[str]) -> Optional[str]:
    """The facades' old ``run(driver=...)`` kwarg, kept as a warning shim.

    ``run()`` routes by bank and query shape in one place; passing
    ``driver`` is deprecated.  Returns "scan" | "loop" | None (auto) or
    raises on unknown values.
    """
    if driver is None:
        return None
    warnings.warn(
        "run(driver=...) is deprecated: run() routes to the session superstep "
        "when the bank and query allow it and to the per-epoch loop otherwise; "
        "call run_scan() directly for an explicit superstep run",
        DeprecationWarning,
        stacklevel=3,
    )
    if driver == "auto":
        return None
    if driver in ("scan", "loop"):
        return driver
    raise ValueError(f"unknown driver: {driver!r}")


def select_plans_batched(
    benefits: TripleBenefits,  # [Q, N, P] leaves
    plan_size: int,
    num_shards: int,
    num_predicates: int,
) -> plan_lib.Plan:
    """Per-query plan selection, optionally sharded over the object axis.

    With ``num_shards=S`` every shard top-ks its own [N/S, P] slice, then
    the survivors reduce through the exact cross-shard merge, identical to
    the unsharded top-k on every valid lane.
    """
    if num_shards <= 1:
        return plan_lib.select_plan(benefits, plan_size)
    s = num_shards
    q, n, p = benefits.benefit.shape
    per_shard = n // s
    local = TripleBenefits(*(x.reshape(q, s, per_shard, p) for x in benefits))
    plans = plan_lib.select_plan(local, plan_size)  # [Q, S, K]
    offsets = torch.arange(s, device=benefits.benefit.device)[None, :, None] * per_shard
    plans = plans._replace(object_idx=plans.object_idx + offsets)
    merged = [
        plan_lib.merge_sharded_plans_exact(plans.map(lambda x: x[i]), plan_size, num_predicates)
        for i in range(q)
    ]
    return plan_lib.Plan(*(torch.stack(leaves) for leaves in zip(*merged)))


# --------------------------------------------------------- session state --


@dataclasses.dataclass
class SessionDerived:
    """Derived state with the slot-independent half stored ONCE."""

    pred_prob: torch.Tensor  # [C, P] substrate dtype, shared across slots
    uncertainty: torch.Tensor  # [C, P] substrate dtype, shared across slots
    joint_prob: torch.Tensor  # [S, C] substrate dtype
    in_answer: torch.Tensor  # [S, C] bool


@dataclasses.dataclass
class SessionState:
    """Everything churn can touch, as fixed-shape tensors (the loop carry)."""

    substrate: SharedSubstrate  # [C, P, F] capacity-padded
    derived: SessionDerived
    bank_outputs: torch.Tensor  # [C, P, F] capacity-padded tagging outputs
    pred_mask: torch.Tensor  # [S, P] bool: slot s's conjunctive predicate columns
    active: torch.Tensor  # [S] bool: slot occupancy
    num_rows: torch.Tensor  # [] int32: rows [0, num_rows) hold real objects
    ledger: CostLedger  # [S] per-tenant attributed cost
    quarantined: Optional[torch.Tensor] = None  # [P, F] bool

    @property
    def capacity(self) -> int:
        return self.substrate.num_objects

    @property
    def num_slots(self) -> int:
        return self.pred_mask.shape[0]

    @property
    def cost_spent(self) -> torch.Tensor:
        return self.substrate.cost_spent

    @property
    def device(self) -> torch.device:
        return self.substrate.func_probs.device

    def row_valid(self) -> torch.Tensor:
        return state_lib.row_validity(self.capacity, self.num_rows)


@dataclasses.dataclass
class SessionEpochStats:
    epoch: int
    cost_spent: float  # cumulative substrate spend
    epoch_cost: float  # newly charged this epoch (post-dedup)
    requested_cost: float  # sum of per-slot plan costs before dedup
    expected_f: list  # [S] per-slot E(F_alpha) (inactive slots: 0)
    answer_size: list  # [S]
    plan_valid: list  # [S]
    merged_valid: int
    active: list  # [S] bool snapshot
    num_rows: int
    attributed: list  # [S] cumulative ledger attribution snapshot
    wall_time_s: float
    answer_mask: Optional[np.ndarray] = None  # [S, C] when collect_masks
    true_f: Optional[list] = None  # [S] when the program carries truth_masks

    @property
    def active_tenants(self) -> int:
        return int(sum(self.active))

    @property
    def mean_expected_f(self) -> float:
        """Mean E(F) over ACTIVE slots (0 when the session idles)."""
        vals = [f for f, a in zip(self.expected_f, self.active) if a]
        return sum(vals) / len(vals) if vals else 0.0


# ----------------------------------------------------------- the program --


class EpochProgram:
    """The fused plan -> execute -> apply superstep and its chunked driver.

    Shapes are read off the state, never off ``self``, so one program serves
    every capacity tier of a growing session.
    """

    def __init__(
        self,
        table: DecisionTable,
        combine_params: CombineParams,
        costs: torch.Tensor,
        config: EngineConfig,
        truth_masks: Optional[torch.Tensor] = None,  # [S, C] bool (metrics only)
        bank=None,  # bank whose execute runs INSIDE the superstep
    ):
        self.table = table
        self.combine_params = combine_params
        self.costs = costs
        self.config = config
        self.truth_masks = truth_masks
        # With a bank attached the superstep calls ``bank.execute(merged)``;
        # without one, outputs gather from the state's ``bank_outputs``.
        if bank is not None and not scan_capable(bank):
            raise ValueError(
                "EpochProgram(bank=...) requires a bank with supports_scan == True "
                "(a fixed-shape execute over the merged plan)"
            )
        self.bank = bank
        self._programs: set = set()  # (capacity, length, collect_masks) built
        # chunks dispatched by program: one device, replicated on a mesh, per rank
        self.program_runs = dict.fromkeys(("device", "replicated", "per_rank"), 0)

    @property
    def num_predicates(self) -> int:
        return self.costs.shape[0]

    @property
    def num_functions(self) -> int:
        return self.costs.shape[1]

    @property
    def superstep_traces(self) -> int:
        """How many chunk programs (capacity, length, collect_masks) were built."""
        return len(self._programs)

    # ---- derived-state maintenance ----------------------------------------

    def _derive(self, substrate, pred_mask, active, row_valid):
        """Shared recombination + per-slot masked-conjunction joint (f32 math,
        stored at the substrate dtype; zero on invalid rows / inactive slots)."""
        store_dt = substrate.func_probs.dtype
        pred32 = combine_probabilities(
            self.combine_params,
            substrate.func_probs.to(torch.float32),
            substrate.exec_mask,
            prior=self.config.prior,
        )  # [C, P]
        terms = torch.where(pred_mask[:, None, :], pred32[None], 1.0)  # [S, C, P]
        joint32 = terms[..., 0]
        for i in range(1, terms.shape[-1]):
            joint32 = joint32 * terms[..., i]
        joint32 = torch.where(active[:, None] & row_valid[None, :], joint32, 0.0)
        return (
            pred32.to(store_dt),
            binary_entropy(pred32).to(store_dt),
            joint32.to(store_dt),
        )

    def _select_answers(self, joint_prob: torch.Tensor) -> threshold_lib.AnswerSelection:
        joint_prob = joint_prob.to(torch.float32)
        if self.config.answer_mode == "approx":
            sels = [
                threshold_lib.select_answer_approx(j, self.config.alpha) for j in joint_prob
            ]
            return threshold_lib.AnswerSelection(*(torch.stack(x) for x in zip(*sels)))
        return threshold_lib.select_answer(joint_prob, self.config.alpha)

    def _answers(self, joint: torch.Tensor, state: SessionState, rows):
        """Theorem-1 selection over the whole [S, C] joint -> (selection,
        the [S, C] answer mask: active slots, valid rows)."""
        sel = self._select_answers(rows.gather(joint))
        mask = sel.mask & state.active[:, None] & rows.all_valid(state.num_rows)[None, :]
        return sel, mask

    def refresh(self, state: SessionState) -> SessionState:
        """Recompute all derived state from the substrate + masks (the warm
        start of every churn event)."""
        rows, state = shard_program.local_view(state)
        return rows.place(self.refresh_rows(state, rows))

    def refresh_rows(self, state: SessionState, rows) -> SessionState:
        """``refresh`` of a state on ``rows``' rows (``local_view``)."""
        pp, unc, joint = self._derive(
            state.substrate, state.pred_mask, state.active, rows.valid(state.num_rows))
        _, mask = self._answers(joint, state, rows)
        derived = SessionDerived(pred_prob=pp, uncertainty=unc, joint_prob=joint,
                                 in_answer=rows.local(mask))
        return dataclasses.replace(state, derived=derived)

    # ---- scoring + planning ------------------------------------------------

    def _benefits(self, state: SessionState, row_valid: torch.Tensor, rows) -> TripleBenefits:
        """Masked Eq. 11 over [S, C, P]: inactive slots and invalid rows get
        -inf, so they never win top-k."""
        cfg = self.config
        der = state.derived
        state_id = state.substrate.state_id()  # [C, P]
        if state.quarantined is not None:
            # quarantined functions look "already executed" to the table
            state_id = state_id | state_lib.pack_function_bits(state.quarantined)[None, :]
        mode = (
            "best"
            if cfg.function_selection == "best" and self.table.delta_h_all is not None
            else "table"
        )
        benefit, nf, est_joint, cost = es_ops.fused_benefits_batched(
            der.pred_prob, der.uncertainty, state_id, der.joint_prob,
            self.table, self.costs, function_selection=mode,
        )
        valid = (
            (nf >= 0)
            & state.pred_mask[:, None, :]
            & state.active[:, None, None]
            & row_valid[None, :, None]
        )
        benefit = torch.where(valid, benefit, NEG_INF)
        cand = benefit_lib.candidate_mask(
            der.uncertainty.to(torch.float32), der.in_answer, cfg.candidate_strategy,
            pred_mask=state.pred_mask, row_valid=row_valid, gather=rows.gather,
        )  # [S, C]
        benefit = benefit_lib.restrict_benefits(benefit, cand, cfg.plan_size, reduce=rows.sum)
        return TripleBenefits(benefit=benefit, next_fn=nf, est_joint=est_joint, cost=cost)

    def _plan_part(self, state: SessionState, rows=None):
        """The superstep up to the bank boundary: score, select, dedup-merge."""
        cfg = self.config
        if rows is None:
            rows = shard_program.OneDevice(state.capacity)
        benefits = self._benefits(state, rows.valid(state.num_rows), rows)
        if rows.per_rank:
            plans = rows.select_plans(benefits, cfg.plan_size, cfg.num_shards,
                                      self.num_predicates)
        else:
            plans = select_plans_batched(
                benefits, cfg.plan_size, cfg.num_shards, self.num_predicates
            )
        merged, want_bits = plan_lib.merge_plans_dedup_wants(
            plans,
            self.num_predicates,
            self.num_functions,
            num_slots=state.num_slots,
            capacity=cfg.merged_capacity,
            cost_budget=cfg.epoch_cost_budget,
            num_objects=rows.capacity,
        )
        if state.quarantined is not None:
            merged = plan_lib.quarantine_filter(merged, state.quarantined)
        return plans, merged, want_bits

    def _gather_outputs(self, state: SessionState, merged: plan_lib.Plan, rows) -> torch.Tensor:
        """The bank boundary.  An attached bank executes the merged plan and
        its f32 probabilities are quantised to the substrate dtype HERE, the
        boundary ``ingest`` quantises at.  Otherwise outputs gather from the
        capacity-padded buffer (invalid lanes, and on a mesh the lanes of
        other ranks' rows, read row 0 and stay inert)."""
        if self.bank is not None:
            return self.bank.execute(merged).to(state.substrate.func_probs.dtype)
        obj, _ = rows.localize(plan_lib.gather_object_idx(merged, rows.capacity), merged.valid)
        return state.bank_outputs[obj, merged.pred_idx, torch.clamp_min(merged.func_idx, 0)]

    def _apply_part(self, state, plans, merged, want_bits, outputs, rows):
        """Charge, apply, attribute, re-derive, select -> (state, stats)."""
        row_valid = rows.valid(state.num_rows)
        obj, mine = rows.localize(merged.object_idx, merged.valid)
        chargeable = rows.any_rank(state_lib.chargeable_mask(
            state.substrate, obj, merged.pred_idx, merged.func_idx, mine
        ))
        prev_cost = state.substrate.cost_spent
        sub = state_lib.apply_outputs_to_substrate(
            state.substrate, obj, merged.pred_idx, merged.func_idx,
            outputs, merged.cost, mine, chargeable=chargeable,
        )
        ledger = ledger_lib.attribute_epoch(state.ledger, merged, want_bits, chargeable)
        pp, unc, joint = self._derive(sub, state.pred_mask, state.active, row_valid)
        sel, mask = self._answers(joint, state, rows)
        new_state = dataclasses.replace(
            state,
            substrate=sub,
            derived=SessionDerived(pred_prob=pp, uncertainty=unc, joint_prob=joint,
                                   in_answer=rows.local(mask)),
            ledger=ledger,
        )
        stats = dict(
            cost_spent=sub.cost_spent,
            epoch_cost=sub.cost_spent - prev_cost,
            requested_cost=torch.where(plans.valid, plans.cost, 0.0).sum(),
            expected_f=torch.where(state.active, sel.expected_f, 0.0),
            answer_size=mask.sum(1),
            plan_valid=plans.valid.sum(1),
            merged_valid=merged.num_valid(),
            active=state.active,
            num_rows=state.num_rows,
            attributed=ledger.attributed,
            answer_mask=mask,
        )
        if self.truth_masks is not None:
            stats["true_f"] = true_f_alpha(mask, self.truth_masks, self.config.alpha)
        return new_state, stats

    def _superstep(self, state: SessionState, rows, collect_masks: bool):
        plans, merged, want_bits = self._plan_part(state, rows)
        outputs = self._gather_outputs(state, merged, rows)
        new_state, stats = self._apply_part(state, plans, merged, want_bits, outputs, rows)
        if not collect_masks:
            del stats["answer_mask"]
        return new_state, stats

    def superstep(self, state: SessionState, collect_masks: bool = False):
        """One plan -> execute -> apply -> attribute epoch (no host sync)."""
        rows, state = shard_program.local_view(state)
        state, stats = self._superstep(state, rows, collect_masks)
        return rows.place(state), stats

    # ---- drivers -----------------------------------------------------------

    @staticmethod
    def chunk_lengths(num_epochs: int, chunk_size: Optional[int]) -> list:
        """Split a run into dispatch chunks (last chunk takes the rest)."""
        if num_epochs < 0:
            raise ValueError(f"num_epochs must be >= 0, got {num_epochs}")
        if chunk_size is not None and chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        if not num_epochs:
            return []
        if chunk_size is None or chunk_size >= num_epochs:
            return [num_epochs]
        k, r = divmod(num_epochs, chunk_size)
        return [chunk_size] * k + ([r] if r else [])

    def dispatch_scan(self, state: SessionState, length: int, collect_masks: bool):
        """Enqueue ONE chunk of ``length`` supersteps without a host sync ->
        (state, stats with a leading [length] axis, on the device)."""
        rows, state = shard_program.local_view(state)
        self._programs.add((rows.capacity, length, collect_masks))
        self.program_runs[rows.kind] += 1
        steps = []
        for _ in range(length):
            state, stats = self._superstep(state, rows, collect_masks)
            steps.append(stats)
        return rows.place(state), {k: torch.stack([s[k] for s in steps]) for k in steps[0]}

    def run_scan(
        self,
        state: SessionState,
        num_epochs: int,
        chunk_size: Optional[int] = None,
        collect_masks: bool = False,
        stop_when_exhausted: bool = True,
        on_chunk=None,
    ):
        """Run ``num_epochs`` supersteps as chunked dispatches.

        Chunked runs are identical to monolithic ones (the carry crosses
        chunk boundaries untouched).  ``on_chunk(carry, epochs_dispatched)``
        fires after each chunk; returning truthy stops dispatching further
        chunks.  Stats cross to the host once, after the last chunk.
        """
        if chunk_size is None:
            chunk_size = self.config.chunk_size
        t0 = time.perf_counter()
        chunks = []
        dispatched = 0
        for length in self.chunk_lengths(num_epochs, chunk_size):
            state, stats = self.dispatch_scan(state, length, collect_masks)
            chunks.append((length, stats))
            dispatched += length
            if on_chunk is not None and on_chunk(state, dispatched):
                break
        hosts = [(length, {k: v.cpu().numpy() for k, v in s.items()}) for length, s in chunks]
        if state.device.type == "cuda":
            torch.cuda.synchronize(state.device)
        wall = time.perf_counter() - t0
        history = self.materialize_history(
            hosts,
            wall_per_epoch=wall / max(dispatched, 1),
            collect_masks=collect_masks,
            stop_when_exhausted=stop_when_exhausted,
        )
        return state, history

    @staticmethod
    def materialize_history(
        hosts,  # [(chunk_len, host_stats_dict)] with leading [L] on leaves
        wall_per_epoch: float,
        collect_masks: bool,
        stop_when_exhausted: bool,
        epoch_base: int = 0,
    ) -> list:
        """Build ``SessionEpochStats`` from chunked host-side stats, trimming
        post-exhaustion no-op epochs."""
        history: list[SessionEpochStats] = []
        e = epoch_base
        for length, stats in hosts:
            for i in range(length):
                merged_valid = int(stats["merged_valid"][i])
                history.append(
                    SessionEpochStats(
                        epoch=e,
                        cost_spent=float(stats["cost_spent"][i]),
                        epoch_cost=float(stats["epoch_cost"][i]),
                        requested_cost=float(stats["requested_cost"][i]),
                        expected_f=[float(x) for x in stats["expected_f"][i]],
                        answer_size=[int(x) for x in stats["answer_size"][i]],
                        plan_valid=[int(x) for x in stats["plan_valid"][i]],
                        merged_valid=merged_valid,
                        active=[bool(x) for x in stats["active"][i]],
                        num_rows=int(stats["num_rows"][i]),
                        attributed=[float(x) for x in stats["attributed"][i]],
                        wall_time_s=wall_per_epoch,
                        answer_mask=(
                            np.asarray(stats["answer_mask"][i]) if collect_masks else None
                        ),
                        true_f=(
                            [float(x) for x in stats["true_f"][i]] if "true_f" in stats else None
                        ),
                    )
                )
                e += 1
                if stop_when_exhausted and merged_valid == 0:
                    return history
        return history
