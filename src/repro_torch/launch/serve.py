"""The progressive query server (port of ``repro.launch.serve``).

Three serving modes, as in the reference:

* single query (no ``--session``, ``--queries 1``, the paper's operator):
  one ``ProgressiveQueryOperator`` over the model-cascade bank, epoch by
  epoch with early termination::

    python -m repro_torch.launch.serve --objects 512 --preds 2 --backbone ""

* multi-tenant (``--queries Q``): Q overlapping conjunctive queries over
  one shared substrate through ``MultiQueryEngine``, reporting per-query
  E(F) and the cost the cross-query dedup avoided::

    python -m repro_torch.launch.serve --objects 512 --preds 3 --queries 4 --backbone ""

* session (``--session``): one long-lived multi-tenant ``EngineSession``
  driven by a scripted ingest/admit/retire/run arrival trace: lockstep, or
  with ``--overlap`` through the async ``SessionPipeline``; durable with
  ``--checkpoint-dir`` (``--restore`` resumes bitwise); ingest events
  streamed through pinned staging and the pending-row ring with
  ``--ingest-batch``; and under the fault supervisor with ``--supervise``
  (``--inject-faults`` schedules deterministic faults)::

    python -m repro_torch.launch.serve --session --objects 256 --device cpu --overlap
    python -m repro_torch.launch.serve --session --objects 256 --device cpu \
        --checkpoint-dir /tmp/ck --checkpoint-every 1
    python -m repro_torch.launch.serve --session --objects 256 --device cpu \
        --checkpoint-dir /tmp/ck --restore
    python -m repro_torch.launch.serve --session --objects 256 --device cpu \
        --ingest-batch 64 --ring-capacity 2 --ingest-policy spill
    python -m repro_torch.launch.serve --session --objects 256 --device cpu \
        --plan-shards 2 --supervise --checkpoint-dir /tmp/ck \
        --chunk-size 1 --inject-faults 'kill:w1@chunk:4'

Session mode has two enrichment banks:

* ``--bank simulated`` (default): precomputed AUC-calibrated outputs,
  ingest-capable::

    python -m repro_torch.launch.serve --session --objects 4096 --preds 4 \\
        --trace 'admit:2;admit:3;run:8;ingest:2048;admit:2;run:8;retire:0;run:8'

* ``--bank cascade``: the model-cascade bank (linear probe, MLP probe and a
  transformer backbone head per predicate) runs its real forwards on every
  epoch's merged plan; a fixed corpus, so no ingest.  ``--backbone`` picks
  the trunk from the ten architectures of ``configs/archs.py`` (qwen3-1.7b,
  the default; the attention-free mamba2-370m, whose SSD mixer runs through
  the intra-chunk kernel; hymba-1.5b, attention and SSD heads in every
  layer; the MoE grok-1-314b and arctic-480b; ...).  The backbone is the
  reference's reduced config unless ``--full-width`` asks for the published
  one (on the card: the f32 trunk and its bf16 copy, 6 bytes a parameter,
  must fit)::

    python -m repro_torch.launch.serve --session --bank cascade --device cpu
    python -m repro_torch.launch.serve --session --bank cascade \\
        --backbone hymba-1.5b --device cpu

The single and multi-tenant modes use the cascade bank; ``--backbone ""``
drops its backbone level and ``--full-width`` builds it at the published
width, as for ``--session --bank cascade``.  Runs on the card by default
(``--device cuda``); ``--device cpu`` runs the plain PyTorch path.  The
reference's ``--backend`` is not taken: the port routes scoring by device.
The report's ``cost_hex``, ``bills_hex`` and ``answer_digest`` are the
bitwise diff surface, as in the reference.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.archs import ARCHS, get_config
from repro_torch.core import shard_program
from repro_torch.core.combine import auc_score, fit_combine_weights
from repro_torch.core.decision_table import learn_decision_table
from repro_torch.core.durability import SessionCheckpointer, restore_session_checkpoint
from repro_torch.core.executor import EngineConfig, SessionState
from repro_torch.core.metrics import true_f_alpha
from repro_torch.core.multi_query import MultiQueryConfig, MultiQueryEngine, build_query_set
from repro_torch.core.operator import OperatorConfig, ProgressiveQueryOperator
from repro_torch.core.query import Predicate, conjunction
from repro_torch.core.session import EngineSession
from repro_torch.data.synthetic import make_corpus, split_corpus, truth_answer_mask
from repro_torch.device import resolve_device
from repro_torch.enrich.cascade import ModelCascadeBank, build_cascade_suite, train_level
from repro_torch.ingest import IngestStream, PendingRing
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.chaos import parse_fault_spec
from repro_torch.runtime.fault_tolerance import Heartbeat, PreemptionHandler, StragglerMonitor
from repro_torch.runtime.supervisor import Supervisor, SupervisorConfig

SESSION_AUCS = (0.60, 0.88, 0.93, 0.97)
SESSION_COSTS = (0.01, 0.05, 0.2, 0.5)


def build_session_server(
    num_objects: int = 256,
    capacity: Optional[int] = None,
    num_preds: int = 4,
    max_tenants: int = 8,
    seed: int = 0,
    train_size: int = 512,
    plan_size: int = 64,
    plan_shards: int = 1,
    max_capacity: Optional[int] = None,
    substrate_dtype: str = "float32",
    device=None,
    aucs=SESSION_AUCS,
    costs=SESSION_COSTS,
):
    """Long-lived serving session over a simulated corpus.

    Offline phase on the target device: draw the corpus (one tagging
    function per entry of ``aucs`` / ``costs``), fit the combine weights and
    learn the decision table on a training split, then open the session over
    ``num_objects`` rows.  ``aucs`` / ``costs`` are for tests that need
    another bank of functions (the 8-function session of the on-card smoke
    test); no command-line flag sets them.  -> (session, state, ingest_pool,
    preds): ``ingest_pool`` holds the remaining outputs (up to
    ``max(capacity, max_capacity)`` rows) for ``ingest`` events.
    """
    dev = resolve_device(device)
    if capacity is None:
        capacity = 2 * num_objects
    limit = max(capacity, max_capacity or capacity)
    preds = [Predicate(i, 1) for i in range(num_preds)]
    gen = torch.Generator(device=dev).manual_seed(seed)
    corpus = make_corpus(
        gen, limit + train_size, [p.tag_type for p in preds], [p.tag for p in preds],
        selectivity=[0.3] * num_preds, aucs=aucs, costs=costs,
    )
    train, evalc = split_corpus(corpus, train_size)
    combine = fit_combine_weights(train.func_probs, train.truth_pred.to(torch.float32), steps=150)
    table = learn_decision_table(train.func_probs, combine, num_bins=10)
    session = EngineSession(
        [p.positive() for p in preds], table, combine, evalc.costs,
        capacity=capacity, max_tenants=max_tenants,
        config=EngineConfig(
            plan_size=plan_size, function_selection="best",
            num_shards=plan_shards, substrate_dtype=substrate_dtype,
        ),
        max_capacity=max_capacity,
        device=dev,
    )
    state = session.init_state(evalc.func_probs[:num_objects])
    pool = evalc.func_probs[num_objects:limit]
    return session, state, pool, preds


def _offline_phase(
    num_objects: int,
    num_preds: int,
    backbone_cfg: Optional[ModelConfig],
    seed: int,
    train_size: int = 512,
    device=None,
):
    """Corpus, cascade training, combine weights and decision table over the
    global predicate space, on ``device`` (no backbone level when
    ``backbone_cfg`` is None).  The bank's features are the evaluation
    split: the corpus the server serves.
    -> (preds, evalc, bank, combine, table, qualities)
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    preds = [Predicate(i, 1) for i in range(num_preds)]
    corpus = make_corpus(
        gen, num_objects + train_size, [p.tag_type for p in preds], [p.tag for p in preds],
        selectivity=[0.3] * num_preds, feature_dim=64,
    )
    train, evalc = split_corpus(corpus, train_size)
    # one SHARED backbone trunk with per-predicate heads
    suite = build_cascade_suite(gen, num_preds, 64, backbone_cfg)
    cascades, qualities = [], []
    for i in range(num_preds):
        levels = [train_level(lvl, train.features, train.truth_pred[:, i]) for lvl in suite[i]]
        cascades.append(levels)
        with torch.no_grad():
            qualities.append([
                float(auc_score(lvl.apply_fn(lvl.params, evalc.features), evalc.truth_pred[:, i]))
                for lvl in levels
            ])
    bank = ModelCascadeBank(cascades=cascades, features=evalc.features)

    # offline artifacts: combine weights + decision table from TRAIN outputs
    with torch.no_grad():
        train_outputs = torch.stack([
            torch.stack([lvl.apply_fn(lvl.params, train.features).float() for lvl in casc], dim=1)
            for casc in cascades
        ], dim=1)  # [Ntr, P, F]
    combine = fit_combine_weights(train_outputs, train.truth_pred.to(torch.float32), steps=150)
    table = learn_decision_table(train_outputs, combine, num_bins=10, costs=bank.costs,
                                 cost_normalized=True)
    return preds, evalc, bank, combine, table, qualities


@dataclasses.dataclass
class ServeReport:
    epochs: int
    cost_spent: float
    expected_f: float
    true_f1: Optional[float]
    wall_s: float
    history: list


def build_server(
    num_objects: int = 512,
    num_preds: int = 1,
    backbone_arch: Optional[str] = "qwen3-1.7b",
    seed: int = 0,
    smoke: bool = True,
    device=None,
):
    """Single-query server over the cascade bank -> (operator, corpus,
    truth, qualities).  Trains the cascade offline; ``smoke=False`` builds
    the backbone at the published width."""
    dev = resolve_device(device)
    backbone_cfg = get_config(backbone_arch, smoke=smoke) if backbone_arch else None
    preds, evalc, bank, combine, table, qualities = _offline_phase(
        num_objects, num_preds, backbone_cfg, seed, device=dev
    )
    query = conjunction(*preds)
    truth = truth_answer_mask(evalc, query)
    cfg = OperatorConfig(plan_size=64, function_selection="best")
    op = ProgressiveQueryOperator(query, table, combine, bank.costs, bank, cfg,
                                  truth_mask=truth, device=dev)
    return op, evalc, truth, qualities


def build_multi_server(
    num_objects: int = 512,
    num_preds: int = 3,
    num_queries: int = 8,
    backbone_arch: Optional[str] = "qwen3-1.7b",
    seed: int = 0,
    preds_per_query: int = 2,
    plan_shards: int = 1,
    smoke: bool = True,
    device=None,
):
    """Multi-tenant server: Q overlapping conjunctive queries, one substrate.

    Tenants draw random predicate subsets from the corpus schema with
    ``np.random.default_rng(seed + 1)``, as the reference does.
    -> (engine, corpus, truths, qualities, queries)
    """
    dev = resolve_device(device)
    backbone_cfg = get_config(backbone_arch, smoke=smoke) if backbone_arch else None
    preds, evalc, bank, combine, table, qualities = _offline_phase(
        num_objects, num_preds, backbone_cfg, seed, device=dev
    )
    rng = np.random.default_rng(seed + 1)
    queries = []
    for _ in range(num_queries):
        k = min(max(1, preds_per_query), num_preds)
        cols = rng.choice(num_preds, size=k, replace=False)
        queries.append(conjunction(*[preds[c] for c in sorted(cols)]))
    query_set = build_query_set(queries, global_predicates=[p.positive() for p in preds])
    # truth_pred columns are the GLOBAL predicate columns: evaluate the
    # reindexed queries, not the local-space originals
    truths = torch.stack([truth_answer_mask(evalc, rq) for rq in query_set.reindexed])
    cfg = MultiQueryConfig(plan_size=64, function_selection="best", num_shards=plan_shards)
    engine = MultiQueryEngine(query_set, table, combine, bank.costs, bank, cfg,
                              truth_masks=truths, device=dev)
    return engine, evalc, truths, qualities, queries


def serve_query(
    op: ProgressiveQueryOperator,
    num_objects: int,
    epochs: int = 40,
    preemption: Optional[PreemptionHandler] = None,
    target_expected_f: Optional[float] = None,
) -> ServeReport:
    """Progressive evaluation with early termination (pay-as-you-go); a
    ``preemption`` request stops it between epochs, and each epoch's host
    time feeds a ``StragglerMonitor``, as in the reference."""
    monitor = StragglerMonitor(num_shards=1)
    state = op.init_state(num_objects)
    t0 = time.perf_counter()
    history = []
    sel = None
    for e in range(epochs):
        if preemption is not None and preemption.should_stop:
            break
        te = time.perf_counter()
        state, sel, plan, _ = op.run_epoch(state)
        monitor.record(0, time.perf_counter() - te)
        history.append(dict(epoch=e, cost=float(state.cost_spent),
                            expected_f=float(sel.expected_f), size=int(sel.size)))
        if int(plan.num_valid()) == 0:
            break
        if target_expected_f is not None and float(sel.expected_f) >= target_expected_f:
            break
    tf1 = None
    if op.truth_mask is not None and sel is not None:
        tf1 = float(true_f_alpha(sel.mask, op.truth_mask))
    return ServeReport(
        epochs=len(history),
        cost_spent=float(state.cost_spent),
        expected_f=history[-1]["expected_f"] if history else 0.0,
        true_f1=tf1,
        wall_s=time.perf_counter() - t0,
        history=history,
    )


@dataclasses.dataclass
class MultiServeReport:
    epochs: int
    num_queries: int
    cost_spent: float  # shared substrate spend
    requested_cost: float  # what the tenants would have paid without dedup
    expected_f: list  # [Q] final per-query E(F_alpha)
    true_f: Optional[list]  # [Q]
    wall_s: float
    history: list  # per-epoch dicts with per-query + aggregate trajectories

    @property
    def dedup_savings(self) -> float:
        return self.requested_cost - self.cost_spent

    @property
    def mean_expected_f(self) -> float:
        return sum(self.expected_f) / max(len(self.expected_f), 1)


def serve_queries(
    engine: MultiQueryEngine,
    num_objects: int,
    epochs: int = 40,
    preemption: Optional[PreemptionHandler] = None,
    target_expected_f: Optional[float] = None,
) -> MultiServeReport:
    """Multi-tenant progressive evaluation: lockstep epochs over Q queries;
    ``target_expected_f`` stops once the MEAN per-query E(F) reaches it, a
    ``preemption`` request between epochs."""
    state = engine.init_state(num_objects)
    t0 = time.perf_counter()
    history = []
    requested = 0.0
    for e in range(epochs):
        if preemption is not None and preemption.should_stop:
            break
        state, sel, plans, merged, _, _ = engine.run_epoch(state)
        requested += float(torch.where(plans.valid, plans.cost, 0.0).sum())
        per_query_f = [float(x) for x in sel.expected_f.cpu()]
        mean_f = sum(per_query_f) / len(per_query_f)
        merged_valid = int(merged.num_valid())
        history.append(dict(epoch=e, cost=float(state.cost_spent), requested_cost=requested,
                            expected_f=per_query_f, mean_expected_f=mean_f,
                            sizes=[int(x) for x in sel.size.cpu()],
                            merged_valid=merged_valid))
        if merged_valid == 0:
            break
        if target_expected_f is not None and mean_f >= target_expected_f:
            break
    tf = None
    if engine.truth_masks is not None and history:
        tf = [float(x) for x in true_f_alpha(state.per_query.in_answer, engine.truth_masks,
                                             engine.config.alpha).cpu()]
    return MultiServeReport(
        epochs=len(history),
        num_queries=engine.query_set.num_queries,
        cost_spent=float(state.cost_spent),
        requested_cost=requested,
        expected_f=history[-1]["expected_f"] if history else [],
        true_f=tf,
        wall_s=time.perf_counter() - t0,
        history=history,
    )


def open_cascade_session(
    preds,
    bank: ModelCascadeBank,
    combine,
    table,
    max_tenants: int = 8,
    plan_size: int = 64,
    plan_shards: int = 1,
    substrate_dtype: str = "float32",
    device=None,
):
    """A session over ``bank``'s whole corpus whose epochs run the bank's
    ``execute`` on every merged plan -> (session, state)."""
    num_objects = bank.features.shape[0]
    session = EngineSession(
        [p.positive() for p in preds], table, combine, bank.costs,
        capacity=num_objects, max_tenants=max_tenants,
        config=EngineConfig(
            plan_size=plan_size, function_selection="best",
            num_shards=plan_shards, substrate_dtype=substrate_dtype,
        ),
        device=device, bank=bank,
    )
    # no precomputed outputs to seed: the bank computes probabilities inside
    # the superstep; the buffer opens at the prior and is never gathered
    placeholder = torch.full((num_objects, len(preds), bank.num_levels), session.config.prior,
                             dtype=torch.float32, device=session.device)
    return session, session.init_state(placeholder)


def build_cascade_session_server(
    num_objects: int = 256,
    num_preds: int = 3,
    max_tenants: int = 8,
    seed: int = 0,
    backbone_arch: Optional[str] = None,
    plan_size: int = 64,
    plan_shards: int = 1,
    substrate_dtype: str = "float32",
    smoke: bool = True,
    train_size: int = 512,
    device=None,
):
    """Long-lived serving session whose enrichment is the model-cascade
    bank, run inside the superstep (``EngineSession(bank=...)``).  The bank's
    feature table IS the corpus, so the session is fixed-capacity
    (capacity == num_objects) and serves no ingest events.  ``smoke=False``
    builds the backbone at the published width of ``backbone_arch`` instead
    of the reference's reduced config.

    -> (session, state, preds, qualities)
    """
    dev = resolve_device(device)
    backbone_cfg = get_config(backbone_arch, smoke=smoke) if backbone_arch else None
    preds, _, bank, combine, table, qualities = _offline_phase(
        num_objects, num_preds, backbone_cfg, seed, train_size=train_size, device=dev,
    )
    session, state = open_cascade_session(
        preds, bank, combine, table, max_tenants=max_tenants, plan_size=plan_size,
        plan_shards=plan_shards, substrate_dtype=substrate_dtype, device=dev,
    )
    return session, state, preds, qualities


class StreamingIngest:
    """Routes ``ingest`` trace events through the staging / ring front-end.

    Owns a ``PendingRing`` sized by the ``--ingest-*`` flags and an
    ``IngestStream`` whose backpressure callback drains the ring back into
    the serve loop: lockstep drains through a host ``num_rows`` shadow (one
    host read at attach, none per event), overlap drains through
    ``SessionPipeline.drain_ring`` against the in-flight carry, so a full
    ring under the ``block`` policy resolves itself.  Rows are fed from the
    host: a pool on the card is copied to the host per event (a sync), so
    serving keeps its ingest pool on the host.
    """

    def __init__(
        self,
        session: EngineSession,
        *,
        batch_rows: int,
        num_slots: int = 4,
        policy: str = "block",
        rate_rows_per_s: Optional[float] = None,
    ):
        self.ring = PendingRing(session, slot_rows=batch_rows, num_slots=num_slots, policy=policy)
        self.stream = IngestStream(
            self.ring, batch_rows=batch_rows, rate_rows_per_s=rate_rows_per_s,
            on_pressure=self.drain,
        )
        self._session = session
        self._pipe = None
        self._state = None
        self._num_rows: Optional[int] = None
        self.drains = 0

    def attach_pipeline(self, pipe) -> None:
        self._pipe = pipe

    def attach_lockstep(self, state) -> None:
        self._state = state
        # one host read, at attach time (a placed state: its local replica)
        self._num_rows = int(shard_program.local_view(state)[1].num_rows)

    def begin(self, state) -> None:
        """Lockstep only: adopt the loop's current state before feed / drain."""
        self._state = state

    @property
    def state(self):
        """Lockstep only: the state after the last feed / drain."""
        return self._state

    def feed(self, rows) -> int:
        return self.stream.feed(rows)

    def drain(self) -> None:
        if self._pipe is not None:
            if self._pipe.drain_ring(self.ring):
                self.drains += 1
            return
        self._state, self._num_rows, drained = self.ring.drain_into(
            self._session, self._state, self._num_rows
        )
        if drained:
            self.drains += 1

    def counters(self) -> dict:
        return self.stream.counters()


def parse_trace(spec: str) -> list:
    """``"admit:2;run:4;ingest:64;retire:0;run:4"`` -> [(kind, int_arg), ...].

    Kinds: ``run:<epochs>``, ``admit:<k>`` (a random conjunction of k schema
    predicates), ``ingest:<m>`` (m pooled objects), ``retire:<slot>``.
    """
    events = []
    for tok in spec.replace(",", ";").split(";"):
        tok = tok.strip()
        if not tok:
            continue
        kind, _, arg = tok.partition(":")
        if kind not in ("run", "admit", "ingest", "retire"):
            raise ValueError(f"unknown trace event {tok!r}")
        arg = int(arg)
        if kind in ("run", "ingest", "admit") and arg < 1:
            raise ValueError(f"trace event {tok!r}: arg must be >= 1")
        if kind == "retire" and arg < 0:
            raise ValueError(f"trace event {tok!r}: slot must be >= 0")
        events.append((kind, arg))
    return events


@dataclasses.dataclass
class SessionServeReport:
    epochs: int
    events: list
    cost_spent: float
    mean_expected_f: float  # over active tenants at the end
    active_tenants: int
    num_rows: int
    attributed: list  # [S] per-tenant ledger totals
    unattributed: float
    superstep_traces: int
    wall_s: float
    history: list
    capacity: int = 0  # the tier the session ended on
    max_capacity: int = 0
    growths: int = 0
    retrace_bound: int = 1
    overlap: bool = False  # events applied against in-flight chunks
    chunk_size: Optional[int] = None
    num_events: int = 0
    events_per_sec: float = 0.0
    # ---- durability (checkpoint / restore / preemption) ----
    preempted: bool = False  # the trace stopped at a preemption drain
    epochs_total: int = 0  # cumulative epochs INCLUDING pre-restore progress
    events_done: int = 0  # trace events fully completed (cumulative)
    restored_step: Optional[int] = None  # checkpoint step this run resumed from
    cost_hex: str = ""  # float.hex of cost_spent (bitwise-diffable)
    bills_hex: list = dataclasses.field(default_factory=list)  # [S] invoice hex
    answer_digest: str = ""  # sha256 over in_answer[:, :num_rows] (tier-free)
    scan_lengths: list = dataclasses.field(default_factory=list)
    checkpoint_saves: int = 0
    checkpoint_seconds: float = 0.0
    # ---- degraded-mode enrichment (quarantine) ----
    quarantined: list = dataclasses.field(default_factory=list)  # [[pred, func]]
    degraded: bool = False  # any enrichment function quarantined at the end
    # ---- streaming ingestion (staging + pending-row ring) ----
    streaming: bool = False
    substrate_dtype: str = "float32"
    ring_drains: int = 0
    ingest_counters: dict = dataclasses.field(default_factory=dict)
    device: str = ""
    state: Optional[SessionState] = None  # final state, for callers that serve on

    def payload(self) -> dict:
        """The JSON report (everything but the history and the state)."""
        skip = ("history", "state")
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if f.name not in skip
        }


HOST_META_FORMAT = 1  # the serve loop's shadow block version in extra["host"]


def state_digests(state: SessionState) -> tuple:
    """(cost_hex, bills_hex, answer_digest): the report's bitwise diff
    surface — ``float.hex`` of the spend and of each invoice, and the sha256
    of the answer masks over the occupied rows (tier-free)."""
    state = shard_program.whole(state)  # a placed state: gathered (a collective)
    rows = int(state.num_rows)
    answers = np.ascontiguousarray(state.derived.in_answer[:, :rows].cpu().numpy())
    return (
        float(state.cost_spent).hex(),
        [float(b).hex() for b in state.ledger.bills(state.cost_spent)],
        hashlib.sha256(answers.tobytes()).hexdigest(),
    )


def serve_session_trace(
    session: EngineSession,
    state: SessionState,
    events: list,  # [(kind, arg)] from parse_trace
    pool=None,  # [R, P, F] outputs available to ingest events
    preds=None,  # schema predicates, for admit events
    seed: int = 0,
    preemption: Optional[PreemptionHandler] = None,
    overlap: bool = False,
    chunk_size: Optional[int] = None,
    checkpointer: Optional[SessionCheckpointer] = None,
    resume: Optional[dict] = None,
    heartbeat: Optional[Heartbeat] = None,
    boundary_hook=None,
    streaming: Optional[StreamingIngest] = None,
) -> SessionServeReport:
    """Drive a scripted arrival trace through one long-lived session.

    Admit events draw their predicate subsets from ``np.random.default_rng
    (seed)`` exactly as the reference does, so both serve the same tenants.

    ``overlap=True`` drives the trace through ``SessionPipeline``: chunks
    are enqueued without waiting, events validate against host shadows and
    apply to the in-flight carry, and the pipeline waits once, at the end —
    bitwise the lockstep result.  ``chunk_size`` sets the dispatch
    granularity of both modes.

    **Durability.**  With a ``checkpointer``, snapshots land only at chunk
    boundaries: lockstep runs save on the checkpointer's cadence from the
    ``on_chunk`` hook; overlap mode saves at event boundaries.  A
    ``preemption`` request stops dispatch at the next boundary, force-saves
    and returns ``preempted=True``.  A clean completion saves a final
    checkpoint past the last event.  ``resume`` takes a checkpoint's
    ``extra["host"]`` block: the trace re-enters at the saved event cursor,
    skipping epochs already run, with the pool cursor and the admit RNG's
    bit-generator state restored, so the resumed run replays the
    uninterrupted one bitwise (``cost_hex``, ``bills_hex``,
    ``answer_digest``).

    ``boundary_hook`` (no-arg callable) fires once per dispatched chunk,
    BEFORE that boundary's preemption poll: the supervisor's fault clock.

    With ``streaming``, ingest events stage their rows through the pinned,
    double-buffered copy path into the pending-row ring; the ring drains
    into the session before every run event, before overlap-mode
    checkpoints, and once at the end — bitwise the direct-ingest result.
    """
    rng = np.random.default_rng(seed)
    pool_off = 0
    start_event = 0
    start_into = 0  # epochs already run of the resumed-into run event
    epochs_total = 0  # cumulative across restarts (the checkpoint step)
    restored_step = None
    if resume is not None:
        if resume.get("format") != HOST_META_FORMAT:
            raise ValueError(
                f"resume host-meta format {resume.get('format')!r} != {HOST_META_FORMAT}"
            )
        rng.bit_generator.state = resume["rng_state"]
        pool_off = int(resume["pool_offset"])
        start_event = int(resume["event_cursor"])
        start_into = int(resume["epochs_into_event"])
        epochs_total = int(resume["epochs_total"])
        restored_step = epochs_total

    def host_meta(cursor: int, into: int, total: int) -> dict:
        # what the restarted serve loop needs before touching array data; the
        # rng state is captured at snapshot time (admits advance it)
        return dict(
            format=HOST_META_FORMAT,
            event_cursor=cursor,
            epochs_into_event=into,
            epochs_total=total,
            pool_offset=pool_off,
            rng_state=rng.bit_generator.state,
        )

    history = []
    scan_lengths: set = set()
    pipe = (
        session.pipeline(
            state, chunk_size=chunk_size, preemption=preemption, heartbeat=heartbeat,
            boundary_hook=boundary_hook,
        )
        if overlap
        else None
    )
    if streaming is not None:
        if pipe is not None:
            streaming.attach_pipeline(pipe)
        else:
            streaming.attach_lockstep(state)
    preempted = False
    events_done = start_event
    t0 = time.perf_counter()
    for idx in range(start_event, len(events)):
        kind, arg = events[idx]
        if preemption is not None and preemption.should_stop:
            preempted = True
            break
        into0 = start_into if idx == start_event else 0
        if kind == "run":
            run_epochs = arg - into0
            if run_epochs <= 0:
                events_done = idx + 1
                continue
            if streaming is not None:
                # pending ring rows join planning before these epochs run
                if pipe is None:
                    streaming.begin(state)
                streaming.drain()
                if pipe is None:
                    state = streaming.state
            if pipe is not None:
                n_chunks = len(pipe._chunks)
                pipe.run(run_epochs)
                lengths = [c[1] for c in pipe._chunks[n_chunks:]]
                scan_lengths.update(lengths)
                this_run = sum(lengths)
                epochs_total += this_run
                if pipe.preempted:
                    preempted = True
                    if checkpointer is not None:
                        done = into0 + this_run
                        cursor, into = (idx + 1, 0) if done >= arg else (idx, done)
                        pipe.checkpoint(
                            checkpointer, epochs_total,
                            host_meta=host_meta(cursor, into, epochs_total),
                        )
                    break
            else:
                base_total = epochs_total
                stop_box = {"stop": False}
                prev_done = [0]

                def on_chunk(carry, done, _idx=idx, _arg=arg, _into0=into0,
                             _base=base_total, _stop=stop_box, _prev=prev_done):
                    scan_lengths.add(done - _prev[0])
                    _prev[0] = done
                    if heartbeat is not None:
                        heartbeat.beat(0)
                    if boundary_hook is not None:
                        boundary_hook()
                    stop = preemption is not None and preemption.should_stop
                    if checkpointer is not None:
                        into = _into0 + done
                        cursor, rem = (_idx + 1, 0) if into >= _arg else (_idx, into)
                        checkpointer.maybe_save(
                            carry, _base + done,
                            host_meta=host_meta(cursor, rem, _base + done),
                            force=stop,
                        )
                    if stop:
                        _stop["stop"] = True
                    return stop

                state, h = session.run(
                    state, run_epochs, stop_when_exhausted=False, chunk_size=chunk_size,
                    on_chunk=on_chunk,
                )
                history.extend(h)
                epochs_total = base_total + prev_done[0]
                if stop_box["stop"]:
                    preempted = True
                    break
        elif kind == "admit":
            if preds is None:
                raise ValueError("admit events need the schema predicates")
            k = min(max(1, arg), len(preds))
            cols = sorted(rng.choice(len(preds), size=k, replace=False))
            query = conjunction(*[preds[c] for c in cols])
            if pipe is not None:
                pipe.admit(query)
            else:
                state, _ = session.admit(state, query)
        elif kind == "ingest":
            if pool is None or pool_off + arg > pool.shape[0]:
                raise ValueError(
                    f"ingest of {arg} exceeds the remaining pool "
                    f"({0 if pool is None else pool.shape[0] - pool_off})"
                )
            batch = pool[pool_off:pool_off + arg]
            if streaming is not None:
                if pipe is None:
                    streaming.begin(state)
                streaming.feed(batch)
                if pipe is None:
                    state = streaming.state
            elif pipe is not None:
                pipe.ingest(batch)
            else:
                state = session.ingest(state, batch)
            pool_off += arg
        else:  # retire
            if pipe is not None:
                pipe.retire(arg)
            else:
                state = session.retire(state, arg)
        events_done = idx + 1
        if pipe is not None and checkpointer is not None:
            if streaming is not None:
                streaming.drain()  # ring rows are not part of a snapshot
            # overlap cadence: event boundaries (a save waits for the chunks)
            pipe.checkpoint(
                checkpointer, epochs_total,
                host_meta=host_meta(idx + 1, 0, epochs_total), force=False,
            )
    if streaming is not None:
        # rows still parked in the ring land before the final answers are read
        if pipe is None:
            streaming.begin(state)
        streaming.drain()
        if pipe is None:
            state = streaming.state
    if pipe is not None:
        state, history = pipe.finish()  # the pipeline's one wait
    if preempted and checkpointer is not None:
        # preemption seen BETWEEN events (the in-run paths force-saved already,
        # leaving last_step == epochs_total): snapshot at the event cursor
        if checkpointer.last_step != epochs_total:
            checkpointer.save(
                state, epochs_total, host_meta=host_meta(events_done, 0, epochs_total)
            )
    if not preempted and checkpointer is not None:
        # clean completion: a final restore point past the last event
        checkpointer.save(state, epochs_total, host_meta=host_meta(len(events), 0, epochs_total))
    if state.device.type == "cuda":
        torch.cuda.synchronize(state.device)
    wall = time.perf_counter() - t0
    last = history[-1] if history else None
    view = shard_program.whole(state)  # a placed state's leaves, whole (a collective)
    num_rows = int(view.num_rows)
    cost = float(view.cost_spent)
    cost_hex, bills_hex, answer_digest = state_digests(view)
    quarantined = []
    if view.quarantined is not None:
        qm = view.quarantined.cpu().numpy()
        quarantined = [[int(i), int(j)] for i, j in zip(*np.nonzero(qm))]
    return SessionServeReport(
        epochs=len(history),
        events=[dict(kind=k, arg=a) for k, a in events],
        cost_spent=cost,
        mean_expected_f=last.mean_expected_f if last else 0.0,
        active_tenants=int(view.active.sum()),
        num_rows=num_rows,
        attributed=[float(x) for x in view.ledger.attributed.cpu()],
        unattributed=float(view.ledger.unattributed),
        superstep_traces=session.superstep_traces,
        wall_s=wall,
        history=history,
        capacity=state.capacity,
        max_capacity=session.max_capacity,
        growths=session.growths,
        retrace_bound=session.retrace_bound,
        overlap=overlap,
        chunk_size=chunk_size,
        num_events=len(events),
        events_per_sec=len(events) / max(wall, 1e-9),
        preempted=preempted,
        epochs_total=epochs_total,
        events_done=events_done,
        restored_step=restored_step,
        cost_hex=cost_hex,
        bills_hex=bills_hex,
        answer_digest=answer_digest,
        scan_lengths=sorted(scan_lengths),
        checkpoint_saves=0 if checkpointer is None else checkpointer.saves,
        checkpoint_seconds=0.0 if checkpointer is None else checkpointer.save_seconds,
        quarantined=quarantined,
        degraded=bool(quarantined),
        streaming=streaming is not None,
        substrate_dtype=session.config.substrate_dtype,
        ring_drains=0 if streaming is None else streaming.drains,
        ingest_counters={} if streaming is None else streaming.counters(),
        device=str(state.device),
        state=state,
    )


def _check_session_flags(ap, args) -> None:
    """The reference's ``ap.error`` combinations, checked before any work."""
    if args.bank == "cascade":
        if args.max_capacity is not None or args.capacity is not None or (
                args.ingest_batch is not None):
            ap.error("--bank cascade serves a fixed corpus: no --capacity / --max-capacity "
                     "/ --ingest-batch")
        if args.trace and any(k == "ingest" for k, _ in parse_trace(args.trace)):
            ap.error("--bank cascade serves a fixed corpus; drop ingest events from --trace")
        if args.supervise:
            ap.error("--bank cascade is not wired into --supervise yet")
    if args.ingest_batch is not None and args.supervise:
        ap.error("--ingest-batch is not wired into --supervise yet")
    if args.restore and not args.checkpoint_dir:
        ap.error("--restore requires --checkpoint-dir")
    if args.inject_faults and not args.supervise:
        ap.error("--inject-faults requires --supervise")
    if args.supervise:
        if not args.checkpoint_dir:
            ap.error("--supervise requires --checkpoint-dir")
        if args.restore:
            ap.error("--supervise owns restore; drop --restore")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--session", action="store_true",
                    help="serve a long-lived EngineSession driven by a scripted "
                         "ingest/admit/retire arrival trace")
    ap.add_argument("--queries", type=int, default=1,
                    help="without --session: concurrent tenant queries (>1 serves "
                         "them through the multi-query engine, 1 the single-query operator)")
    ap.add_argument("--preds-per-query", type=int, default=2)
    ap.add_argument("--bank", default="simulated", choices=("simulated", "cascade"),
                    help="session enrichment bank: 'simulated' (precomputed AUC-calibrated "
                         "outputs, ingest-capable) or 'cascade' (real model-cascade "
                         "forwards every epoch; fixed corpus, no ingest)")
    ap.add_argument("--backbone", default="qwen3-1.7b", choices=sorted(ARCHS) + [""],
                    help="cascade backbone architecture ('' for probes only)")
    ap.add_argument("--full-width", action="store_true",
                    help="cascade backbone at the published width (default: the "
                         "reference's reduced config)")
    ap.add_argument("--objects", type=int, default=512)
    ap.add_argument("--preds", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=40,
                    help="epochs of the default trace (split over its run events)")
    ap.add_argument("--plan-shards", type=int, default=1,
                    help="plan selection over this many object shards (identical "
                         "to unsharded planning)")
    ap.add_argument("--capacity", type=int, default=None,
                    help="session row capacity (default 2x --objects)")
    ap.add_argument("--max-capacity", type=int, default=None,
                    help="grow past --capacity through geometric tiers up to this bound")
    ap.add_argument("--max-tenants", type=int, default=8, help="pre-allocated tenant slots")
    ap.add_argument("--trace", default=None,
                    help="arrival trace, e.g. 'admit:2;run:4;ingest:64;admit:3;run:4;retire:0;run:4'")
    ap.add_argument("--substrate-dtype", default="float32", choices=("float32", "bfloat16"),
                    help="storage dtype of the substrate (scoring math stays f32)")
    ap.add_argument("--ingest-batch", type=int, default=None, metavar="ROWS",
                    help="stream ingest trace events through the staging + "
                         "pending-row-ring front-end in micro-batches of this "
                         "many rows (enables streaming ingestion; results "
                         "stay bitwise identical to direct ingest)")
    ap.add_argument("--ring-capacity", type=int, default=4, metavar="SLOTS",
                    help="pending-row ring slots; arrivals beyond "
                         "ring + drain rate hit --ingest-policy")
    ap.add_argument("--ingest-rate", type=float, default=None, metavar="ROWS_PER_S",
                    help="throttle staged arrivals to this many rows/s "
                         "(default: unthrottled)")
    ap.add_argument("--ingest-policy", default="block", choices=("block", "shed", "spill"),
                    help="full-ring behavior: block (drain then retry), shed "
                         "(drop + count), spill (host-side FIFO overflow)")
    ap.add_argument("--chunk-size", type=int, default=None,
                    help="epochs per dispatched chunk (bitwise inert; the unit "
                         "of event overlap)")
    ap.add_argument("--overlap", action="store_true",
                    help="apply trace events against in-flight chunks (async "
                         "pipeline: no host syncs until the final drain) instead "
                         "of lockstep between runs")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="durable sessions: snapshot the full session state "
                         "here at chunk boundaries (atomic step_N dirs); "
                         "SIGTERM drains in-flight chunks, checkpoints, and "
                         "exits 0")
    ap.add_argument("--checkpoint-every", type=int, default=4,
                    help="snapshot cadence in chunk boundaries (lockstep mode; "
                         "overlap snapshots at event boundaries)")
    ap.add_argument("--checkpoint-keep", type=int, default=3,
                    help="checkpoints retained after each save")
    ap.add_argument("--restore", action="store_true",
                    help="resume the trace from the latest checkpoint in "
                         "--checkpoint-dir (bitwise-identical to an "
                         "uninterrupted run; works onto a different "
                         "--plan-shards or capacity tier)")
    ap.add_argument("--restore-step", type=int, default=None,
                    help="restore this checkpoint step instead of the latest")
    ap.add_argument("--supervise", action="store_true",
                    help="run the session trace under runtime.supervisor: "
                         "heartbeat-driven failure detection, elastic shrink "
                         "(ElasticPolicy), restore onto the resharded session, and "
                         "enrichment-function quarantine with backoff probes "
                         "(requires --checkpoint-dir)")
    ap.add_argument("--inject-faults", default=None, metavar="SPEC",
                    help="deterministic chaos schedule at named chunk "
                         "boundaries, e.g. 'kill:w1@chunk:6;"
                         "raise:p2.f1@chunk:5+3;slow:w0*4@chunk:3+8;"
                         "silence:w1@chunk:4+2' (see runtime.chaos; "
                         "requires --supervise)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for 'auto' fault boundaries in --inject-faults")
    ap.add_argument("--heartbeat-timeout", type=float, default=2.0,
                    help="supervised mode: chunk boundaries of silence before "
                         "a worker is declared failed")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' (default) raises when no GPU is present")
    ap.add_argument("--report", default=None,
                    help="write the serve report as JSON (the kill-and-resume "
                         "bitwise diff surface)")
    args = ap.parse_args(argv)
    handler = PreemptionHandler().install()
    try:
        if not args.session:
            return _serve_queries_main(args, handler)
        _check_session_flags(ap, args)
        return _serve_session_main(ap, args, handler)
    finally:
        handler.uninstall()


def _serve_session_main(ap, args, handler) -> int:
    """The ``--session`` mode of ``main``."""
    e = max(args.epochs // 4, 1)
    if args.bank == "cascade":
        session, state, preds, qualities = build_cascade_session_server(
            num_objects=args.objects, num_preds=max(args.preds, 2),
            max_tenants=args.max_tenants, seed=args.seed, backbone_arch=args.backbone or None,
            plan_shards=args.plan_shards, substrate_dtype=args.substrate_dtype,
            smoke=not args.full_width, device=args.device,
        )
        pool = None
        print(f"[serve] cascade qualities (AUC): {qualities}")
        # the cascade bank serves its fixed corpus: the default trace churns tenants only
        spec = args.trace or f"admit:2;run:{e};admit:2;run:{e};retire:0;run:{e}"
    else:
        session, state, pool, preds = build_session_server(
            num_objects=args.objects, capacity=args.capacity,
            num_preds=max(args.preds, 2), max_tenants=args.max_tenants, seed=args.seed,
            plan_shards=args.plan_shards, max_capacity=args.max_capacity,
            substrate_dtype=args.substrate_dtype, device=args.device,
        )
        spec = args.trace or (
            f"admit:2;admit:2;run:{e};ingest:{pool.shape[0] // 2};run:{e};"
            f"admit:3;run:{e};retire:0;run:{e}"
        )
    events = parse_trace(spec)
    streaming = None
    if args.ingest_batch is not None:
        streaming = StreamingIngest(
            session, batch_rows=args.ingest_batch, num_slots=args.ring_capacity,
            policy=args.ingest_policy, rate_rows_per_s=args.ingest_rate,
        )
        pool = pool.cpu()  # arrivals come from the host
    checkpointer = None
    if args.checkpoint_dir:
        checkpointer = SessionCheckpointer(
            session, args.checkpoint_dir, every=args.checkpoint_every, keep=args.checkpoint_keep,
        )
    resume = None
    if args.restore:
        # build_session_server is deterministic given (args, seed), so the
        # restored state drops into an identically-schema'd session; restore
        # re-pads onto THIS session's tiers and shard count
        state, step, extra = restore_session_checkpoint(
            session, args.checkpoint_dir, step=args.restore_step
        )
        resume = extra.get("host")
        if resume is None:
            ap.error("checkpoint has no serve host metadata to resume")
        print(
            f"[serve] restored step {step} (event cursor {resume['event_cursor']}, "
            f"{resume['epochs_total']} epochs done, {extra['num_rows']} rows) onto tier "
            f"{state.capacity} x {args.plan_shards} shard(s)"
        )
    supervision = None
    if args.supervise:
        plan = (
            parse_fault_spec(args.inject_faults, seed=args.fault_seed)
            if args.inject_faults
            else None
        )
        sup = Supervisor(
            session, state, events, pool=pool, preds=preds, seed=args.seed,
            checkpoint_dir=args.checkpoint_dir, fault_plan=plan, external=handler,
            chunk_size=args.chunk_size, overlap=args.overlap,
            config=SupervisorConfig(
                heartbeat_timeout=args.heartbeat_timeout,
                checkpoint_every=args.checkpoint_every,
                checkpoint_keep=args.checkpoint_keep,
            ),
        )
        report = sup.serve()
        supervision = sup.summary()
        print(
            f"[serve] supervised: state={supervision['final_state']}, "
            f"{supervision['restarts']} restarts, shrinks={supervision['shrinks']}, "
            f"quarantined={supervision['quarantined']}, "
            f"recovered={supervision['recovered']}, "
            f"transitions={supervision['transitions']}"
        )
    else:
        report = serve_session_trace(
            session, state, events, pool=pool, preds=preds, seed=args.seed,
            preemption=handler, overlap=args.overlap, chunk_size=args.chunk_size,
            checkpointer=checkpointer, resume=resume, streaming=streaming,
        )
    eps = report.epochs / max(report.wall_s, 1e-9)
    bills = {i: f"{c:.3f}" for i, c in enumerate(report.attributed) if c > 0}
    mode = "overlap" if args.overlap else "lockstep"
    print(
        f"[serve] session trace {spec!r} on {report.device} ({mode}, chunk={args.chunk_size}): "
        f"{report.epochs} epochs ({report.epochs_total} total), {report.num_rows} rows "
        f"(tier {report.capacity} of {report.max_capacity} max, {report.growths} growths), "
        f"{report.active_tenants} active tenants, cost={report.cost_spent:.4f}s-model, "
        f"mean E(F1)={report.mean_expected_f:.3f}, ledger={bills} "
        f"(+{report.unattributed:.4f} unattributed), "
        f"superstep traces={report.superstep_traces}, wall={report.wall_s:.2f}s "
        f"({eps:.2f} epochs/s, {report.events_per_sec:.2f} events/s)"
        + (f", {report.checkpoint_saves} checkpoints" if checkpointer is not None else "")
        + (" [PREEMPTED: drained + checkpointed]" if report.preempted else "")
    )
    if report.streaming:
        c = report.ingest_counters
        print(
            f"[serve] streaming ingest ({args.substrate_dtype} substrate, "
            f"batch={args.ingest_batch} x {args.ring_capacity} slots, "
            f"policy={args.ingest_policy}): {c.get('pushed_rows', 0)} rows staged, "
            f"{report.ring_drains} drains, blocked={c.get('blocked', 0)}, "
            f"shed={c.get('shed_rows', 0)}, spilled={c.get('spilled_rows', 0)}"
        )
    if args.report:
        payload = report.payload()
        if supervision is not None:
            payload["supervision"] = supervision
        with open(args.report, "w") as fh:
            json.dump(payload, fh, indent=1, sort_keys=True)
    # each distinct dispatched chunk length builds one program per visited
    # tier; supervised runs rebuild legitimately across reshards
    expected = max(len(report.scan_lengths), 1) * (report.growths + 1)
    if not args.supervise and report.superstep_traces > expected:
        print(
            f"[serve] WARNING: superstep re-built under churn ({report.superstep_traces} "
            f"programs for {expected} chunk-length x visited-tier combinations)"
        )
        return 1
    return 0


def _serve_queries_main(args, handler) -> int:
    """The single-query (``--queries 1``) and multi-tenant modes."""
    backbone = args.backbone or None
    if args.queries > 1:
        engine, _, _, qualities, _ = build_multi_server(
            args.objects, args.preds, args.queries, backbone, seed=args.seed,
            preds_per_query=args.preds_per_query, plan_shards=args.plan_shards,
            smoke=not args.full_width, device=args.device,
        )
        print(f"[serve] cascade qualities (AUC): {qualities}")
        report = serve_queries(engine, args.objects, args.epochs, handler)
        tf = [f"{x:.3f}" for x in report.true_f] if report.true_f else "n/a"
        eps = report.epochs / max(report.wall_s, 1e-9)
        print(
            f"[serve] {report.num_queries} queries x {report.epochs} epochs on "
            f"{engine.device}, cost={report.cost_spent:.4f}s-model "
            f"(requested {report.requested_cost:.4f}, dedup saved "
            f"{report.dedup_savings:.4f}), mean E(F1)={report.mean_expected_f:.3f}, "
            f"per-query E(F1)={[f'{x:.3f}' for x in report.expected_f]}, "
            f"true F1={tf}, wall={report.wall_s:.2f}s ({eps:.2f} epochs/s)"
        )
        return 0
    op, _, _, qualities = build_server(args.objects, args.preds, backbone, seed=args.seed,
                                       smoke=not args.full_width, device=args.device)
    print(f"[serve] cascade qualities (AUC): {qualities}")
    report = serve_query(op, args.objects, args.epochs, handler)
    eps = report.epochs / max(report.wall_s, 1e-9)
    print(
        f"[serve] {report.epochs} epochs on {op.device}, cost={report.cost_spent:.4f}s-model, "
        f"E(F1)={report.expected_f:.3f}, true F1={report.true_f1:.3f}, "
        f"wall={report.wall_s:.2f}s ({eps:.2f} epochs/s)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
