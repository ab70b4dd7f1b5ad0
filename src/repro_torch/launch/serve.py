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
  driven by a scripted ingest/admit/retire/run arrival trace, lockstep.

Session mode has two enrichment banks:

* ``--bank simulated`` (default): precomputed AUC-calibrated outputs,
  ingest-capable::

    python -m repro_torch.launch.serve --session --objects 4096 --preds 4 \\
        --trace 'admit:2;admit:3;run:8;ingest:2048;admit:2;run:8;retire:0;run:8'

* ``--bank cascade``: the model-cascade bank (linear probe, MLP probe and a
  transformer backbone head per predicate) runs its real forwards on every
  epoch's merged plan; a fixed corpus, so no ingest.  ``--backbone`` picks
  the trunk (qwen3-1.7b, the default, or the attention-free mamba2-370m,
  whose SSD mixer runs through the intra-chunk kernel).  The backbone is the
  reference's reduced config unless ``--full-width`` asks for the published
  one::

    python -m repro_torch.launch.serve --session --bank cascade --device cpu
    python -m repro_torch.launch.serve --session --bank cascade \\
        --backbone mamba2-370m --device cpu

The single and multi-tenant modes use the cascade bank; ``--backbone ""``
drops its backbone level and ``--full-width`` builds it at the published
width, as for ``--session --bank cascade``.  Runs on the card by default
(``--device cuda``); ``--device cpu`` runs the plain PyTorch path.  The report's ``cost_hex``, ``bills_hex`` and
``answer_digest`` are the bitwise diff surface, as in the reference.
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

from repro_torch.configs.archs import get_config
from repro_torch.core.combine import auc_score, fit_combine_weights
from repro_torch.core.decision_table import learn_decision_table
from repro_torch.core.executor import EngineConfig, SessionState
from repro_torch.core.metrics import true_f_alpha
from repro_torch.core.multi_query import MultiQueryConfig, MultiQueryEngine, build_query_set
from repro_torch.core.operator import OperatorConfig, ProgressiveQueryOperator
from repro_torch.core.query import Predicate, conjunction
from repro_torch.core.session import EngineSession
from repro_torch.data.synthetic import make_corpus, split_corpus, truth_answer_mask
from repro_torch.device import resolve_device
from repro_torch.enrich.cascade import ModelCascadeBank, build_cascade_suite, train_level
from repro_torch.models.config import ModelConfig

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
):
    """Long-lived serving session over a simulated corpus.

    Offline phase on the target device: draw the corpus, fit the combine
    weights and learn the decision table on a training split, then open the
    session over ``num_objects`` rows.  -> (session, state, ingest_pool,
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
        selectivity=[0.3] * num_preds, aucs=SESSION_AUCS, costs=SESSION_COSTS,
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
    target_expected_f: Optional[float] = None,
) -> ServeReport:
    """Progressive evaluation with early termination (pay-as-you-go)."""
    state = op.init_state(num_objects)
    t0 = time.perf_counter()
    history = []
    sel = None
    for e in range(epochs):
        state, sel, plan, _ = op.run_epoch(state)
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
    target_expected_f: Optional[float] = None,
) -> MultiServeReport:
    """Multi-tenant progressive evaluation: lockstep epochs over Q queries;
    ``target_expected_f`` stops once the MEAN per-query E(F) reaches it."""
    state = engine.init_state(num_objects)
    t0 = time.perf_counter()
    history = []
    requested = 0.0
    for e in range(epochs):
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
    chunk_size: Optional[int] = None
    num_events: int = 0
    events_per_sec: float = 0.0
    cost_hex: str = ""  # float.hex of cost_spent (bitwise-diffable)
    bills_hex: list = dataclasses.field(default_factory=list)  # [S] invoice hex
    answer_digest: str = ""  # sha256 over in_answer[:, :num_rows] (tier-free)
    scan_lengths: list = dataclasses.field(default_factory=list)
    substrate_dtype: str = "float32"
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


def serve_session_trace(
    session: EngineSession,
    state: SessionState,
    events: list,  # [(kind, arg)] from parse_trace
    pool=None,  # [R, P, F] outputs available to ingest events
    preds=None,  # schema predicates, for admit events
    seed: int = 0,
    chunk_size: Optional[int] = None,
    on_chunk=None,
) -> SessionServeReport:
    """Drive a scripted arrival trace through one session, lockstep.

    Admit events draw their predicate subsets from ``np.random.default_rng
    (seed)`` exactly as the reference does, so both serve the same tenants.
    ``on_chunk(state, epochs_done)`` is called after each dispatched chunk
    of a run event (``EngineSession.run``'s hook; its return is ignored).
    """
    rng = np.random.default_rng(seed)
    pool_off = 0
    history = []
    scan_lengths: set = set()
    t0 = time.perf_counter()
    for kind, arg in events:
        if kind == "run":
            prev = [0]

            def record(carry, done, _prev=prev):
                scan_lengths.add(done - _prev[0])
                _prev[0] = done
                if on_chunk is not None:
                    on_chunk(carry, done)
                return False

            state, h = session.run(
                state, arg, stop_when_exhausted=False, chunk_size=chunk_size, on_chunk=record
            )
            history.extend(h)
        elif kind == "admit":
            if preds is None:
                raise ValueError("admit events need the schema predicates")
            k = min(max(1, arg), len(preds))
            cols = sorted(rng.choice(len(preds), size=k, replace=False))
            state, _ = session.admit(state, conjunction(*[preds[c] for c in cols]))
        elif kind == "ingest":
            if pool is None or pool_off + arg > pool.shape[0]:
                raise ValueError(
                    f"ingest of {arg} exceeds the remaining pool "
                    f"({0 if pool is None else pool.shape[0] - pool_off})"
                )
            state = session.ingest(state, pool[pool_off:pool_off + arg])
            pool_off += arg
        else:  # retire
            state = session.retire(state, arg)
    if state.device.type == "cuda":
        torch.cuda.synchronize(state.device)
    wall = time.perf_counter() - t0
    last = history[-1] if history else None
    num_rows = int(state.num_rows)
    answers = np.ascontiguousarray(state.derived.in_answer[:, :num_rows].cpu().numpy())
    bills = state.ledger.bills(state.cost_spent)
    cost = float(state.cost_spent)
    return SessionServeReport(
        epochs=len(history),
        events=[dict(kind=k, arg=a) for k, a in events],
        cost_spent=cost,
        mean_expected_f=last.mean_expected_f if last else 0.0,
        active_tenants=int(state.active.sum()),
        num_rows=num_rows,
        attributed=[float(x) for x in state.ledger.attributed.cpu()],
        unattributed=float(state.ledger.unattributed),
        superstep_traces=session.superstep_traces,
        wall_s=wall,
        history=history,
        capacity=state.capacity,
        max_capacity=session.max_capacity,
        growths=session.growths,
        retrace_bound=session.retrace_bound,
        chunk_size=chunk_size,
        num_events=len(events),
        events_per_sec=len(events) / max(wall, 1e-9),
        cost_hex=cost.hex(),
        bills_hex=[float(b).hex() for b in bills],
        answer_digest=hashlib.sha256(answers.tobytes()).hexdigest(),
        scan_lengths=sorted(scan_lengths),
        substrate_dtype=session.config.substrate_dtype,
        device=str(state.device),
        state=state,
    )


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
    ap.add_argument("--backbone", default="qwen3-1.7b",
                    help="cascade backbone architecture: qwen3-1.7b or mamba2-370m ('' for "
                         "probes only)")
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
    ap.add_argument("--chunk-size", type=int, default=None,
                    help="epochs per dispatched chunk (bitwise inert)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' (default) raises when no GPU is present")
    ap.add_argument("--report", default=None, help="write the serve report as JSON")
    args = ap.parse_args(argv)
    if not args.session:
        return _serve_queries_main(args)

    e = max(args.epochs // 4, 1)
    if args.bank == "cascade":
        if args.max_capacity is not None or args.capacity is not None:
            ap.error("--bank cascade serves a fixed corpus: no --capacity / --max-capacity")
        if args.trace and any(k == "ingest" for k, _ in parse_trace(args.trace)):
            ap.error("--bank cascade serves a fixed corpus; drop ingest events from --trace")
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
    report = serve_session_trace(
        session, state, events, pool=pool, preds=preds, seed=args.seed,
        chunk_size=args.chunk_size,
    )
    eps = report.epochs / max(report.wall_s, 1e-9)
    bills = {i: f"{c:.3f}" for i, c in enumerate(report.attributed) if c > 0}
    print(
        f"[serve] session trace {spec!r} on {report.device} (chunk={args.chunk_size}): "
        f"{report.epochs} epochs, {report.num_rows} rows (tier {report.capacity} of "
        f"{report.max_capacity} max, {report.growths} growths), "
        f"{report.active_tenants} active tenants, cost={report.cost_spent:.4f}s-model, "
        f"mean E(F1)={report.mean_expected_f:.3f}, ledger={bills} "
        f"(+{report.unattributed:.4f} unattributed), "
        f"superstep traces={report.superstep_traces}, wall={report.wall_s:.2f}s "
        f"({eps:.2f} epochs/s)"
    )
    if args.report:
        with open(args.report, "w") as fh:
            json.dump(report.payload(), fh, indent=1, sort_keys=True)
    # each distinct dispatched chunk length builds one program per visited tier
    expected = max(len(report.scan_lengths), 1) * (report.growths + 1)
    if report.superstep_traces > expected:
        print(
            f"[serve] WARNING: superstep re-built under churn ({report.superstep_traces} "
            f"programs for {expected} chunk-length x visited-tier combinations)"
        )
        return 1
    return 0


def _serve_queries_main(args) -> int:
    """The single-query (``--queries 1``) and multi-tenant modes."""
    backbone = args.backbone or None
    if args.queries > 1:
        engine, _, _, qualities, _ = build_multi_server(
            args.objects, args.preds, args.queries, backbone, seed=args.seed,
            preds_per_query=args.preds_per_query, plan_shards=args.plan_shards,
            smoke=not args.full_width, device=args.device,
        )
        print(f"[serve] cascade qualities (AUC): {qualities}")
        report = serve_queries(engine, args.objects, args.epochs)
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
    report = serve_query(op, args.objects, args.epochs)
    eps = report.epochs / max(report.wall_s, 1e-9)
    print(
        f"[serve] {report.epochs} epochs on {op.device}, cost={report.cost_spent:.4f}s-model, "
        f"E(F1)={report.expected_f:.3f}, true F1={report.true_f1:.3f}, "
        f"wall={report.wall_s:.2f}s ({eps:.2f} epochs/s)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
