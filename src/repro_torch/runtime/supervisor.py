"""Supervised serving: failure detection -> elastic restore -> bitwise resume.

The ``Supervisor`` owns the serve loop and closes the loop the runtime
pieces left dangling: ``Heartbeat`` detects dead workers, ``ElasticPolicy``
decides the shrunken mesh, ``core.durability`` restores the newest complete
checkpoint onto it, and the host-shadowed event cursor replays the trace —
with answers, spend, and per-tenant bills **byte-equal** to an uninterrupted
control run (sharded plan selection is exact and restore re-pads inertly, so
recovery is bitwise, not merely close).

State machine (one monotone pass per incident, logged in ``transitions``)::

    healthy ──failure detected──▶ draining ──drained + force-saved──▶
    restoring ──restored──▶ healthy            (no quarantine active)
                          └─▶ degraded         (quarantined functions remain)

* **healthy** — serving; every chunk boundary ticks the fault clock, beats
  live workers, feeds the straggler monitor.
* **draining** — an intervention tripped the preemption flag; in-flight
  chunks drain and the state force-saves at that superstep boundary.
* **restoring** — the supervisor reshards (worker death), restores the
  checkpoint, re-applies the quarantine mask, and re-enters the trace at
  the saved event cursor.
* **degraded** — serving with one or more enrichment functions quarantined:
  answers keep improving from the surviving functions; the ledger bills
  nothing for the masked work.

Enrichment failures run through a per-function circuit breaker: the first
injected raise opens it (quarantine — a pure data update on the scan carry),
then probes retry on exponential backoff (``backoff_base * 2^k`` boundaries);
a probe landing after the fault window closes the breaker (un-quarantine),
while ``max_retries`` failed probes make the quarantine permanent.  Only
breaker *transitions* cost a drain/restore cycle; failed probes are host
bookkeeping.

Faults come from a deterministic ``runtime.chaos.FaultPlan`` (or real worker
silence when driven by actual heartbeats); recovery latency is measured from
detection to the first post-restore chunk dispatch.

Port of ``repro.runtime.supervisor``: the same state machine, breaker and
``summary()`` keys.  The resharded session and the restored state live on
the supervised session's device; with ``mesh=`` every restore places the
state on that same mesh (the session runs it as a per-rank program), so a
worker death reshards the plan shards and keeps the mesh.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.core.durability import (
    SessionCheckpointer,
    restore_session_checkpoint,
)
from repro_torch.runtime.chaos import FaultPlan
from repro_torch.runtime.fault_tolerance import (
    ElasticPolicy,
    Heartbeat,
    PreemptionHandler,
    StragglerMonitor,
)

__all__ = ["Supervisor", "SupervisorConfig", "SupervisedStop"]


@dataclasses.dataclass
class SupervisorConfig:
    heartbeat_timeout: float = 2.0  # boundaries of silence before failure
    max_retries: int = 3  # failed probes before permanent quarantine
    backoff_base: int = 1  # boundaries before the first retry probe
    max_restarts: int = 8  # drain/restore cycles before giving up
    checkpoint_every: int = 4  # scan-chunk boundaries per cadence save
    checkpoint_keep: int = 3
    straggler_factor: float = 1.5  # EMA multiple that flags a straggler
    step_time_base: float = 1.0  # synthetic per-boundary shard step time


class SupervisedStop(PreemptionHandler):
    """OR of the external (signal) handler and supervisor interventions.

    The serve loop polls one ``should_stop``; the supervisor distinguishes
    afterwards: an external stop ends the run preempted (the normal SIGTERM
    drain/save/exit contract), an intervention stop enters the
    draining -> restoring arc.
    """

    def __init__(self, external: Optional[PreemptionHandler] = None):
        super().__init__()
        self.external = external

    @property
    def should_stop(self) -> bool:
        return self.external_stop or self._requested

    @property
    def external_stop(self) -> bool:
        return self.external is not None and self.external.should_stop

    def clear(self):
        self._requested = False


_CLOSED, _OPEN, _PERMANENT = "closed", "open", "permanent"


@dataclasses.dataclass
class _Breaker:
    """Per-(pred, func) enrichment circuit breaker (host bookkeeping)."""

    failures: int = 0
    next_probe: int = 0  # boundary of the next backoff probe
    state: str = _CLOSED

    @property
    def masked(self) -> bool:
        return self.state in (_OPEN, _PERMANENT)


class Supervisor:
    """Owns the serve loop; composes detection, shrink, restore, resume.

    Workers are plan shards (worker i plans object shard i); the fault
    clock is the chunk-boundary count, monotone across restarts, which also
    drives the (injectable-clock) ``Heartbeat`` — so chaos runs are fully
    deterministic and CI can byte-diff recovery against a control run.
    """

    def __init__(
        self,
        session,
        state,
        events: list,  # [(kind, arg)] from launch.serve.parse_trace
        pool=None,
        preds=None,
        checkpoint_dir=None,
        seed: int = 0,
        fault_plan: Optional[FaultPlan] = None,
        config: Optional[SupervisorConfig] = None,
        external: Optional[PreemptionHandler] = None,
        chunk_size: Optional[int] = None,
        overlap: bool = False,
        mesh=None,  # the device mesh every restore places the state on
    ):
        if checkpoint_dir is None:
            raise ValueError(
                "the supervisor needs a checkpoint_dir: recovery restores "
                "the newest complete checkpoint"
            )
        self.session = session
        self.state = state
        self.events = events
        self.pool = pool
        self.preds = preds
        self.seed = seed
        self.dir = checkpoint_dir
        self.plan = fault_plan if fault_plan is not None else FaultPlan([])
        self.cfg = config if config is not None else SupervisorConfig()
        self.chunk_size = chunk_size
        self.overlap = overlap
        self.mesh = mesh
        self._stop = SupervisedStop(external)

        self.num_workers = int(session.config.num_shards)
        self.boundary = 0  # the fault clock: chunk boundaries ever seen
        self._init_workers(self.num_workers)
        self.state_name = "healthy"
        self.transitions: list = []  # [boundary, from, to, reason]
        self.restarts = 0
        self.shrinks: list = []  # [from_shards, to_shards]
        self.failed_log: list = []  # worker ids declared failed (pre-shrink ids)
        self.restored_steps: list = []
        self.recovery_latency_s: list = []
        self.rebalances: list = []  # advisory straggler repartitions
        self.recovered: list = []  # [pred, func] un-quarantined after probes
        self.breakers: dict = {}  # (pred, func) -> _Breaker
        self._pending_failed: set = set()
        self._pending_reason: Optional[str] = None
        self._killed: set = set()
        self._detect_t: Optional[float] = None
        self._await_first_chunk = False
        self._last_stragglers: list = []
        self._saves_prior = 0
        self.checkpointer = self._new_checkpointer()

    # ---- worker-set lifecycle ---------------------------------------------

    def _clock(self) -> float:
        return float(self.boundary)

    def _init_workers(self, num_workers: int):
        self.heartbeat = Heartbeat(
            num_workers, timeout_s=self.cfg.heartbeat_timeout, clock=self._clock
        )
        self.monitor = StragglerMonitor(num_workers)
        self.policy = ElasticPolicy(data_axis=num_workers, model_axis=1)

    def _new_checkpointer(self) -> SessionCheckpointer:
        return SessionCheckpointer(
            self.session,
            self.dir,
            every=self.cfg.checkpoint_every,
            keep=self.cfg.checkpoint_keep,
        )

    def _transition(self, to: str, reason: str):
        self.transitions.append([self.boundary, self.state_name, to, reason])
        self.state_name = to

    def _request(self, reason: str):
        """Trip the stop flag once per incident; serve drains + force-saves
        at the boundary that tripped it."""
        if self._pending_reason is None:
            self._pending_reason = reason
            self._detect_t = time.perf_counter()
            self._transition("draining", reason)
            self._stop.request()

    # ---- the fault clock ---------------------------------------------------

    def _on_boundary(self):
        """One tick per dispatched scan chunk (both serve modes).

        Order matters: arrivals land first (a killed worker misses THIS
        beat), live workers beat and feed the monitor, breaker probes run,
        and only then is failure detection evaluated — so detection sees
        this boundary's silence.
        """
        self.boundary += 1
        b = self.boundary
        if self._await_first_chunk:
            # first post-restore chunk dispatched: recovery is complete
            self.recovery_latency_s.append(time.perf_counter() - self._detect_t)
            self._await_first_chunk = False
            self._detect_t = None
            self._pending_reason = None

        for ev in self.plan.due(b):
            if ev.kind == "kill":
                if ev.worker is not None and ev.worker < self.num_workers:
                    self._killed.add(ev.worker)
            else:  # raise onset: open the breaker (quarantine transition)
                self._open_breaker(ev.pred, ev.func, b)

        for w in range(self.num_workers):
            if w in self._killed or self.plan.silenced(w, b):
                continue
            self.heartbeat.beat(w)
            self.monitor.record(
                w, self.cfg.step_time_base * self.plan.slow_factor(w, b)
            )

        self._probe_breakers(b)
        self._check_stragglers(b)

        failed = self.heartbeat.failed_workers()
        if failed:
            self._pending_failed.update(failed)
            self._request(f"worker_failure:{sorted(failed)}")

    # ---- enrichment circuit breakers --------------------------------------

    def _open_breaker(self, pred: int, func: int, boundary: int):
        br = self.breakers.setdefault((pred, func), _Breaker())
        if br.state != _CLOSED:
            return
        br.state = _OPEN
        br.failures = 1
        br.next_probe = boundary + self.cfg.backoff_base
        self._request(f"enrichment_failure:p{pred}.f{func}")

    def _probe_breakers(self, boundary: int):
        for (pred, func), br in self.breakers.items():
            if br.state != _OPEN or boundary < br.next_probe:
                continue
            if self.plan.raising(pred, func, boundary):
                br.failures += 1
                if br.failures > self.cfg.max_retries:
                    # permanent quarantine: the mask is already set, so no
                    # drain/restore cycle — just stop probing
                    br.state = _PERMANENT
                else:
                    br.next_probe = boundary + self.cfg.backoff_base * (
                        2 ** (br.failures - 1)
                    )
            else:
                br.state = _CLOSED
                self.recovered.append([pred, func])
                self._request(f"enrichment_recovered:p{pred}.f{func}")

    def _quarantine_mask(self) -> np.ndarray:
        mask = np.zeros(
            (self.session.num_predicates, self.session.num_functions), bool
        )
        for (pred, func), br in self.breakers.items():
            if br.masked:
                mask[pred, func] = True
        return mask

    def quarantined_pairs(self) -> list:
        return [
            [p, f] for (p, f), br in sorted(self.breakers.items()) if br.masked
        ]

    # ---- straggler advisory ------------------------------------------------

    def _check_stragglers(self, boundary: int):
        if self.num_workers < 2:
            return
        strag = self.monitor.stragglers(self.cfg.straggler_factor)
        if strag and strag != self._last_stragglers:
            self.rebalances.append(
                dict(
                    boundary=boundary,
                    stragglers=strag,
                    ranges=self.monitor.rebalance_objects(
                        int(self.session.capacity)
                    ),
                )
            )
        self._last_stragglers = strag

    # ---- recovery ----------------------------------------------------------

    def _recover(self) -> dict:
        """draining -> restoring -> (healthy | degraded); -> resume meta."""
        reason = self._pending_reason or "intervention"
        self._transition("restoring", reason)
        self.restarts += 1
        if self.restarts > self.cfg.max_restarts:
            raise RuntimeError(
                f"supervisor exceeded max_restarts={self.cfg.max_restarts} "
                f"(last incident: {reason})"
            )
        if self._pending_failed:
            failed = sorted(self._pending_failed)
            self.failed_log.extend(failed)
            healthy = self.num_workers - len(
                set(failed) | {w for w in self._killed}
            )
            new_shards, _ = self.policy.shrink_for_failures(healthy)
            self.shrinks.append([self.num_workers, new_shards])
            self._saves_prior += self.checkpointer.saves
            self.session = self.session.reshard(new_shards)
            # surviving workers renumber 0..new_shards-1 on the new mesh;
            # later fault-plan events target the NEW numbering
            self.num_workers = new_shards
            self._killed = set()
            self._pending_failed = set()
            self._init_workers(new_shards)
            self.checkpointer = self._new_checkpointer()
        state, step, extra = restore_session_checkpoint(self.session, self.dir, mesh=self.mesh)
        self.restored_steps.append(step)
        resume = extra.get("host")
        if resume is None:
            raise RuntimeError(
                "checkpoint has no serve host metadata; the supervisor can "
                "only resume serve_session_trace checkpoints"
            )
        # re-apply the breaker view of quarantine on top of the restored
        # bits: the checkpoint predates the transition that tripped this
        # incident (pure data update; no refresh, no retrace)
        self.state = self.session.set_quarantine(state, self._quarantine_mask())
        self._await_first_chunk = True
        self._transition(
            "degraded" if any(br.masked for br in self.breakers.values())
            else "healthy",
            f"restored:step_{step}",
        )
        return resume

    # ---- the supervised serve loop ----------------------------------------

    def serve(self):
        """Run the trace to completion under supervision -> final report.

        Each pass serves until the trace completes or an intervention (or a
        real external preemption) drains it; interventions recover and
        re-enter at the saved event cursor.  The returned report is the
        final pass's ``SessionServeReport`` — its digests are the byte-diff
        surface against an uninterrupted control run.
        """
        from repro_torch.launch.serve import serve_session_trace

        resume = None
        while True:
            self._stop.clear()
            report = serve_session_trace(
                self.session,
                self.state,
                self.events,
                pool=self.pool,
                preds=self.preds,
                seed=self.seed,
                preemption=self._stop,
                overlap=self.overlap,
                chunk_size=self.chunk_size,
                checkpointer=self.checkpointer,
                resume=resume,
                boundary_hook=self._on_boundary,
            )
            if not report.preempted:
                if self.state_name == "draining":
                    # the incident tripped on the trace's final boundary;
                    # nothing is left to replay
                    self._transition("healthy", "trace_complete")
                return report
            if self._stop.external_stop:
                # a real preemption: the drain/force-save already happened;
                # exit with the preempted report (restart resumes durably)
                self._transition("preempted", "external_stop")
                return report
            resume = self._recover()

    def summary(self) -> dict:
        """JSON-able supervision block for ``--report`` / CI assertions."""
        return dict(
            supervised=True,
            final_state=self.state_name,
            boundaries=self.boundary,
            restarts=self.restarts,
            plan_shards=self.num_workers,
            shrinks=[list(s) for s in self.shrinks],
            failed_workers=list(self.failed_log),
            quarantined=self.quarantined_pairs(),
            recovered=[list(r) for r in self.recovered],
            function_failures={
                f"p{p}.f{f}": br.failures
                for (p, f), br in sorted(self.breakers.items())
            },
            transitions=[list(t) for t in self.transitions],
            rebalances=self.rebalances,
            restored_steps=list(self.restored_steps),
            recovery_latency_s=list(self.recovery_latency_s),
            checkpoint_saves_total=self._saves_prior + self.checkpointer.saves,
        )
