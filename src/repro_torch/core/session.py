"""Session-oriented engine core: churn as data updates on fixed-shape state.

Port of ``repro.core.session``.  ``EngineSession`` makes every churn axis a
masked, pre-allocated dimension:

* **capacity-padded substrate** — tensors are allocated at ``[capacity, P,
  F]``; a row-validity prefix (one device ``num_rows`` scalar) says which
  rows hold real objects, and ``ingest`` appends into the next free rows;
* **tenant slots** — ``max_tenants`` slots allocated up front; a slot is its
  conjunctive query's predicate-column mask plus an ``active`` bit;
* **cost ledger** — fair-share attribution of deduplicated spend;
* **capacity tiers** — with ``max_capacity > capacity`` an overflowing
  ingest migrates the state to the next geometric tier
  (``pad_session_state``, padded rows inert), so chunk programs are built
  at most once per tier and length (``retrace_bound``);
* **an attached bank** — ``bank=`` (the model-cascade bank) runs its
  ``execute`` on every epoch's merged plan inside the superstep; a ragged
  bank's missing levels open in the quarantine channel;
* **async event overlap** — ``SessionPipeline`` stages ingest / admit /
  retire events against host shadows of ``num_rows`` and ``active`` while
  earlier chunks are still running on the card: after one upfront read of
  the shadows no event and no dispatch synchronises the host with the
  device, and the pipeline waits once, chunk by chunk, in ``finish()``.

Event methods that take the host shadows (``num_rows=`` / ``active=``)
make no host sync on a CUDA state.  Two PyTorch idioms would sync, so they
are avoided: indexing with a host list (its index tensor is copied to the
card) and assigning a Python scalar to a single element (``t[i] = v``
copies a host scalar into a 0-d view); single elements are written as
one-element slices (``t[i:i + 1] = v``, a fill), and host outputs cross
through pinned memory with a non-blocking copy.

The session runs on the card unless ``device="cpu"`` is passed; without a
GPU and without an explicit ``"cpu"`` it raises.

Every event takes a state placed on a device mesh as well
(``durability.shard_session_state``): it runs on each rank's rows
(``core.shard_program``) and returns the state placed as it came; a tier
change gathers the state, pads it and places it again on the same mesh.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import ledger as ledger_lib
from repro_torch.core import shard_program
from repro_torch.core import state as state_lib
from repro_torch.core.errors import CapacityError, SlotActiveError, SlotsExhaustedError
from repro_torch.core.executor import (
    EngineConfig,
    EpochProgram,
    SessionDerived,
    SessionEpochStats,
    SessionState,
    resolve_substrate_dtype,
)
from repro_torch.core.query import CompiledQuery
from repro_torch.core.state import SharedSubstrate
from repro_torch.device import resolve_device


def tier_schedule(capacity: int, max_capacity: int, num_shards: int = 1) -> tuple:
    """Geometric capacity tiers ``capacity, 2c, 4c, ...`` covering
    ``max_capacity``, each rounded up to a multiple of ``num_shards``."""
    if capacity < 1:
        raise ValueError("capacity must be >= 1")
    if max_capacity < capacity:
        raise ValueError(f"max_capacity={max_capacity} < capacity={capacity}")

    def up(c: int) -> int:
        return -(-c // num_shards) * num_shards

    tiers = [up(capacity)]
    while tiers[-1] < max_capacity:
        tiers.append(up(min(2 * tiers[-1], max_capacity)))
    return tuple(tiers)


def pad_session_state(state: SessionState, capacity: int, prior: float) -> SessionState:
    """Migrate a full ``SessionState`` onto a larger row capacity.

    Pure data movement: every row-indexed leaf pads with the fill its
    allocator uses, so a grown state is bitwise indistinguishable from one
    allocated at the target capacity.  Callers refresh derived state after.
    """
    if capacity < state.capacity:
        raise ValueError(f"cannot shrink a session from {state.capacity} to {capacity} rows")
    if capacity == state.capacity:
        return state
    sub, der = state.substrate, state.derived
    return dataclasses.replace(
        state,
        substrate=SharedSubstrate(
            func_probs=state_lib.pad_rows(sub.func_probs, capacity, prior),
            exec_mask=state_lib.pad_rows(sub.exec_mask, capacity, False),
            cost_spent=sub.cost_spent,
        ),
        derived=SessionDerived(
            pred_prob=state_lib.pad_rows(der.pred_prob, capacity, 0.0),
            uncertainty=state_lib.pad_rows(der.uncertainty, capacity, 0.0),
            joint_prob=state_lib.pad_axis(der.joint_prob, capacity, 0.0, axis=1),
            in_answer=state_lib.pad_axis(der.in_answer, capacity, False, axis=1),
        ),
        bank_outputs=state_lib.pad_rows(state.bank_outputs, capacity, prior),
        ledger=ledger_lib.migrate_ledger(state.ledger, state.num_slots),
    )


def _host_rows(state: SessionState, num_rows: Optional[int]) -> int:
    """The host-known row count, else read from the device (a placed
    state's local replica)."""
    if num_rows is not None:
        return int(num_rows)
    return int(shard_program.local_view(state)[1].num_rows)


class EngineSession:
    """Long-lived multi-tenant PIQUE engine with churn-stable shapes."""

    def __init__(
        self,
        global_predicates: Sequence,  # the corpus schema (fixes the P axis)
        table,
        combine_params,
        costs,  # [P, F] over the global predicate space
        capacity: int,
        max_tenants: int,
        config: EngineConfig = EngineConfig(),
        max_capacity: Optional[int] = None,
        truth_masks: Optional[torch.Tensor] = None,  # [S, capacity] bool, metrics only
        device=None,
        bank=None,  # bank executed INSIDE the superstep (see executor)
    ):
        if config.num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        if config.num_shards > 1 and capacity % config.num_shards:
            raise ValueError(
                f"capacity={capacity} must divide evenly over num_shards={config.num_shards}"
            )
        if max_tenants < 1:
            raise ValueError("max_tenants must be >= 1")
        self.device = resolve_device(device)
        self.global_predicates = tuple(global_predicates)
        self.table = table.to(self.device)
        self.combine_params = combine_params.to(self.device)
        self.costs = torch.as_tensor(costs, dtype=torch.float32).to(self.device).contiguous()
        self.capacity = int(capacity)
        self.max_tenants = int(max_tenants)
        self.config = config
        self.substrate_dtype = resolve_substrate_dtype(config.substrate_dtype)
        self._tiers = tier_schedule(
            self.capacity,
            self.capacity if max_capacity is None else int(max_capacity),
            config.num_shards,
        )
        self.growths = 0
        if self.costs.shape[0] != len(self.global_predicates):
            raise ValueError(
                f"costs rows ({self.costs.shape[0]}) != global predicates "
                f"({len(self.global_predicates)})"
            )
        self._pred_index = {p: i for i, p in enumerate(self.global_predicates)}
        if truth_masks is not None:
            if self.max_capacity != self.capacity:
                raise ValueError(
                    "truth_masks require a fixed-capacity session (the [S, C] "
                    "truth rows cannot follow tier growth)"
                )
            truth_masks = torch.as_tensor(truth_masks).to(self.device)
        self.bank = bank
        self.program = EpochProgram(
            self.table, self.combine_params, self.costs, config, truth_masks=truth_masks,
            bank=bank,
        )

    @property
    def num_predicates(self) -> int:
        return len(self.global_predicates)

    @property
    def num_functions(self) -> int:
        return self.costs.shape[1]

    @property
    def superstep_traces(self) -> int:
        """Chunk programs built (1 per scan shape within a tier under churn)."""
        return self.program.superstep_traces

    @property
    def tier_capacities(self) -> tuple:
        return self._tiers

    @property
    def max_capacity(self) -> int:
        return self._tiers[-1]

    @property
    def retrace_bound(self) -> int:
        """Max programs built per distinct chunk length over ANY event trace."""
        return len(self._tiers)

    # ---- session lifecycle ---------------------------------------------------

    def _tier_for(self, rows: int, used: int = 0, requested: Optional[int] = None) -> int:
        for t in self._tiers:
            if rows <= t:
                return t
        raise CapacityError(
            f"{rows} rows exceeds capacity: the session's last tier holds "
            f"{self.max_capacity} (tiers {self._tiers}); open the session "
            "with a larger max_capacity for the expected arrival volume",
            used=used,
            capacity=self.max_capacity,
            requested=rows if requested is None else requested,
        )

    def _as_outputs(self, outputs) -> torch.Tensor:
        """THE quantization boundary: outputs land at the substrate dtype.

        Host outputs bound for the card cross through pinned memory with a
        non-blocking copy (the caching host allocator keeps the pinned block
        until the copy is done), so an ingest makes no host sync."""
        outputs = torch.as_tensor(outputs)
        if outputs.device != self.device:
            if self.device.type == "cuda" and outputs.device.type == "cpu":
                outputs = outputs.pin_memory().to(self.device, non_blocking=True)
            else:
                outputs = outputs.to(self.device)
        if outputs.dtype != self.substrate_dtype:
            outputs = outputs.to(self.substrate_dtype)
        if outputs.ndim != 3 or tuple(outputs.shape[1:]) != (
            self.num_predicates,
            self.num_functions,
        ):
            raise ValueError(
                f"bank outputs must be [M, {self.num_predicates}, "
                f"{self.num_functions}]; got {tuple(outputs.shape)}"
            )
        return outputs

    def init_state(self, bank_outputs) -> SessionState:
        """Open a session over an initial corpus of ``bank_outputs`` [N0, P, F]
        at the smallest tier that holds it; no tenants are active yet."""
        bank_outputs = self._as_outputs(bank_outputs)
        n0 = bank_outputs.shape[0]
        if n0 > self.max_capacity:
            raise CapacityError(
                f"initial corpus {n0} exceeds capacity {self.max_capacity} "
                f"(tiers {self._tiers})",
                used=0,
                capacity=self.max_capacity,
                requested=n0,
            )
        cap = self._tier_for(n0)
        p, s, dt, dev = self.num_predicates, self.max_tenants, self.substrate_dtype, self.device
        state = SessionState(
            substrate=state_lib.init_substrate(
                n0, p, self.num_functions, prior=self.config.prior, dtype=dt,
                capacity=cap, device=dev,
            ),
            derived=SessionDerived(  # placeholder; refresh fills it
                pred_prob=torch.zeros((cap, p), dtype=dt, device=dev),
                uncertainty=torch.zeros((cap, p), dtype=dt, device=dev),
                joint_prob=torch.zeros((s, cap), dtype=dt, device=dev),
                in_answer=torch.zeros((s, cap), dtype=torch.bool, device=dev),
            ),
            bank_outputs=state_lib.pad_rows(bank_outputs, cap, self.config.prior),
            pred_mask=torch.zeros((s, p), dtype=torch.bool, device=dev),
            active=torch.zeros(s, dtype=torch.bool, device=dev),
            num_rows=torch.tensor(n0, dtype=torch.int32, device=dev),
            ledger=ledger_lib.init_ledger(s, device=dev),
            quarantined=self._initial_quarantine(),
        )
        return self.program.refresh(state)

    def _initial_quarantine(self) -> torch.Tensor:
        """(pred, fn) pairs dead from birth: a ragged bank's missing levels
        (``bank.available == False``) enter the quarantine channel, so beyond
        their sentinel cost they are structurally unplannable."""
        q = torch.zeros((self.num_predicates, self.num_functions), dtype=torch.bool,
                        device=self.device)
        avail = getattr(self.bank, "available", None)
        if avail is not None:
            q = q | ~torch.as_tensor(avail, dtype=torch.bool).to(self.device)
        return q

    def _query_columns(self, query: CompiledQuery) -> list:
        if not query.is_conjunctive:
            raise NotImplementedError(
                "EngineSession slots are conjunctive predicate masks; general "
                "ASTs are not served by the session"
            )
        missing = [p for p in query.predicates if p not in self._pred_index]
        if missing:
            raise ValueError(
                f"query references {len(missing)} predicate(s) outside the "
                f"session's global space (num_predicates={self.num_predicates}): "
                f"{missing}; sessions are compiled over the corpus schema "
                "passed at construction"
            )
        return [self._pred_index[p] for p in query.predicates]

    def admit(
        self, state: SessionState, query: CompiledQuery, slot: Optional[int] = None, *, active=None
    ) -> tuple[SessionState, int]:
        """Admit a tenant into a free slot between supersteps -> (state, slot).

        Resets the slot's ledger accumulator (the previous occupant's bill is
        archived) and warm-starts derived state from the substrate.
        ``active`` may carry a host copy of ``state.active`` (else read from
        the device).
        """
        cols = self._query_columns(query)
        rows, state = shard_program.local_view(state)
        active_np = np.asarray(state.active.cpu() if active is None else active)
        if slot is None:
            free = np.flatnonzero(~active_np)
            if free.size == 0:
                raise SlotsExhaustedError(
                    f"no free tenant slots (max_tenants={self.max_tenants}); "
                    "retire a tenant or open the session with more slots",
                    used=int(active_np.sum()),
                    capacity=self.max_tenants,
                    requested=1,
                )
            slot = int(free[0])
        else:
            if not 0 <= slot < self.max_tenants:
                raise ValueError(f"slot {slot} out of range [0, {self.max_tenants})")
            if active_np[slot]:
                raise SlotActiveError(f"slot {slot} is already occupied; retire it first", slot=slot)
        pred_mask = state.pred_mask.clone()
        pred_mask[slot] = False
        for c in cols:  # one-element fills: no host index tensor, no 0-d copy
            pred_mask[slot, c:c + 1] = True
        act = state.active.clone()
        act[slot:slot + 1] = True
        state = dataclasses.replace(
            state, pred_mask=pred_mask, active=act, ledger=ledger_lib.reset_slot(state.ledger, slot)
        )
        return rows.place(self.program.refresh_rows(state, rows)), slot

    def retire(self, state: SessionState, slot: int, *, active=None) -> SessionState:
        """Retire a tenant slot between supersteps (mask bits off; its ledger
        row keeps the final bill until the slot is recycled)."""
        if not 0 <= slot < self.max_tenants:
            raise ValueError(f"slot {slot} out of range [0, {self.max_tenants})")
        rows, state = shard_program.local_view(state)
        occupied = bool(state.active[slot]) if active is None else bool(np.asarray(active)[slot])
        if not occupied:
            raise ValueError(f"slot {slot} is not active")
        pred_mask = state.pred_mask.clone()
        pred_mask[slot] = False
        act = state.active.clone()
        act[slot:slot + 1] = False
        state = dataclasses.replace(state, pred_mask=pred_mask, active=act)
        return rows.place(self.program.refresh_rows(state, rows))

    def refresh(self, state: SessionState) -> SessionState:
        """Recompute all derived state from the substrate + masks."""
        return self.program.refresh(state)

    # ---- degraded-mode enrichment (quarantine) -------------------------------

    def set_quarantine(self, state: SessionState, quarantined) -> SessionState:
        """Replace the [P, F] enrichment-function quarantine mask (gates only
        future plan selection; delivered enrichment stays)."""
        q = torch.as_tensor(quarantined, dtype=torch.bool).to(self.device)
        want = (self.num_predicates, self.num_functions)
        if tuple(q.shape) != want:
            raise ValueError(f"quarantine mask must be {want}; got {tuple(q.shape)}")
        rows, state = shard_program.local_view(state)
        return rows.place(dataclasses.replace(state, quarantined=q))

    def quarantine(self, state: SessionState, pred: int, func: int) -> SessionState:
        """Mask function ``func`` of predicate ``pred`` out of plan selection."""
        return self._set_pf(state, pred, func, True)

    def unquarantine(self, state: SessionState, pred: int, func: int) -> SessionState:
        """Re-admit a recovered enrichment function into plan selection."""
        return self._set_pf(state, pred, func, False)

    def _set_pf(self, state, pred: int, func: int, value: bool) -> SessionState:
        if not (0 <= pred < self.num_predicates and 0 <= func < self.num_functions):
            raise ValueError(
                f"(pred={pred}, func={func}) outside "
                f"[P={self.num_predicates}, F={self.num_functions}]"
            )
        rows, state = shard_program.local_view(state)
        q = state.quarantined.clone()
        q[pred, func:func + 1] = value
        return rows.place(dataclasses.replace(state, quarantined=q))

    def reshard(self, num_shards: int) -> "EngineSession":
        """A new session over the same world, planning across ``num_shards``.

        The elastic-restart building block: after ``ElasticPolicy`` shrinks
        the data axis, the supervisor opens the resharded session and
        restores the newest checkpoint onto it.  Sharded plan selection is
        exact, so answers stay bitwise the same.  Same table, parameters,
        costs, tiers, ``truth_masks``, bank and device; the new session
        builds its own chunk programs.
        """
        cfg = dataclasses.replace(self.config, num_shards=int(num_shards))
        return EngineSession(
            self.global_predicates,
            self.table,
            self.combine_params,
            self.costs,
            capacity=self.capacity,
            max_tenants=self.max_tenants,
            config=cfg,
            max_capacity=self._tiers[-1],
            truth_masks=self.program.truth_masks,
            device=self.device,
            bank=self.bank,
        )

    # ---- growth + ingest ------------------------------------------------------

    def _grow_padded(self, state: SessionState, min_rows: int, used: int) -> SessionState:
        """Tier migration without the derived-state refresh, for callers whose
        own tail refreshes anyway (``ingest``).  ``used`` is the host-known
        occupied row count: no device read here."""
        if min_rows <= state.capacity:
            return state
        target = self._tier_for(min_rows, used=used, requested=min_rows - used)
        self.growths += 1
        mesh = shard_program.mesh_of(state)
        if mesh is None:
            return pad_session_state(state, target, self.config.prior)
        # rows change owners: gather, pad, place on the same mesh (a rare event)
        grown = pad_session_state(shard_program.whole(state), target, self.config.prior)
        return shard_program.place_state(grown, mesh)

    def grow(
        self, state: SessionState, min_rows: int, *, num_rows: Optional[int] = None
    ) -> SessionState:
        """Migrate a live session to the smallest tier holding ``min_rows``
        (no-op when the current tier does), then refresh derived state once.

        Padded rows are inert and every accumulator carries over, so the
        next ``run`` builds one chunk program for the new tier.  Raises
        ``CapacityError`` past the last tier.  ``num_rows`` may carry the
        host-known row count (it only feeds the error payload); without it
        the count is read from the device.
        """
        if min_rows <= state.capacity:
            return state
        used = _host_rows(state, num_rows)
        return self.program.refresh(self._grow_padded(state, min_rows, used))

    def ingest(
        self, state: SessionState, outputs, *, num_rows: Optional[int] = None, refresh: bool = True
    ) -> SessionState:
        """Stream new objects into pre-allocated rows between supersteps.

        ``outputs`` is [M, P, F] tagging outputs of the new objects; their
        substrate rows start cold and join planning next epoch.  Overflowing
        the current tier grows the session; past the last tier raises
        ``CapacityError``.  ``num_rows`` may carry the host-known row count.
        """
        outputs = self._as_outputs(outputs)
        nr = _host_rows(state, num_rows)
        m = outputs.shape[0]
        if nr + m > self.max_capacity:
            raise CapacityError(
                f"ingest of {m} objects overflows capacity ({nr} rows used of "
                f"{state.capacity}, max_capacity={self.max_capacity}); open the "
                "session with a larger max_capacity for the expected arrival volume",
                used=nr,
                capacity=self.max_capacity,
                requested=m,
            )
        rows, state = shard_program.local_view(self._grow_padded(state, nr + m, nr))
        bank, new_rows = rows.ingest(state.bank_outputs, state.num_rows, outputs)
        state = dataclasses.replace(state, bank_outputs=bank, num_rows=new_rows)
        return rows.place(self.program.refresh_rows(state, rows) if refresh else state)

    # ---- driver --------------------------------------------------------------

    def run(
        self,
        state: SessionState,
        num_epochs: int,
        collect_masks: bool = False,
        stop_when_exhausted: bool = True,
        chunk_size: Optional[int] = None,
        on_chunk=None,
    ):
        """Run ``num_epochs`` supersteps as chunked dispatches -> (state, history)."""
        return self.program.run_scan(
            state,
            num_epochs,
            chunk_size=chunk_size,
            collect_masks=collect_masks,
            stop_when_exhausted=stop_when_exhausted,
            on_chunk=on_chunk,
        )

    def pipeline(
        self,
        state: SessionState,
        chunk_size: Optional[int] = None,
        preemption=None,
        heartbeat=None,
        boundary_hook=None,
    ) -> "SessionPipeline":
        """Open an async event pipeline over this session (one host read
        here, the shadow snapshot, then none until ``finish()``).
        ``preemption`` (a ``runtime.fault_tolerance.PreemptionHandler``) is
        polled at chunk boundaries; ``heartbeat`` beats worker 0 per
        dispatched chunk; ``boundary_hook`` (no-arg callable) fires once per
        dispatched chunk — the supervisor's fault clock."""
        return SessionPipeline(
            self, state, chunk_size=chunk_size,
            preemption=preemption, heartbeat=heartbeat, boundary_hook=boundary_hook,
        )


class SessionPipeline:
    """Overlap churn-event application with in-flight chunks.

    The lockstep loop waits at every boundary: ``run`` copies its stats to
    the host before the next event is looked at, and each event reads
    ``num_rows`` / ``active`` from the device.  The pipeline removes those
    waits:

    * chunks are enqueued on the current CUDA stream and never waited on;
      a CUDA event recorded after each chunk marks its completion;
    * events validate against host shadows of ``num_rows`` and ``active``
      (every event's effect on them is host-computable) and enqueue their
      data updates behind the in-flight chunks;
    * ``finish()`` waits on each chunk's event in dispatch order and copies
      its stats, so each completion time is that chunk's own.

    It enqueues the same chunk programs the lockstep path does, in the same
    order, so the result is bitwise the lockstep result and
    ``superstep_traces`` is unchanged.
    """

    def __init__(
        self,
        session: EngineSession,
        state: SessionState,
        chunk_size: Optional[int] = None,
        preemption=None,
        heartbeat=None,
        boundary_hook=None,
    ):
        self.session = session
        self.state = state
        self.chunk_size = chunk_size if chunk_size is not None else session.config.chunk_size
        self.preemption = preemption
        self.heartbeat = heartbeat
        self.boundary_hook = boundary_hook
        self.preempted = False  # a chunk-boundary poll saw should_stop
        # the pipeline's ONE upfront host read: the shadows
        local = shard_program.local_view(state)[1]
        self.num_rows = int(local.num_rows)
        self.active = local.active.cpu().numpy().copy()
        self._cuda = state.device.type == "cuda"
        self._chunks = []  # (epoch_base_within_run, length, stats, collect, done_event)
        self.epochs_dispatched = 0
        self.events_staged = 0  # churn events only (ingest / admit / retire / drains)
        self.stamps: list = []  # (wall_s, mean_active_expected_f) per epoch
        self._t0 = time.perf_counter()

    def run(self, num_epochs: int, collect_masks: bool = False) -> None:
        """Enqueue ``num_epochs`` supersteps as chunks (non-blocking).

        With a ``preemption`` handler, each chunk boundary polls
        ``should_stop``: once it is set no further chunk is dispatched
        (``preempted`` latches), so the stop is always at a superstep
        boundary.
        """
        prog = self.session.program
        base = 0
        for length in prog.chunk_lengths(num_epochs, self.chunk_size):
            if self.preemption is not None and self.preemption.should_stop:
                self.preempted = True
                break
            self.state, stats = prog.dispatch_scan(self.state, length, collect_masks)
            done = None
            if self._cuda:
                done = torch.cuda.Event()
                done.record()
            self._chunks.append((base, length, stats, collect_masks, done))
            base += length
            if self.heartbeat is not None:
                self.heartbeat.beat(0)
            if self.boundary_hook is not None:
                # may trip ``preemption`` so the NEXT poll stops dispatch here
                self.boundary_hook()
        self.epochs_dispatched += base

    def checkpoint(self, checkpointer, step: int, host_meta=None, force=True):
        """Snapshot the carry at this chunk boundary (the save waits for the
        in-flight chunks).  Stats stay queued for ``finish()`` and the
        shadows are untouched.  -> the checkpoint path, or None when the
        cadence said skip and ``force`` is False."""
        return checkpointer.maybe_save(self.state, step, host_meta=host_meta, force=force)

    def ingest(self, outputs) -> None:
        """Stage an ingest against the in-flight carry (bounds-checked and
        tier-grown from the host shadow; no sync)."""
        self.state = self.session.ingest(self.state, outputs, num_rows=self.num_rows)
        self.num_rows += int(outputs.shape[0])
        self.events_staged += 1

    def drain_ring(self, ring) -> int:
        """Drain a ``repro_torch.ingest.PendingRing`` into the in-flight carry:
        refresh-free ingests of every pending slot, one refresh at the end,
        bounds checks and growth off the host shadow.  -> rows drained."""
        self.state, self.num_rows, drained = ring.drain_into(
            self.session, self.state, self.num_rows
        )
        if drained:
            self.events_staged += 1
        return drained

    def admit(self, query: CompiledQuery, slot: Optional[int] = None) -> int:
        """Stage a tenant admission (slot chosen from the host shadow)."""
        self.state, slot = self.session.admit(self.state, query, slot=slot, active=self.active)
        self.active[slot] = True
        self.events_staged += 1
        return slot

    def retire(self, slot: int) -> None:
        """Stage a tenant retirement (validated against the host shadow)."""
        self.state = self.session.retire(self.state, slot, active=self.active)
        self.active[slot] = False
        self.events_staged += 1

    def finish(self) -> tuple:
        """Drain the pipeline -> (final state, history): wait on each chunk's
        event in dispatch order, copy its stats, stamp its completion time.
        The only place the pipeline waits for the card."""
        prog = self.session.program
        history: list[SessionEpochStats] = []
        for base, length, stats, collect, done in self._chunks:
            if done is not None:
                done.synchronize()  # THIS chunk's completion
            host = {k: v.cpu().numpy() for k, v in stats.items()}
            t_done = time.perf_counter() - self._t0
            chunk_hist = prog.materialize_history(
                [(length, host)],
                wall_per_epoch=t_done / max(self.epochs_dispatched, 1),
                collect_masks=collect,
                stop_when_exhausted=False,
                epoch_base=base,
            )
            for h in chunk_hist:
                self.stamps.append((t_done, h.mean_expected_f))
            history.extend(chunk_hist)
        if self._cuda:
            torch.cuda.synchronize(self.state.device)
        self._chunks = []
        return self.state, history
