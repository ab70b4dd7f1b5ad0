"""Pending-row ring: device-resident staging between arrival and drain.

Port of ``repro.ingest.ring``.  ``PendingRing`` holds arriving
micro-batches in a preallocated ``[K, B, P, F]`` device tensor at the
session's substrate dtype:

* ``push`` copies one micro-batch into the next free slot in place
  (``buf[slot, :m].copy_(batch)``, where the reference donates the buffer to
  a jitted ``dynamic_update_slice``): no copy of K slots per arrival and no
  host sync, since occupancy lives in host shadows;
* ``drain_into`` replays every pending slot into an ``EngineSession`` as
  refresh-free ingests and refreshes derived state once, bitwise the same
  as ingesting each batch directly (refresh is idempotent w.r.t. the
  substrate).

Backpressure, a full ring at ``push`` time, is resolved by policy:

* ``"block"``  raise the typed ``IngestBackpressure``; the caller drains
  and retries.  Lossless, ordered.
* ``"shed"``   drop the INCOMING batch and count it.  Lossy.
* ``"spill"``  queue the batch host-side (pinned memory, filled by a
  non-blocking copy) and count it; drains move spilled batches into freed
  slots FIFO before new pushes land, so arrival order holds.  Lossless.

Every counter is host-side bookkeeping: reading one never touches the
device.
"""

from __future__ import annotations

from collections import deque

import torch

from repro_torch.core.errors import CapacityError, IngestBackpressure, SubstrateDtypeError

_POLICIES = ("block", "shed", "spill")


class PendingRing:
    """Bounded FIFO of pending ingest micro-batches on the session's device.

    ``slot_rows`` is the capacity B of each of ``num_slots`` slots; a pushed
    batch may be SHORTER than B (a stream's trailing batch): the slot's
    host-side fill count says how many rows are real.  Shapes (P, F), dtype
    and device come from the session.
    """

    def __init__(self, session, *, slot_rows: int, num_slots: int, policy: str = "block"):
        if policy not in _POLICIES:
            raise ValueError(f"policy must be one of {_POLICIES}, got {policy!r}")
        if slot_rows < 1 or num_slots < 1:
            raise ValueError(
                f"need slot_rows >= 1 and num_slots >= 1, got ({slot_rows}, {num_slots})"
            )
        self.session = session
        self.slot_rows = int(slot_rows)
        self.num_slots = int(num_slots)
        self.policy = policy
        self.device = session.device
        p, f = session.num_predicates, session.num_functions
        self._buf = torch.zeros(
            (self.num_slots, self.slot_rows, p, f), dtype=session.substrate_dtype,
            device=self.device,
        )
        # host shadows of occupancy: FIFO position + per-slot fill counts
        self._head = 0  # oldest pending slot
        self._count = 0  # pending slots
        self._fill = [0] * self.num_slots  # real rows per slot
        self._spilled: deque = deque()  # host-side overflow (policy="spill")
        self.counters = {
            "pushed_batches": 0,
            "pushed_rows": 0,
            "drained_batches": 0,
            "drained_rows": 0,
            "shed_batches": 0,
            "shed_rows": 0,
            "spilled_batches": 0,
            "spilled_rows": 0,
            "blocked": 0,
        }

    # ---- occupancy (host shadows, never a device read) ----------------------

    @property
    def occupied(self) -> int:
        """Pending slots awaiting a drain."""
        return self._count

    @property
    def free_slots(self) -> int:
        return self.num_slots - self._count

    @property
    def pending_rows(self) -> int:
        """Rows parked on the device (spilled host-side rows not included)."""
        return sum(self._fill[(self._head + i) % self.num_slots] for i in range(self._count))

    @property
    def spilled_pending(self) -> int:
        """Host-side batches waiting for freed slots (policy="spill")."""
        return len(self._spilled)

    # ---- producer side -------------------------------------------------------

    def _validate(self, batch: torch.Tensor) -> None:
        shape = tuple(batch.shape)
        p, f = self.session.num_predicates, self.session.num_functions
        if len(shape) != 3 or shape[1:] != (p, f) or not 1 <= shape[0] <= self.slot_rows:
            raise ValueError(
                f"ring batch must be [1..{self.slot_rows}, {p}, {f}]; got {list(shape)}"
            )
        if batch.dtype.is_floating_point and batch.dtype != self._buf.dtype:
            raise SubstrateDtypeError(
                f"ring stores {self._buf.dtype} but push got {batch.dtype}; "
                "quantize at the staging buffer (IngestStream does)",
                expected=str(self._buf.dtype),
                got=str(batch.dtype),
                where="PendingRing.push",
            )

    def _enqueue(self, batch: torch.Tensor) -> None:
        """Copy into the next free slot (the caller guarantees one exists).
        Rows past ``m`` keep stale data; the fill shadow keeps them out of
        every drain."""
        m = batch.shape[0]
        slot = (self._head + self._count) % self.num_slots
        self._buf[slot, :m].copy_(batch, non_blocking=True)
        self._fill[slot] = m
        self._count += 1
        self.counters["pushed_batches"] += 1
        self.counters["pushed_rows"] += m

    def _spill(self, batch: torch.Tensor) -> torch.Tensor:
        """A host copy of ``batch``: pinned and filled by a non-blocking copy
        for a card batch (no sync; its later refill copy runs on the same
        stream, after this one), a clone for a CPU batch."""
        if batch.device.type == "cuda":
            host = torch.empty(batch.shape, dtype=batch.dtype, pin_memory=True)
            return host.copy_(batch, non_blocking=True)
        return batch.clone()

    def push(self, batch) -> bool:
        """Stage one micro-batch; True if it landed in the ring (or spilled),
        False if the shed policy dropped it.

        ``batch`` is [m <= slot_rows, P, F] at the substrate dtype (a host
        batch is fine; ``IngestStream`` ships it ahead on a side stream).
        Mixed-float input raises ``SubstrateDtypeError``.
        """
        batch = torch.as_tensor(batch)
        self._validate(batch)
        m = int(batch.shape[0])
        if self.policy == "spill" and (self._count == self.num_slots or self._spilled):
            # order preservation: once anything is spilled, EVERYTHING spills
            # until the queue has drained back into slots
            self._spilled.append(self._spill(batch))
            self.counters["spilled_batches"] += 1
            self.counters["spilled_rows"] += m
            return True
        if self._count == self.num_slots:
            if self.policy == "shed":
                self.counters["shed_batches"] += 1
                self.counters["shed_rows"] += m
                return False
            self.counters["blocked"] += 1
            raise IngestBackpressure(
                f"pending-row ring is full ({self._count}/{self.num_slots} "
                f"slots); drain into the session and retry",
                occupied=self._count,
                capacity=self.num_slots,
                requested=m,
                policy=self.policy,
            )
        self._enqueue(batch)
        return True

    # ---- consumer side -------------------------------------------------------

    def drain_into(self, session, state, num_rows: int):
        """Apply every pending slot to ``state`` in arrival order ->
        ``(state, num_rows, drained_rows)``.

        Each slot lands as a refresh-free ``session.ingest`` of a view of
        the ring; ONE refresh recomputes derived state at the end.  No host
        sync: bounds checks and tier growth run off the ``num_rows`` shadow.
        Spilled batches re-enter freed slots FIFO and drain in the same
        pass.

        All-or-nothing: capacity is checked against the TOTAL pending rows
        (ring + spill queue) before any slot is applied, so a
        ``CapacityError`` leaves the shadows, the spill queue and ``state``
        untouched.
        """
        total = self.pending_rows + sum(int(b.shape[0]) for b in self._spilled)
        if num_rows + total > session.max_capacity:
            raise CapacityError(
                f"draining {total} pending rows overflows capacity "
                f"({num_rows} rows used, max_capacity="
                f"{session.max_capacity}); nothing was applied — shrink the "
                "backlog or open the session with a larger max_capacity",
                used=num_rows,
                capacity=session.max_capacity,
                requested=total,
            )
        drained = 0
        while self._count or self._spilled:
            while self._count:
                slot = self._head
                m = self._fill[slot]
                state = session.ingest(state, self._buf[slot, :m], num_rows=num_rows,
                                       refresh=False)
                num_rows += m
                drained += m
                self._fill[slot] = 0
                self._head = (self._head + 1) % self.num_slots
                self._count -= 1
                self.counters["drained_batches"] += 1
                self.counters["drained_rows"] += m
            # refill from the spill queue in arrival order; the outer loop
            # drains these slots on its next pass
            while self._spilled and self._count < self.num_slots:
                self._enqueue(self._spilled.popleft())
        if drained:
            state = session.program.refresh(state)
        return state, num_rows, drained
