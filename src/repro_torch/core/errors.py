"""Typed capacity errors for the session layer (port of ``repro.core.errors``,
with the same classes, bases and payload fields).

Bare ``ValueError``s with "plan capacity" advice are useless to serving code
that wants to REACT — shed load, spill to a new session, or page an operator
with the actual numbers.  These carry the machine-readable triple
``(used, capacity, requested)`` and subclass the exceptions the session
raised before they existed, so existing handlers (and tests) keep working.
"""

from __future__ import annotations


class CapacityError(ValueError):
    """Row-capacity exhaustion: an ingest (or initial corpus) does not fit.

    ``used`` rows are occupied, ``requested`` more were asked for, and
    ``capacity`` is the bound that failed — the session's *maximum* tier
    capacity, so a handler sees the true ceiling, not the current tier
    (growth past the current tier is automatic when ``max_capacity``
    allows it; this error means even the last tier cannot hold the rows).
    """

    def __init__(self, message: str, *, used: int, capacity: int, requested: int):
        super().__init__(message)
        self.used = int(used)
        self.capacity = int(capacity)
        self.requested = int(requested)


class SlotActiveError(ValueError):
    """Admission targeted a slot that is still occupied.

    ``slot`` is the requested index; the handler's fix is to ``retire`` the
    occupant first (which issues its final bill and frees the slot) or admit
    without a slot hint and let the session pick a free one.  Subclasses
    ``ValueError`` because that is what the session raised before this type
    existed, so existing handlers keep working.
    """

    def __init__(self, message: str, *, slot: int):
        super().__init__(message)
        self.slot = int(slot)


class MeshShrinkError(RuntimeError):
    """Elastic shrink failed: the surviving chips cannot hold the mesh.

    ``healthy_chips`` survived the failure; ``model_axis`` is the tensor-
    parallel extent that must stay intact (TP is wired to the parameter
    layout, so it cannot shrink).  Raised by
    ``ElasticPolicy.shrink_for_failures`` when even a data axis of 1 does
    not fit — the supervisor's options are to page an operator or drain
    the session to its checkpoint and wait for capacity.
    """

    def __init__(self, message: str, *, healthy_chips: int, model_axis: int):
        super().__init__(message)
        self.healthy_chips = int(healthy_chips)
        self.model_axis = int(model_axis)


class SubstrateDtypeError(ValueError):
    """Mixed-dtype substrate write: the incoming floats don't match storage.

    The substrate has ONE storage dtype (``expected``); merging or ingesting
    float data of another dtype (``got``) would either silently widen the
    whole buffer (type promotion) or silently quantize the input.  Both are
    wrong by default — the caller must cast explicitly at the boundary where
    the precision contract is documented.  ``where`` names the operation
    that refused (e.g. ``"ingest_rows"``, ``"with_cached_state"``).
    """

    def __init__(self, message: str, *, expected: str, got: str, where: str):
        super().__init__(message)
        self.expected = str(expected)
        self.got = str(got)
        self.where = str(where)


class IngestBackpressure(RuntimeError):
    """Pending-row ring is full: enrichment has fallen behind ingestion.

    Raised by ``PendingRing.push`` under the ``block`` policy (the other
    policies — ``shed``/``spill`` — absorb the overflow themselves).  The
    handler's fix is to drain the ring into the session (freeing every
    slot) and retry the push; ``occupied``/``capacity`` are in ring slots,
    ``requested`` is the number of rows that did not fit, and ``policy``
    echoes the ring's configured policy so generic handlers can log it.
    """

    def __init__(
        self, message: str, *, occupied: int, capacity: int, requested: int, policy: str
    ):
        super().__init__(message)
        self.occupied = int(occupied)
        self.capacity = int(capacity)
        self.requested = int(requested)
        self.policy = str(policy)


class SlotsExhaustedError(RuntimeError):
    """Tenant-slot exhaustion: ``admit`` found no free slot.

    ``used`` slots are active of ``capacity`` (``max_tenants``) allocated;
    ``requested`` is how many more were asked for (1 per admit).
    """

    def __init__(self, message: str, *, used: int, capacity: int, requested: int):
        super().__init__(message)
        self.used = int(used)
        self.capacity = int(capacity)
        self.requested = int(requested)
