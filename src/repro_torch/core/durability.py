"""Durable sessions: checkpoint / restore of a live ``EngineSession``.

Port of ``repro.core.durability``.  PIQUE's pay-as-you-go contract is that
enrichment already billed to tenants is never wasted, so a preempted worker
must not lose its ``SessionState``:

* ``save_session_checkpoint`` waits for the device and snapshots the
  ENTIRE state (capacity-padded substrate, derived state, bank outputs,
  tenant masks, ``num_rows``, every ledger accumulator, the quarantine)
  through ``checkpoint.store.save_checkpoint`` (atomic tmp / rename), with
  the host shadows (event cursor, RNG state, epoch counter, tier index) in
  the same ``meta.json``;
* ``restore_session_checkpoint`` validates the checkpoint (format, P / F /
  slot axes, substrate dtype), loads it at its SAVED capacity and re-pads
  it through ``pad_session_state`` onto the smallest tier of the restoring
  session that holds it, so restoring onto another shard count or a larger
  tier is a data operation.

Snapshots are taken only between chunks, so every checkpoint sits at a
superstep boundary: a process that restores one and runs the remaining
epochs replays the uninterrupted run bit for bit.  Restore does NOT call
``refresh``: derived state is the saved bits, which is what makes resume
bitwise rather than merely close.

The on-disk format is the reference's (``CHECKPOINT_FORMAT = 3``), so a
session checkpoint written by either package restores in the other.

``shard_session_state`` places a state onto a device mesh, and
``restore_session_checkpoint(mesh=)`` restores onto one: a checkpoint
written on any topology (the files are the same whatever wrote them: a
placed state is gathered and rank 0 writes) lands on a mesh of any size,
where the session runs it as a per-rank program (``core.shard_program``).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Optional

import torch

from repro_torch.checkpoint import store
from repro_torch.checkpoint.store import LeafSpec
from repro_torch.core import shard_program
from repro_torch.core.errors import CapacityError
from repro_torch.core.executor import SessionDerived, SessionState
from repro_torch.core.ledger import CostLedger, migrate_ledger
from repro_torch.core.session import EngineSession, pad_session_state
from repro_torch.core.state import SharedSubstrate

# The reference's format: 2 added the [P, F] quarantine mask; 3 made the
# substrate dtype a session parameter (float leaves persist at it).  A
# format-2 checkpoint is byte-identical to format 3 at float32.
CHECKPOINT_FORMAT = 3


def session_state_spec(session: EngineSession, capacity: int) -> SessionState:
    """A ``SessionState`` of ``LeafSpec`` leaves for ``session`` at
    ``capacity`` rows: the ``like`` tree a restore validates against.
    Float leaves follow the substrate dtype; ``cost_spent`` and the ledger
    stay f32."""
    p, f, s = session.num_predicates, session.num_functions, session.max_tenants
    dt = session.substrate_dtype
    f32, b, i32 = torch.float32, torch.bool, torch.int32
    return SessionState(
        substrate=SharedSubstrate(
            func_probs=LeafSpec((capacity, p, f), dt),
            exec_mask=LeafSpec((capacity, p, f), b),
            cost_spent=LeafSpec((), f32),
        ),
        derived=SessionDerived(
            pred_prob=LeafSpec((capacity, p), dt),
            uncertainty=LeafSpec((capacity, p), dt),
            joint_prob=LeafSpec((s, capacity), dt),
            in_answer=LeafSpec((s, capacity), b),
        ),
        bank_outputs=LeafSpec((capacity, p, f), dt),
        pred_mask=LeafSpec((s, p), b),
        active=LeafSpec((s,), b),
        num_rows=LeafSpec((), i32),
        ledger=CostLedger(
            attributed=LeafSpec((s,), f32),
            triples=LeafSpec((s,), f32),
            wanted=LeafSpec((s,), i32),
            unattributed=LeafSpec((), f32),
            archived=LeafSpec((), f32),
        ),
        quarantined=LeafSpec((p, f), b),
    )


def _session_extra(session: EngineSession, state: SessionState) -> dict:
    """The session-level ``meta.json`` block: format, axis fingerprint and
    the host shadows a serving loop needs before touching array data (the one
    host read of a save)."""
    capacity = state.capacity
    state = shard_program.local_view(state)[1]  # the replicated leaves' local copies
    q = state.quarantined.cpu().numpy()
    return {
        "format": CHECKPOINT_FORMAT,
        "capacity": capacity,
        "substrate_dtype": session.config.substrate_dtype,
        "num_predicates": session.num_predicates,
        "num_functions": session.num_functions,
        "num_slots": session.max_tenants,
        "num_rows": int(state.num_rows),
        "active": [bool(x) for x in state.active.cpu().numpy()],
        "quarantined": [
            [i, j] for i in range(q.shape[0]) for j in range(q.shape[1]) if bool(q[i, j])
        ],
        "tier_index": session.tier_capacities.index(capacity)
        if capacity in session.tier_capacities
        else -1,
    }


def save_session_checkpoint(
    root, step: int, session: EngineSession, state: SessionState, host_meta: Optional[dict] = None
) -> Path:
    """Snapshot a live session state at a superstep boundary.

    The caller guarantees the boundary (``run``'s ``on_chunk`` hook and
    ``SessionPipeline.checkpoint`` do); this function waits for the device,
    so in-flight chunks finish here rather than being torn mid-superstep.
    ``host_meta`` lands under ``extra["host"]`` in the same atomic rename.
    """
    if state.device.type == "cuda":
        torch.cuda.synchronize(state.device)
    extra = _session_extra(session, state)
    if host_meta is not None:
        extra["host"] = host_meta
    return store.save_checkpoint(root, step, state, extra=extra)


def _target_capacity(session: EngineSession, saved_capacity: int) -> int:
    """Smallest tier of the restoring session holding the saved rows
    (padding only grows: a smaller last tier cannot adopt the checkpoint)."""
    for t in session.tier_capacities:
        if t >= saved_capacity:
            return t
    raise CapacityError(
        f"checkpoint capacity {saved_capacity} exceeds the restoring "
        f"session's last tier {session.max_capacity} (tiers "
        f"{session.tier_capacities}); open the session with max_capacity >= "
        "the saved capacity",
        used=saved_capacity,
        capacity=session.max_capacity,
        requested=saved_capacity - session.max_capacity,
    )


def shard_session_state(state: SessionState, mesh) -> SessionState:
    """Place a (restored) session state onto a device mesh.

    Row-axis leaves shard over the mesh's object axes — the substrate, bank
    outputs and shared derived maps on axis 0, the per-slot ``[S, C]``
    leaves on axis 1 — while the slot-axis leaves (``pred_mask``,
    ``active``), scalars, the ledger and the quarantine replicate
    explicitly: the axis-0 rule of ``state.shard_over_objects`` would split
    ``pred_mask`` over tenant slots, which is never the serving layout.
    Save-time placement is irrelevant (a save gathers to the host), so this
    is how a checkpoint written on one topology lands on another.
    """
    return shard_program.place_state(state, mesh)


def restore_session_checkpoint(
    session: EngineSession, root, step: Optional[int] = None, mesh=None
) -> tuple:
    """Rebuild a live state from a checkpoint inside ``session``, on the
    session's device -> (state, step, extra).

    ``extra["host"]`` holds the serving loop's shadows ``save_session_checkpoint``
    was given.  The checkpoint loads at its saved capacity (strict shape /
    dtype match), then pads onto the session's smallest holding tier
    (``migrate_ledger`` replayed inside), then, with ``mesh``, is placed on
    it (``shard_session_state``).  No ``refresh``: derived state is the
    saved bits.
    """
    meta = store.load_meta(root, step)
    extra = meta.get("extra", {})
    fmt = extra.get("format")
    if fmt == 2:
        # format 2 predates the substrate-dtype parameter and is byte-identical
        # to format 3 at float32: default the field, the gate below arbitrates
        extra.setdefault("substrate_dtype", "float32")
    elif fmt != CHECKPOINT_FORMAT:
        raise ValueError(
            f"checkpoint format {fmt!r} != supported {CHECKPOINT_FORMAT} "
            "(not a session checkpoint, or from an incompatible version)"
        )
    for field, have in (
        ("num_predicates", session.num_predicates),
        ("num_functions", session.num_functions),
        ("num_slots", session.max_tenants),
        # restore is bitwise: a dtype change is a different world
        ("substrate_dtype", session.config.substrate_dtype),
    ):
        if extra[field] != have:
            raise ValueError(
                f"checkpoint {field}={extra[field]} != session {have}; a "
                "session can only adopt checkpoints over its own schema"
            )
    saved_capacity = int(extra["capacity"])
    target = _target_capacity(session, saved_capacity)
    like = session_state_spec(session, saved_capacity)
    state, step = store.restore_checkpoint(root, meta["step"], like, device=session.device)
    if target != saved_capacity:
        state = pad_session_state(state, target, session.config.prior)
    else:
        # a same-tier restore still routes the ledger through the audited hop
        migrate_ledger(state.ledger, session.max_tenants)
    if mesh is not None:
        state = shard_session_state(state, mesh)
    return state, step, extra


class SessionCheckpointer:
    """Cadence and retention around ``save_session_checkpoint``.

    ``maybe_save`` is called at every chunk boundary (the only legal
    snapshot points) and saves on every ``every``-th one, or at once with
    ``force=True`` (the preemption drain).  After each save the newest
    ``keep`` checkpoints are kept (``store.prune_old``).  ``saves``,
    ``save_seconds`` and ``bytes_written`` account for the cost.
    """

    def __init__(self, session: EngineSession, root, every: int = 1, keep: int = 3):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.session = session
        self.root = Path(root)
        self.every = int(every)
        self.keep = int(keep)
        self.saves = 0
        self.save_seconds = 0.0
        self.bytes_written = 0
        self.last_step: Optional[int] = None
        self._boundaries = 0  # chunk boundaries seen since the last save

    def save(self, state: SessionState, step: int, host_meta: Optional[dict] = None) -> Path:
        t0 = time.perf_counter()
        path = save_session_checkpoint(self.root, step, self.session, state, host_meta=host_meta)
        self.save_seconds += time.perf_counter() - t0
        self.bytes_written += sum(f.stat().st_size for f in path.iterdir() if f.is_file())
        self.saves += 1
        self.last_step = step
        self._boundaries = 0
        if shard_program.mesh_of(state) is None:
            store.prune_old(self.root, keep=self.keep)
        else:  # every rank saw the rename: rank 0 prunes, the others wait for it
            import torch.distributed as dist

            if dist.get_rank() == 0:
                store.prune_old(self.root, keep=self.keep)
            dist.barrier()
        return path

    def maybe_save(
        self, state: SessionState, step: int, host_meta: Optional[dict] = None, force: bool = False
    ) -> Optional[Path]:
        """Called at a chunk boundary; saves on cadence (or ``force``)."""
        self._boundaries += 1
        if force or self._boundaries >= self.every:
            return self.save(state, step, host_meta=host_meta)
        return None
