"""The session's per-rank shard program: a session state placed over the
object axis of a ``torch.distributed`` ``DeviceMesh`` runs every entry
point as one program per rank over its own rows, with explicit, exact
collectives over the object axis's process group.

The port adds this module; the reference has no counterpart.  There the
placement (``state.shard_over_objects``, ``durability.shard_session_state``)
is all there is, and XLA partitions the unchanged superstep.  The port's
superstep sorts, top-ks, scatters and launches its kernels through
``ctypes``: none of that is partitioned by DTensor, whose per-op dispatch
also costs milliseconds.  So a placed state is unwrapped once per chunk or
churn event (``local_view``: each DTensor leaf's local shard), the epochs
run on plain tensors, and ``place`` wraps the result again
(``DTensor.from_local``: no communication).

A layout says which rows this rank holds and supplies the steps that read
across rows:

* ``OneDevice`` — a plain state: every row local, no collective;
* ``Replicated`` — a placed state whose row leaves replicate (its capacity
  does not divide over the mesh, the reference's rule): the one-device
  program on every rank, placed again replicated;
* ``RowShards`` — row leaves sharded: rank r of R owns the contiguous rows
  ``[r C / R, (r + 1) C / R)``, the block layout of the emulated
  ``num_shards`` program.

Every cross-row quantity is computed on every rank from the same gathered
inputs, never as a sum of per-rank partial results, so a placed session is
bitwise the one-device program:

* the "auto" candidate median: the [S, C] mean entropies and the row
  validity gathered, sorted alike on every rank;
* the starvation guard: integer counts all-reduced;
* plan selection: a top-k per plan shard this rank holds (its own rows when
  the plan shards and the ranks do not nest) with global object indices,
  the survivors all-gathered and merged exactly
  (``plan.merge_sharded_plans_exact``);
* charging: each rank's chargeable lanes gathered as uint8, the spend
  summed over all lanes in the one-device order;
* answer selection: the [S, C] joint gathered and selected on every rank,
  each rank keeping its slice of the mask.

The dedup merge, the quarantine filter, the ledger and the stats read
replicated inputs.  ``COLLECTIVES`` counts the collectives issued.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import plan as plan_lib
from repro_torch.core import state as state_lib
from repro_torch.core.benefit import TripleBenefits

COLLECTIVES = {"all_gather": 0, "all_reduce": 0}


def reset_counts() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


def mesh_of(state):
    """The ``DeviceMesh`` a placed state lives on (None for a plain state)."""
    leaf = state.substrate.func_probs
    return leaf.device_mesh if hasattr(leaf, "device_mesh") else None


def _map_fields(fn, obj, path: str = ""):
    """``fn(path, leaf)`` over the tensor (or None) fields of a state's
    nested dataclasses."""
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _map_fields(fn, getattr(obj, f.name), f"{path}.{f.name}")
            for f in dataclasses.fields(obj)})
    return fn(path, obj)


def whole(state):
    """A state with every leaf whole and plain (a collective for each
    sharded leaf); a plain state is returned as it is."""
    if mesh_of(state) is None:
        return state
    return state_lib.map_tensors(state_lib.whole, state)


def place_state(state, mesh, axis_names=("pod", "data")):
    """Place a session state onto ``mesh`` (the reference's
    ``shard_session_state`` layout): row leaves over the object axes — the
    substrate, bank outputs and shared derived maps on axis 0, the per-slot
    ``[S, C]`` leaves on axis 1 — and the slot-axis leaves, scalars, the
    ledger and the quarantine replicated explicitly (the axis-0 rule would
    split ``pred_mask`` over tenant slots)."""
    from repro_torch.models.sharding import place_whole

    state = whole(state)

    def rows(x, axis=0):
        return state_lib.shard_over_objects(x, mesh, axis_names, object_axis=axis)

    def rep(tree):
        return state_lib.map_tensors(
            lambda x: place_whole(x, mesh, _replicate(mesh)), tree)

    der = state.derived
    return dataclasses.replace(
        state,
        substrate=state_lib.shard_substrate(state.substrate, mesh, axis_names),
        derived=dataclasses.replace(
            der, pred_prob=rows(der.pred_prob), uncertainty=rows(der.uncertainty),
            joint_prob=rows(der.joint_prob, 1), in_answer=rows(der.in_answer, 1)),
        bank_outputs=rows(state.bank_outputs),
        pred_mask=rep(state.pred_mask),
        active=rep(state.active),
        num_rows=rep(state.num_rows),
        ledger=rep(state.ledger),
        quarantined=rep(state.quarantined),
    )


def _replicate(mesh) -> tuple:
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * mesh.ndim


def local_view(state) -> tuple:
    """-> (layout, the state on this rank's rows as plain tensors).

    A plain state comes back as it is with a ``OneDevice`` layout; a placed
    one as each leaf's local shard, with the layout that runs it and places
    the result again (``layout.place``)."""
    mesh = mesh_of(state)
    if mesh is None:
        return OneDevice(state.capacity), state
    spec = {}

    def unwrap(path, x):
        if not hasattr(x, "device_mesh"):
            return x
        spec[path] = (tuple(x.placements), tuple(x.shape))
        return x.to_local()

    local = _map_fields(unwrap, state)
    placements = state.substrate.func_probs.placements
    dims = tuple(i for i, p in enumerate(placements) if p.is_shard())
    if dims:
        return RowShards(mesh, dims, state.capacity, spec), local
    return Replicated(mesh, state.capacity, spec), local


class OneDevice:
    """A plain state's layout: every row local, no collective."""

    kind = "device"
    per_rank = False

    def __init__(self, capacity: int):
        self.capacity = int(capacity)

    def valid(self, num_rows: torch.Tensor) -> torch.Tensor:
        """[rows here] bool: which of this rank's rows hold objects."""
        return state_lib.row_validity(self.capacity, num_rows)

    def all_valid(self, num_rows: torch.Tensor) -> torch.Tensor:
        """[C] bool: the row validity of the whole state."""
        return state_lib.row_validity(self.capacity, num_rows)

    def gather(self, x: torch.Tensor, axis: int = -1) -> torch.Tensor:
        """This rank's rows along ``axis`` -> every rank's, in row order."""
        return x

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """A [..., C] tensor -> this rank's [..., rows] slice."""
        return x

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """An integer count over this rank's rows -> over all rows."""
        return x

    def any_rank(self, mask: torch.Tensor) -> torch.Tensor:
        """A lane mask set by the rank that holds each lane -> on every rank."""
        return mask

    def localize(self, object_idx: torch.Tensor, valid: torch.Tensor) -> tuple:
        """Global object indices of plan lanes -> (row indices on this
        rank, the valid lanes whose object this rank holds); other lanes
        read row 0 and stay inert."""
        return object_idx, valid

    def ingest(self, buffer, num_rows, new_rows) -> tuple:
        """``state.ingest_rows`` on this rank's rows."""
        return state_lib.ingest_rows(buffer, num_rows, new_rows)

    def place(self, state):
        return state


class Replicated(OneDevice):
    """A placed state whose row leaves replicate: the one-device program on
    every rank, each leaf placed again as it was."""

    kind = "replicated"

    def __init__(self, mesh, capacity: int, spec: dict):
        super().__init__(capacity)
        self.mesh = mesh
        self.spec = spec

    def place(self, state):
        from torch.distributed.tensor import DTensor

        default = _replicate(self.mesh)

        def wrap(path, x):
            if x is None:
                return None
            placements, shape = self.spec.get(path, (default, tuple(x.shape)))
            return DTensor.from_local(
                x.contiguous(), self.mesh, placements, run_check=False,
                shape=torch.Size(shape), stride=_contiguous_stride(shape))

        return _map_fields(wrap, state)


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


class RowShards(Replicated):
    """Row leaves sharded over the object axis: this rank's block of rows
    and the collectives over the object axis's process group."""

    kind = "per_rank"
    per_rank = True

    def __init__(self, mesh, dims: tuple, capacity: int, spec: dict):
        super().__init__(mesh, capacity, spec)
        self.group, self.position, self.world = _object_group(mesh, dims)
        self.rows = self.capacity // self.world
        self.offset = self.position * self.rows

    def valid(self, num_rows):
        idx = torch.arange(self.rows, dtype=torch.int32, device=num_rows.device) + self.offset
        return idx < num_rows

    def gather(self, x, axis=-1):
        import torch.distributed as dist

        axis = axis % x.ndim
        send = (x.to(torch.uint8) if x.dtype == torch.bool else x).reshape(-1).contiguous()
        out = torch.empty(self.world * send.numel(), dtype=send.dtype, device=send.device)
        dist.all_gather_into_tensor(out, send, group=self.group)  # the concatenated form
        COLLECTIVES["all_gather"] += 1
        shape = list(x.shape)
        shape[axis] *= self.world
        out = out.view(self.world, *x.shape).movedim(0, axis).reshape(shape)
        return out.to(torch.bool) if x.dtype == torch.bool else out

    def local(self, x):
        return x[..., self.offset:self.offset + self.rows].contiguous()

    def sum(self, x):
        import torch.distributed as dist

        out = x.clone()
        dist.all_reduce(out, group=self.group)
        COLLECTIVES["all_reduce"] += 1
        return out

    def any_rank(self, mask):
        return self.gather(mask[None], axis=0).any(0)

    def localize(self, object_idx, valid):
        here = object_idx - self.offset
        mine = valid & (here >= 0) & (here < self.rows)
        return torch.where(mine, here, 0), mine

    def ingest(self, buffer, num_rows, new_rows):
        """Rows ``[num_rows, num_rows + M)`` may cross rank boundaries: each
        rank writes the ones it holds; the others go to a spare dump row."""
        state_lib._check_float_dtype(buffer, new_rows, "ingest_rows")
        m = new_rows.shape[0]
        here = num_rows.to(torch.int64) + torch.arange(m, device=buffer.device) - self.offset
        here = torch.where((here >= 0) & (here < self.rows), here, self.rows)
        ext = torch.cat([buffer, buffer[:1]])
        ext = ext.index_copy(0, here, new_rows.to(buffer.device, buffer.dtype))
        return ext[:self.rows], num_rows + m

    def select_plans(self, benefits: TripleBenefits, plan_size: int, num_shards: int,
                     num_predicates: int) -> plan_lib.Plan:
        """Per-slot plans over the whole state, from this rank's rows.

        When the plan shards nest in the ranks, this rank top-ks each plan
        shard it holds, so the gathered survivors are the emulated
        ``num_shards`` program's, lane for lane; otherwise it top-ks its own
        rows, and the exact merge still gives the unsharded plan on every
        valid lane.  Object indices are global before the merge."""
        q, n, p = benefits.benefit.shape
        s = num_shards // self.world if num_shards % self.world == 0 else 1
        per = n // s
        local = TripleBenefits(*(x.reshape(q, s, per, p) for x in benefits))
        plans = plan_lib.select_plan(local, plan_size)  # [Q, s, K]
        dev = benefits.benefit.device
        offsets = self.offset + torch.arange(s, device=dev)[None, :, None] * per
        plans = plans._replace(object_idx=plans.object_idx + offsets)
        ints = self.gather(torch.stack([plans.object_idx, plans.pred_idx, plans.func_idx]), 2)
        floats = self.gather(torch.stack([plans.benefit, plans.cost]), 2)
        valid = self.gather(plans.valid, 1)  # [Q, R s, K]
        merged = []
        for i in range(q):
            every = plan_lib.Plan(ints[0, i], ints[1, i], ints[2, i], floats[0, i], floats[1, i],
                                  valid[i])
            merged.append(plan_lib.merge_sharded_plans_exact(every, plan_size, num_predicates))
        return plan_lib.Plan(*(torch.stack(leaves) for leaves in zip(*merged)))


def _object_group(mesh, dims: tuple) -> tuple:
    """(process group, this rank's position, size) of the object axis: the
    mesh dims the row leaves shard over, major first."""
    split = tuple(d for d in dims if mesh.size(d) > 1)
    if len(split) <= 1:
        d = split[0] if split else dims[0]
        return mesh.get_group(d), mesh.get_local_rank(d), mesh.size(d)
    names = tuple(mesh.mesh_dim_names[d] for d in split)
    flat = mesh[names]._flatten()
    return flat.get_group(0), flat.get_local_rank(0), flat.size(0)
