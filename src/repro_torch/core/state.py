"""Enrichment state: capacity-padded structure-of-arrays tensors.

Port of ``repro.core.state``.  The shared substrate is the
query-independent half of enrichment state:

    func_probs  [C, P, F]  raw tagging-function outputs (prior where unexecuted)
    exec_mask   [C, P, F]  bool, which functions have run (the "state" bitmask)
    cost_spent  []         cumulative enrichment cost, always f32

written once per (object, predicate, function) triple however many tenants
asked for it.  ``state_id`` (the decision-table key) is the little-endian
packing of ``exec_mask``.  ``PerQueryState`` stacks the per-query derived
half (``pred_prob``, ``uncertainty``, ``joint_prob``, ``in_answer``) on a
leading ``[Q]`` axis, and ``EnrichmentState`` is the fused single-query
view the paper's operator works on.

Storage contract: ``func_probs`` is f32 or bf16; all arithmetic runs in f32
and ``cost_spent`` stays f32.  A write of another float dtype into a buffer
raises ``SubstrateDtypeError`` instead of promoting or quantizing silently.

Every function here returns new tensors and leaves its inputs untouched, so
a caller may keep an older state alive (chunked vs monolithic replays,
grown vs pre-allocated sessions).

``shard_over_objects`` / ``shard_substrate`` place a state's object axis
over a ``torch.distributed`` ``DeviceMesh`` as DTensors, leaf by leaf by
the reference's rule; ``core.shard_program`` runs a placed session.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import combine as combine_lib
from repro_torch.core import entropy as entropy_lib
from repro_torch.core.errors import SubstrateDtypeError


def _check_float_dtype(buffer: torch.Tensor, values: torch.Tensor, where: str) -> None:
    """Refuse mixed-float writes into a substrate buffer."""
    if (
        buffer.dtype.is_floating_point
        and values.dtype.is_floating_point
        and buffer.dtype != values.dtype
    ):
        raise SubstrateDtypeError(
            f"{where}: substrate stores {buffer.dtype} but got {values.dtype} "
            f"values; cast explicitly at the ingest/merge boundary",
            expected=str(buffer.dtype),
            got=str(values.dtype),
            where=where,
        )


def _pack_state_id(exec_mask: torch.Tensor) -> torch.Tensor:
    """[..., P] int32 little-endian packing of an [..., P, F] exec mask."""
    f = exec_mask.shape[-1]
    weights = 2 ** torch.arange(f, dtype=torch.int32, device=exec_mask.device)
    return (exec_mask.to(torch.int32) * weights).sum(-1, dtype=torch.int32)


def pack_function_bits(mask: torch.Tensor) -> torch.Tensor:
    """Packing of an [..., F] function mask into state-id bits.

    The decision table never selects a function whose bit is set in the
    state id, so OR-ing extra bits into the lookup id excludes functions
    from plan selection (the quarantine channel) without touching
    ``exec_mask``."""
    return _pack_state_id(mask)


@dataclasses.dataclass
class SharedSubstrate:
    """The query-independent half of enrichment state."""

    func_probs: torch.Tensor  # [C, P, F] storage dtype (prior where unexecuted)
    exec_mask: torch.Tensor  # [C, P, F] bool
    cost_spent: torch.Tensor  # [] f32

    @property
    def num_objects(self) -> int:
        return self.func_probs.shape[0]

    @property
    def num_predicates(self) -> int:
        return self.func_probs.shape[1]

    @property
    def num_functions(self) -> int:
        return self.func_probs.shape[2]

    def state_id(self) -> torch.Tensor:
        """[C, P] int32 decision-table key."""
        return _pack_state_id(self.exec_mask)


def init_substrate(
    num_objects: int,
    num_predicates: int,
    num_functions: int,
    prior: float = 0.5,
    dtype=torch.float32,
    capacity: Optional[int] = None,
    device=None,
) -> SharedSubstrate:
    """Allocate a substrate, optionally capacity-padded for streaming ingestion.

    Padded rows are indistinguishable from never-enriched objects (prior
    probabilities, empty exec mask); callers track real rows with
    ``row_validity``.
    """
    if capacity is None:
        capacity = num_objects
    if capacity < num_objects:
        raise ValueError(f"capacity={capacity} < num_objects={num_objects}")
    shape = (capacity, num_predicates, num_functions)
    return SharedSubstrate(
        func_probs=torch.full(shape, prior, dtype=dtype, device=device),
        exec_mask=torch.zeros(shape, dtype=torch.bool, device=device),
        cost_spent=torch.zeros((), dtype=torch.float32, device=device),
    )


def substrate_hbm_bytes(
    capacity: int, num_predicates: int, num_functions: int, dtype=torch.float32
) -> int:
    """Device bytes held by a capacity-padded substrate (func_probs +
    exec_mask + cost_spent)."""
    n = int(capacity) * int(num_predicates) * int(num_functions)
    itemsize = torch.empty((), dtype=dtype).element_size()
    return n * itemsize + n * 1 + 4


def row_validity(capacity: int, num_rows: torch.Tensor) -> torch.Tensor:
    """[capacity] bool: rows [0, num_rows) hold real objects (a prefix mask
    read off one device scalar, so admitting rows needs no host sync)."""
    return torch.arange(capacity, dtype=torch.int32, device=num_rows.device) < num_rows


def pad_axis(x: torch.Tensor, capacity: int, fill, axis: int = 0) -> torch.Tensor:
    """Pad ``axis`` of ``x`` up to ``capacity`` entries with ``fill``."""
    n = x.shape[axis]
    if n > capacity:
        raise ValueError(f"cannot pad {n} rows into capacity {capacity}")
    if n == capacity:
        return x
    shape = list(x.shape)
    shape[axis] = capacity - n
    pad = torch.full(shape, fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=axis)


def pad_rows(x: torch.Tensor, capacity: int, fill) -> torch.Tensor:
    """Pad axis 0 of ``x`` up to ``capacity`` rows with ``fill``."""
    return pad_axis(x, capacity, fill, axis=0)


def ingest_rows(
    buffer: torch.Tensor,  # [C, ...] capacity-padded row buffer
    num_rows: torch.Tensor,  # [] int32: rows currently valid
    new_rows: torch.Tensor,  # [M, ...] rows to append
) -> tuple[torch.Tensor, torch.Tensor]:
    """Append ``new_rows`` into the next free rows -> (buffer', num_rows + M).

    The row offset stays on the device (``index_copy`` at ``num_rows +
    arange(M)``), so no host sync; callers bound-check M host-side.
    """
    _check_float_dtype(buffer, new_rows, "ingest_rows")
    m = new_rows.shape[0]
    idx = num_rows.to(torch.int64) + torch.arange(m, device=buffer.device)
    out = buffer.index_copy(0, idx, new_rows.to(buffer.device, buffer.dtype))
    return out, num_rows + m


def chargeable_mask(
    substrate: SharedSubstrate,
    object_idx: torch.Tensor,  # [K]
    pred_idx: torch.Tensor,  # [K]
    func_idx: torch.Tensor,  # [K]
    valid: torch.Tensor,  # [K] bool
) -> torch.Tensor:
    """[K] bool: which plan lanes the write-once substrate would charge —
    THE charging rule, shared by ``apply_outputs_to_substrate`` and the
    ledger so attribution reconciles by construction."""
    obj_safe = torch.clamp(object_idx, 0, substrate.num_objects - 1).long()
    already = substrate.exec_mask[obj_safe, pred_idx.long(), func_idx.long()]
    return valid & ~already


def apply_outputs_to_substrate(
    substrate: SharedSubstrate,
    object_idx: torch.Tensor,  # [K], may hold don't-care entries on invalid lanes
    pred_idx: torch.Tensor,  # [K]
    func_idx: torch.Tensor,  # [K]
    probs: torch.Tensor,  # [K] at the substrate's storage dtype
    cost: torch.Tensor,  # [K] f32
    valid: torch.Tensor,  # [K] bool
    chargeable: Optional[torch.Tensor] = None,  # [K] bool, default chargeable_mask(...)
) -> SharedSubstrate:
    """Scatter executed triples into the substrate with write-once charging.

    ``chargeable`` may carry the charged lanes when they are known beyond
    the lanes scattered here (a session on a mesh: every rank charges the
    lanes of all ranks, in the one-device order, and scatters its own).

    The reference drops invalid lanes by scattering them out of range.  An
    out-of-range index is a device-side assert on CUDA, and ``index_put_``
    leaves the winner of duplicate writes undefined, so here every invalid
    lane targets one spare dump element past the end of the flattened
    buffer: it can never alias a real triple (row 0 included), and valid
    lanes of a deduplicated plan are distinct.
    """
    _check_float_dtype(substrate.func_probs, probs, "apply_outputs_to_substrate")
    c, p, f = substrate.func_probs.shape
    dump = c * p * f
    if chargeable is None:
        chargeable = chargeable_mask(substrate, object_idx, pred_idx, func_idx, valid)
    flat = (object_idx.long() * p + pred_idx.long()) * f + func_idx.long()
    flat = torch.where(valid, flat, dump)

    def scatter(buf, values):
        ext = torch.cat([buf.reshape(-1), buf.new_empty(1)])
        ext.index_put_((flat,), values)
        return ext[:dump].view(c, p, f)

    fp = scatter(substrate.func_probs, probs)
    em = scatter(substrate.exec_mask, torch.ones_like(valid))
    charged = torch.where(chargeable, cost, 0.0).sum()
    return SharedSubstrate(
        func_probs=fp, exec_mask=em, cost_spent=substrate.cost_spent + charged
    )


@dataclasses.dataclass
class PerQueryState:
    """Per-query derived state for Q concurrent queries, stacked on axis 0
    (recomputable from the substrate, the query set and combine params)."""

    pred_prob: torch.Tensor  # [Q, N, P] f32
    uncertainty: torch.Tensor  # [Q, N, P] f32
    joint_prob: torch.Tensor  # [Q, N] f32
    in_answer: torch.Tensor  # [Q, N] bool

    @property
    def num_queries(self) -> int:
        return self.joint_prob.shape[0]


def derive_query_state(
    substrate: SharedSubstrate,
    query,
    combine_params: combine_lib.CombineParams,
    prior: float = 0.5,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(pred_prob [N, P], uncertainty [N, P], joint_prob [N]) for one query:
    the warm start of a newly admitted query (paper §5 "Caching")."""
    pred_prob = combine_lib.combine_probabilities(
        combine_params, substrate.func_probs, substrate.exec_mask, prior=prior
    )
    return pred_prob, entropy_lib.binary_entropy(pred_prob), query.evaluate(pred_prob)


@dataclasses.dataclass
class EnrichmentState:
    """The single-query state: substrate and derived half fused (Q = 1)."""

    func_probs: torch.Tensor  # [N, P, F] f32
    exec_mask: torch.Tensor  # [N, P, F] bool
    pred_prob: torch.Tensor  # [N, P] f32
    uncertainty: torch.Tensor  # [N, P] f32
    joint_prob: torch.Tensor  # [N] f32
    in_answer: torch.Tensor  # [N] bool
    cost_spent: torch.Tensor  # [] f32

    @property
    def num_objects(self) -> int:
        return self.func_probs.shape[0]

    @property
    def num_predicates(self) -> int:
        return self.func_probs.shape[1]

    @property
    def num_functions(self) -> int:
        return self.func_probs.shape[2]

    @property
    def device(self) -> torch.device:
        return self.func_probs.device

    def state_id(self) -> torch.Tensor:
        """[N, P] int32 little-endian packing of exec_mask (decision-table key)."""
        return _pack_state_id(self.exec_mask)

    @property
    def substrate(self) -> SharedSubstrate:
        """The query-independent half of this state."""
        return SharedSubstrate(
            func_probs=self.func_probs, exec_mask=self.exec_mask, cost_spent=self.cost_spent
        )

    def with_substrate(self, substrate: SharedSubstrate) -> "EnrichmentState":
        """Replace the substrate half (derived fields left stale: refresh after)."""
        return dataclasses.replace(
            self,
            func_probs=substrate.func_probs,
            exec_mask=substrate.exec_mask,
            cost_spent=substrate.cost_spent,
        )


def init_state(
    num_objects: int,
    num_predicates: int,
    num_functions: int,
    prior: float = 0.5,
    dtype=torch.float32,
    device=None,
) -> EnrichmentState:
    n, p, f = num_objects, num_predicates, num_functions
    h0 = float(entropy_lib.binary_entropy(torch.tensor(prior, dtype=torch.float32)))
    return EnrichmentState(
        func_probs=torch.full((n, p, f), prior, dtype=dtype, device=device),
        exec_mask=torch.zeros((n, p, f), dtype=torch.bool, device=device),
        pred_prob=torch.full((n, p), prior, dtype=dtype, device=device),
        uncertainty=torch.full((n, p), h0, dtype=dtype, device=device),
        joint_prob=torch.full((n,), prior**p, dtype=dtype, device=device),
        in_answer=torch.zeros((n,), dtype=torch.bool, device=device),
        cost_spent=torch.zeros((), dtype=torch.float32, device=device),  # spend is always f32
    )


def refresh_derived(
    state: EnrichmentState,
    query,
    combine_params: combine_lib.CombineParams,
    prior: float = 0.5,
) -> EnrichmentState:
    """Recompute pred_prob / uncertainty / joint_prob from raw outputs + mask."""
    pred_prob, uncertainty, joint = derive_query_state(
        state.substrate, query, combine_params, prior=prior
    )
    return dataclasses.replace(
        state, pred_prob=pred_prob, uncertainty=uncertainty, joint_prob=joint
    )


def apply_function_outputs(
    state: EnrichmentState,
    query,
    combine_params: combine_lib.CombineParams,
    object_idx: torch.Tensor,  # [K]
    pred_idx: torch.Tensor,  # [K]
    func_idx: torch.Tensor,  # [K]
    probs: torch.Tensor,  # [K] raw outputs of the executed functions
    cost: torch.Tensor,  # [K] per-triple cost
    valid: torch.Tensor,  # [K] bool
) -> EnrichmentState:
    """Scatter a batch of executed triples through the write-once substrate
    path (re-executed triples are free) and recombine every row.  Like the
    reference, the recombination uses the default prior of 0.5."""
    sub = apply_outputs_to_substrate(
        state.substrate, object_idx, pred_idx, func_idx, probs, cost, valid
    )
    return refresh_derived(state.with_substrate(sub), query, combine_params)


def object_spec(mesh, shape, axis_names=("pod", "data"), object_axis: int = 0):
    """The reference's placement rule for one leaf of ``shape`` -> its
    ``PartitionSpec``: the ``object_axis`` over the mesh axes of
    ``axis_names`` that ``mesh`` has, when the leaf has that axis, the axis
    divides over their devices and is at least as long; otherwise
    replicated (``PartitionSpec()``).  ``mesh`` may be a ``DeviceMesh`` or a
    stand-in with ``axis_names`` and a ``shape`` dict."""
    from repro_torch.models.sharding import PartitionSpec, mesh_axis_names, mesh_axis_sizes

    names, sizes = mesh_axis_names(mesh), mesh_axis_sizes(mesh)
    present = tuple(a for a in axis_names if a in names)
    n_devices = 1
    for a in present:
        n_devices *= sizes[a]
    shape = tuple(shape)
    if (present and len(shape) > object_axis and shape[object_axis] % n_devices == 0
            and shape[object_axis] >= n_devices):
        spec = [None] * len(shape)
        spec[object_axis] = present
        return PartitionSpec(*spec)
    return PartitionSpec()


def map_tensors(fn, tree):
    """``fn`` over every tensor leaf of a tree of dataclasses, named tuples,
    tuples, lists and dicts (None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: map_tensors(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        return type(tree)(*(map_tensors(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tensors(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    raise TypeError(f"not a tree of tensors: {type(tree)}")


def whole(x: torch.Tensor) -> torch.Tensor:
    """A leaf's whole value as a plain tensor: a DTensor's ``full_tensor()``
    (a collective when it is sharded), a plain tensor itself."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def shard_over_objects(tree, mesh, axis_names: tuple = ("pod", "data"), object_axis: int = 0):
    """Place a state tree's object axis over the given mesh axes.

    Every tensor leaf becomes a DTensor on ``mesh`` (the counterpart of the
    reference's ``NamedSharding``) in the placements ``object_spec`` gives
    it: the ``object_axis`` split over whichever of ``axis_names`` the mesh
    has (a pod-scale mesh both "pod" and "data", a host mesh "data"), each
    rank a contiguous block of rows; scalars and leaves too small or not
    divisible replicate.  Per-query stacks pass ``object_axis=1``.  Each
    rank keeps its own slice of the leaf it holds whole: no collective
    (a leaf that is already a DTensor is gathered first).
    """
    from repro_torch.models.sharding import place_whole, spec_placements

    def place(x):
        x = whole(x)
        spec = object_spec(mesh, x.shape, axis_names, object_axis)
        return place_whole(x, mesh, spec_placements(mesh, spec))

    return map_tensors(place, tree)


def shard_substrate(substrate: SharedSubstrate, mesh, axis_names=("pod", "data")):
    """``shard_over_objects`` for the shared substrate: its [C, P, F] leaves
    split on C, the cost scalar replicated."""
    return shard_over_objects(substrate, mesh, axis_names, object_axis=0)


def with_cached_state(
    state: EnrichmentState,
    query,
    combine_params: combine_lib.CombineParams,
    cached_probs: torch.Tensor,  # [N, P, F]
    cached_mask: torch.Tensor,  # [N, P, F] bool
    prior: float = 0.5,
) -> EnrichmentState:
    """Warm-start from a previous query's cache (paper section 5, "Caching").

    Cached triples replace the state's; derived quantities are recombined so
    the first answer set already reflects the cache.  A cache of another
    float dtype than ``func_probs`` raises ``SubstrateDtypeError``.
    """
    _check_float_dtype(state.func_probs, cached_probs, "with_cached_state")
    merged_mask = state.exec_mask | cached_mask
    merged_probs = torch.where(cached_mask, cached_probs, state.func_probs)
    new = dataclasses.replace(state, func_probs=merged_probs, exec_mask=merged_mask)
    return refresh_derived(new, query, combine_params, prior=prior)
