"""Logical-axis sharding (port of ``repro.models.sharding``): parameters
and activations carry logical axis names; a rules table maps them onto
mesh axes (MaxText-style).

Mesh axes (the dim names of a ``torch.distributed`` ``DeviceMesh``):
    pod    — outer data axis across pods
    data   — FSDP / batch axis within a pod
    model  — tensor-parallel axis

Default rules: TP over heads / d_ff / vocab; FSDP (("pod", "data")) over
the largest remaining weight dim; batch over ("pod", "data").

``ShardingRules.spec`` maps a logical-axes tuple to a ``PartitionSpec``
(a tuple of mesh-axis entries, one a tensor dim: None, a name or a tuple of
names, as ``jax.sharding.PartitionSpec``), never mapping two tensor dims to
one mesh axis.  ``placements`` turns the spec, filtered to the mesh's axes,
into DTensor placements (the counterpart of the reference's
``NamedSharding``): a tensor dim whose entry names mesh axes is
``Shard(dim)`` on each of those mesh dims — a tuple entry lists them major
first, which is the mesh's own order — and every mesh dim no tensor dim
uses is ``Replicate()``.  ``place_whole`` turns a tensor every rank holds
whole into a DTensor with given placements, each rank keeping its own
shard: no collective, so a data-loading thread may call it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

FSDP_AXES = ("pod", "data")


class PartitionSpec(tuple):
    """One entry per tensor dim: None, a mesh-axis name or a tuple of names
    (an empty tuple is None and a one-name tuple the name, as
    ``jax.sharding.PartitionSpec`` has them)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))


def _entry(e):
    if isinstance(e, (tuple, list)):
        return None if len(e) == 0 else e[0] if len(e) == 1 else tuple(e)
    return e

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_axis_names(mesh) -> tuple:
    """The mesh's axis names: a ``DeviceMesh``'s ``mesh_dim_names`` or a
    stand-in's ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def mesh_axis_sizes(mesh) -> dict:
    """name -> size for a ``DeviceMesh`` (``shape`` is a tuple) or a
    stand-in whose ``shape`` maps names to sizes."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(mesh_axis_names(mesh), tuple(shape)))


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: dict

    def spec(self, axes: Sequence[Optional[str]]) -> PartitionSpec:
        out = []
        used = set()
        for ax in axes:
            m = self.rules.get(ax) if ax is not None else None
            # never map two tensor dims to the same mesh axis
            key = tuple(m) if isinstance(m, (tuple, list)) else (m,)
            if m is None or any(k in used for k in key if k is not None):
                out.append(None)
            else:
                out.append(tuple(m) if isinstance(m, (tuple, list)) else m)
                used.update(k for k in key if k is not None)
        return P(*out)

    def placements(self, mesh, axes: Sequence[Optional[str]]) -> tuple:
        """DTensor placements of a tensor with logical ``axes`` on ``mesh``."""
        return spec_placements(mesh, self.filter_for_mesh(mesh, self.spec(axes)))

    @staticmethod
    def filter_for_mesh(mesh, spec: PartitionSpec) -> PartitionSpec:
        """Drop mesh axes absent from ``mesh`` (single-pod has no 'pod' axis)."""
        names = set(mesh_axis_names(mesh))

        def keep(entry):
            if entry is None:
                return None
            if isinstance(entry, (tuple, list)):
                kept = tuple(e for e in entry if e in names)
                return kept if kept else None
            return entry if entry in names else None

        return P(*[keep(e) for e in spec])


def spec_placements(mesh, spec: PartitionSpec) -> tuple:
    """A mesh-filtered spec -> one placement per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_axis_names(mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's order {names}: a "
                             "DTensor shards a dim over its mesh dims major first")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def default_rules(mesh, num_experts: int | None = None) -> ShardingRules:
    """Build rules compatible with ``mesh`` (handles 2-axis single-pod meshes).

    The expert dim shards over "data" when divisible, else stays unsharded
    and the per-expert weights FSDP over embed."""
    names = set(mesh_axis_names(mesh))
    sizes = mesh_axis_sizes(mesh)
    fsdp = tuple(a for a in FSDP_AXES if a in names)
    expert_axis: Optional[str] = None
    if num_experts is not None and "data" in names and num_experts % sizes["data"] == 0:
        expert_axis = "data"
    rules = {
        # activations
        "batch": fsdp,
        "seq": None,
        "act_seq": None,
        "kv_seq": None,  # long-context decode overrides this to "data"
        "act_embed": None,
        "act_heads": "model",
        "act_ff": "model",
        # params
        "embed": fsdp,  # FSDP shard of non-TP weight dim
        "embed_unsharded": None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "experts": expert_axis,
        "expert_embed": fsdp,
        "layers": None,
        "conv": None,
        "state": None,
        "ssm_heads": "model",
        "ssm_inner": "model",
    }
    # avoid double-mapping when experts took the data axis: expert_embed must
    # not reuse "data"; fall back to "pod" only (or nothing on single pod).
    if expert_axis == "data":
        rules["expert_embed"] = tuple(a for a in fsdp if a != "data")
    return ShardingRules(rules=rules)


def is_axes_leaf(x) -> bool:
    """Logical-axes leaves are tuples of axis names (or empty, for scalars).
    A tuple of ONLY Nones is not a leaf: that shape arises in cache trees
    as a container of per-pattern-position entries where a position has no
    cache — e.g. ``ssm_conv=(None,)`` for attention-only models."""
    if not isinstance(x, tuple):
        return False
    if not all(e is None or isinstance(e, str) for e in x):
        return False
    return len(x) == 0 or any(isinstance(e, str) for e in x)


def map_axes(fn, axes_tree):
    """``fn`` over every logical-axes leaf of a tree of dicts, tuples,
    lists and dataclasses (None stays None)."""
    if axes_tree is None:
        return None
    if is_axes_leaf(axes_tree):
        return fn(axes_tree)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, v) for k, v in axes_tree.items()}
    if isinstance(axes_tree, (tuple, list)):
        return type(axes_tree)(map_axes(fn, v) for v in axes_tree)
    if dataclasses.is_dataclass(axes_tree):
        return dataclasses.replace(axes_tree, **{
            f.name: map_axes(fn, getattr(axes_tree, f.name))
            for f in dataclasses.fields(axes_tree)})
    raise TypeError(f"not an axes tree: {type(axes_tree)}")


def spec_tree_for_params(axes_tree, rules: ShardingRules, mesh):
    """A tree of logical-axes tuples -> the same tree of placements."""
    return map_axes(lambda axes: rules.placements(mesh, axes), axes_tree)


def local_box(shape, mesh, placements) -> tuple:
    """(this rank's local shape, its offset in the global tensor) under
    ``placements``: each ``Shard(d)`` splits dim d in the mesh dims' order
    as ``torch.chunk`` does (ceil-sized pieces, the last ones short or
    empty).  Plain arithmetic on the mesh coordinate, so it runs under a
    fake-tensor mode too."""
    sizes, offsets = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        d = getattr(p, "dim", None)
        if d is None:
            continue
        piece = -(-sizes[d] // mesh.size(i))
        start = min(coord[i] * piece, sizes[d])
        offsets[d] += start
        sizes[d] = min(start + piece, sizes[d]) - start
    return tuple(sizes), tuple(offsets)


def place_whole(t, mesh, placements):
    """A tensor that every rank of ``mesh`` holds whole (the same values) ->
    a DTensor in ``placements`` whose local shard is a copy of this rank's
    slice of ``t``, on the mesh's device."""
    import torch
    from torch.distributed.tensor import DTensor

    shape, offset = local_box(t.shape, mesh, placements)
    local = t[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    if t.device.type == "meta":  # the dry run's stand-ins stay meta
        dev = t.device
    elif mesh.device_type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device(mesh.device_type)
    local = local.to(dev).clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=t.shape,
                              stride=torch.empty(t.shape, device="meta").stride())
