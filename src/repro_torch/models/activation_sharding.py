"""Activation sharding constraints (port of
``repro.models.activation_sharding``) and the other helpers the model code
calls under a mesh.

The model code annotates activations with LOGICAL axes via ``shard_act``;
a mesh step runs the model inside ``activation_sharding(mesh, rules)``, and
there each annotation redistributes its DTensor to the placements the rules
give those axes (the counterpart of ``jax.lax.with_sharding_constraint``:
DTensor's propagation, left alone, keeps whatever placement an op's
strategy picked).  Without an active context (unit tests, one device)
annotations are no-ops and cost one attribute read.  Inside one, a tensor
that is not a DTensor is refused: a mesh step holds every activation as a
DTensor.

The context also turns on DTensor's implicit replication: the plain
tensors the model makes from shapes and from the cache's length (aranges,
masks, zero pads, RoPE frequencies) are built alike on every rank, so they
are the replicated tensors DTensor takes them for.

``on_local_shards`` runs a function on the local shards of its DTensor
arguments (``torch.distributed.tensor.experimental.local_map``), each
redistributed first to the placements it is given: the hand-written kernels
take plain tensors, and so do the few ops DTensor has no sharding rule for
(the MoE's sorts and scatters).  The placements are stated at every call
site; a redistribute there is a collective the call pays for.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch

class _Context:
    """The active (mesh, rules), process-wide: the autograd engine runs a
    CUDA backward pass — and under remat the forward it recomputes — on its
    own device thread, which must see the mesh the forward saw."""

    val = None


_CTX = _Context()


@contextlib.contextmanager
def activation_sharding(mesh, rules):
    from torch.distributed.tensor.experimental import implicit_replication

    prev = _CTX.val
    _CTX.val = (mesh, rules)
    try:
        with implicit_replication():
            yield
    finally:
        _CTX.val = prev


def active():
    """-> (mesh, rules) of the active context, or None."""
    return _CTX.val


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (False without an active context: the
    mesh-free path never imports ``torch.distributed.tensor``)."""
    if _CTX.val is None:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shard_act(x, *axes: Optional[str]):
    """Redistribute ``x`` to the mesh axes the logical ``axes`` map to."""
    ctx = _CTX.val
    if ctx is None or x is None:
        return x
    from torch.distributed.tensor import DTensor

    mesh, rules = ctx
    if len(axes) != x.ndim:
        raise ValueError(f"axes {axes} rank != tensor rank {x.ndim}")
    if not isinstance(x, DTensor):
        raise TypeError("shard_act under an activation_sharding context takes a DTensor, got "
                        f"a plain tensor of shape {tuple(x.shape)}")
    return pin(x.redistribute(mesh, rules.placements(mesh, axes)))


class _PinGrad(torch.autograd.Function):
    """The identity on a DTensor, whose gradient is redistributed to the
    DTensor's own placements.  An op that redistributes its inputs inside
    DTensor's dispatch (a residual add of a seq-sharded and a seq-whole
    tensor) hands back gradients in its output's placements, and a redistribute
    to the placements a tensor already has may make no autograd node at all;
    a view before such a point would then get a gradient it cannot view."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate

        # the gradient of a partial sum is whole on every rank
        ctx.mesh = x.device_mesh
        ctx.placements = tuple(Replicate() if p.is_partial() else p for p in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) == tuple(ctx.placements):
            return grad
        return grad.redistribute(ctx.mesh, ctx.placements)


def pin(x):
    """``x``, whose gradient arrives in ``x``'s own placements (for a merged
    or split view: DTensor cannot view a gradient that its propagation left
    sharded across the merged dims).  A no-op without a mesh or a gradient."""
    if _CTX.val is None or not torch.is_grad_enabled() or not is_dtensor(x):
        return x
    return _PinGrad.apply(x)


def whole(x):
    """A DTensor ``x`` replicated on every rank (an all-reduce of a partial
    result: a mean over sharded groups stays partial otherwise, and torch
    2.11's DTensor cannot add a partial mean to a partial sum); ``x`` itself
    without a mesh."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def placements(*axes: Optional[str]) -> tuple:
    """The active rules' placements of logical ``axes``."""
    mesh, rules = _CTX.val
    return rules.placements(mesh, axes)


def on_local_shards(fn, out_placements, in_placements: Sequence, *args):
    """``fn(*local shards)`` -> DTensors with ``out_placements`` (one
    sequence, or a tuple of them for a tuple of outputs).  Each DTensor
    argument is redistributed to its entry of ``in_placements`` first; a
    None entry marks an argument that is not a tensor.  Under autograd the
    gradient of an argument replicated over a mesh dim that splits the work
    is the sum of the ranks' gradients (``Partial``)."""
    from torch.distributed.tensor import DTensor, Partial, Placement
    from torch.distributed.tensor.experimental import local_map

    mesh, _ = _CTX.val
    for a, p in zip(args, in_placements):
        if (p is None) != (not isinstance(a, DTensor)):
            raise TypeError(f"on_local_shards: argument {type(a).__name__} with placements {p}")
    single = bool(out_placements) and isinstance(out_placements[0], Placement)
    outs = [out_placements] if single else [p for p in out_placements if p is not None]
    # A mesh dim that splits the work (an output sharded or partial on it)
    # makes an input replicated on it a sum of the ranks' contributions in
    # the backward pass: its gradient is Partial there.
    split = {i for p in outs for i, pl in enumerate(p) if not pl.is_replicate()}
    grad_placements = tuple(
        None if p is None else tuple(Partial() if pl.is_replicate() and i in split else pl
                                     for i, pl in enumerate(p))
        for p in in_placements)
    if single:  # one output: a list
        out_placements = list(out_placements)

    several = mesh.size() > 1

    def on_shards(*local):  # plain tensors: the annotations inside are no-ops
        ctx, _CTX.val = _CTX.val, None
        try:
            return fn(*(_contiguous_grad(t) if several else t for t in local))
        finally:
            _CTX.val = ctx

    return local_map(on_shards, out_placements=out_placements,
                     in_placements=tuple(in_placements), in_grad_placements=grad_placements,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient leaves contiguous.  Over more than one
    rank a local gradient that a local region's backward left transposed
    would otherwise reach the DTensor views before it, which take the global
    tensor's strides for the local one's and view it in place.  (On one rank
    the two agree, and the backward stays bitwise the one-device one.)"""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def _contiguous_grad(t):
    if isinstance(t, torch.Tensor) and t.requires_grad and torch.is_grad_enabled():
        return _ContiguousGrad.apply(t)
    return t


def shard_offset(x, dim: int) -> tuple:
    """(global offset, local size) of this rank's shard of DTensor ``x``
    along ``dim``."""
    from repro_torch.models.sharding import local_box

    shape, offset = local_box(x.shape, x.device_mesh, x.placements)
    return int(offset[dim]), int(shape[dim])


def sharded_dims(placements, dim: int) -> list:
    """The mesh dims whose placement shards tensor dim ``dim``."""
    return [i for i, p in enumerate(placements) if getattr(p, "dim", None) == dim]
