"""Leaf-wise helpers over the port's parameter trees: nested dicts and
tuples (the period-grouped ``layers`` stack) of tensors.

Leaves come in ``jax.tree`` order — dict keys sorted, tuples in order — so
a loop over them sums and updates in the reference's order, and any trees
of one structure (params, grads, optimiser moments) line up leaf by leaf.
"""

from __future__ import annotations


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for sub in tree for x in leaves(sub)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of each tree in ``rest`` (same
    structure) -> a tree of ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (tuple, list)):
        return tuple(tree_map(fn, *subs) for subs in zip(tree, *rest))
    return fn(tree, *rest)


def zeros_for(p, shape, dtype):
    """Zeros of ``shape`` and ``dtype`` beside parameter ``p``: on its
    device, or for a DTensor ``p`` a DTensor on its mesh — in its placements
    when the shape is its own (a moment that mirrors it), else replicated
    (a factor or a placeholder)."""
    import torch

    if type(p) is torch.Tensor or not hasattr(p, "device_mesh"):
        return torch.zeros(shape, dtype=dtype, device=p.device)
    if tuple(shape) == tuple(p.shape):
        return torch.zeros_like(p, dtype=dtype)
    import torch.distributed.tensor as dtensor

    return dtensor.zeros(shape, dtype=dtype, device_mesh=p.device_mesh,
                         placements=[dtensor.Replicate()] * p.device_mesh.ndim)


def unflatten(like, values: list):
    """A tree of ``like``'s structure whose leaves, in ``leaves`` order, are
    ``values``."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (tuple, list)):
            return tuple(build(sub) for sub in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out
